"""Verify kernel vs plain verify path inside the full map program, on a GPU.

Builds chip_smoke.py's phase-c deployment (46 Mb genome, 30% repeats,
k=12/step=3, 100 bp reads with up to 5 errors, e=5 a=1, B=8192), then:

  1. end to end: `fem map` through the CLI, with the engine's verify
     choice forced to plain or kernel (`forced_verify`), in the order
     plain, kernel, kernel, plain; steady reads/s from the
     per-batch times (`--verbose-batches`) after the first two batches,
     each run compared with fem_baseline;
  2. device time: one `--profile` run of each, reduced by
     tools/trace_share.py to the device time of the `verify` and
     `filter_tail` scopes, the busy time and the idle share;
  3. the kernel alone at a slab like the program's (V = 2 * B * 16
     slots, the live prefix as in the traced run) over block sizes and
     warp counts.

    python tools/verify_ab.py [--reads 262144] [--out verify_ab.json]

Prints one JSON object and writes it to --out. Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def forced_verify(choice: str):
    """Make every MappingEngine built inside use `choice` ("plain" or
    "kernel") for verify, in place of the engine's own pick."""
    from fem_tpu.pipeline import engine

    pick = engine.resolve_verify
    engine.resolve_verify = lambda _requested, platform: pick(choice, platform)
    try:
        yield
    finally:
        engine.resolve_verify = pick


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--out", default="verify_ab.json")
    ap.add_argument("--trace-dir", default=None,
                    help="where traces go (default: a temporary directory)")
    ap.add_argument("--order", default="plain,kernel,kernel,plain",
                    help="verify implementations of the timed runs, in turn")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        return 1

    import chip_smoke as smoke
    from fem_tpu import sim
    from fem_tpu.native.build import build_baseline
    from fem_tpu.utils.cache import enable_compile_cache
    from tools.trace_share import summarize

    enable_compile_cache()
    bin_ = build_baseline()
    clock = smoke.CompileClock()
    batch, e = smoke.MAIN["batch"], smoke.MAIN["e"]
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "name_power_limit": smoke.nvidia_smi()},
        "reads": args.reads, "batch": batch, "runs": [], "traces": {},
    }
    seqs = sim.random_genome(smoke.MAIN["genome"], num_seqs=1, seed=7,
                             repeat_fraction=smoke.MAIN["repeats"])
    reads = sim.simulate_reads(seqs, args.reads, read_length=100,
                               max_errors=e, seed=9)
    with tempfile.TemporaryDirectory() as d, contextlib.ExitStack() as stack:
        tdir = args.trace_dir or stack.enter_context(tempfile.TemporaryDirectory())
        fa, fq, ix = smoke.write_workload(d, seqs, reads)
        order = args.order.split(",")
        for verify in order:
            with forced_verify(verify):
                _, compile_s, wall, log = smoke.map_and_compare(
                    f"ab-{verify}", bin_, fa, fq, ix, e, batch, d, clock,
                    extra=("--verbose-batches",))
            dts = [float(x) for x in re.findall(
                r"Mapped read batch in ([0-9.]+)s", log)]
            steady = dts[2:]
            run = {
                "verify": verify, "wall_s": wall, "compile_s": compile_s,
                "steady_reads_per_s": (len(steady) * batch / sum(steady)
                                       if steady else None),
                "batches": len(dts),
            }
            out["runs"].append(run)
            smoke.say(f"[ab] {json.dumps(run)}")
        for verify in dict.fromkeys(order):
            tr = os.path.join(tdir, verify)
            with forced_verify(verify):
                smoke.map_and_compare(
                    f"trace-{verify}", bin_, fa, fq, ix, e, batch, d, clock,
                    extra=("--profile", tr))
            try:
                summ = summarize(tr, ["verify", "filter_tail", "banded_myers"],
                                 top=15)
            except (OSError, ValueError) as exc:  # keep the timed runs
                summ = {"error": f"{type(exc).__name__}: {exc}"}
            out["traces"][verify] = summ
            smoke.say(f"[ab] trace {verify}: " + json.dumps(
                {k: v for k, v in summ.items() if k != "top"}))
    out["kernel_sweep"] = [] if args.no_sweep else kernel_sweep(batch, e)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("device", "runs", "kernel_sweep")}))
    return 0


def kernel_sweep(batch: int, e: int, live: int = 16_384) -> list:
    """The kernel alone on a verify slab shaped like the program's: V =
    2 * batch * 16 slots of which the first `live` hold 100 bp reads
    (padded to 128), over block sizes and warp counts."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fem_tpu.ops import verify_pallas as vp

    V, L = 2 * batch * 16, 128
    rng = np.random.default_rng(3)
    window = jnp.asarray(rng.integers(0, 4, (V, L + 2 * e), dtype=np.uint8))
    text = jnp.asarray(rng.integers(0, 4, (V, L), dtype=np.uint8))
    lengths = jnp.asarray(np.where(np.arange(V) < live, 100, 0).astype(np.int32))
    res = []
    saved = vp.BLOCK, vp.NUM_WARPS
    try:
        for block in (64, 128, 256):
            for warps in (1, 2, 4, 8):
                if block < 32 * warps:
                    continue
                vp.BLOCK, vp.NUM_WARPS = block, warps
                fn = jax.jit(lambda w, t, n: vp.banded_myers_pallas(w, t, n, e))
                jax.block_until_ready(fn(window, text, lengths))
                ts = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(window, text, lengths))
                    ts.append(time.perf_counter() - t0)
                res.append({"block": block, "num_warps": warps,
                            "median_ms": float(np.median(ts) * 1e3),
                            "min_ms": float(np.min(ts) * 1e3)})
                print(f"[ab] sweep {res[-1]}", flush=True)
    finally:
        vp.BLOCK, vp.NUM_WARPS = saved
    return res


if __name__ == "__main__":
    sys.exit(main())
