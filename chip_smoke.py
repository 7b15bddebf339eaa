#!/usr/bin/env python3
"""Start-up proof: drive the mapper's main path once on one NVIDIA GPU.

    python chip_smoke.py              # phases a-d on one GPU
    python chip_smoke.py --four       # the multi-GPU paths on 4 GPUs
    python chip_smoke.py --rehearse   # the same phases at toy size on the
                                      # CPU, kernels interpreted (add --four
                                      # for 4 virtual CPU devices)

Phases, in one process:
  a. device: JAX's first device must be a GPU (exit 1 otherwise); prints
     its kind, the device count, JAX's version and nvidia-smi's name and
     power limit.
  b. kernels: the Pallas verify kernel, compiled for the card, against
     the plain `banded_myers` at V = 262,144 candidates, L in {100, 150},
     e in {0, 2, 5, 7}. Integer DP: equality is exact.
  c. main path at chr21 scale (BASELINE.json config 3): a 46 Mb genome
     with 30% repeats, k=12/step=3 index resident on the card, 65,536
     100 bp reads with up to 5 errors; `fem index 12 3` and
     `fem map -e 5 -a 1 --batch-size 8192` through the CLI entry point,
     compared with fem_baseline (record multiset + the five counters);
     the native reader, emitter and CPU mapper must be in use. Prints
     compile seconds cold and from the persistent cache, peak device
     memory, the tier-0 program's memory analysis, retried and fallback
     reads and one smoke timing.
  d. heavy-repeat path: a satellite-repeat genome, 16,384 reads at e=5
     on the engine's default retry ladder, compared with fem_baseline.
  --four: the CLI's automatic data mesh over 4 local GPUs and
     `--index-shards 2` (a 2x2 data x index mesh), each compared with
     fem_baseline on phase c's inputs, plus a check that the index is
     placed through NamedSharding with no device holding more than its
     share.

Any failure exits non-zero before the last line. On success the last
line is {"ok": true, "device": {"platform", "kind", "count"}} (never
printed with --rehearse).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# Phase c's deployment (BASELINE.json config 3, bench.py's generator).
MAIN = dict(genome=46_000_000, repeats=0.3, reads=65_536, e=5, batch=8192)
# Phase d's satellite genome (bench.py's adversarial geometry).
SAT = dict(genome=46_000_000, reads=16_384, e=5, batch=8192)
KERNEL_V = 262_144
TOY = dict(genome=300_000, reads=512, batch=128, sat_reads=256,
           sat_batch=64, kernel_v=1024)
# The toy rehearsal of phase d maps with narrow slabs and sends overflow
# to the host mapper: the default retry rungs take most of a CPU
# rehearsal to compile.
TOY_REPEATS = ("--cap-occ", "64", "--cap-vote", "32", "--cap-cand", "32",
               "--verify-per-read", "4", "--accept-per-read", "4")


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        return out[0].strip() if out else "no GPU listed"
    except Exception as exc:
        return f"unavailable ({type(exc).__name__})"


def digest_lines(chunks) -> tuple[int, int]:
    """Order-independent multiset digest of SAM records: the sum of each
    record's blake2b-128 digest mod 2^128, and the record count. `chunks`
    is an iterable of bytes holding whole lines; headers are skipped.
    Equal digests and counts mean equal record multisets (the reference's
    unordered t>1 emission contract, SURVEY.md §2.4)."""
    dig, cnt = 0, 0
    for chunk in chunks:
        for line in chunk.split(b"\n"):
            if line and not line.startswith(b"@"):
                cnt += 1
                dig = (dig + int.from_bytes(
                    hashlib.blake2b(line, digest_size=16).digest(),
                    "little")) % (1 << 128)
    return dig, cnt


def digest_sam(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        return digest_lines(f)


COUNTERS = ("num_reads", "num_mapped_reads",
            "num_candidates_without_additional_qgram_filter",
            "num_candidates", "num_mappings")


def baseline_counters(stderr: str) -> dict:
    """The five counters from the stderr of fem_baseline or the reference
    binary (src/FEM_map.c's closing lines)."""
    vals = [
        int(re.search(pat + r": (\d+)", stderr).group(1))
        for pat in ("The number of read", "The number of mapped read",
                    "additional q-gram filter", "The number of candidate",
                    "The number of mapping")
    ]
    return dict(zip(COUNTERS, vals))


def run_baseline(bin_: str, fa: str, ix: str, fq: str, sam: str, e: int,
                 threads: int = 1) -> str:
    """`map -e e -a 1` with fem_baseline or the reference binary (same
    command line); returns its stderr."""
    return subprocess.run(
        [bin_, "map", "-e", str(e), "-a", "1", "-t", str(threads),
         "--ref", fa, "--index", ix, "--read1", fq, "-o", sam],
        check=True, capture_output=True, text=True,
    ).stderr


def baseline_map(bin_: str, fa: str, ix: str, fq: str, sam: str, e: int):
    """fem_baseline's (counters, record digest) on these files."""
    counters = baseline_counters(run_baseline(bin_, fa, ix, fq, sam, e))
    return counters, digest_sam(sam)


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (or loading from
    the persistent cache) while it is active."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if self.active and event in self.EVENTS:
            self.seconds += duration

    @contextlib.contextmanager
    def run(self):
        self.seconds, self.active = 0.0, True
        try:
            yield self
        finally:
            self.active = False


@contextlib.contextmanager
def _env(values: dict):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli(*argv: str) -> str:
    """Run the `fem` CLI in-process; returns its stderr."""
    from fem_tpu.pipeline.cli import main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(list(argv))
    text = err.getvalue()
    if rc != 0:
        sys.stderr.write(text)
        raise SystemExit(f"fem {' '.join(argv[:1])} exited {rc}")
    return text


def write_workload(d: str, seqs, reads) -> tuple[str, str, str]:
    from fem_tpu import sim

    fa, fq, ix = (os.path.join(d, n) for n in ("ref.fa", "reads.fq", "ref.index"))
    sim.write_fasta(fa, seqs)
    sim.write_fastq(fq, reads)
    cli("index", "12", "3", fa, ix)
    return fa, fq, ix


def main_workload(toy: bool):
    from fem_tpu import sim

    n = TOY["genome"] if toy else MAIN["genome"]
    seqs = sim.random_genome(n, num_seqs=1, seed=7,
                             repeat_fraction=MAIN["repeats"])
    reads = sim.simulate_reads(seqs, TOY["reads"] if toy else MAIN["reads"],
                               read_length=100, max_errors=MAIN["e"], seed=9)
    return seqs, reads


def map_and_compare(tag, bin_, fa, fq, ix, e, batch, d, clock, extra=(),
                    env=None):
    """`fem map` through the CLI, compared with fem_baseline's output on
    the same files. Returns (stats json, compile seconds, wall seconds,
    the CLI's stderr)."""
    sam = os.path.join(d, f"{tag}.sam")
    js = os.path.join(d, f"{tag}.json")
    t0 = time.time()
    with clock.run(), _env(env or {}):
        log = cli("map", "-e", str(e), "-a", "1", "--batch-size", str(batch),
            "--ref", fa, "--index", ix, "--read1", fq, "-o", sam,
            "--stats-json", js, *extra)
    wall = time.time() - t0
    with open(js) as f:
        stats = json.load(f)
    base_counters, base_dig = baseline_map(
        bin_, fa, ix, fq, os.path.join(d, f"{tag}.base.sam"), e)
    dig = digest_sam(sam)
    counters = {k: stats["mapping_stats"][k] for k in COUNTERS}
    say(f"[{tag}] {dig[1]} records compared with fem_baseline's {base_dig[1]}: "
        f"records_equal={dig == base_dig} counters_equal="
        f"{counters == base_counters} {counters}")
    if dig != base_dig or counters != base_counters:
        raise SystemExit(f"[{tag}] output differs from fem_baseline "
                         f"(baseline counters {base_counters})")
    return stats, clock.seconds, wall, log


def phase_kernels(toy: bool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fem_tpu.ops.verify import banded_myers, compute_eq
    from fem_tpu.ops.verify_pallas import banded_myers_pallas

    V = TOY["kernel_v"] if toy else KERNEL_V
    rng = np.random.default_rng(5)
    plain = jax.jit(lambda w, t, n, e: banded_myers(compute_eq(w, t, e), n, e),
                    static_argnums=3)
    kern = jax.jit(
        lambda w, t, n, e: banded_myers_pallas(w, t, n, e, interpret=toy),
        static_argnums=3)
    for L, e in [(L, e) for L in (100, 150) for e in (0, 2, 5, 7)
                 if not toy or L == 100 or e == 5]:
        window = rng.integers(0, 5, (V, L + 2 * e), dtype=np.uint8)
        text = rng.integers(0, 5, (V, L), dtype=np.uint8)
        # Every other candidate: its window's diagonal with up to e+1
        # substitutions, so a share of them is accepted.
        half = window[::2, e:e + L].copy()
        hits = rng.integers(0, L, (half.shape[0], e + 1))
        keep = rng.random(hits.shape) < 0.5
        rows = np.broadcast_to(np.arange(half.shape[0])[:, None], hits.shape)
        half[rows[keep], hits[keep]] = rng.integers(0, 4, keep.sum())
        text[::2] = half
        lengths = np.full(V, L, np.int32)
        lengths[1::4] = rng.integers(L // 2, L, lengths[1::4].shape[0])
        args = (jnp.asarray(window), jnp.asarray(text), jnp.asarray(lengths))
        ref = jax.block_until_ready(plain(*args, e))
        out = jax.block_until_ready(kern(*args, e))
        times = []
        for fn in (plain, kern):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args, e))
            times.append(time.perf_counter() - t0)
        for f in ("edit_distance", "end_offset", "accepted"):
            if not np.array_equal(np.asarray(getattr(out, f)),
                                  np.asarray(getattr(ref, f))):
                raise SystemExit(f"[kernel] V={V} L={L} e={e}: {f} differs")
        say(f"[kernel] banded_myers Pallas (triton) == plain at V={V} L={L} "
            f"e={e}: {int(np.asarray(ref.accepted).sum())} accepted; "
            f"wall {times[1] * 1e3:.3f} ms vs plain {times[0] * 1e3:.3f} ms")


def phase_main(toy: bool, bin_: str, clock, card: str) -> None:
    import jax

    from fem_tpu.config import FemArgs
    from fem_tpu.index.storage import load_index
    from fem_tpu.io.fastx import read_fasta
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine

    batch = TOY["batch"] if toy else MAIN["batch"]
    e = MAIN["e"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        seqs, reads = main_workload(toy)
        fa, fq, ix = write_workload(d, seqs, reads)
        say(f"[main] set-up {time.time() - t0:.1f} s: genome "
            f"{sum(len(s) for _, s in seqs)} bp, {len(reads)} reads, index built")
        stats, cold, _, _ = map_and_compare(
            "main", bin_, fa, fq, ix, e, batch, d, clock)
        for k in ("native_reader", "native_emitter", "native_mapper"):
            if not stats[k]:
                raise SystemExit(f"[main] {k} was not used (Python fallback)")
        say(f"[main] native reader, emitter and CPU mapper in use; verify="
            f"{stats['verify']} on {stats['platform']}")
        stats2, cached, wall, _ = map_and_compare(
            "main.cached", bin_, fa, fq, ix, e, batch, d, clock)
        say(f"[main] compile seconds: cold {cold:.2f}, from the persistent "
            f"cache {cached:.2f}")
        say(f"[main] retried reads {stats2['retried_reads']}, host fallback "
            f"reads {stats2['fallback_reads']}")
        say(f"[main] smoke timing, not a benchmark: {len(reads) / wall:.1f} "
            f"reads/s wall for the cached `fem map` run ({wall:.2f} s incl. "
            f"index upload) on {card}")
        engine = MappingEngine(
            FemArgs(error_threshold=e, num_additional_qgrams=1),
            read_fasta(fa), load_index(ix),
            EngineConfig(batch_size=batch),
        )
        say(f"[main] tier-0 program memory_analysis: "
            f"{engine.compiled(128).memory_analysis()}")
        mem = jax.devices()[0].memory_stats() or {}
        say(f"[main] peak_bytes_in_use {mem.get('peak_bytes_in_use', 'n/a')}")


def phase_repeats(toy: bool, bin_: str, clock) -> None:
    from fem_tpu import sim

    n = TOY["genome"] if toy else SAT["genome"]
    seqs = sim.satellite_genome(
        n, num_seqs=2, seed=13, satellite_fraction=0.03,
        unit_range=(24, 160), copies_range=(48, 512),
    )
    reads = sim.simulate_reads(seqs, TOY["sat_reads"] if toy else SAT["reads"],
                               read_length=100, max_errors=SAT["e"], seed=14)
    with tempfile.TemporaryDirectory() as d:
        fa, fq, ix = write_workload(d, seqs, reads)
        stats, secs, _, _ = map_and_compare(
            "repeats", bin_, fa, fq, ix, SAT["e"],
            TOY["sat_batch"] if toy else SAT["batch"], d, clock,
            extra=TOY_REPEATS if toy else (),
            env={"FEM_TPU_TIERS": "none"} if toy else None)
        say(f"[repeats] retried reads {stats['retried_reads']}, host fallback "
            f"reads {stats['fallback_reads']}, compile seconds {secs:.2f}")


def phase_four(toy: bool, bin_: str, clock) -> None:
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    from fem_tpu.config import FemArgs
    from fem_tpu.index.storage import load_index
    from fem_tpu.io.fastx import read_fasta
    from fem_tpu.parallel import multihost
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine

    devs = jax.devices()
    if len(devs) != 4:
        raise SystemExit(f"--four needs 4 devices, JAX sees {len(devs)}")
    batch = TOY["batch"] if toy else MAIN["batch"]
    e = MAIN["e"]
    with tempfile.TemporaryDirectory() as d:
        seqs, reads = main_workload(toy)
        fa, fq, ix = write_workload(d, seqs, reads)
        map_and_compare("data-mesh", bin_, fa, fq, ix, e, batch, d, clock)
        map_and_compare("index-shards-2", bin_, fa, fq, ix, e, batch, d, clock,
                        extra=("--index-shards", "2"))

        args = FemArgs(error_threshold=e, num_additional_qgrams=1)
        ref, index = read_fasta(fa), load_index(ix)
        def used():
            return [(dv.memory_stats() or {}).get("bytes_in_use", 0)
                    for dv in devs]

        before = used()
        dp = MappingEngine(args, ref, index, EngineConfig(
            batch_size=batch, mesh=multihost.local_data_mesh()))
        ish = MappingEngine(args, ref, index, EngineConfig(
            batch_size=batch, index_mesh=multihost.global_index_mesh(2)))
        after = used()
        for leaf in jax.tree.leaves(dp.dindex):
            sh = leaf.sharding
            if not (isinstance(sh, NamedSharding) and sh.is_fully_replicated
                    and len(sh.device_set) == 4):
                raise SystemExit(f"[four] data-mesh index leaf placed as {sh}")
        occ = ish._device_args[1]
        if not (isinstance(occ.sharding, NamedSharding)
                and occ.sharding.spec[0] == "index"
                and {s.data.shape[0] for s in occ.addressable_shards}
                == {occ.shape[0] // 2}):
            raise SystemExit(f"[four] sharded occurrence table placed as "
                             f"{occ.sharding}")
        added = np.array(after) - np.array(before)
        shard = occ.addressable_shards[0].data.shape
        say(f"[four] index placement: data mesh replicated by NamedSharding "
            f"over 4 devices; index-sharded occurrence table "
            f"{tuple(occ.shape)} as {occ.sharding.spec}, {tuple(shard)} per "
            f"device; bytes added per device {added.tolist()}")
        if added.any() and added.max() > 1.25 * max(added.min(), 1):
            raise SystemExit("[four] one device holds more than its share")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-GPU paths, on 4 devices")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU with interpreted kernels")
    args = ap.parse_args()
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()

    # a. device
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"[device] JAX's first device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    card = nvidia_smi()
    say(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
        f"jax {jax.__version__}")
    say(f"[device] nvidia-smi name, power.limit: {card}")

    from fem_tpu.native.build import build_baseline
    from fem_tpu.utils.cache import enable_compile_cache

    say(f"[device] compile cache {enable_compile_cache()}")
    t0 = time.time()
    bin_ = build_baseline()  # set-up: built for this host on first use
    say(f"[device] native build (set-up) {time.time() - t0:.1f} s")
    clock = CompileClock()
    if args.four:
        phases = [("four", lambda: phase_four(args.rehearse, bin_, clock))]
    else:
        phases = [
            ("kernels", lambda: phase_kernels(args.rehearse)),
            ("main", lambda: phase_main(args.rehearse, bin_, clock, card)),
            ("repeats", lambda: phase_repeats(args.rehearse, bin_, clock)),
        ]
    for name, run in phases:
        t0 = time.time()
        run()
        say(f"[{name}] phase passed in {time.time() - t0:.1f} s")
    if args.rehearse:
        say("[rehearse] all phases passed (no ok line off the GPU)")
        return 0
    say(f"[device] nvidia-smi name, power.limit: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
