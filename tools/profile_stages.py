"""Stage-level profiler for the device mapping pipeline.

Prefix bisection: jit the candidate pipeline truncated at successive
stage boundaries (the `_stop_after` probes in ops/candidates.py) and
difference the per-call times. It complements a `jax.profiler` trace of
the whole program (`fem map --profile DIR`), which attributes device
time to XLA fusions rather than to pipeline stages.

Usage:  python tools/profile_stages.py [--iters 30] [--stages a,b,c]
The workload mirrors bench.py's north-star config and is built afresh
from seeds on every run.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from fem_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

STAGES = [
    "nop",        # sum(codes) only: the H2D + dispatch floor
    "hash",       # RC + seed hashing + ambiguity counts
    "freqs",      # frequency-table gather over all (lane, group, seed)
    "dp",         # q-gram selection DP + traceback
    "selattr",    # selected-seed attribute select-chains + freq sort
    "occgather",  # occurrence row gather + barrel shift
    "trunc",      # slot validity + last-seed truncation
    "sortvote",   # per-group slab sort + pigeonhole vote
    "dedup",      # greedy dedup fold over groups
    "cand",       # full generate_candidates (+ range filter)
    "full",       # map_core (adds verify + compaction)
]


def build_workload(B=2048, max_errors=3):
    import tempfile

    from fem_tpu import sim
    from fem_tpu.index.build import build_index
    from fem_tpu.io import fastx
    from tests.test_engine import _batch_from_reads

    t0 = time.time()
    seqs = sim.random_genome(int(46e6), num_seqs=1, seed=7, repeat_fraction=0.3)
    with tempfile.TemporaryDirectory() as d:
        fap = os.path.join(d, "ref.fa")
        sim.write_fasta(fap, seqs)
        ref = fastx.read_fasta(fap)
    index = build_index(ref, 12, 3)
    reads = sim.simulate_reads(
        seqs, B, read_length=100, max_errors=max_errors, seed=9
    )
    batch = _batch_from_reads(reads)
    print(f"[prof] workload built in {time.time()-t0:.1f}s", file=sys.stderr)
    return ref, index, batch.codes, batch.lengths


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--e", type=int, default=5)
    ap.add_argument("--cap", type=int, default=64)
    ap.add_argument("--cap-vote", type=int, default=None)
    ap.add_argument("--cap-cand", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--vpr", type=int, default=16)
    ap.add_argument("--apr", type=int, default=4)
    ap.add_argument("--max-errors", type=int, default=None,
                    help="read error budget (default: e, the honest point)")
    ap.add_argument("--stages", type=str, default=",".join(STAGES))
    args = ap.parse_args()
    stages = args.stages.split(",")
    max_errors = args.e if args.max_errors is None else args.max_errors

    from fem_tpu.config import FemArgs
    from fem_tpu.ops.candidates import generate_candidates
    from fem_tpu.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
    from fem_tpu.ops.types import FilterParams, device_index_from_host
    from fem_tpu.pipeline.engine import map_core, pack_outputs, resolve_verify

    ref, index, codes_np, lengths_np = build_workload(args.batch, max_errors)
    dindex = device_index_from_host(index, ref)
    fa = FemArgs(error_threshold=args.e, num_additional_qgrams=1)
    params = FilterParams.from_args(
        fa, codes_np.shape[1], cap_occ=args.cap,
        cap_cand=args.cap_cand or args.cap,
        cap_vote=args.cap_vote or args.cap,
    )
    B = codes_np.shape[0]
    verify_cap = 2 * B * args.vpr
    accept_cap = max(2 * B * args.apr, 64)
    verify = resolve_verify(None, jax.devices()[0].platform)

    # A distinct input buffer per dispatch.
    KBUF = args.iters + 1
    codes_v = [jnp.asarray(np.roll(codes_np, k, axis=0)) for k in range(KBUF)]
    lengths = jnp.asarray(lengths_np.astype(np.int32))

    def prefix(stop):
        def body(di, c, l):
            if stop == "nop":
                return jnp.sum(c.astype(jnp.uint32)) + jnp.sum(
                    l.astype(jnp.uint32)
                )
            neg = reverse_complement(c, l)
            both = jnp.concatenate([c, neg], axis=0)
            lens2 = jnp.concatenate([l, l], axis=0)
            hashes = seed_hashes(both, params.kmer_size)
            amb = ambiguous_base_counts(both, lens2, params.kmer_size)
            if stop == "hash":
                return jnp.sum(hashes.astype(jnp.uint32)) + jnp.sum(
                    amb.astype(jnp.uint32)
                )
            r = generate_candidates(
                both, lens2, hashes, amb, di, params, _stop_after=stop
            )
            if stop == "cand":
                return (
                    jnp.sum(r.cand_pos.astype(jnp.uint32))
                    + jnp.sum(r.num_candidates.astype(jnp.uint32))
                    + jnp.sum(r.dp_total)
                )
            if stop == "full":
                raise AssertionError
            return jax.tree.reduce(
                lambda a, x: a + jnp.sum(x.astype(jnp.uint32)), r, jnp.uint32(0)
            )

        if stop == "full":
            def body(di, c, l):  # noqa: F811
                out = map_core(di, c, l, params, verify_cap, verify,
                               accept_cap)
                return jnp.sum(pack_outputs(out).astype(jnp.uint32))

        return jax.jit(body)

    # Each call fetches its scalar checksum (np.asarray), so the time
    # covers execution; the fetch itself is one word.
    results = {}
    for stop in stages:
        fn = prefix(stop)
        t0 = time.time()
        np.asarray(fn(dindex, codes_v[0], lengths))
        compile_s = time.time() - t0
        t0 = time.time()
        for i in range(1, args.iters + 1):  # buffer 0 was the warm call
            np.asarray(fn(dindex, codes_v[i], lengths))
        per = (time.time() - t0) / args.iters * 1e3
        results[stop] = per
        print(f"[prof] {stop:10s} {per:8.2f} ms/call  (compile+1st {compile_s:.1f}s)",
              file=sys.stderr)

    prev = 0.0
    print("\nstage deltas (ms):")
    for stop in stages:
        print(f"  {stop:10s} {results[stop]:8.2f}  (+{results[stop]-prev:6.2f})")
        prev = results[stop]


if __name__ == "__main__":
    main()
