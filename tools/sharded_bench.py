"""Throughput of the coordinate-sharded-index program (whole-genome path).

BASELINE.json configs 3-4 target GRCh38-scale genomes, where the
occurrence table shards by reference coordinate over an `index` mesh axis
(fem_tpu/parallel/sharded_index.py). This tool measures the sharded
PROGRAM's throughput — the mesh-shaped map step with its pmax/psum
collectives, per-shard CSR, ownership filtering and halo logic — as
opposed to bench.py's plain single-device program:

  * on one GPU: a (data=1, index=1) mesh — every sharded-path op
    (shard_map, collectives, own-range filter) at full speed, directly
    comparable to bench.py's number (the sharded-path overhead);
  * on a virtual CPU mesh (--platform cpu --shards N): functional scaling
    shape for the (1 x N) layout, plus per-batch wall times for the
    SCALE.md efficiency model.

Prints one JSON line: {"reads_per_s", "mesh", "retried", "fallbacks",
"stats", ...}. Usage:
    python tools/sharded_bench.py [--genome-mb 46] [--reads 98304]
        [--shards 1] [--e 5] [--batch 8192] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=46.0)
    ap.add_argument("--reads", type=int, default=98304)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--e", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--platform", default=None, choices=[None, "cpu"])
    ap.add_argument("--repeats", type=float, default=0.3)
    args = ap.parse_args()

    if args.platform == "cpu":
        n_dev = args.shards * args.data
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n_dev}"
        )
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from fem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from jax.sharding import Mesh

    from fem_tpu import sim
    from fem_tpu.config import FemArgs
    from fem_tpu.golden.model import MappingStats
    from fem_tpu.index.build import build_index
    from fem_tpu.io import fastx
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine
    from tests.test_engine import _batch_from_reads

    t0 = time.time()
    seqs = sim.random_genome(
        int(args.genome_mb * 1e6), num_seqs=4, seed=7,
        repeat_fraction=args.repeats,
    )
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.fa")
        sim.write_fasta(p, seqs)
        ref = fastx.read_fasta(p)
    index = build_index(ref, 12, 3)
    reads = sim.simulate_reads(
        seqs, args.reads, read_length=100, max_errors=args.e, seed=9
    )
    print(f"[shbench] setup {time.time()-t0:.1f}s", file=sys.stderr)

    devs = np.array(jax.devices()[: args.data * args.shards]).reshape(
        args.data, args.shards
    )
    mesh = Mesh(devs, ("data", "index"))
    fem_args = FemArgs(error_threshold=args.e, num_additional_qgrams=1)
    engine = MappingEngine(
        fem_args, ref, index,
        EngineConfig(
            batch_size=args.batch, cap_occ=80, cap_cand=16, cap_vote=32,
            verify_per_read=2, accept_per_read=1, index_mesh=mesh,
        ),
    )
    batches = [
        _batch_from_reads(reads[i : i + args.batch])
        for i in range(0, args.reads, args.batch)
    ]
    t0 = time.time()
    total = MappingStats()
    n_rec = 0
    for recs, stats in engine.map_stream(batches[:1]):
        total += stats
        n_rec += len(recs)
    warm_s = time.time() - t0
    print(f"[shbench] compile+warmup {warm_s:.1f}s", file=sys.stderr)
    t0 = time.time()
    per_batch = []
    bt = time.time()
    for recs, stats in engine.map_stream(batches[1:]):
        total += stats
        n_rec += len(recs)
        now = time.time()
        per_batch.append(round(now - bt, 4))
        bt = now
    dt = time.time() - t0
    timed = args.reads - args.batch
    out = {
        "metric": "sharded-index program reads/s",
        "mesh": f"{args.data}x{args.shards}",
        "platform": jax.devices()[0].platform,
        "genome_mb": args.genome_mb,
        "e": args.e,
        "reads_per_s": round(timed / dt, 1),
        "timed_reads": timed,
        "seconds": round(dt, 3),
        "retried": engine.retried_reads,
        "fallbacks": engine.fallback_reads,
        "records": n_rec,
        "stats": total.__dict__,
        "per_batch_s_head": per_batch[:8],
    }
    print(f"[shbench] {timed} reads in {dt:.2f}s -> "
          f"{timed/dt:,.0f} reads/s | retried {engine.retried_reads} "
          f"fallbacks {engine.fallback_reads}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
