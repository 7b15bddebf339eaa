"""Scaling-efficiency measurement (BASELINE.json: >=80% 1->N hosts).

Real multi-chip hardware is not available in this environment, so two
proxies are measured and recorded in docs/SCALE.md:

1. Virtual-device scaling (this script): reads/s of the data-parallel
   shard_mapped program at 1/2/4/8 virtual CPU devices, same total work.
   This mostly validates that the sharded program adds no serial
   overhead (per-shard work shrinks ~linearly); device scaling needs
   several GPUs (`chip_smoke.py --four` checks the multi-GPU paths).

Run: python tools/scaling_bench.py  [FEM_SCALE_READS=16384]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from fem_tpu import sim
    from fem_tpu.config import FemArgs
    from fem_tpu.index.build import build_index
    from fem_tpu.io import fastx
    from fem_tpu.parallel.mesh import make_mesh
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine
    from tests.test_engine import _batch_from_reads

    num_reads = int(os.environ.get("FEM_SCALE_READS", "16384"))
    batch = int(os.environ.get("FEM_SCALE_BATCH", "2048"))
    e = int(os.environ.get("FEM_SCALE_E", "2"))

    import tempfile

    seqs = sim.random_genome(4_600_000, num_seqs=2, seed=7, repeat_fraction=0.2)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.fa")
        sim.write_fasta(p, seqs)
        ref = fastx.read_fasta(p)
    index = build_index(ref, 12, 3)
    args = FemArgs(error_threshold=e, num_additional_qgrams=1)
    reads = sim.simulate_reads(seqs, num_reads, read_length=100,
                               max_errors=2, seed=9)
    batches = [
        _batch_from_reads(reads[i : i + batch])
        for i in range(0, num_reads, batch)
    ]

    results = {}
    for n in (1, 2, 4, 8):
        if len(jax.devices()) < n:
            break
        mesh = make_mesh(jax.devices()[:n]) if n > 1 else None
        engine = MappingEngine(
            args, ref, index,
            EngineConfig(batch_size=batch, cap_occ=64, cap_cand=64,
                         verify_per_read=4, accept_per_read=2, mesh=mesh),
        )
        engine.map_batch(batches[0])  # compile + warm
        t0 = time.time()
        total = 0
        for recs, stats in engine.map_stream(batches):
            total += stats.num_reads
        dt = time.time() - t0
        results[n] = total / dt
        eff = results[n] / (results[1] * n) if 1 in results and n > 1 else 1.0
        print(f"[scale] {n} device(s): {results[n]:,.0f} reads/s "
              f"(efficiency vs 1x{n}: {eff:.2f})", file=sys.stderr)

    print(json.dumps({
        "metric": "virtual-device data-parallel scaling (CPU proxy)",
        "reads_per_s": {str(k): round(v, 1) for k, v in results.items()},
        "note": "2 physical cores bound total compute; see docs/SCALE.md",
    }))


if __name__ == "__main__":
    main()
