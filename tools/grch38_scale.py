"""GRCh38-scale memory validation (SURVEY §7 hard part "index memory on
device").

Synthesizes a ~3 Gb, 24-chromosome genome (GRCh38-like length profile,
repeat content via segment re-insertion), builds the full k=12/step=3
index (~1e9 occurrences — exercising the u32-CSR boundary), builds the
8-shard coordinate-range sharded index (sub-chromosome splits + halo),
maps a sampled read batch on an 8-device virtual mesh, and checks the
records byte-equal the golden scalar oracle. Reports phase timings and
peak RSS.

Run:  python tools/grch38_scale.py [--gb 3.0] [--reads 256]
CI keeps a small version; this script is the real-memory pass, recorded
in docs/SCALE.md.
"""

import argparse
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def log(msg: str) -> None:
    print(f"[scale +{time.time()-T0:8.1f}s rss {rss_gb():5.1f}G] {msg}",
          file=sys.stderr, flush=True)


T0 = time.time()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=3.0)
    ap.add_argument("--reads", type=int, default=256)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--golden-sample", type=int, default=64)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from fem_tpu import sim
    from fem_tpu.config import FemArgs
    from fem_tpu.golden.model import GoldenMapper
    from fem_tpu.index.build import build_index
    from fem_tpu.io.fastx import Reference
    from fem_tpu.core.encoding import encode

    # GRCh38-like chromosome length profile (Mb), scaled to --gb total.
    profile = np.array([248, 242, 198, 190, 182, 171, 159, 145, 138, 134,
                        135, 133, 114, 107, 102, 90, 83, 80, 59, 64,
                        47, 51, 156, 57], dtype=np.float64)
    lengths = (profile / profile.sum() * args.gb * 1e9).astype(np.int64)
    log(f"synthesizing {lengths.sum()/1e9:.2f} Gb over {len(lengths)} chromosomes")

    rng = np.random.default_rng(2024)
    names, seqs = [], []
    for i, ln in enumerate(lengths):
        codes = rng.integers(0, 4, size=int(ln), dtype=np.int8)
        # ~20% repeat content: re-insert earlier segments with divergence.
        target = int(ln * 0.2)
        placed = 0
        while placed < target:
            seg_len = int(rng.integers(500, 5000))
            src = int(rng.integers(0, max(int(ln) - seg_len, 1)))
            dst = int(rng.integers(0, max(int(ln) - seg_len, 1)))
            seg = codes[src : src + seg_len].copy()
            muts = rng.random(seg_len) < 0.01
            seg[muts] = rng.integers(0, 4, size=int(muts.sum()), dtype=np.int8)
            codes[dst : dst + seg_len] = seg
            placed += seg_len
        names.append(b"chr%d" % (i + 1))
        seqs.append(np.frombuffer(b"ACGT", np.uint8)[codes.astype(np.int64)].tobytes())
        del codes
    log("genome synthesized")

    gap = 256
    offsets = np.zeros(len(seqs), np.int64)
    pos = gap
    for i, s in enumerate(seqs):
        offsets[i] = pos
        pos += len(s) + gap
    flat = np.full(pos, 4, np.uint8)
    for i, s in enumerate(seqs):
        flat[int(offsets[i]) : int(offsets[i]) + len(s)] = encode(s)
    ref = Reference(names, seqs, lengths, offsets, flat)
    log("reference encoded (flat %.2f Gb)" % (flat.nbytes / 1e9))

    t = time.time()
    index = build_index(ref, 12, 3)
    log(
        f"index built in {time.time()-t:.0f}s: {index.num_occurrences:,} "
        f"occurrences ({index.occurrences.nbytes/1e9:.2f} Gb), lookup "
        f"{index.lookup.nbytes/1e6:.0f} Mb"
    )

    from fem_tpu.parallel.sharded_index import partition_ranges

    ranges = partition_ranges(lengths, args.shards)
    for s, pieces in enumerate(ranges):
        span = sum(e - b for _, b, e in pieces)
        log(f"  shard {s}: {len(pieces)} pieces, {span/1e6:.0f} Mb")
    # (The engine builds the 8-shard ShardedIndex itself — occ_rows ~8 GB
    # stacked + ref slices ~3 GB; the placement log line below covers it.)

    from jax.sharding import Mesh

    from fem_tpu.config import FemArgs
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine
    from tests.test_engine import _batch_from_reads

    fem_args = FemArgs(error_threshold=5, num_additional_qgrams=1)
    reads = sim.simulate_reads(
        [(n, s) for n, s in zip(names, seqs)], args.reads,
        read_length=100, max_errors=3, seed=77,
    )
    devs = np.array(jax.devices()[: args.shards]).reshape(1, args.shards)
    t = time.time()
    engine = MappingEngine(
        fem_args, ref, index,
        EngineConfig(
            batch_size=args.reads, cap_occ=128, cap_cand=128,
            verify_per_read=16, accept_per_read=8,
            index_mesh=Mesh(devs, ("data", "index")),
        ),
    )
    log(f"engine + device placement in {time.time()-t:.0f}s")
    batch = _batch_from_reads(reads)
    t = time.time()
    recs, stats = engine.map_batch(batch)
    log(
        f"mapped {stats.num_reads} reads in {time.time()-t:.0f}s "
        f"(compile included): {stats.num_mappings} mappings, "
        f"host fallbacks {engine.fallback_reads}, retried {engine.retried_reads}"
    )

    golden = GoldenMapper(fem_args, ref, index)
    k = args.golden_sample
    t = time.time()
    grecs, gstats = golden.map_reads(
        batch.names[:k], batch.seqs[:k], batch.quals[:k]
    )
    # The engine emits in read order, so the golden records of the sampled
    # prefix must be a byte-prefix of the engine's full-batch records.
    eng_blob = b"".join(recs)
    gold_blob = b"".join(grecs)
    assert eng_blob.startswith(gold_blob), "sampled-prefix record mismatch"
    log(f"golden parity on {k} sampled reads OK ({time.time()-t:.0f}s)")
    log(f"DONE peak rss {rss_gb():.1f} Gb")


if __name__ == "__main__":
    main()
