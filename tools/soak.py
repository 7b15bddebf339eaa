"""Large-scale differential soak: engine vs fem_baseline byte equality.

Maps FEM_SOAK_READS (default 1M) simulated reads against an adversarial
satellite-repeat genome at e in {2, 5, 7}, comparing the device engine's
SAM output with the standalone C++ baseline mapper (byte-identical
semantics to the reference, src/*) as a sorted-record-set + counter
equality check — the reference's own t>1 contract (SURVEY.md §2.4).
Heavy-tail reads exercise the full capacity-retry ladder; the script
reports tier/host-fallback counts per config. Results are recorded in
docs/SOAK.md; CI keeps small versions (tests/test_retry_tiers.py,
tests/test_baseline.py).

Run: python tools/soak.py  [FEM_SOAK_READS=200000 FEM_SOAK_E=2,5,7]
"""

import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def counters(stderr: str) -> list:
    out = []
    for pat in [
        r"The number of read: (\d+)",
        r"The number of mapped read: (\d+)",
        r"additional q-gram filter: (\d+)",
        r"The number of candidate: (\d+)",
        r"The number of mapping: (\d+)",
    ]:
        m = re.search(pat, stderr)
        assert m, f"missing counter in:\n{stderr[-2000:]}"
        out.append(int(m.group(1)))
    return out


def sorted_records(path: str) -> bytes:
    with open(path, "rb") as f:
        recs = [l for l in f if not l.startswith(b"@")]
    recs.sort()
    return b"".join(recs)


def main() -> None:
    from fem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from fem_tpu import sim
    from fem_tpu.config import FemArgs
    from fem_tpu.golden.model import MappingStats
    from fem_tpu.index.build import build_index
    from fem_tpu.io import fastx
    from fem_tpu.io.sam import SamWriter
    from fem_tpu.native.build import build_baseline
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine
    from tests.test_engine import _batch_from_reads

    num_reads = int(os.environ.get("FEM_SOAK_READS", "500000"))
    genome_mb = float(os.environ.get("FEM_SOAK_GENOME_MB", "46"))
    es = [int(x) for x in os.environ.get("FEM_SOAK_E", "5").split(",")]
    # e=2,7 need fresh ~15-min compiles each; default soaks the north-star e=5
    # (whose program is warm from bench.py) — pass FEM_SOAK_E=2,5,7 for all.
    batch = int(os.environ.get("FEM_SOAK_BATCH", "8192"))

    # Honest error budget: reads carry up to max(e) errors (incl. indels)
    # — the advertised capability (src/FEM_map.c:30), not an easier
    # subset. e=7 needs >= 123 bp reads for the step-size sensitivity
    # bound step <= L/(e+2) - k + 1 (README.md:30): default 150 there.
    read_len = int(os.environ.get(
        "FEM_SOAK_READ_LEN", "150" if max(es) >= 7 else "100"
    ))
    max_errors = int(os.environ.get("FEM_SOAK_MAX_ERRORS", str(max(es))))
    t0 = time.time()
    seqs = sim.satellite_genome(
        int(genome_mb * 1e6), num_seqs=2, seed=13, satellite_fraction=0.03,
        unit_range=(24, 160), copies_range=(48, 512),
    )
    reads = sim.simulate_reads(seqs, num_reads, read_length=read_len,
                               max_errors=max_errors, seed=14)
    print(f"[soak] setup {time.time()-t0:.0f}s: {genome_mb}Mb satellite "
          f"genome, {num_reads} reads ({read_len} bp, <= {max_errors} "
          f"errors)", file=sys.stderr)

    bin_ = build_baseline()
    results = []
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "ref.fa")
        fq = os.path.join(d, "reads.fq")
        ix = os.path.join(d, "ref.index")
        sim.write_fasta(fa, seqs)
        sim.write_fastq(fq, reads)
        ref = fastx.read_fasta(fa)
        index = build_index(ref, 12, 3)
        subprocess.run([bin_, "index", "12", "3", fa, ix], check=True,
                       capture_output=True)
        for e in es:
            args = FemArgs(error_threshold=e, num_additional_qgrams=1)
            bsam = os.path.join(d, f"base_e{e}.sam")
            t0 = time.time()
            p = subprocess.run(
                [bin_, "map", "-e", str(e), "-a", "1", "-t", "1",
                 "--ref", fa, "--index", ix, "--read1", fq, "-o", bsam],
                check=True, capture_output=True, text=True)
            base_s = time.time() - t0
            base_counters = counters(p.stderr)

            engine = MappingEngine(
                args, ref, index,
                EngineConfig(batch_size=batch, cap_occ=80, cap_cand=64,
                             verify_per_read=4, accept_per_read=1),
            )
            esam = os.path.join(d, f"eng_e{e}.sam")
            writer = SamWriter(esam, ref.names, ref.lengths.tolist())
            total = MappingStats()
            t0 = time.time()
            batches = (
                _batch_from_reads(reads[i : i + batch])
                for i in range(0, num_reads, batch)
            )
            # Steady-state throughput under retry pressure: exclude the
            # one-time compile+warmup by timestamping
            # after the first WARM yields; the tier-retry pipeline stays
            # active throughout, so steady reads/s INCLUDES the retry tax.
            warm_yields = 2
            n_yield = 0
            steady_t0 = None
            steady_reads0 = 0
            for recs, stats in engine.map_stream(batches):
                for r in recs:
                    writer.write_record(r)
                total += stats
                n_yield += 1
                if n_yield == warm_yields:
                    steady_t0 = time.time()
                    steady_reads0 = total.num_reads
            eng_s = time.time() - t0
            steady_rps = (
                (total.num_reads - steady_reads0) / (time.time() - steady_t0)
                if steady_t0 and total.num_reads > steady_reads0
                else num_reads / eng_s
            )
            writer.close()

            eng_counters = [
                total.num_reads, total.num_mapped_reads,
                total.num_candidates_without_additional_qgram_filter,
                total.num_candidates, total.num_mappings,
            ]
            rec_equal = sorted_records(esam) == sorted_records(bsam)
            ok = rec_equal and eng_counters == base_counters
            line = (
                f"e={e}: records_equal={rec_equal} counters_equal="
                f"{eng_counters == base_counters} mappings={total.num_mappings} "
                f"retried={engine.retried_reads} "
                f"({100.0*engine.retried_reads/num_reads:.2f}%) "
                f"tier_dispatches={engine.tier_dispatches} host_fallbacks="
                f"{engine.fallback_reads} "
                f"({100.0*engine.fallback_reads/num_reads:.3f}%) "
                f"engine steady {steady_rps:,.0f} reads/s "
                f"(whole-run {num_reads/eng_s:,.0f}) vs baseline "
                f"{num_reads/base_s:,.0f} reads/s"
            )
            print(f"[soak] {line}", file=sys.stderr)
            results.append((e, ok, line))
            os.unlink(bsam)
            os.unlink(esam)

    failed = [r for r in results if not r[1]]
    for e, ok, line in results:
        print(("PASS " if ok else "FAIL ") + line)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
