"""Benchmark: all-mapping reads/s on one GPU.

Config mirrors the north-star operating point (BASELINE.json config 3:
human-chr21-scale genome — synthetic 46 Mb with 30% repeat content, the
repo ships no fixtures and the environment has no egress — 100 bp
single-end reads carrying the full e-error budget, k=12/step=3, e=5,
group seeding, src/FEM_map.c:67-72 flags).

Prints ONE headline JSON line: {"metric", "value", "unit", "vs_baseline",
"vs_reference_binary", "scoring", "whole_run_rps", "records_equal",
"device", ...} plus one auxiliary JSON line (before the headline) for the
adversarial satellite-genome workload. Two CPU baselines run first on the
same workload:

  * the ACTUAL reference binary, built unmodified by refbuild/build.sh
    (gcc -O3 -march=native) when its sources are present, at -t 1 and
    -t 2 (src/FEM_map.c:182-189) — `vs_reference_binary` is the device
    vs ONE reference thread;
  * `fem_baseline`, our C++ reimplementation (byte-identical output) —
    the conservative `vs_baseline` denominator.

All device work runs in ONE child process at a time, which holds the
GPU alone (a JAX process reserves most of the card's memory when it
starts); this parent never imports JAX. A first short child checks that
JAX's first device is a GPU; without one the benchmark exits 1 before
any set-up and prints no JSON line.

Every timed device run is also a correctness run: the child digests the
FULL SAM record multiset it emitted, and the parent maps the identical
timed read subset with fem_baseline and asserts record-multiset + counter
equality (the reference's t>1 contract, SURVEY.md §2.4).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import chip_smoke as smoke

def _batch_size() -> int:
    return int(os.environ.get("FEM_BENCH_BATCH", "16384"))


def _timed_read_ranges(num_reads, batch_size, n_warm):
    """The reads the child timed: every batch after its first n_warm."""
    total_batches = -(-num_reads // batch_size)
    return [
        (i * batch_size, min((i + 1) * batch_size, num_reads))
        for i in range(n_warm, total_batches)
    ]


def _verify_against_baseline(bin_, fixture_dir, reads, e, ranges, child_stats):
    """Map the exact timed read subset with fem_baseline (byte-identical
    to the reference binary) and compare record-multiset digest + the five
    MappingStats counters against the child's aggregates."""
    timed = [r for lo, hi in ranges for r in reads[lo:hi]]
    if not timed:
        return None
    from fem_tpu import sim

    with tempfile.TemporaryDirectory() as d:
        fq = os.path.join(d, "timed.fq")
        sim.write_fastq(fq, timed)
        t0 = time.time()
        base_counters, (dig, cnt) = smoke.baseline_map(
            bin_, os.path.join(fixture_dir, "ref.fa"),
            os.path.join(fixture_dir, "ref.index"), fq,
            os.path.join(d, "timed.sam"), e)
    eng_counters = {k: child_stats[k] for k in smoke.COUNTERS}
    equal = (
        dig == child_stats["rec_digest"]
        and cnt == child_stats["rec_count"]
        and base_counters == eng_counters
    )
    print(
        f"[bench] full-run equality over {len(timed)} timed reads: "
        f"records_equal={dig == child_stats['rec_digest']} "
        f"({cnt} vs {child_stats['rec_count']} records), "
        f"counters_equal={base_counters == eng_counters} "
        f"(baseline map {time.time()-t0:.1f}s)",
        file=sys.stderr)
    return {"records_equal": bool(equal), "records_checked": int(cnt),
            "reads_checked": len(timed)}


def _build_binaries():
    """Build fem_baseline and (best-effort) the reference binary."""
    from fem_tpu.native.build import build_baseline

    bin_ = build_baseline()
    ref_bin = None
    out = subprocess.run(
        [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "refbuild", "build.sh")],
        capture_output=True, text=True)
    if out.returncode == 0:
        ref_bin = out.stdout.strip().splitlines()[-1]
    else:
        print(f"[bench] reference binary not built: {out.stderr.strip()}",
              file=sys.stderr)
    return bin_, ref_bin


def run_child(fixture_dir, phase="", extra_env=None):
    """Map the fixture in ONE child process (the only process on the
    GPU); returns its result dict, or None if it failed."""
    import fem_tpu

    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(fem_tpu.__file__)))
        + os.pathsep + env.get("PYTHONPATH", "")
    )
    env.update(extra_env or {})
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", fixture_dir],
        env=env, capture_output=True, text=True,
    )
    if p.returncode != 0:
        print(f"[bench]{phase} child failed rc={p.returncode}: "
              f"{p.stderr[-1500:]}", file=sys.stderr)
        return None
    s = json.loads(p.stdout.strip().splitlines()[-1])
    best = max(h["reads"] / h["seconds"] for h in s["halves"])
    stats = dict(s["stats"])
    stats["rec_digest"] = int(s["rec_digest"])
    stats["rec_count"] = s["rec_count"]
    dev = s["device"]
    print(
        f"[bench]{phase} {best:,.0f} reads/s best half "
        f"({s['reads'] / s['seconds']:,.0f} whole-run, {s['reads']} timed "
        f"reads, {s['seconds']:.2f}s, warmup {s['warmup_seconds']:.0f}s) on "
        f"{dev['platform']} {dev['kind']} x{dev['count']} "
        f"[{dev['name_power_limit']}] | stats "
        f"{ {k: v for k, v in stats.items() if not k.startswith('rec_')} } | "
        f"retried {s['retried']} | host fallbacks {s['fallbacks']}",
        file=sys.stderr)
    return {
        "best": best, "whole_run": s["reads"] / s["seconds"],
        "stats": stats, "retried": s["retried"],
        "fallbacks": s["fallbacks"], "device": dev,
    }


def probe() -> int:
    """Device process: exit 1 unless JAX's first device is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] needs a GPU; JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    # The device check runs first, in its own short-lived process, so a
    # machine without a GPU fails before the set-up and the CPU baselines.
    if subprocess.run([sys.executable, os.path.abspath(__file__),
                       "--probe"]).returncode != 0:
        return 1
    # Default config mirrors the north-star operating point (BASELINE.json
    # config 3: human-chr21-scale genome, 100bp reads, e=5 all-mapping).
    genome_mb = float(os.environ.get("FEM_BENCH_GENOME_MB", "46"))
    num_reads = int(os.environ.get("FEM_BENCH_READS", "327680"))
    e = int(os.environ.get("FEM_BENCH_E", "5"))
    repeat_fraction = float(os.environ.get("FEM_BENCH_REPEATS", "0.3"))
    adversarial_reads = int(os.environ.get("FEM_BENCH_ADV_READS", "163840"))
    n_warm = 1

    from fem_tpu import sim
    from fem_tpu.index.build import build_index
    from fem_tpu.index.storage import save_index
    from fem_tpu.io import fastx

    t0 = time.time()
    seqs = sim.random_genome(
        int(genome_mb * 1e6), num_seqs=1, seed=7, repeat_fraction=repeat_fraction
    )
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.fa")
        sim.write_fasta(p, seqs)
        ref = fastx.read_fasta(p)
    index = build_index(ref, 12, 3)
    # Honest operating point: reads carry up to e errors (incl. indels) —
    # the advertised capability (src/FEM_map.c:30), not an easier subset.
    reads = sim.simulate_reads(
        seqs, num_reads, read_length=100, max_errors=e, seed=9
    )
    print(f"[bench] setup {time.time()-t0:.1f}s "
          f"(genome {genome_mb}Mb repeats={repeat_fraction}, {num_reads} reads, e={e})", file=sys.stderr)

    # CPU baselines first, while no device process shares the host.
    reference_rps = None
    reference_t2_rps = None
    bin_, ref_bin = _build_binaries()
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "ref.fa")
        fq = os.path.join(d, "reads.fq")
        ix = os.path.join(d, "ref.index")
        sam = os.path.join(d, "out.sam")
        sim.write_fasta(fa, seqs)
        sim.write_fastq(fq, reads)
        subprocess.run([bin_, "index", "12", "3", fa, ix], check=True,
                       capture_output=True)

        def timed_map(b, t):
            t0 = time.time()
            smoke.run_baseline(b, fa, ix, fq, sam, e, threads=t)
            return num_reads / (time.time() - t0)

        if ref_bin:
            # The index file format is bit-identical between the two
            # builders (tests/test_reference_binary.py), so the reference
            # binary maps from the same index.
            reference_rps = timed_map(ref_bin, 1)
            reference_t2_rps = timed_map(ref_bin, 2)
            print(
                f"[bench] reference binary: {reference_rps:,.0f} reads/s "
                f"@ -t 1, {reference_t2_rps:,.0f} reads/s @ -t 2 (host CPU)",
                file=sys.stderr)
        baseline_rps = timed_map(bin_, 1)
    print(f"[bench] fem_baseline (1 CPU thread): {baseline_rps:,.0f} reads/s",
          file=sys.stderr)

    with tempfile.TemporaryDirectory() as fixture_dir:
        sim.write_fasta(os.path.join(fixture_dir, "ref.fa"), seqs)
        sim.write_fastq(os.path.join(fixture_dir, "reads.fq"), reads)
        save_index(index, os.path.join(fixture_dir, "ref.index"))
        res = run_child(fixture_dir)
        if res is None:
            return 1
        equality = _verify_against_baseline(
            bin_, fixture_dir, reads, e,
            _timed_read_ranges(num_reads, _batch_size(), n_warm),
            res["stats"])

    # Adversarial phase: satellite-repeat genome (tools/soak.py geometry)
    # exercising heavy-tailed occurrence lists — the workload where the
    # reference's unbounded merge (src/filter.c:80-131) pays no retry tax.
    adv_result = None
    if adversarial_reads > 0 and os.environ.get("FEM_BENCH_SKIP_ADV") != "1":
        t0 = time.time()
        adv_seqs = sim.satellite_genome(
            int(genome_mb * 1e6), num_seqs=2, seed=13, satellite_fraction=0.03,
            unit_range=(24, 160), copies_range=(48, 512),
        )
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "ref.fa")
            sim.write_fasta(p, adv_seqs)
            adv_ref = fastx.read_fasta(p)
        adv_index = build_index(adv_ref, 12, 3)
        adv_reads = sim.simulate_reads(
            adv_seqs, adversarial_reads, read_length=100, max_errors=e, seed=14
        )
        print(f"[bench] adversarial setup {time.time()-t0:.1f}s "
              f"(satellite genome, {adversarial_reads} reads)", file=sys.stderr)
        with tempfile.TemporaryDirectory() as fixture_dir:
            fa = os.path.join(fixture_dir, "ref.fa")
            fq = os.path.join(fixture_dir, "reads.fq")
            sim.write_fasta(fa, adv_seqs)
            sim.write_fastq(fq, adv_reads)
            save_index(adv_index, os.path.join(fixture_dir, "ref.index"))
            t0 = time.time()
            smoke.run_baseline(bin_, fa, os.path.join(fixture_dir, "ref.index"),
                               fq, os.path.join(fixture_dir, "out.sam"), e)
            adv_base_rps = adversarial_reads / (time.time() - t0)
            print(f"[bench] adversarial fem_baseline: {adv_base_rps:,.0f} "
                  f"reads/s", file=sys.stderr)
            # Slabs sized for the satellite workload's ~10 candidates and
            # ~9 mappings per read; overflow goes to the exact host mapper.
            adv_env = {"FEM_BENCH_TIERS": "none",
                       "FEM_BENCH_CAP_CAND": "64",
                       "FEM_BENCH_VPR": "8",
                       "FEM_BENCH_APR": "8"}
            adv = run_child(fixture_dir, phase=" [adversarial]",
                            extra_env=adv_env)
            if adv is None:
                return 1
            adv_eq = _verify_against_baseline(
                bin_, fixture_dir, adv_reads, e,
                _timed_read_ranges(adversarial_reads, _batch_size(), n_warm),
                adv["stats"])
        adv_result = {
            "metric": "adversarial all-mapping reads/s/GPU "
            f"(satellite-repeat {genome_mb}Mb genome, 100bp SE, e={e})",
            "value": round(adv["best"], 1),
            "unit": "reads/s",
            "scoring": "best half of the timed batches",
            "whole_run_rps": round(adv["whole_run"], 1),
            "retried_reads": adv["retried"],
            "host_fallbacks": adv["fallbacks"],
            "vs_baseline": round(adv["best"] / adv_base_rps, 2),
            "device": adv["device"],
        }
        if adv_eq is not None:
            adv_result.update(adv_eq)
        print(json.dumps(adv_result))

    result = {
        "metric": f"all-mapping reads/s/GPU (synthetic {genome_mb}Mb "
        f"genome, {int(repeat_fraction*100)}% repeats, 100bp SE, "
        f"k=12 step=3 e={e} a=1)",
        "value": round(res["best"], 1),
        "unit": "reads/s",
        "scoring": "best half of the timed batches (whole_run_rps = all "
        "timed batches)",
        "whole_run_rps": round(res["whole_run"], 1),
        "vs_baseline": round(res["best"] / baseline_rps, 2),
        "device": res["device"],
    }
    if equality is not None:
        result.update(equality)
    if adv_result is not None:
        result["adversarial_rps"] = adv_result["value"]
    if reference_rps:
        result["vs_reference_binary"] = round(res["best"] / reference_rps, 2)
        result["reference_binary_rps"] = round(reference_rps, 1)
    if reference_t2_rps:
        result["vs_reference_binary_t2"] = round(
            res["best"] / reference_t2_rps, 2)
    print(json.dumps(result))
    ok = equality is not None and equality["records_equal"]
    if adv_result is not None:
        ok = ok and adv_result.get("records_equal", False)
    return 0 if ok else 1


def child(d: str) -> int:
    """Device process: map the fixture, print one JSON line {reads,
    seconds, halves, stats, retried, fallbacks, warmup_seconds,
    rec_digest, rec_count, device} of steady-state mapping (first batch
    excluded as warmup). Records emitted during the timed region are
    digested AFTER timing so the parent can assert full-run record
    equality against fem_baseline. Exits 1 without a GPU."""
    if probe() != 0:
        return 1
    import jax

    from fem_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    enable_compile_cache()
    batch_size = _batch_size()
    e = int(os.environ.get("FEM_BENCH_E", "5"))
    # Tier-0 caps from tools/demand_stats.py on this workload: cap_occ 80
    # bounds the 8-pair-aligned row fetch, cap_vote 32 the compacted
    # true-pair slab, cap_cand 16 the per-lane candidates, vpr 2 the
    # verify demand per read.
    cap_occ = int(os.environ.get("FEM_BENCH_CAP_OCC", "80"))
    cap_vote = int(os.environ.get("FEM_BENCH_CAP_VOTE", "32"))
    cap_cand = int(os.environ.get("FEM_BENCH_CAP_CAND", "16"))
    verify_per_read = int(os.environ.get("FEM_BENCH_VPR", "2"))
    # Fractional: the batch SUM of accepted hits concentrates (sigma of
    # the sum ~ sqrt(2B)); 0.85 = 1.7 slots/read, overflow only retries.
    accept_per_read = float(os.environ.get("FEM_BENCH_APR", "0.85"))

    from fem_tpu.config import FemArgs
    from fem_tpu.golden.model import MappingStats
    from fem_tpu.index.storage import load_index
    from fem_tpu.io import fastx
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine

    ref = fastx.read_fasta(os.path.join(d, "ref.fa"))
    index = load_index(os.path.join(d, "ref.index"))
    args = FemArgs(kmer_size=index.kmer_size, step_size=index.step_size,
                   error_threshold=e, num_additional_qgrams=1)
    # FEM_BENCH_TIERS=none routes capacity-overflow reads straight to the
    # exact host C++ mapper instead of the device retry ladder.
    tiers = () if os.environ.get("FEM_BENCH_TIERS", "none") == "none" else None
    engine = MappingEngine(
        args, ref, index,
        EngineConfig(batch_size=batch_size, cap_occ=cap_occ, cap_cand=cap_cand,
                     cap_vote=cap_vote, verify_per_read=verify_per_read,
                     accept_per_read=accept_per_read, tiers=tiers),
    )
    batches = list(fastx.stream_fastq_batches(
        os.path.join(d, "reads.fq"), batch_size=batch_size))
    t0 = time.time()
    for _ in engine.map_stream(batches[:1]):
        pass
    warm_s = time.time() - t0
    timed = batches[1:]
    half = max(len(timed) // 2, 1)
    total = MappingStats()
    halves = []
    blobs = []
    for part in (timed[:half], timed[half:]):
        if not part:
            continue
        sub = MappingStats()
        t0 = time.time()
        for recs, stats in engine.map_stream(part):
            sub += stats
            blobs.extend(recs)  # cheap list append; digested after timing
        halves.append({"reads": sub.num_reads, "seconds": time.time() - t0})
        total += sub
    dig, cnt = smoke.digest_lines(blobs)
    print(json.dumps({
        "reads": total.num_reads,
        "seconds": sum(h["seconds"] for h in halves),
        "halves": halves, "stats": total.__dict__,
        "retried": engine.retried_reads, "fallbacks": engine.fallback_reads,
        "warmup_seconds": warm_s,
        "rec_digest": str(dig), "rec_count": cnt,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "name_power_limit": smoke.nvidia_smi(),
        },
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        sys.exit(child(sys.argv[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "--probe":
        sys.exit(probe())
    sys.exit(main())
