"""Differential tests against the ACTUAL reference FEM binary.

The reference's sources are not part of this repository and its htslib
submodule is not vendored, so refbuild/build.sh compiles the reference's
src/ unmodified (from the checkout FEM_REFERENCE_DIR names) against a
minimal text-SAM htslib stub (refbuild/htslib_stub/) covering exactly the
symbols FEM uses (src/output_queue.c:17-19,83,114, src/align.c:546-632).
This closes SURVEY.md §4's differential contract: fem_tpu's index files,
SAM output, and all five MappingStats counters are asserted byte-equal /
equal to the reference binary itself — not just to the golden oracle.

The tests are opt-in: without FEM_REFERENCE_DIR they skip, and the skip
reason is the build script's own message.
"""

import os
import subprocess

import pytest

from fem_tpu import sim
from fem_tpu.config import FemArgs
from fem_tpu.golden.model import GoldenMapper, MappingStats
from fem_tpu.index.build import build_index
from fem_tpu.index.storage import save_index
from fem_tpu.io.fastx import read_fasta, stream_fastq_batches
from fem_tpu.io.sam import sam_header_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_reference() -> tuple[str | None, str]:
    """(the binary's path, "") or (None, why it was not built)."""
    out = subprocess.run(
        [os.path.join(REPO, "refbuild", "build.sh")],
        capture_output=True, text=True,
    )
    if out.returncode != 0:
        why = out.stderr.strip().splitlines()[-1:] or [f"rc={out.returncode}"]
        return None, f"reference binary not built: {why[0]}"
    return out.stdout.strip().splitlines()[-1], ""


BIN, WHY = build_reference()
pytestmark = pytest.mark.skipif(BIN is None, reason=WHY)


def parse_counters(stderr: str) -> dict:
    return {
        l.split(": ")[0]: int(l.split(": ")[1])
        for l in stderr.strip().splitlines()
        if l.startswith("The number of ") and ": " in l
    }


def golden_sam_and_stats(fa, fq, e, a):
    ref = read_fasta(str(fa))
    index = build_index(ref, 12, 3)
    args = FemArgs(error_threshold=e, num_additional_qgrams=a)
    golden = GoldenMapper(args, ref, index)
    chunks = [sam_header_text(ref.names, ref.lengths.tolist())]
    total = MappingStats()
    for b in stream_fastq_batches(str(fq), batch_size=64):
        rr, st = golden.map_reads(b.names, b.seqs, b.quals)
        chunks.extend(rr)
        total += st
    return b"".join(chunks), total, ref, index


@pytest.mark.parametrize("e,a", [(2, 1), (0, 0), (5, 1), (6, 0)])
def test_reference_binary_byte_equal(tmp_path, e, a):
    seqs = sim.random_genome(
        150_000, num_seqs=3, seed=21 + e, n_fraction=0.0003,
        repeat_fraction=0.2,
    )
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    sim.write_fasta(str(fa), seqs)
    reads = sim.simulate_reads(
        seqs, 200, read_length=100, max_errors=min(e, 3), seed=4 + a
    )
    sim.write_fastq(str(fq), reads)

    # Index file byte-equality (binary format, src/index.c:133-168).
    rix = tmp_path / "ref.index"
    subprocess.run([BIN, "index", "12", "3", str(fa), str(rix)],
                   check=True, capture_output=True)
    ours_sam, total, ref, index = golden_sam_and_stats(fa, fq, e, a)
    pix = tmp_path / "py.index"
    save_index(index, str(pix))
    assert rix.read_bytes() == pix.read_bytes()

    sam = tmp_path / "ref.sam"
    r = subprocess.run(
        [BIN, "map", "-e", str(e), "-a", str(a), "-t", "1", "--ref",
         str(fa), "--index", str(rix), "--read1", str(fq), "-o", str(sam)],
        check=True, capture_output=True, text=True)
    assert sam.read_bytes() == ours_sam

    c = parse_counters(r.stderr)
    assert c["The number of read"] == total.num_reads
    assert c["The number of mapped read"] == total.num_mapped_reads
    assert (
        c["The number of candidate before additional q-gram filter"]
        == total.num_candidates_without_additional_qgram_filter
    )
    assert c["The number of candidate"] == total.num_candidates
    assert c["The number of mapping"] == total.num_mappings


def test_reference_binary_e7_long_reads(tmp_path):
    """e=7 byte-equality needs reads long enough for the reference's q-gram
    DP to be feasible (see test_reference_crashes_at_e7_on_100bp_reads):
    150 bp gives 46 seeds/group >= (7+1+2)*ceil(12/3) columns."""
    seqs = sim.random_genome(150_000, num_seqs=2, seed=71, repeat_fraction=0.2)
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    sim.write_fasta(str(fa), seqs)
    reads = sim.simulate_reads(seqs, 150, read_length=150, max_errors=5, seed=8)
    sim.write_fastq(str(fq), reads)
    rix = tmp_path / "ref.index"
    subprocess.run([BIN, "index", "12", "3", str(fa), str(rix)],
                   check=True, capture_output=True)
    sam = tmp_path / "ref.sam"
    r = subprocess.run(
        [BIN, "map", "-e", "7", "-a", "2", "-t", "1", "--ref", str(fa),
         "--index", str(rix), "--read1", str(fq), "-o", str(sam)],
        check=True, capture_output=True, text=True)
    ours_sam, total, _, _ = golden_sam_and_stats(fa, fq, 7, 2)
    assert sam.read_bytes() == ours_sam
    c = parse_counters(r.stderr)
    assert c["The number of mapping"] == total.num_mappings


def test_reference_crashes_at_e7_on_100bp_reads(tmp_path):
    """Documented REFERENCE BUG: at L=100, k=12, step=3 the q-gram DP's
    column count `num_seeds_in_group - (e+1+a)*ceil(k/step) + 2`
    (src/filter.c:5) underflows as uint32 whenever e+1+a > 7 — the length
    check at src/filter.c:166-172 only requires e+1+a <= 29. The resulting
    VLA is ~4 billion entries -> stack overflow (verified with ASan:
    stack-overflow at filter.c:6). So the reference cannot actually map
    100 bp reads at its advertised e=7 with the default index. fem_tpu
    defines this case cleanly (treats the infeasible DP as read-too-short,
    consistently across golden/C++/device paths)."""
    seqs = sim.random_genome(60_000, num_seqs=1, seed=50)
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    sim.write_fasta(str(fa), seqs)
    reads = sim.simulate_reads(seqs, 20, read_length=100, max_errors=2, seed=1)
    sim.write_fastq(str(fq), reads)
    rix = tmp_path / "ref.index"
    subprocess.run([BIN, "index", "12", "3", str(fa), str(rix)],
                   check=True, capture_output=True)
    r = subprocess.run(
        [BIN, "map", "-e", "7", "-a", "2", "-t", "1", "--ref", str(fa),
         "--index", str(rix), "--read1", str(fq), "-o",
         str(tmp_path / "o.sam")],
        capture_output=True)
    assert r.returncode != 0  # segfault (-11)
    # Ours maps the same workload without crashing.
    ours_sam, total, _, _ = golden_sam_and_stats(fa, fq, 7, 2)
    assert total.num_reads == 20


def test_reference_binary_multithread_record_set(tmp_path):
    """With -t 4 the reference's inter-read output order is queue-arrival
    order (SURVEY §2.4); the contract is record-set equality."""
    seqs = sim.random_genome(120_000, num_seqs=2, seed=33)
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    sim.write_fasta(str(fa), seqs)
    reads = sim.simulate_reads(seqs, 300, read_length=100, max_errors=2, seed=3)
    sim.write_fastq(str(fq), reads)
    rix = tmp_path / "ref.index"
    subprocess.run([BIN, "index", "12", "3", str(fa), str(rix)],
                   check=True, capture_output=True)
    sam = tmp_path / "ref.sam"
    subprocess.run(
        [BIN, "map", "-e", "2", "-a", "1", "-t", "4", "--ref", str(fa),
         "--index", str(rix), "--read1", str(fq), "-o", str(sam)],
        check=True, capture_output=True)
    ours_sam, _, _, _ = golden_sam_and_stats(fa, fq, 2, 1)
    assert sorted(sam.read_bytes().splitlines()) == sorted(
        ours_sam.splitlines()
    )


def test_reference_binary_vs_device_engine(tmp_path):
    """Close the full chain: reference binary == device-pipeline engine
    (engine == golden is covered elsewhere; this is the end-to-end link)."""
    from fem_tpu.pipeline.engine import EngineConfig, MappingEngine
    from tests.test_engine import _batch_from_reads

    seqs = sim.random_genome(100_000, num_seqs=2, seed=41, repeat_fraction=0.2)
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    sim.write_fasta(str(fa), seqs)
    reads = sim.simulate_reads(seqs, 96, read_length=100, max_errors=2, seed=6)
    sim.write_fastq(str(fq), reads)
    rix = tmp_path / "ref.index"
    subprocess.run([BIN, "index", "12", "3", str(fa), str(rix)],
                   check=True, capture_output=True)
    sam = tmp_path / "ref.sam"
    subprocess.run(
        [BIN, "map", "-e", "2", "-a", "1", "-t", "1", "--ref", str(fa),
         "--index", str(rix), "--read1", str(fq), "-o", str(sam)],
        check=True, capture_output=True)

    ref = read_fasta(str(fa))
    index = build_index(ref, 12, 3)
    args = FemArgs(error_threshold=2, num_additional_qgrams=1)
    engine = MappingEngine(
        args, ref, index,
        EngineConfig(batch_size=96, cap_occ=128, cap_cand=128),
    )
    recs, stats = engine.map_batch(_batch_from_reads(reads))
    ours = sam_header_text(ref.names, ref.lengths.tolist()) + b"".join(recs)
    assert sam.read_bytes() == ours
