"""Engine end-to-end: device pipeline output must be record-identical to
the golden oracle (the SURVEY.md §4 differential contract)."""

import numpy as np
import pytest

from fem_tpu import sim
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.io.fastx import ReadBatch
from fem_tpu.pipeline.engine import EngineConfig, MappingEngine, resolve_verify


def _batch_from_reads(reads):
    from fem_tpu.core.encoding import encode

    lengths = np.array([len(r.seq) for r in reads], np.int32)
    Lmax = max(128, -(-int(lengths.max()) // 32) * 32)
    codes = np.full((len(reads), Lmax), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r.seq)] = encode(r.seq)
    return ReadBatch(
        [r.name for r in reads],
        [r.seq for r in reads],
        [r.qual for r in reads],
        codes,
        lengths,
    )


@pytest.fixture(scope="module")
def engine_world(small_reference, small_index, default_args):
    seqs, ref = small_reference
    engine = MappingEngine(
        default_args,
        ref,
        small_index,
        EngineConfig(batch_size=64, cap_occ=256, cap_cand=128, verify_per_read=32),
    )
    golden = GoldenMapper(default_args, ref, small_index)
    return seqs, engine, golden


def test_engine_matches_golden_records_and_stats(engine_world):
    seqs, engine, golden = engine_world
    reads = sim.simulate_reads(seqs, 64, read_length=100, max_errors=2, seed=31)
    batch = _batch_from_reads(reads)
    recs, stats = engine.map_batch(batch)
    grecs, gstats = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert stats.num_reads == gstats.num_reads
    assert stats.num_mapped_reads == gstats.num_mapped_reads
    assert (
        stats.num_candidates_without_additional_qgram_filter
        == gstats.num_candidates_without_additional_qgram_filter
    )
    assert stats.num_candidates == gstats.num_candidates
    assert stats.num_mappings == gstats.num_mappings
    assert b"".join(recs) == b"".join(grecs)  # byte-identical SAM output


def test_engine_partial_batch_padding(engine_world):
    seqs, engine, golden = engine_world
    reads = sim.simulate_reads(seqs, 10, read_length=100, max_errors=1, seed=32)
    batch = _batch_from_reads(reads)
    recs, stats = engine.map_batch(batch)
    grecs, gstats = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert stats.num_reads == 10
    assert b"".join(recs) == b"".join(grecs)
    assert stats.num_mappings == gstats.num_mappings


def test_engine_mixed_lengths_and_ns(engine_world):
    seqs, engine, golden = engine_world
    base = sim.simulate_reads(seqs, 12, read_length=100, max_errors=2, seed=33)
    # Perturb: truncate some reads, inject Ns into others.
    muts = []
    for i, r in enumerate(base):
        s = r.seq
        if i % 4 == 0:
            s = s[:57]
        elif i % 4 == 1:
            s = s[:20] + b"N" + s[21:]
        elif i % 4 == 2:
            s = s[:20] + b"NNNN" + s[24:]  # > e ambiguous -> unmapped
        muts.append(
            sim.SimulatedRead(r.name, s, b"I" * len(s), r.sid, r.pos, r.strand, 0)
        )
    batch = _batch_from_reads(muts)
    recs, stats = engine.map_batch(batch)
    grecs, gstats = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert stats.num_candidates == gstats.num_candidates
    assert stats.num_mappings == gstats.num_mappings


def test_engine_repeat_read_all_mappings(engine_world):
    seqs, engine, golden = engine_world
    read = seqs[0][1][10_050:10_150]  # inside the planted repeat
    batch = _batch_from_reads(
        [sim.SimulatedRead(b"rep", read, b"I" * 100, 0, 10_050, 0, 0)]
    )
    recs, stats = engine.map_batch(batch)
    grecs, _ = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert b"".join(recs).count(b"\n") >= 2  # both repeat copies reported


def test_verify_choice_plain_on_cpu_kernel_refused(small_reference, small_index,
                                                   default_args):
    """One place chooses the verify implementation: the Pallas kernel on
    a GPU, the plain path elsewhere; asking for the compiled kernel off
    the GPU raises instead of falling back."""
    assert resolve_verify(None, "gpu") == "kernel"
    assert resolve_verify(None, "cpu") == "plain"
    assert resolve_verify("interpret", "cpu") == "interpret"
    with pytest.raises(ValueError, match="GPU only"):
        resolve_verify("kernel", "cpu")
    with pytest.raises(ValueError, match="unknown"):
        resolve_verify("pallas", "gpu")
    _, ref = small_reference
    engine = MappingEngine(default_args, ref, small_index,
                           EngineConfig(batch_size=32))
    assert engine.verify == "plain"
    with pytest.raises(ValueError, match="GPU only"):
        MappingEngine(default_args, ref, small_index,
                      EngineConfig(batch_size=32, verify="kernel"))


def test_engine_with_interpreted_kernel_matches_golden(
        small_reference, small_index, default_args):
    """The verify kernel inside the full map program (Pallas interpreter
    on the CPU) gives the golden oracle's records and counters."""
    seqs, ref = small_reference
    engine = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=32, cap_occ=128, cap_cand=64,
                     verify_per_read=8, verify="interpret"),
    )
    golden = GoldenMapper(default_args, ref, small_index)
    reads = sim.simulate_reads(seqs, 32, read_length=100, max_errors=2, seed=41)
    batch = _batch_from_reads(reads)
    recs, stats = engine.map_batch(batch)
    grecs, gstats = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert stats.__dict__ == gstats.__dict__
