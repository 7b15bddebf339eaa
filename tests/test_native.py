"""Native C++ emitter (mapping sort + traceback + SAM) vs golden."""

import numpy as np
import pytest

from fem_tpu import sim
from fem_tpu.golden.model import GoldenMapper
from fem_tpu.pipeline.engine import EngineConfig, MappingEngine

from tests.test_engine import _batch_from_reads

native = pytest.importorskip("fem_tpu.native")
if not native.native_available():
    pytest.skip("native library unavailable", allow_module_level=True)


def test_native_emitter_matches_golden(small_reference, small_index, default_args):
    seqs, ref = small_reference
    golden = GoldenMapper(default_args, ref, small_index)
    cfg = EngineConfig(batch_size=96, cap_occ=256, cap_cand=128, verify_per_read=32)
    eng_native = MappingEngine(default_args, ref, small_index, cfg, use_native=True)
    eng_py = MappingEngine(default_args, ref, small_index, cfg, use_native=False)
    assert eng_native._native is not None
    reads = sim.simulate_reads(seqs, 96, read_length=100, max_errors=2, seed=77)
    batch = _batch_from_reads(reads)
    rn, sn = eng_native.map_batch(batch)
    rp, sp = eng_py.map_batch(batch)
    gr, gs = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(rn) == b"".join(gr) == b"".join(rp)
    assert sn.__dict__ == sp.__dict__ == gs.__dict__


def test_native_emitter_handles_indels_and_secondary(small_reference, small_index, default_args):
    seqs, ref = small_reference
    golden = GoldenMapper(default_args, ref, small_index)
    eng = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=8, cap_occ=256, cap_cand=128, verify_per_read=64),
        use_native=True,
    )
    # Indel-heavy reads + a repeat read (secondary records).
    reads = sim.simulate_reads(
        seqs, 7, read_length=100, max_errors=2, indel_fraction=1.0, seed=78
    )
    rep = seqs[0][1][10_050:10_150]
    reads.append(sim.SimulatedRead(b"rep", rep, b"I" * 100, 0, 10_050, 0, 0))
    batch = _batch_from_reads(reads)
    rn, _ = eng.map_batch(batch)
    gr, _ = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(rn) == b"".join(gr)
    assert b"\t272\t" in b"".join(rn) or b"\t256\t" in b"".join(rn)


def test_native_fastq_reader_matches_python(tmp_path):
    import gzip

    import numpy as np

    from fem_tpu.io.fastx import stream_fastq_batches

    seqs = sim.random_genome(60_000, num_seqs=1, seed=61)
    reads = sim.simulate_reads(seqs, 2500, read_length=100, max_errors=2, seed=62)
    p = tmp_path / "r.fq"
    sim.write_fastq(str(p), reads)
    pg = tmp_path / "r.fq.gz"
    pg.write_bytes(gzip.compress(p.read_bytes()))
    for path in (p, pg):
        bn = list(stream_fastq_batches(str(path), batch_size=1000, use_native=True))
        bp = list(stream_fastq_batches(str(path), batch_size=1000, use_native=False))
        assert [b.num_reads for b in bn] == [b.num_reads for b in bp] == [1000, 1000, 500]
        for a, b in zip(bn, bp):
            assert a.packed is not None and a.has_blobs
            assert a.names == b.names and a.seqs == b.seqs and a.quals == b.quals
            np.testing.assert_array_equal(a.lengths, b.lengths)
            np.testing.assert_array_equal(a.codes, b.codes[:, : a.codes.shape[1]])


def test_engine_with_native_reader_batches(small_reference, small_index, default_args, tmp_path):
    from fem_tpu.golden.model import MappingStats
    from fem_tpu.io.fastx import stream_fastq_batches

    seqs, ref = small_reference
    reads = sim.simulate_reads(seqs, 100, read_length=100, max_errors=2, seed=63)
    p = tmp_path / "reads.fq"
    sim.write_fastq(str(p), reads)
    golden = GoldenMapper(default_args, ref, small_index)
    eng = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=50, cap_occ=256, cap_cand=128, verify_per_read=32),
    )
    chunks = []
    total = MappingStats()
    for recs, st in eng.map_stream(
        stream_fastq_batches(str(p), batch_size=50, use_native=True)
    ):
        chunks.extend(recs)
        total += st
    grecs, gstats = golden.map_reads(
        [r.name for r in reads], [r.seq for r in reads], [r.qual for r in reads]
    )
    assert b"".join(chunks) == b"".join(grecs)
    assert total.num_mappings == gstats.num_mappings
    assert total.num_reads == 100


def test_native_cpu_mapper_matches_golden(small_reference, small_index, default_args):
    from fem_tpu.io.sam import sam_header_text
    from fem_tpu.native.mapper import NativeCpuMapper, mapper_available

    if not mapper_available():
        pytest.skip("native mapper unavailable")
    seqs, ref = small_reference
    golden = GoldenMapper(default_args, ref, small_index)
    mapper = NativeCpuMapper(default_args, ref, small_index)
    reads = sim.simulate_reads(seqs, 60, read_length=100, max_errors=2, seed=81)
    names = [r.name for r in reads]
    sqs = [r.seq for r in reads]
    quals = [r.qual for r in reads]
    blob, st = mapper.map_reads(names, sqs, quals)
    grecs, gstats = golden.map_reads(names, sqs, quals)
    assert blob == b"".join(grecs)
    assert st.tolist() == [
        gstats.num_reads, gstats.num_mapped_reads,
        gstats.num_candidates_without_additional_qgram_filter,
        gstats.num_candidates, gstats.num_mappings,
    ]


def test_engine_overflow_fallback_uses_cpu_mapper(small_reference, small_index, default_args):
    """Tiny caps force occurrence-slab overflows; results must still be
    byte-identical to golden via the C++ fallback."""
    seqs, ref = small_reference
    golden = GoldenMapper(default_args, ref, small_index)
    eng = MappingEngine(
        default_args, ref, small_index,
        EngineConfig(batch_size=32, cap_occ=16, cap_cand=16, verify_per_read=8,
                     accept_per_read=8),
    )
    reads = sim.simulate_reads(seqs, 32, read_length=100, max_errors=2, seed=82)
    # Guarantee at least one repeat read (many occurrences -> overflow).
    rep = seqs[0][1][10_050:10_150]
    reads[0] = sim.SimulatedRead(b"rep", rep, b"I" * 100, 0, 10_050, 0, 0)
    batch = _batch_from_reads(reads)
    recs, stats = eng.map_batch(batch)
    grecs, gstats = golden.map_reads(batch.names, batch.seqs, batch.quals)
    assert b"".join(recs) == b"".join(grecs)
    assert stats.num_mappings == gstats.num_mappings
    assert stats.num_candidates == gstats.num_candidates


def test_tsan_stress():
    """Race-exercise the native layer under ThreadSanitizer (SURVEY §5.2):
    concurrent fem_emit_batch (the drain-thread pattern, with cross-thread
    determinism checks) and fem_mapper_map under both documented handle
    contracts. Any TSAN report makes the binary exit non-zero."""
    import subprocess

    from fem_tpu.native.build import build_tsan_stress

    try:
        binary = build_tsan_stress()
    except Exception as exc:  # toolchain without -fsanitize=thread
        pytest.skip(f"TSAN build unavailable: {exc}")
    res = subprocess.run([binary], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "tsan_stress ok" in res.stdout


def test_artifact_built_for_another_host_is_not_loaded(monkeypatch, tmp_path):
    """Native artifacts are keyed by the host CPU: a library built on
    another machine (other model/feature flags) is never returned here;
    this host compiles its own, then reuses it."""
    from fem_tpu.native import build

    calls = []

    def fake_compile(cmd, **_):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write(build.cpu_id())
        calls.append(cmd)

    monkeypatch.setattr(build, "_BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(build.subprocess, "run", fake_compile)
    monkeypatch.setattr(build, "cpu_id", lambda: "other host: avx512f")
    foreign = build.build_native()
    monkeypatch.setattr(build, "cpu_id", lambda: "this host: avx2")
    mine = build.build_native()
    assert mine != foreign and len(calls) == 2
    with open(mine) as f:
        assert f.read() == "this host: avx2"
    assert build.build_native() == mine and len(calls) == 2
