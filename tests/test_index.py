import numpy as np

from fem_tpu.core.encoding import encode
from fem_tpu.index.build import build_index, hash_windows
from fem_tpu.index.storage import load_index, save_index


def scalar_hash(seq_codes, pos, k):
    """Literal reimplementation of hash_seed_in_sequence (src/utils.h:83-99)."""
    mask = (1 << (2 * k)) - 1
    h = 0
    for i in range(k):
        if pos + i < len(seq_codes):
            b = int(seq_codes[pos + i])
            h = ((h << 2) | b) & mask if b < 4 else (h << 2) & mask
        else:
            h = (h << 2) & mask
    return h


def test_hash_windows_matches_scalar(rng):
    codes = rng.integers(0, 5, size=500).astype(np.uint8)
    k = 12
    positions = np.arange(0, len(codes) - k + 1, 3, dtype=np.int64)
    fast = hash_windows(codes, k, positions)
    for i, p in enumerate(positions):
        assert fast[i] == scalar_hash(codes, int(p), k)


def test_build_index_bruteforce(small_reference):
    seqs, ref = small_reference
    k, step = 8, 5  # small k keeps the brute-force check fast
    idx = build_index(ref, k, step)
    # Brute force: every window every step, grouped by hash, locations ascending.
    entries = {}
    for sid, (_, seq) in enumerate(seqs):
        codes = encode(seq)
        for pos in range(0, len(seq) - k + 1, step):
            h = scalar_hash(codes, pos, k)
            entries.setdefault(h, []).append((sid << 32) | pos)
    total = sum(len(v) for v in entries.values())
    assert idx.num_occurrences == total
    for h, locs in list(entries.items())[:2000]:
        got = idx.occurrences_of(h)
        assert got.tolist() == sorted(locs)
    # Buckets absent from the genome are empty.
    assert idx.frequency(0x1234) == len(entries.get(0x1234, []))


def test_index_lookup_is_csr(small_index):
    idx = small_index
    assert idx.lookup.shape[0] == (1 << (2 * idx.kmer_size)) + 1
    assert idx.lookup[0] == 0
    assert idx.lookup[-1] == idx.num_occurrences
    assert (np.diff(idx.lookup.astype(np.int64)) >= 0).all()


def test_index_serialization_roundtrip_and_layout(tmp_path, small_index):
    path = tmp_path / "test.index"
    save_index(small_index, str(path))
    # Byte-level layout check against the reference format (src/index.c:100-168).
    raw = path.read_bytes()
    k, step = np.frombuffer(raw[:8], dtype="<i4")
    assert (k, step) == (12, 3)
    lut_bytes = 4 * ((1 << (2 * 12)) + 1)
    occ_size = np.frombuffer(raw[8 + lut_bytes : 16 + lut_bytes], dtype="<u8")[0]
    assert occ_size == small_index.num_occurrences
    assert len(raw) == 16 + lut_bytes + 8 * occ_size

    idx2 = load_index(str(path))
    assert idx2.kmer_size == 12 and idx2.step_size == 3
    np.testing.assert_array_equal(idx2.lookup, small_index.lookup)
    np.testing.assert_array_equal(idx2.occurrences, small_index.occurrences)


def test_split_sid_pos(small_index):
    sid, pos = small_index.split_sid_pos()
    recon = (sid.astype(np.uint64) << np.uint64(32)) | pos.astype(np.uint64)
    np.testing.assert_array_equal(recon, small_index.occurrences)


def test_u32_csr_guard_points_at_plan():
    """The u32 CSR ceiling fails loudly and points at the recorded
    >u32 plan in docs/SCALE.md."""
    import os

    import pytest

    from fem_tpu.index.build import check_u32_csr

    check_u32_csr((1 << 32) - 1)  # at the ceiling: fine
    with pytest.raises(ValueError, match="Beyond the u32 CSR ceiling"):
        check_u32_csr(1 << 32)
    scale_md = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "SCALE.md",
    )
    with open(scale_md) as f:
        assert "## Beyond the u32 CSR ceiling" in f.read()
