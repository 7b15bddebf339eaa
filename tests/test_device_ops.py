"""Differential tests: every device op must match the golden oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu import sim
from fem_tpu.config import FemArgs
from fem_tpu.core.encoding import CHAR_TO_CODE
from fem_tpu.golden.model import (
    GoldenMapper,
    hash_all_seeds,
    read_strands,
    select_optimal_prefix_qgrams,
)
from fem_tpu.ops.candidates import generate_candidates
from fem_tpu.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu.ops.seed_select import select_qgrams
from fem_tpu.ops.types import FilterParams, device_index_from_host
from fem_tpu.ops.verify import verify_candidates_jnp

_U32 = 0xFFFFFFFF


def _pad_batch(seqs, Lmax=128):
    codes = np.full((len(seqs), Lmax), 4, np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = CHAR_TO_CODE[np.frombuffer(s, np.uint8)]
        lengths[i] = len(s)
    return jnp.asarray(codes), jnp.asarray(lengths)


@pytest.fixture(scope="module")
def world(small_reference, small_index, default_args):
    seqs, ref = small_reference
    mapper = GoldenMapper(default_args, ref, small_index)
    dindex = device_index_from_host(small_index, ref)
    reads = sim.simulate_reads(seqs, 80, read_length=100, max_errors=2, seed=21)
    return seqs, ref, small_index, mapper, dindex, reads


def test_reverse_complement_matches_golden(world):
    *_, reads = world
    codes, lengths = _pad_batch([r.seq for r in reads])
    neg = np.asarray(reverse_complement(codes, lengths))
    for i, r in enumerate(reads):
        _, _, _, neg_codes = read_strands(r.seq)
        np.testing.assert_array_equal(neg[i, : len(r.seq)], neg_codes)
        assert (neg[i, len(r.seq) :] == 4).all()


def test_seed_hashes_and_ambiguity(world, default_args):
    *_, reads = world
    k = default_args.kmer_size
    seqs = [r.seq for r in reads[:20]] + [b"ACGTNNAC" * 12, b"NNNN" + b"ACGT" * 24]
    codes, lengths = _pad_batch(seqs)
    h = np.asarray(seed_hashes(codes, k))
    amb = np.asarray(ambiguous_base_counts(codes, lengths, k))
    for i, s in enumerate(seqs):
        rcodes = CHAR_TO_CODE[np.frombuffer(s, np.uint8)]
        gh, gamb = hash_all_seeds(rcodes, k)
        ns = len(s) - k + 1
        np.testing.assert_array_equal(h[i, :ns], gh.astype(np.int32))
        assert amb[i] == gamb


def test_select_qgrams_matches_golden(world, default_args, rng):
    _, _, index, *_ = world
    args = default_args
    params = FilterParams.from_args(args, 128)
    S = params.num_qgrams
    NG = params.max_group_size
    # Random frequency tables over a range of group sizes.
    NL = 64
    freqs = rng.integers(0, 50, size=(NL, NG)).astype(np.uint32)
    freqs[rng.random((NL, NG)) < 0.2] = 0
    sizes = rng.integers(S * params.seed_span, NG + 1, size=NL).astype(np.int32)
    out = select_qgrams(
        jnp.asarray(freqs), jnp.asarray(sizes), jnp.asarray(np.int32(12345)), params
    )
    pos = np.asarray(out.positions)
    tot = np.asarray(out.min_total)
    comp = np.asarray(out.complete)
    for i in range(NL):
        gtot, gsel = select_optimal_prefix_qgrams(
            args, 12345, params.seed_span, int(sizes[i]), freqs[i].tolist()
        )
        assert comp[i] == (len(gsel) == S)
        assert tot[i] == np.uint32(gtot)
        if comp[i]:
            assert pos[i].tolist() == gsel


def test_generate_candidates_matches_golden(world, default_args):
    seqs, ref, index, mapper, dindex, reads = world
    params = FilterParams.from_args(default_args, 128, cap_occ=256, cap_cand=128)
    seq_list = [r.seq for r in reads]
    codes, lengths = _pad_batch(seq_list)
    hashes = seed_hashes(codes, params.kmer_size)
    amb = ambiguous_base_counts(codes, lengths, params.kmer_size)
    res = generate_candidates(codes, lengths, hashes, amb, dindex, params)
    sid = np.asarray(res.cand_sid)
    pos = np.asarray(res.cand_pos)
    valid = np.asarray(res.cand_valid)
    nc = np.asarray(res.num_candidates)
    dp = np.asarray(res.dp_total)
    fb = np.asarray(res.needs_fallback) | np.asarray(res.inherent_fallback)
    for i, s in enumerate(seq_list):
        rcodes = CHAR_TO_CODE[np.frombuffer(s, np.uint8)]
        gc, gdp = mapper.generate_candidates(rcodes)
        if fb[i]:
            continue  # capacity overflow lanes go to host fallback
        got = [
            (int(sid[i, j]) << 32) | int(pos[i, j])
            for j in range(valid.shape[1])
            if valid[i, j]
        ]
        assert got == gc, f"read {i}"
        assert nc[i] == len(gc)
        assert dp[i] == np.uint32(gdp)
    assert fb.sum() == 0  # small genome: nothing should overflow


def test_verify_matches_golden(world, default_args):
    seqs, ref, index, mapper, dindex, reads = world
    e = default_args.error_threshold
    # Collect (read, candidate) pairs from golden filtering.
    texts, sids, poss, eds, ends = [], [], [], [], []
    for r in reads[:40]:
        rcodes = CHAR_TO_CODE[np.frombuffer(r.seq, np.uint8)]
        cands, _ = mapper.generate_candidates(rcodes)
        for c in cands:
            sid_, pos_ = c >> 32, c & _U32
            pattern = mapper._ref_codes[sid_][pos_ : pos_ + len(r.seq) + 2 * e]
            ged, gend = mapper.banded_edit_distance(pattern, rcodes)
            texts.append(r.seq)
            sids.append(sid_)
            poss.append(pos_)
            eds.append(ged)
            ends.append(gend)
    assert texts, "no candidates generated"
    codes, lengths = _pad_batch(texts)
    out = verify_candidates_jnp(
        dindex,
        jnp.asarray(np.array(sids, np.int32)),
        jnp.asarray(np.array(poss, np.int32)),
        codes,
        lengths,
        e,
    )
    ved = np.asarray(out.edit_distance)
    vend = np.asarray(out.end_offset)
    acc = np.asarray(out.accepted)
    n_acc = 0
    for i in range(len(texts)):
        if eds[i] <= e:
            assert acc[i]
            assert ved[i] == eds[i]
            assert vend[i] == ends[i]
            n_acc += 1
        else:
            assert not acc[i]
    assert n_acc > 0


def test_gather_windows_row_path(world, rng):
    """The row-gather + barrel-shift window fetch must equal direct slices."""
    from fem_tpu.ops.verify import gather_windows

    seqs, ref, index, mapper, dindex, reads = world
    W = 114
    V = 257
    sid = rng.integers(0, ref.num_seqs, V).astype(np.int32)
    pos = np.array(
        [rng.integers(0, ref.lengths[s] - W) for s in sid], dtype=np.int32
    )
    got = np.asarray(gather_windows(dindex, jnp.asarray(sid), jnp.asarray(pos), W))
    for i in range(V):
        off = int(ref.offsets[sid[i]]) + int(pos[i])
        np.testing.assert_array_equal(got[i], ref.flat_codes[off : off + W])
