"""Parity of the filter tail with the filter semantics.

`filter_tail` (ops/candidates.py) must produce, for every lane, the
exact candidate list of the reference fold (src/filter.c:45-144): sort by
(sid, diag), additional-q-gram vote (src/filter.c:118-131), then the
left-to-right group fold through the greedy +-e dedup that can evict
earlier winners (src/filter.c:45-78,210-212). Checked here against a
direct scalar model on adversarial inputs (duplicate diagonals, cluster
runs straddling group boundaries, eviction chains, multi-chromosome
interleavings).
"""

import numpy as np
import pytest

from fem_tpu.ops.candidates import _BIG, filter_tail
from fem_tpu.ops.types import SENTINEL_SID


def _scalar_tail(sid, diag, valid, cc, e, a):
    """Scalar model of the filter tail (sort + vote + greedy dedup fold)."""
    NB, G, CAP = sid.shape
    cands = []
    overflow = np.zeros(NB, bool)
    for b in range(NB):
        cand = []
        for g in range(G):
            pairs = sorted(
                (int(sid[b, g, i]), int(diag[b, g, i]))
                for i in range(CAP)
                if valid[b, g, i]
            )
            if a > 0:
                voted = [
                    (s, d)
                    for i, (s, d) in enumerate(pairs)
                    if i + a < len(pairs)
                    and pairs[i + a][0] == s
                    and pairs[i + a][1] <= d + e
                ]
            else:
                voted = pairs
            merged = sorted(cand + voted)
            kept = []
            last_s, last_d = -1, 0
            for s, d in merged:
                if s > last_s or (s == last_s and d > last_d + e):
                    kept.append((s, d))
                    last_s, last_d = s, d
            if len(kept) > cc:
                overflow[b] = True
            cand = kept[:cc]
        cands.append(cand)
    return cands, overflow


def _random_slabs(rng, NB, G, CAP, num_sids=3, spread=40):
    """Clustered diagonals so votes pass and dedup windows overlap."""
    sid = rng.integers(0, num_sids, (NB, G, CAP)).astype(np.int32)
    centers = rng.integers(0, spread, (NB, G, CAP))
    jitter = rng.integers(0, 4, (NB, G, CAP))
    diag = (centers + jitter).astype(np.int32)
    valid = rng.random((NB, G, CAP)) < 0.4
    return sid, diag, valid


@pytest.mark.parametrize("a", [0, 1, 2])
@pytest.mark.parametrize("e", [2, 5, 7])
def test_tail_matches_scalar_fold(a, e):
    rng = np.random.default_rng(1000 + 10 * a + e)
    NB, G, CAP, CC = 130, 3, 24, 8  # NB forces lane padding
    sid, diag, valid = _random_slabs(rng, NB, G, CAP)
    sid_m = np.where(valid, sid, SENTINEL_SID).astype(np.int32)
    diag_m = np.where(valid, diag, _BIG).astype(np.int32)
    k_sid, k_pos, k_ov = (
        np.asarray(x) for x in filter_tail(sid_m, diag_m, CAP, CC, e, a)
    )
    cands, ov = _scalar_tail(sid, diag, valid, CC, e, a)
    for b in range(NB):
        got = [
            (int(k_sid[b, j]), int(k_pos[b, j]))
            for j in range(CC)
            if k_sid[b, j] != SENTINEL_SID
        ]
        assert got == cands[b], (b, got, cands[b])
    np.testing.assert_array_equal(k_ov, ov)


def test_tail_eviction_across_groups():
    """A later group's smaller position evicts an earlier kept candidate
    in the re-scan (the fold's order dependence, src/filter.c:45-78)."""
    e, a, CC = 5, 0, 4
    NB, G, CAP = 1, 2, 8
    sid = np.zeros((NB, G, CAP), np.int32)
    diag = np.full((NB, G, CAP), _BIG, np.int32)
    valid = np.zeros((NB, G, CAP), bool)
    # Group 0 keeps 10 and 20 (gap > e); group 1 adds 14: scan keeps
    # 10, then 14 is within e of 10? 14 > 10+5 is False -> dropped; 20
    # remains. Add 16: 16 > 15 -> kept, then 20 <= 16+5 -> EVICTED.
    diag[0, 0, :2] = [10, 20]
    valid[0, 0, :2] = True
    diag[0, 1, 0] = 16
    valid[0, 1, 0] = True
    sid_m = np.where(valid, sid, SENTINEL_SID).astype(np.int32)
    diag_m = np.where(valid, diag, _BIG).astype(np.int32)
    k_sid, k_pos, _ = (
        np.asarray(x) for x in filter_tail(sid_m, diag_m, CAP, CC, e, a)
    )
    got = [
        (int(k_sid[0, j]), int(k_pos[0, j]))
        for j in range(CC)
        if k_sid[0, j] != SENTINEL_SID
    ]
    cands, _ = _scalar_tail(sid, diag, valid, CC, e, a)
    assert got == cands[0] == [(0, 10), (0, 16)]


def test_tail_in_generate_candidates_matches_scalar_model():
    """End-to-end: on a satellite-genome workload, the candidate lists
    generate_candidates produces for every read without a fallback equal
    the scalar fold of the slabs it fed the tail (probed via the
    `truncmat` stage), after the range filter and band-start shift."""
    import jax.numpy as jnp

    from fem_tpu import sim
    from fem_tpu.config import FemArgs
    from fem_tpu.index.build import build_index
    from fem_tpu.io import fastx
    from fem_tpu.ops.candidates import generate_candidates
    from fem_tpu.ops.hashing import (
        ambiguous_base_counts,
        reverse_complement,
        seed_hashes,
    )
    from fem_tpu.ops.types import FilterParams, device_index_from_host
    from tests.test_engine import _batch_from_reads

    seqs = sim.satellite_genome(
        80_000, num_seqs=2, seed=51, satellite_fraction=0.05
    )
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.fa")
        sim.write_fasta(p, seqs)
        ref = fastx.read_fasta(p)
    index = build_index(ref, 12, 3)
    reads = sim.simulate_reads(seqs, 64, read_length=100, max_errors=5, seed=52)
    batch = _batch_from_reads(reads)
    e, a, CC = 5, 1, 16
    args = FemArgs(error_threshold=e, num_additional_qgrams=a)
    params = FilterParams.from_args(
        args, batch.codes.shape[1], cap_occ=48, cap_cand=CC, cap_vote=48
    )
    dindex = device_index_from_host(index, ref)

    codes = jnp.asarray(batch.codes)
    lengths = jnp.asarray(batch.lengths)
    neg = reverse_complement(codes, lengths)
    both = jnp.concatenate([codes, neg], axis=0)
    lens2 = jnp.concatenate([lengths, lengths], axis=0)
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)

    res = generate_candidates(both, lens2, hashes, amb, dindex, params)
    slot_valid, diag, sid = (
        np.asarray(x)
        for x in generate_candidates(
            both, lens2, hashes, amb, dindex, params, _stop_after="truncmat"
        )
    )
    cands, _ = _scalar_tail(sid, diag, slot_valid, CC, e, a)
    ref_len = np.asarray(ref.lengths)
    lens = np.asarray(lens2)
    ok = ~np.asarray(res.needs_fallback) & np.asarray(res.mappable)
    assert ok.sum() > 64
    checked = 0
    for b in np.flatnonzero(ok):
        want = [
            (s, d - e) for s, d in cands[b]
            if d >= e and d + lens[b] + e < ref_len[s]
        ]
        valid = np.asarray(res.cand_valid[b])
        got = list(zip(np.asarray(res.cand_sid[b])[valid].tolist(),
                       np.asarray(res.cand_pos[b])[valid].tolist()))
        assert got == want, (b, got, want)
        checked += len(want)
    assert checked > 0
