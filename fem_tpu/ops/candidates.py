"""Candidate generation: occurrence gather + pigeonhole vote + dedup.

Reference semantics (src/filter.c:80-223) reformulated for fixed-shape
device programs. The CPU version is a chain of pointer-chasing k-way
merges; here every (read, strand, group) lane gathers the occurrence lists
of its selected seeds into a fixed-capacity slab, sorts them with a
bitonic network (ops/sortnet.py), and applies
the vote and dedup as vector ops. Parity-critical quirks preserved:

  * occurrences whose in-chromosome position precedes the seed's read
    offset are dropped (src/filter.c:89-90,106);
  * after the stable sort by frequency (src/filter.c:204), the *last*
    (most frequent) seed only contributes diagonal positions <= the
    maximum position contributed by the other seeds (loop bound at
    src/filter.c:85) — here a masked lexicographic max + compare;
  * the additional-q-gram vote keeps a position only when more than `a`
    merged positions fall within [p, p+e] (src/filter.c:118-131) — on the
    sorted slab this is a single shifted compare;
  * groups fold left-to-right through the greedy +-e dedup
    (src/filter.c:45-78,210-212), which can evict earlier winners — an
    order-dependent fold reproduced exactly by a per-group scan;
  * finally candidates near chromosome edges are dropped and survivors
    shift by -e to the band start (src/filter.c:133-144).

64-bit candidate values (seqid<<32|pos) are represented as (sid, pos)
int32 pairs ordered by two-key lexicographic sorts — identical order,
with 32-bit keys.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.ops.seed_select import select_qgrams
from fem_tpu.ops.sortnet import bitonic_sort_2key
from fem_tpu.ops.types import DeviceIndex, FilterParams, SENTINEL_SID

# np scalar, not jnp: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed bring-up.
_BIG = np.int32(2**30)


class CandidateResult(NamedTuple):
    cand_sid: jnp.ndarray  # (NB, CAP_CAND) int32
    cand_pos: jnp.ndarray  # (NB, CAP_CAND) int32 band-start positions
    cand_valid: jnp.ndarray  # (NB, CAP_CAND) bool, ascending positions first
    num_candidates: jnp.ndarray  # (NB,) int32
    dp_total: jnp.ndarray  # (NB,) uint32 — pre-filter counter per strand-read
    needs_fallback: jnp.ndarray  # (NB,) bool — capacity overflow: a bigger
    # tier fixes these, so they ride the retry ladder
    inherent_fallback: jnp.ndarray  # (NB,) bool — shard-halo risk /
    # incomplete DP: no tier helps, route straight to the exact host mapper
    mappable: jnp.ndarray  # (NB,) bool — passed length/ambiguity guards


def _probe(*arrays) -> jnp.ndarray:
    """Tiny live-value checksum used by the stage profiler (tools/
    profile_stages.py): forces XLA to materialize everything computed so
    far while keeping the D2H payload one scalar."""
    acc = jnp.uint32(0)
    for a in arrays:
        if a.dtype == jnp.bool_:
            a = a.astype(jnp.uint32)
        acc += jnp.sum(a.astype(jnp.uint32) if a.dtype != jnp.uint32 else a)
    return acc


def generate_candidates(
    codes: jnp.ndarray,  # (NB, Lmax) uint8 — reads with strand applied
    lengths: jnp.ndarray,  # (NB,) int32
    hashes: jnp.ndarray,  # (NB, NSmax) int32 seed hashes
    ambiguous: jnp.ndarray,  # (NB,) int32
    index: DeviceIndex,
    params: FilterParams,
    index_axis: str | None = None,
    _stop_after: str | None = None,
) -> CandidateResult:
    """With `index_axis` set, the occurrence table is coordinate-sharded
    over that mesh axis (whole chromosomes per shard): `index.freq_table`
    holds *global* frequencies (the DP and the stable frequency sort are
    global decisions) while `index.lookup`/`index.occ_rows` are the local
    shard's CSR. The only cross-shard dependency in the filter is the
    last-seed truncation threshold — a lexicographic max over the other
    seeds' diagonal positions — realized as two pmaxes. The pigeonhole
    vote and greedy dedup never cross chromosome boundaries, so they stay
    local; callers psum candidate counts over the axis.
    """
    NB = codes.shape[0]
    G = params.step_size
    # Every table index below is in range by construction (hashes are
    # base-4 polynomials in [0, 4^k); occ row ids are clipped before the
    # shift).
    def take0(table, idx):
        return jnp.take(table, idx, mode="clip", axis=0)
    NG = params.max_group_size
    S = params.num_qgrams
    e = params.error_threshold
    a = params.num_additional_qgrams
    CAP = params.cap_occ
    CC = params.cap_cand

    num_seeds = lengths - params.kmer_size + 1  # (NB,)
    min_group = jnp.where(num_seeds > 0, num_seeds // params.step_size, 0)
    mappable = (
        (num_seeds > 0)
        & (S <= min_group)  # src/filter.c:166-172
        & (ambiguous <= e)  # src/filter.c:180-182
    )

    # ---- per-(lane, group) seed tables -------------------------------------
    # group_hashes[b, g, p] = hashes[b, min(g + p*step, NSh-1)]: STRIDED
    # views, not a gather — static strided slices are a windowed copy
    # where the fancy-index formulation is a minor-axis gather. Group
    # coordinates past the hash row (only ever
    # padding beyond group_sizes, masked in the DP) replicate the last
    # column, matching the old clipped-index semantics exactly.
    NSh = hashes.shape[1]
    cols = []
    for g in range(G):
        n_ok = min(NG, (NSh - 1 - g) // params.step_size + 1)
        sl = jax.lax.slice_in_dim(
            hashes, g, g + (n_ok - 1) * params.step_size + 1,
            stride=params.step_size, axis=1,
        )
        if n_ok < NG:
            sl = jnp.concatenate(
                [sl, jnp.broadcast_to(hashes[:, NSh - 1:], (NB, NG - n_ok))],
                axis=1,
            )
        cols.append(sl)
    group_hashes = jnp.stack(cols, axis=1)  # (NB, G, NG)
    group_sizes = jnp.maximum(
        (num_seeds[:, None] - jnp.arange(G, dtype=jnp.int32)[None, :])
        // params.step_size,
        0,
    )  # (NB, G) — floor counts, reproducing the reference's truncation
    # Flat-index gather, reshaped after (the flat formulation of the same
    # access set; its cost on the H100 against a (NB, G, NG)-shaped index
    # is not measured).
    freqs = (
        take0(index.freq_table, group_hashes.reshape(-1))
        .reshape(group_hashes.shape)
        .astype(jnp.uint32)
    )
    if _stop_after == "freqs":
        return _probe(freqs, group_sizes, mappable)

    # ---- DP selection per (lane, group) ------------------------------------
    NL = NB * G
    sel = select_qgrams(
        freqs.reshape(NL, NG),
        group_sizes.reshape(NL),
        index.num_occurrences,
        params,
    )
    sel_p = sel.positions.reshape(NB, G, S)  # group coords, traceback order
    dp_total = jnp.where(
        mappable[:, None], sel.min_total.reshape(NB, G), jnp.uint32(0)
    ).sum(axis=1, dtype=jnp.uint32)
    complete = sel.complete.reshape(NB, G)
    degenerate = sel.degenerate.reshape(NB, G)
    if _stop_after == "dp":
        return _probe(sel_p, dp_total, complete, degenerate)

    # ---- selected-seed attributes, stable-sorted by frequency --------------
    sel_pc = jnp.clip(sel_p, 0, NG - 1)

    def at_selected(arr):  # (NB, G, NG) -> (NB, G, S) via a select chain
        # (no minor-axis gather)
        out = jnp.broadcast_to(arr[..., 0, None], sel_pc.shape)
        for k in range(1, NG):
            out = jnp.where(sel_pc == k, arr[..., k, None], out)
        return out

    # read position of group coordinate p in group si is si + p*step —
    # pure arithmetic, no selection needed. The selected frequency comes
    # from the ALREADY-GATHERED (NB, G, NG) freqs via the same select
    # chain instead of a second random table gather. Only the CSR start
    # offset still needs a table gather (one 2-word csr_rows row per
    # selected seed).
    start = (
        jnp.arange(G, dtype=jnp.int32)[None, :, None]
        + sel_pc * params.step_size
    )
    sel_hash = at_selected(group_hashes)
    if _stop_after == "selhash":
        return _probe(sel_hash, start)
    # Both DeviceIndex constructors build csr_rows (types.py keeps
    # lookup=None); the contract is explicit here rather than carrying
    # a dead lookup-gather branch. One 2-word row gather yields both CSR
    # bounds; flat-index formulation as above.
    assert index.csr_rows is not None, "DeviceIndex must carry csr_rows"
    lf = take0(index.csr_rows, sel_hash.reshape(-1)).reshape(
        *sel_hash.shape, 2
    )
    sstart_off = lf[..., 0]
    lfreq = lf[..., 1] - lf[..., 0]
    if index_axis is None:
        sfreq = lfreq  # local == global on an unsharded index
    else:
        # Sharded: the sort key is the GLOBAL frequency; csr_rows
        # holds the local shard's CSR. The global value is already in
        # the gathered (NB, G, NG) freqs — select, don't re-gather.
        sfreq = at_selected(freqs).astype(jnp.int32)
    if _stop_after == "selgather":
        return _probe(sfreq, sstart_off, start)
    # Stable ascending sort by *global* frequency; ties keep traceback
    # order — this mirrors glibc qsort's (stable msort) behavior on the
    # 3-way comparator (src/utils.h:126-136). A bitonic network over the
    # S-wide rows (ops/sortnet.py); the distinct `order` tiebreaker key
    # makes the network's output equal the stable sort. Only (key, order)
    # ride the exchange network; the three payloads are recovered
    # afterwards by applying the permutation `order_s` as S-step select
    # chains.
    order = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (NB, G, S))
    sfreq_s, order_s = bitonic_sort_2key(sfreq, order)

    def at_perm(arr):  # permute (NB, G, S) by order_s via select chain
        out = jnp.broadcast_to(arr[..., 0, None], order_s.shape)
        for j in range(1, S):
            out = jnp.where(order_s == j, arr[..., j, None], out)
        return out

    start_s = at_perm(start)
    off_s = at_perm(sstart_off)
    lfreq_s = at_perm(lfreq)
    last_j = jnp.full((NB, G), S - 1, jnp.int32)  # sorted: last slot
    if _stop_after == "selattr":
        return _probe(sfreq_s, start_s, off_s, lfreq_s)

    # ---- occurrence gather into CAP slots (aligned 8-pair rows) ------------
    # Each selected seed's occurrence run [off, off+freq) is covered by the
    # ALIGNED 64-byte rows that contain it (ceil((off%8 + freq)/8) rows),
    # so every 8-slot chunk is exactly ONE row gather — no second row, no
    # barrel shift. Pairs in a row outside the run (neighbors from adjacent
    # hash buckets) are masked invalid; the valid set and its order are
    # unchanged.
    assert CAP % 8 == 0, "cap_occ must be a multiple of 8"
    NCH = CAP // 8
    fc = jnp.minimum(lfreq_s, CAP + 1)  # clamp for slot math; flags overflow
    srow = off_s & 7  # start offset within the first row
    fc8 = jnp.where(fc > 0, ((srow + fc + 7) // 8) * 8, 0)  # aligned span
    pfx8 = jnp.cumsum(fc8, axis=2) - fc8  # exclusive, 8-aligned slot space
    total_c = pfx8[..., -1] + fc8[..., -1]
    overflow_occ = total_c > CAP  # (NB, G); stricter than the exact total,
    # which only costs a few extra tier retries, never wrong results.

    c8 = jnp.arange(NCH, dtype=jnp.int32) * 8
    j_of_c = jnp.zeros((NB, G, NCH), jnp.int32)
    for j in range(1, S):
        j_of_c = j_of_c + (c8[None, None, :] >= pfx8[..., j, None]).astype(jnp.int32)

    # Per-chunk attributes of the owning seed: with S <= 10 a select chain
    # replaces a minor-axis take_along_axis.
    def of_seed(arr):  # (NB, G, S) -> (NB, G, NCH) via j_of_c
        out = jnp.broadcast_to(arr[..., 0, None], j_of_c.shape)
        for j in range(1, S):
            out = jnp.where(j_of_c == j, arr[..., j, None], out)
        return out

    within_c = c8[None, None, :] - of_seed(pfx8)  # slot offset in seed span
    row = of_seed(off_s >> 3) + (within_c >> 3)  # logical 8-pair row id
    row = jnp.clip(row, 0, index.occ_rows.shape[0] * 8 - 1)
    # Fetch the enclosing 128-word super-row and extract the logical row
    # with a select chain (whether the wider row still pays on the H100
    # is not measured).
    words128 = (
        take0(index.occ_rows, (row >> 3).reshape(-1))
        .reshape(NB, G, NCH, 128)
        .astype(jnp.uint32)
    )  # flat-index formulation, see the freqs gather note
    sub = (row & 7)[..., None]
    words = jax.lax.slice_in_dim(words128, 0, 16, axis=-1)
    for t in range(1, 8):
        words = jnp.where(
            sub == t,
            jax.lax.slice_in_dim(words128, 16 * t, 16 * (t + 1), axis=-1),
            words,
        )
    sid = words[..., 0::2].astype(jnp.int32).reshape(NB, G, CAP)
    pos = words[..., 1::2].astype(jnp.int32).reshape(NB, G, CAP)
    if _stop_after == "occgather":
        return _probe(sid, pos, overflow_occ)

    lane_ok = mappable[:, None] & complete  # (NB, G)
    # Slot k of chunk c holds pair (seed_first_row + within_c//8)*8 + k;
    # it belongs to the seed's run iff within_c + k is inside
    # [srow, srow + freq).
    rel = within_c[..., None] + jnp.arange(8, dtype=jnp.int32)
    srow_j = of_seed(srow)[..., None]
    slot_valid = (
        (rel >= srow_j)
        & (rel < srow_j + of_seed(fc)[..., None])
        & lane_ok[..., None, None]
    ).reshape(NB, G, CAP)
    seed_start = jnp.broadcast_to(
        of_seed(start_s)[..., None], (NB, G, NCH, 8)
    ).reshape(NB, G, CAP)
    slot_valid &= pos >= seed_start  # src/filter.c:89-90
    diag = pos - seed_start
    is_last = jnp.broadcast_to(
        (j_of_c == last_j[..., None])[..., None], (NB, G, NCH, 8)
    ).reshape(NB, G, CAP)

    # ---- last-seed truncation (src/filter.c:85) ----------------------------
    others = slot_valid & ~is_last
    tsid = jnp.max(jnp.where(others, sid, -1), axis=2, keepdims=True)
    if index_axis is not None:
        tsid = jax.lax.pmax(tsid, index_axis)
    tpos = jnp.max(
        jnp.where(others & (sid == tsid), diag, -1), axis=2, keepdims=True
    )
    if index_axis is not None:
        tpos = jax.lax.pmax(tpos, index_axis)
    keep_last = (sid < tsid) | ((sid == tsid) & (diag <= tpos))
    slot_valid &= jnp.where(is_last, keep_last, True)
    if _stop_after == "trunc":
        return _probe(slot_valid, diag)
    if _stop_after == "truncmat":  # materialized variant (profiling only)
        return (slot_valid, diag, sid)

    # Coordinate-range sharding: if this shard's slice of the candidate's
    # chromosome starts mid-chromosome (halo_lo), candidates in the slice's
    # first e positions could sit within e of unseen pre-halo candidates —
    # the greedy dedup fold cannot prove its carry is right there, so such
    # reads take the exact host path (rare: the halo is ~40 read lengths).
    # Checked before the vote: a voted-out candidate never enters the
    # fold, but the conservative superset costs only extra fallbacks.
    halo_risk = None
    if index.halo_lo is not None:
        hlo = jnp.take(
            index.halo_lo,
            jnp.clip(sid, 0, index.halo_lo.shape[0] - 1),
            mode="clip",
        )
        halo_risk = (
            slot_valid & (diag >= hlo) & (diag < hlo + e)
        ).any(axis=(1, 2))
    sid_m = jnp.where(slot_valid, sid, SENTINEL_SID)
    diag_m = jnp.where(slot_valid, diag, _BIG)
    with jax.named_scope("filter_tail"):  # read by tools/trace_share.py
        tail = filter_tail(
            sid_m, diag_m, params.cap_vote, CC, e, a, _stop_after=_stop_after
        )
    if _stop_after is not None:
        return tail  # a profiling probe of the tail
    cand_sid, cand_pos, overflow_cand = tail
    return _finish_candidates(
        cand_sid, cand_pos, overflow_cand, overflow_occ, halo_risk,
        complete, degenerate, mappable, dp_total, lengths, index, params,
    )


def filter_tail(
    sid: jnp.ndarray,  # (NB, G, CAP) int32, SENTINEL_SID in invalid slots
    diag: jnp.ndarray,  # (NB, G, CAP) int32 diagonal positions, _BIG invalid
    cap_vote: int,
    cap_cand: int,
    e: int,
    a: int,
    _stop_after: str | None = None,
):
    """Sort + additional-q-gram vote + greedy dedup fold over the
    occurrence slabs of each lane (src/filter.c:45-131,210-212). Returns
    (cand_sid, cand_pos, overflow): the lane's candidate list
    (NB, cap_cand) in ascending order with SENTINEL_SID / _BIG past its
    end, and a per-lane flag set when the vote slab or the candidate list
    overflowed (a bigger retry tier fixes those)."""
    NB, G, _ = sid.shape
    CC = cap_cand
    # The aligned-row fetch is 8-slot granular, so the CAP slab is mostly
    # padding. One batch-wide scatter compacts the valid (sid, diag) pairs
    # into a (NB, G, cap_vote) slab sized by the TRUE occurrence
    # distribution; overflow joins the capacity-retry ladder.
    VC = cap_vote
    valid = sid != SENTINEL_SID
    cnt = jnp.cumsum(valid.astype(jnp.int32), axis=2)
    overflow_vote = cnt[..., -1] > VC  # (NB, G)
    within = cnt - 1
    lanegroup = (
        jnp.arange(NB, dtype=jnp.int32)[:, None] * G
        + jnp.arange(G, dtype=jnp.int32)[None, :]
    )
    target = jnp.where(
        valid & (within < VC),
        lanegroup[..., None] * VC + within,
        NB * G * VC,  # out-of-bounds scatters drop
    ).reshape(-1)
    sid_s = (
        jnp.full((NB * G * VC,), SENTINEL_SID, jnp.int32)
        .at[target]
        .set(sid.reshape(-1))
        .reshape(NB, G, VC)
    )
    diag_s = (
        jnp.full((NB * G * VC,), _BIG, jnp.int32)
        .at[target]
        .set(diag.reshape(-1))
        .reshape(NB, G, VC)
    )
    if _stop_after == "presort":
        return _probe(sid_s, diag_s, overflow_vote)
    if _stop_after == "sortvote_b":  # profiling: barrier before the sort
        sid_s, diag_s = jax.lax.optimization_barrier((sid_s, diag_s))

    # ---- sort vote slab, vote ----------------------------------------------
    # Validity is recoverable from the sid sentinel, so only the two keys
    # travel through the sort network.
    sid_s, diag_s = bitonic_sort_2key(sid_s, diag_s)
    valid_s = sid_s != SENTINEL_SID
    if a > 0:
        pad_sid = jnp.concatenate(
            [sid_s[..., a:], jnp.full((NB, G, a), SENTINEL_SID, jnp.int32)], axis=2
        )
        pad_diag = jnp.concatenate(
            [diag_s[..., a:], jnp.full((NB, G, a), _BIG, jnp.int32)], axis=2
        )
        vote = (pad_sid == sid_s) & (pad_diag <= diag_s + e)
        valid_s &= vote
    if _stop_after in ("sortvote", "sortvote_b"):
        return _probe(sid_s, diag_s, valid_s)

    # ---- fold groups through the greedy dedup ------------------------------
    cand_sid = jnp.full((NB, CC), SENTINEL_SID, jnp.int32)
    cand_pos = jnp.full((NB, CC), _BIG, jnp.int32)
    cand_valid = jnp.zeros((NB, CC), bool)
    overflow = jnp.any(overflow_vote, axis=1)

    for g in range(G):
        m_sid = jnp.concatenate([cand_sid, sid_s[:, g]], axis=1)
        m_pos = jnp.concatenate([cand_pos, diag_s[:, g]], axis=1)
        m_valid = jnp.concatenate([cand_valid, valid_s[:, g]], axis=1)
        m_sid = jnp.where(m_valid, m_sid, SENTINEL_SID)
        m_pos = jnp.where(m_valid, m_pos, _BIG)
        m_sid, m_pos = bitonic_sort_2key(m_sid, m_pos)
        m_valid = m_sid != SENTINEL_SID

        # Greedy dedup is the one truly sequential piece; amortize the
        # scan's per-step overhead by consuming 16 elements per step.
        M = m_sid.shape[1]
        CH = 16
        pad = (-M) % CH
        if pad:
            m_sid_p = jnp.pad(m_sid, ((0, 0), (0, pad)), constant_values=SENTINEL_SID)
            m_pos_p = jnp.pad(m_pos, ((0, 0), (0, pad)), constant_values=_BIG)
            m_valid_p = jnp.pad(m_valid, ((0, 0), (0, pad)))
        else:
            m_sid_p, m_pos_p, m_valid_p = m_sid, m_pos, m_valid
        Mp = M + pad

        def dedup_step(carry, x):
            last_sid, last_pos = carry
            s_c, p_c, v_c = x  # each (CH, NB)
            keeps = []
            for i in range(CH):
                cond = (s_c[i] > last_sid) | (
                    (s_c[i] == last_sid) & (p_c[i] > last_pos + e)
                )
                keep = v_c[i] & cond
                last_sid = jnp.where(keep, s_c[i], last_sid)
                last_pos = jnp.where(keep, p_c[i], last_pos)
                keeps.append(keep)
            return (last_sid, last_pos), jnp.stack(keeps)

        xs = (
            m_sid_p.T.reshape(Mp // CH, CH, NB),
            m_pos_p.T.reshape(Mp // CH, CH, NB),
            m_valid_p.T.reshape(Mp // CH, CH, NB),
        )
        init = (jnp.full((NB,), -1, jnp.int32), jnp.zeros((NB,), jnp.int32))
        _, keep_c = jax.lax.scan(dedup_step, init, xs)
        keep = keep_c.reshape(Mp, NB).T[:, :M]  # (NB, M)
        n_keep = keep.sum(axis=1)
        overflow |= n_keep > CC
        k_sid = jnp.where(keep, m_sid, SENTINEL_SID)
        k_pos = jnp.where(keep, m_pos, _BIG)
        k_sid, k_pos = bitonic_sort_2key(k_sid, k_pos)
        cand_sid = k_sid[:, :CC]
        cand_pos = k_pos[:, :CC]
        cand_valid = cand_sid != SENTINEL_SID
    if _stop_after == "dedup":
        return _probe(cand_sid, cand_pos, cand_valid)
    return cand_sid, cand_pos, overflow


def _finish_candidates(
    cand_sid, cand_pos, overflow_cand, overflow_occ, halo_risk,
    complete, degenerate, mappable, dp_total, lengths,
    index: DeviceIndex, params: FilterParams,
) -> CandidateResult:
    e = params.error_threshold
    cand_valid = cand_sid != SENTINEL_SID

    # ---- range filter + band-start shift (src/filter.c:133-144) ------------
    ref_len = jnp.take(
        index.ref_lengths, jnp.clip(cand_sid, 0, index.ref_lengths.shape[0] - 1)
    )
    in_range = (cand_pos >= e) & (cand_pos + lengths[:, None] + e < ref_len)
    cand_valid &= in_range
    # Coordinate-range ownership: the dedup above ran over owned + halo
    # candidates (so the fold matches the global one); only candidates
    # whose diagonal position lies in this shard's owned range survive —
    # each global candidate is emitted by exactly one shard.
    if index.own_start is not None:
        sid_c = jnp.clip(cand_sid, 0, index.own_start.shape[0] - 1)
        owned = (cand_pos >= jnp.take(index.own_start, sid_c)) & (
            cand_pos < jnp.take(index.own_end, sid_c)
        )
        cand_valid &= owned
    cand_pos = jnp.where(cand_valid, cand_pos - e, cand_pos)

    # Capacity overflow (occurrence slab / candidate list) retries at a
    # bigger tier. Degenerate groups (DP < 2 columns) are defined no-ops,
    # not fallbacks (see fem_tpu/ops/seed_select.py); a non-degenerate
    # incomplete traceback would be a bug, and a shard-halo risk is a
    # property of the shard geometry — neither is fixed by a bigger tier,
    # so both carry the separate *inherent* bit that routes straight to
    # the exact host mapper.
    needs_fallback = mappable & (jnp.any(overflow_occ, axis=1) | overflow_cand)
    inherent = mappable & jnp.any(~complete & ~degenerate, axis=1)
    if halo_risk is not None:
        inherent |= mappable & halo_risk
    num_candidates = cand_valid.sum(axis=1).astype(jnp.int32)
    return CandidateResult(
        cand_sid, cand_pos, cand_valid, num_candidates, dp_total,
        needs_fallback, inherent, mappable,
    )
