"""Coordinate-sharded index: whole-genome scale-out across devices.

For GRCh38-scale genomes the occurrence table (~8 GB at step 3) and the
reference itself outgrow one chip's HBM. The index therefore shards by
reference coordinate — whole chromosomes per shard, contiguous and in
order — across an `index` mesh axis, while reads stay data-parallel over a
`data` axis (SURVEY.md §5.7; the reference's analogous axis is its
step-size/memory trade-off, README.md:32).

Per-shard state: local CSR (lookup + occ rows of the shard's chromosomes)
and the shard's reference slice. Replicated state: the 4^k global
frequency table (the optimal-prefix-q-gram DP and the frequency sort are
*global* decisions) and chromosome lengths. The only cross-shard
communication in the whole filter/verify path is one lexicographic pmax
(last-seed truncation) plus psums for counters — everything else is local
because the pigeonhole vote and greedy dedup never cross chromosome
boundaries (inter-chromosome gaps exceed the error threshold by
construction).

Mapping results concatenate per (data, index) shard; the host's stable
sort by lane restores the reference's per-read candidate order because
shards hold ascending chromosome ranges.
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fem_tpu.index.storage import FemIndex
from fem_tpu.io.fastx import Reference
from fem_tpu.ops.types import DeviceIndex, FilterParams, pack_occ_super

DATA_AXIS = "data"
INDEX_AXIS = "index"

_ROW_BYTES = 64


@dataclasses.dataclass
class ShardedIndex:
    """Host-side stacked per-shard arrays (leading dim = shard)."""

    num_shards: int
    ranges: List[List[tuple]]  # per shard: [(sid, start, end)] owned ranges
    halo: int  # occurrence/reference overlap beyond owned ranges (bases)
    lookup: np.ndarray  # (n, 4^k+1) int32 local CSR
    freq_table: np.ndarray  # (4^k,) int32 global frequencies
    occ_rows: np.ndarray  # (n, max_super_rows, 128) uint32 super-rows
    csr_rows: np.ndarray  # (n, 4^k, 2) int32 local [lookup[h], lookup[h+1]]
    ref_flat: np.ndarray  # (n, max_ref) uint8
    ref_rows: np.ndarray  # (n, max_ref/64, 16) uint32
    ref_offsets: np.ndarray  # (n, num_seqs) int32 — ref_flat[off + p] = chrom[p]
    ref_lengths: np.ndarray  # (num_seqs,) int32
    num_occurrences: np.ndarray  # () int32 global
    own_start: np.ndarray  # (n, num_seqs) int32 owned [start, end) per sid
    own_end: np.ndarray  # (n, num_seqs) int32 (start == end: none owned)
    halo_lo: np.ndarray  # (n, num_seqs) int32 left-halo slice start, or
    # 2^30 sentinel when the slice starts at the chromosome start (no
    # unseen left context -> the local dedup fold is exact)


def partition_chromosomes(lengths: np.ndarray, num_shards: int) -> List[List[int]]:
    """Contiguous, in-order partition of whole chromosomes balanced by
    length (kept for diagnostics; `partition_ranges` is what the build
    uses — it also splits inside a chromosome)."""
    total = int(lengths.sum())
    target = total / num_shards
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    remaining = len(lengths)
    for sid, ln in enumerate(lengths):
        cur.append(sid)
        acc += int(ln)
        remaining -= 1
        # Close the group when at target, keeping enough chromosomes for
        # the remaining shards.
        if (
            len(groups) < num_shards - 1
            and acc >= target * (len(groups) + 1) - total / (2 * num_shards)
            and remaining >= (num_shards - 1 - len(groups))
        ):
            groups.append(cur)
            cur = []
    groups.append(cur)
    while len(groups) < num_shards:
        groups.append([])  # tolerate more shards than chromosomes
    return groups


def partition_ranges(lengths: np.ndarray, num_shards: int) -> List[List[tuple]]:
    """Equal-bases contiguous partition of the concatenated genome into
    coordinate ranges, splitting INSIDE chromosomes when needed — so a
    single huge chromosome (GRCh38 chr1, 248 Mb) spreads over shards
    instead of pinning its whole occurrence mass to one device. Returns
    per-shard [(sid, start, end)] pieces, in order, disjoint, covering."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    out: List[List[tuple]] = []
    for k in range(num_shards):
        lo = total * k // num_shards
        hi = total * (k + 1) // num_shards
        pieces = []
        for sid in range(len(lengths)):
            s = max(lo, int(bounds[sid]))
            e = min(hi, int(bounds[sid + 1]))
            if s < e:
                pieces.append((sid, s - int(bounds[sid]), e - int(bounds[sid])))
        out.append(pieces)
    return out


def build_sharded_index(
    index: FemIndex,
    reference: Reference,
    num_shards: int,
    gap: int = 256,
    halo: int = 4096,
) -> ShardedIndex:
    """Shard occurrences + reference by coordinate range with a `halo`
    overlap: shard s stores occurrences/reference for [start-halo,
    end+halo) of each owned piece, so candidate generation, the pigeonhole
    vote, the greedy ±e dedup, and banded verification of every OWNED
    candidate are shard-local (reads longer than halo - 2e are rejected at
    engine setup). Candidates outside the owned ranges are dropped after
    dedup (each global candidate is owned exactly once); reads with
    candidates in the first `e` positions of a mid-chromosome slice fall
    back to the exact host mapper — the local dedup fold cannot prove the
    unseen pre-halo carry is irrelevant there (see ops/candidates.py)."""
    lengths = reference.lengths.astype(np.int64)
    shard_ranges = partition_ranges(lengths, num_shards)
    num_seqs = reference.num_seqs

    sid_all = (index.occurrences >> np.uint64(32)).astype(np.uint32)
    pos_all = (index.occurrences & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hash_of = np.repeat(
        np.arange(index.lookup.shape[0] - 1, dtype=np.int64),
        np.diff(index.lookup.astype(np.int64)),
    )
    # Shard membership by concatenated-genome coordinate: two compares per
    # occurrence per shard (vs per-piece masks, untenable at 1e9
    # occurrences). The window may pull in a neighboring chromosome's
    # tail/head where a cut abuts a chromosome boundary — harmless: those
    # candidates are never owned (dropped post-dedup) and a different-sid
    # carry never suppresses a kept candidate in the greedy fold.
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    gpos = bounds[sid_all.astype(np.int64)] + pos_all.astype(np.int64)
    total = int(lengths.sum())

    own_start = np.zeros((num_shards, num_seqs), np.int32)
    own_end = np.zeros((num_shards, num_seqs), np.int32)
    halo_lo = np.full((num_shards, num_seqs), 2**30, np.int32)

    nbuckets = index.lookup.shape[0] - 1
    lookups = []
    occ_pair_lists = []
    for s, pieces in enumerate(shard_ranges):
        for sid, rs, re in pieces:
            own_start[s, sid] = rs
            own_end[s, sid] = re
            if rs - halo > 0:
                halo_lo[s, sid] = rs - halo
        cut_lo = total * s // num_shards - halo
        cut_hi = total * (s + 1) // num_shards + halo
        mask = (gpos >= cut_lo) & (gpos < cut_hi)
        counts = np.bincount(hash_of[mask], minlength=nbuckets)
        lk = np.zeros(nbuckets + 1, np.int64)
        np.cumsum(counts, out=lk[1:])
        lookups.append(lk.astype(np.int32))
        pairs = np.stack(
            [sid_all[mask], pos_all[mask]], axis=1
        )  # occurrence order preserved -> bucket-sorted like the global CSR
        occ_pair_lists.append(pairs)

    max_pairs = max((p.shape[0] for p in occ_pair_lists), default=0)
    max_rows = -(-max_pairs // 8) + 1
    max_super = -(-max_rows // 8)
    occ_rows = np.zeros((num_shards, max_super, 128), np.uint32)
    for s, pairs in enumerate(occ_pair_lists):
        occ_rows[s] = pack_occ_super(pairs[:, 0], pairs[:, 1], max_rows)
    csr_rows = np.stack(
        [np.stack([lk[:-1], lk[1:]], axis=1) for lk in lookups]
    )

    # Per-shard reference slices (leading + trailing sentinel gaps). Slice
    # [lo, hi) of chromosome `sid` lands at flat position `pos`, so the
    # global-coordinate offset is pos - lo.
    flats = []
    offsets = np.zeros((num_shards, num_seqs), np.int32)
    for s, pieces in enumerate(shard_ranges):
        spans = [
            (
                sid,
                max(rs - halo, 0),
                min(re + halo, int(lengths[sid])),
            )
            for sid, rs, re in pieces
        ]
        size = gap + sum(hi - lo + gap for _, lo, hi in spans)
        size += (-size) % _ROW_BYTES + _ROW_BYTES
        flat = np.full(size, 4, np.uint8)
        pos = gap
        for sid, lo, hi in spans:
            offsets[s, sid] = pos - lo
            flat[pos : pos + hi - lo] = reference.codes_of(sid)[lo:hi]
            pos += hi - lo + gap
        flats.append(flat)
    max_ref = max(f.shape[0] for f in flats)
    max_ref += (-max_ref) % _ROW_BYTES
    ref_flat = np.full((num_shards, max_ref), 4, np.uint8)
    for s, f in enumerate(flats):
        ref_flat[s, : f.shape[0]] = f
    ref_rows = ref_flat.reshape(num_shards, -1).view(np.uint32).reshape(
        num_shards, max_ref // _ROW_BYTES, 16
    )

    lookup_i32 = index.lookup.astype(np.int32)
    return ShardedIndex(
        num_shards=num_shards,
        ranges=shard_ranges,
        halo=halo,
        lookup=np.stack(lookups),
        freq_table=np.diff(lookup_i32),
        occ_rows=occ_rows,
        ref_flat=ref_flat,
        ref_rows=ref_rows,
        ref_offsets=offsets,
        ref_lengths=reference.lengths.astype(np.int32),
        num_occurrences=np.int32(index.num_occurrences),
        own_start=own_start,
        own_end=own_end,
        halo_lo=halo_lo,
        csr_rows=csr_rows,
    )


def make_index_sharded_map_fn(
    mesh: Mesh,
    params: FilterParams,
    verify_cap_per_shard: int,
    accept_cap_per_shard: int,
    verify: str,
    gather_rows: bool = False,
):
    """shard_map over a ('data', 'index') mesh: reads sharded on `data`,
    index pieces sharded on `index`, full mapping step per device.

    With `gather_rows` (the cross-host mode), each data row's per-index-
    shard packed segments all_gather over the index axis *inside* the
    program, so every device holds its row's complete hit set and any one
    host owning a device in the row can emit that row's reads without
    host-side cross-process traffic (the hit merge is a device collective,
    SURVEY.md §5.8). Lane ids then stay row-local ([0, 2*Bloc)) so a row
    segment unpacks exactly like a single-host (1 x n_ip) batch."""
    from fem_tpu.pipeline.engine import map_core, pack_outputs

    n_dp = mesh.shape[DATA_AXIS]
    n_ip = mesh.shape[INDEX_AXIS]

    def shard_fn(
        freq_table, occ_rows, ref_rows, ref_offsets,
        ref_lengths, num_occurrences, own_start, own_end, halo_lo,
        csr_rows, packed_in,
    ):
        codes = packed_in[:, :-4]
        lb = packed_in[:, -4:].astype(jnp.int32)
        lengths = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
        index = DeviceIndex(
            lookup=None,  # csr_rows carries both local CSR bounds
            freq_table=freq_table,
            occ_rows=occ_rows[0],
            ref_rows=ref_rows[0],
            ref_offsets=ref_offsets[0],
            ref_lengths=ref_lengths,
            num_occurrences=num_occurrences,
            own_start=own_start[0],
            own_end=own_end[0],
            halo_lo=halo_lo[0],
            csr_rows=csr_rows[0],
        )
        out = map_core(
            index, codes, lengths, params, verify_cap_per_shard, verify,
            accept_cap_per_shard, index_axis=INDEX_AXIS,
        )
        Bloc = codes.shape[0]
        if not gather_rows:
            # Globalize lane ids (single-host drain concatenates all
            # shards); in gather_rows mode lanes stay row-local.
            shard = jax.lax.axis_index(DATA_AXIS)
            l = out["a_lane"]
            strand = (l >= Bloc).astype(jnp.int32)
            out["a_lane"] = (
                strand * (n_dp * Bloc) + shard * Bloc + (l - strand * Bloc)
            )
        # Global per-read counters: candidate counts sum over index shards;
        # fallback is any-shard; DP totals are identical on every shard.
        out["num_candidates"] = jax.lax.psum(out["num_candidates"], INDEX_AXIS)
        out["needs_fallback"] = (
            jax.lax.pmax(out["needs_fallback"].astype(jnp.int32), INDEX_AXIS) > 0
        )
        out["inherent_fallback"] = (
            jax.lax.pmax(out["inherent_fallback"].astype(jnp.int32), INDEX_AXIS)
            > 0
        )
        # A read overflowing ANY index shard's slabs must retry wholly (its
        # hit set would otherwise merge incomplete shards).
        out["retry"] = (
            jax.lax.pmax(out["retry"].astype(jnp.int32), INDEX_AXIS) > 0
        )
        out["total_candidates"] = jax.lax.psum(
            out["total_candidates"], (DATA_AXIS, INDEX_AXIS)
        )
        seg = pack_outputs(out)
        if gather_rows:
            # Row-complete results on every device of the row: one
            # all_gather over the index axis, n_ip segments each
            # (segments are (rows, 128) u32 tiles; keep that shape).
            seg = jax.lax.all_gather(seg, INDEX_AXIS, axis=0).reshape(
                -1, seg.shape[-1]
            )
        return seg

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(),  # freq_table
            P(INDEX_AXIS),  # occ_rows
            P(INDEX_AXIS),  # ref_rows
            P(INDEX_AXIS),  # ref_offsets
            P(),  # ref_lengths
            P(),  # num_occurrences
            P(INDEX_AXIS),  # own_start
            P(INDEX_AXIS),  # own_end
            P(INDEX_AXIS),  # halo_lo
            P(INDEX_AXIS),  # csr_rows
            P(DATA_AXIS),  # packed reads
        ),
        out_specs=P(DATA_AXIS) if gather_rows else P((DATA_AXIS, INDEX_AXIS)),
        check_vma=False,
    )
    return jax.jit(fn)
