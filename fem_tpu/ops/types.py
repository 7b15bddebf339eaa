"""Device-side data structures.

Layout decisions:
  * 64-bit occurrence values (seqid << 32 | position, src/index.h) are split
    into two int32 planes — two-key lexicographic sorts give identical
    ordering to u64 comparison because in-chrom positions never approach
    2^31, and every key stays 32-bit.
  * The CSR lookup table stays a flat int32 HBM array with a precomputed
    4^k frequency table, making a frequency query one gather
    (src/index.h:22-28 semantics).
  * The reference genome is a single flat uint8 code array with >=
    (max read + 2*7) sentinel bases between chromosomes, so banded windows
    gathered near boundaries never alias a neighbor.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.config import FemArgs
from fem_tpu.index.storage import FemIndex
from fem_tpu.io.fastx import Reference


class DeviceIndex(NamedTuple):
    lookup: jnp.ndarray | None  # (4^k + 1,) int32 CSR offsets; None when
    # csr_rows is present (csr_rows carries both CSR bounds per bucket, so
    # shipping the flat table too would burn 67 MB of HBM with no consumer
    # on the hot path)
    freq_table: jnp.ndarray  # (4^k,) int32 lookup[h+1]-lookup[h] (one gather per query)
    occ_rows: jnp.ndarray  # (Rs, 128) uint32 — (sid,pos) pairs, 64 per 512B
    # super-row (8 logical 8-pair rows). The slab fetch gathers full
    # 128-word super-rows and extracts the 16-word logical row with a
    # select chain (whether this still pays on the H100 is not measured).
    ref_rows: jnp.ndarray  # (total/64, 16) uint32 — same bytes, 64B rows
    ref_offsets: jnp.ndarray  # (num_seqs,) int32 offsets into ref_flat
    ref_lengths: jnp.ndarray  # (num_seqs,) int32 chromosome lengths
    num_occurrences: jnp.ndarray  # () int32
    # Coordinate-range sharding (fem_tpu/parallel/sharded_index.py): the
    # shard owns [own_start, own_end) of each chromosome and stores a halo
    # beyond it; candidates outside the owned range drop after dedup, and
    # reads with candidates in the first `e` positions of a mid-chromosome
    # slice (halo_lo sentinel 2^30 = slice starts at 0) fall back — the
    # local dedup fold cannot see the pre-halo carry. None on an
    # unsharded index.
    own_start: jnp.ndarray | None = None  # (num_seqs,) int32
    own_end: jnp.ndarray | None = None  # (num_seqs,) int32
    halo_lo: jnp.ndarray | None = None  # (num_seqs,) int32
    # (4^k, 2) int32 rows [lookup[h], lookup[h+1]]: the selected-seed
    # attribute fetch needs BOTH the CSR start and the run length, so one
    # 2-word row gather replaces two element gathers.
    csr_rows: jnp.ndarray | None = None


_ROW_BYTES = 64
_ROW_WORDS = _ROW_BYTES // 4


def pack_occ_super(
    sid: np.ndarray, pos: np.ndarray, n_rows: int
) -> np.ndarray:
    """(sid, pos) u32 pairs -> (Rs, 128) super-rows covering >= n_rows
    logical 8-pair rows (zero padded)."""
    n = sid.shape[0]
    n_super = -(-n_rows // 8)
    occ_pairs = np.zeros((n_super * 64, 2), np.uint32)
    occ_pairs[:n, 0] = sid.astype(np.uint32)
    occ_pairs[:n, 1] = pos.astype(np.uint32)
    return occ_pairs.reshape(n_super, 128)


def device_index_from_host(
    index: FemIndex, reference: Reference, sharding=None
) -> DeviceIndex:
    """Upload the index. `sharding` (e.g. a replicated NamedSharding over
    a data mesh) places every table; None puts them on the default
    device."""
    put = jnp.asarray if sharding is None else (
        lambda x: jax.device_put(x, sharding)
    )
    sid, pos = index.split_sid_pos()
    flat = reference.flat_codes
    padded = len(flat) + (-len(flat)) % _ROW_BYTES + _ROW_BYTES
    buf = np.full(padded, 4, np.uint8)
    buf[: len(flat)] = flat
    # 64-byte rows viewed as little-endian u32 words: the plain verify
    # path fetches banded windows as 3 aligned row gathers + a barrel
    # shift (ops/verify.py); the verify kernel reads the same bytes by
    # offset.
    rows = buf.view(np.uint32).reshape(-1, _ROW_WORDS)
    # Occurrence table as interleaved (sid, pos) u32 pairs, 8 pairs per
    # logical 64-byte row, stored as (Rs, 128) super-rows of 8 logical
    # rows each (see DeviceIndex.occ_rows).
    n = sid.shape[0]
    n_rows = -(-n // 8) + 1
    occ_rows = pack_occ_super(sid, pos, n_rows)
    lookup_i32 = index.lookup.astype(np.int32)
    return DeviceIndex(
        lookup=None,  # csr_rows carries both CSR bounds (see field note)
        freq_table=put(np.diff(lookup_i32)),
        occ_rows=put(occ_rows),
        ref_rows=put(rows),
        ref_offsets=put(reference.offsets.astype(np.int32)),
        ref_lengths=put(reference.lengths.astype(np.int32)),
        num_occurrences=put(np.int32(index.num_occurrences)),
        csr_rows=put(np.stack([lookup_i32[:-1], lookup_i32[1:]], axis=1)),
    )


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Static (trace-time) parameters of the jitted mapping program."""

    kmer_size: int
    step_size: int
    error_threshold: int
    num_additional_qgrams: int
    max_read_length: int  # Lmax: padded read length
    cap_occ: int = 512  # max gathered occurrences per (read, strand, group)
    cap_cand: int = 512  # max candidates carried per (read, strand)
    cap_vote: int = 512  # max TRUE occurrences per (read, strand, group):
    # the width of the compacted slab the sort/vote/dedup chain runs on
    # (cap_occ bounds the 8-aligned row fetch, cap_vote the live pairs)

    @classmethod
    def from_args(cls, args: FemArgs, max_read_length: int, **caps) -> "FilterParams":
        return cls(
            kmer_size=args.kmer_size,
            step_size=args.step_size,
            error_threshold=args.error_threshold,
            num_additional_qgrams=args.num_additional_qgrams,
            max_read_length=max_read_length,
            **caps,
        )

    @property
    def num_qgrams(self) -> int:
        return self.error_threshold + 1 + self.num_additional_qgrams

    @property
    def seed_span(self) -> int:
        return -(-self.kmer_size // self.step_size)

    @property
    def max_num_seeds(self) -> int:
        return self.max_read_length - self.kmer_size + 1

    @property
    def max_group_size(self) -> int:
        return -(-self.max_num_seeds // self.step_size)

    @property
    def max_dp_cols(self) -> int:
        """Upper bound on the q-gram DP column count over all lanes."""
        return max(self.max_group_size - self.num_qgrams * self.seed_span + 2, 2)


# Sentinel chromosome id marking invalid (sid, pos) slots; sorts after any
# real chromosome and never equals one, so windowed comparisons are inert.
SENTINEL_SID = np.int32(2**30)
