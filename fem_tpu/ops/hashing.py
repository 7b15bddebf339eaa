"""Batched seed hashing and reverse complement — pure vector ops.

The reference hashes seeds with a scalar rolling loop
(src/utils.h:83-117). With a fixed k, hash(i) is just a windowed base-4
polynomial of the codes with ambiguous bases as 0, so a batch of reads
hashes with k shifted adds — no recurrence, no scan.
"""

from __future__ import annotations

import jax.numpy as jnp


def reverse_complement(codes: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Per-read reverse complement of padded code rows.

    codes: (B, Lmax) uint8 (0..4, padding 4); lengths: (B,) int32.
    Matches prepare_negative_sequence_at (src/sequence_batch.h:90-98):
    complement = 3 ^ code for real bases, ambiguous stays ambiguous.
    """
    B, Lmax = codes.shape
    # Dense formulation: flip the padded row (pad lands at the front),
    # then left-rotate by the per-read pad width with a log-step barrel
    # shift — all full-row selects instead of a per-element
    # take_along_axis gather.
    flipped = codes[:, ::-1]
    amt = (Lmax - lengths).astype(jnp.int32)  # left-rotation per row
    x = flipped
    for b in range((Lmax - 1).bit_length()):
        s = 1 << b
        rolled = jnp.concatenate([x[:, s:], x[:, :s]], axis=1)
        x = jnp.where(((amt >> b) & 1)[:, None] != 0, rolled, x)
    pos = jnp.arange(Lmax, dtype=jnp.int32)[None, :]
    comp = jnp.where(x > 3, jnp.uint8(4), (3 ^ x).astype(jnp.uint8))
    return jnp.where(pos < lengths[:, None], comp, jnp.uint8(4))


def seed_hashes(codes: jnp.ndarray, kmer_size: int) -> jnp.ndarray:
    """All window hashes: (B, Lmax) uint8 -> (B, Lmax-k+1) int32.

    hash(i) = sum_j code4[i+j] << 2*(k-1-j), ambiguous bases as A
    (src/utils.h:83-99). Windows that overlap padding hash the pad bases
    as A too — callers mask seeds beyond each read's length.
    """
    B, Lmax = codes.shape
    num = Lmax - kmer_size + 1
    c4 = jnp.where(codes > 3, jnp.uint8(0), codes).astype(jnp.int32)
    acc = jnp.zeros((B, num), dtype=jnp.int32)
    for j in range(kmer_size):
        acc = (acc << 2) + c4[:, j : j + num]
    return acc


def ambiguous_base_counts(
    codes: jnp.ndarray, lengths: jnp.ndarray, kmer_size: int
) -> jnp.ndarray:
    """Count ambiguous bases at positions [k, L-1] per read — the bail-out
    counter of hash_all_seeds_in_sequence (src/utils.h:101-117)."""
    B, Lmax = codes.shape
    pos = jnp.arange(Lmax, dtype=jnp.int32)[None, :]
    in_range = (pos >= kmer_size) & (pos < lengths[:, None])
    return jnp.sum(jnp.where(in_range & (codes > 3), 1, 0), axis=1).astype(jnp.int32)
