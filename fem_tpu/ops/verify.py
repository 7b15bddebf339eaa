"""Batched banded Myers edit-distance verification.

Reference semantics: banded Myers bit-parallel DP, band width 2e+1 <= 15
bits, over pattern = reference window starting at the band start and
text = read, with the final 2e-step band scan picking (min ED, first end
position attaining it) (src/align.c:102-147 scalar, 149-277 8-lane SSE).

Plain XLA formulation: one (read, candidate) pair per vector element; the
per-step match bitvectors Eq are precomputed for the whole batch with
2e+1 shifted compares (no per-step Peq register file), then a single
`lax.scan` runs the 12-op Myers recurrence on uint32 elements. The 3e
early-exit (src/align.c:128-130,247-252) is omitted: it only ever rejects
candidates that the full run also rejects (band-start errors are
monotonic in i and the final scan can lower them by at most 2e), so
accepted results are identical. A Pallas kernel for the GPU implements
the same contract (fem_tpu/ops/verify_pallas.py); this version is the
reference it is tested against and the path on every other platform.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fem_tpu.ops.types import DeviceIndex


class VerifyResult(NamedTuple):
    edit_distance: jnp.ndarray  # (V,) int32 (capped at whatever the DP gave)
    end_offset: jnp.ndarray  # (V,) int32 end position relative to band start
    accepted: jnp.ndarray  # (V,) bool: ED <= e


def gather_windows(
    index: DeviceIndex,
    sid: jnp.ndarray,  # (V,) int32
    pos: jnp.ndarray,  # (V,) int32 band-start positions
    window_length: int,
) -> jnp.ndarray:
    """(V, window_length) uint8 reference codes starting at each band start.
    Out-of-range lanes (masked-out slots) read inter-chromosome sentinel
    gap bases, never a neighboring chromosome.

    Windows are fetched as ceil(W/64)+1 aligned 64-byte row gathers from
    the u32 row view, then realigned with a log-step barrel shift over
    words and a per-lane byte extract (a formulation chosen to avoid
    per-byte element gathers; its cost on the H100 against a plain
    element gather is not measured).
    """
    base = jnp.take(index.ref_offsets, jnp.clip(sid, 0, index.ref_offsets.shape[0] - 1))
    g = base + pos  # absolute byte offset into ref_flat
    row_words = index.ref_rows.shape[1]  # 16 words = 64 bytes
    num_rows = -(-window_length // 64) + 1
    row0 = jnp.clip(g >> 6, 0, index.ref_rows.shape[0] - num_rows)
    rows = jnp.concatenate(
        [jnp.take(index.ref_rows, row0 + k, axis=0) for k in range(num_rows)],
        axis=1,
    ).astype(jnp.uint32)  # (V, num_rows * 16)

    # Barrel shift by the word offset w = (g>>2) & 15 (log-step selects).
    w = (g >> 2) & (row_words - 1)
    total_words = rows.shape[1]
    for bit, shift in ((1, 1), (2, 2), (4, 4), (8, 8)):
        shifted = jnp.concatenate(
            [rows[:, shift:], jnp.zeros((rows.shape[0], shift), jnp.uint32)], axis=1
        )
        rows = jnp.where((w & bit)[:, None] != 0, shifted, rows)
    del total_words

    # Byte extraction: window[t] = byte (sub + t) of the aligned words.
    sub = (g & 3).astype(jnp.uint32)
    out = []
    for t in range(window_length):
        lo = rows[:, t >> 2]
        hi = rows[:, (t >> 2) + 1]
        k = sub + (t & 3)
        word = jnp.where(k >= 4, hi, lo)
        shift = (k & 3) << 3
        out.append(((word >> shift) & 0xFF).astype(jnp.uint8))
    return jnp.stack(out, axis=1)


def compute_eq(
    window: jnp.ndarray,  # (V, L + 2e) uint8
    text: jnp.ndarray,  # (V, L) uint8
    error_threshold: int,
) -> jnp.ndarray:
    """Eq[v, i] bit j = (window[v, i+j] == text[v, i]) — the banded match
    bitvector the reference maintains incrementally via the Peq register
    file (src/align.c:103-134)."""
    L = text.shape[1]
    eq = jnp.zeros(text.shape, jnp.uint32)
    for j in range(2 * error_threshold + 1):
        eq = eq | ((window[:, j : j + L] == text).astype(jnp.uint32) << j)
    return eq


def banded_myers(
    eq: jnp.ndarray,  # (V, L) uint32 precomputed match bitvectors
    lengths: jnp.ndarray,  # (V,) int32 true text lengths
    error_threshold: int,
) -> VerifyResult:
    V, L = eq.shape
    e = error_threshold

    def step(carry, x):
        VP, VN, nerr, i = carry
        eq_i = x
        active = i < lengths
        X = eq_i | VN
        D0 = (((VP + (X & VP)) ^ VP) | X).astype(jnp.uint32)
        HN = VP & D0
        HP = VN | ~(VP | D0)
        X2 = D0 >> 1
        VN_n = X2 & HP
        VP_n = HN | ~(X2 | HP)
        nerr_n = nerr + (1 - (D0 & 1)).astype(jnp.int32)
        VP = jnp.where(active, VP_n, VP)
        VN = jnp.where(active, VN_n, VN)
        nerr = jnp.where(active, nerr_n, nerr)
        return (VP, VN, nerr, i + 1), None

    init = (
        jnp.zeros((V,), jnp.uint32),
        jnp.zeros((V,), jnp.uint32),
        jnp.zeros((V,), jnp.int32),
        jnp.int32(0),
    )
    (VP, VN, nerr, _), _ = jax.lax.scan(step, init, eq.T)

    # Final band scan (src/align.c:135-146): walk the 2e upper band cells;
    # the end position records the *first* strict improvement of the min.
    end = lengths - 1
    min_err = nerr
    for i in range(2 * e):
        nerr = nerr + ((VP >> i) & 1).astype(jnp.int32)
        nerr = nerr - ((VN >> i) & 1).astype(jnp.int32)
        improve = nerr < min_err
        end = jnp.where(improve, lengths - 1 + 1 + i, end)
        min_err = jnp.minimum(min_err, nerr)
    return VerifyResult(min_err, end, min_err <= e)


def verify_candidates_jnp(
    index: DeviceIndex,
    sid: jnp.ndarray,
    pos: jnp.ndarray,
    text: jnp.ndarray,  # (V, Lmax) uint8
    lengths: jnp.ndarray,  # (V,) int32
    error_threshold: int,
) -> VerifyResult:
    Lmax = text.shape[1]
    window = gather_windows(index, sid, pos, Lmax + 2 * error_threshold)
    eq = compute_eq(window, text, error_threshold)
    return banded_myers(eq, lengths, error_threshold)
