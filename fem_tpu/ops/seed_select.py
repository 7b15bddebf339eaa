"""Optimal prefix q-gram selection — the batched on-device DP.

Reference semantics (generate_optimal_prefix_qgram_for_group_seeding,
src/filter.c:3-43): for one seed group, pick e+1+a non-overlapping seeds
(span ceil(k/step) in group coordinates) minimizing total occurrence count,
via a (e+a+2) x (Ng - (e+1+a)*span + 2) DP with uint32-wrapping sums and a
decision-matrix traceback. Ties prefer the horizontal move (skip the seed).

Device design: one DP *lane* per (read, strand, group). The frequencies each
(row, column) cell needs are known statically, so they are pre-gathered
into the scan inputs as contiguous rows of a transposed (NG, NL) table —
no strided minor-axis loads inside the loop. The traceback exploits that
horizontal runs are skippable: a per-row suffix "last non-horizontal
column" table (running max along columns) turns the walk into exactly
S = e+1+a steps, each a single row lookup.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fem_tpu.ops.types import FilterParams


class SeedSelection(NamedTuple):
    positions: jnp.ndarray  # (NL, S) int32 group-coord positions, -1 = unfilled
    min_total: jnp.ndarray  # (NL,) uint32 minimum total frequency
    complete: jnp.ndarray  # (NL,) bool — all S seeds selected (non-degenerate)
    degenerate: jnp.ndarray  # (NL,) bool — DP had < 2 columns (reference UB region)


def select_qgrams(
    freqs: jnp.ndarray,  # (NL, NGmax) uint32 per-group seed frequencies
    group_sizes: jnp.ndarray,  # (NL,) int32 true seeds per group (ng)
    occurrence_table_size: jnp.ndarray,  # () int32
    params: FilterParams,
) -> SeedSelection:
    NL, NGmax = freqs.shape
    S = params.num_qgrams  # seeds to select = R - 1
    R = S + 1
    sl = params.seed_span
    NC = params.max_dp_cols
    sentinel = occurrence_table_size.astype(jnp.uint32)

    # Cell (row, col) reads freqs[col+(row-1)*sl-1] — a STATIC position, so
    # each input is a plain row slice of the transposed table (an
    # index-array gather here materialized a (NC-1, R-1, NL) tensor in HBM
    # for no reason; static slices fuse into the sweep).
    freqs_t = freqs.astype(jnp.uint32).T  # (NGmax, NL)

    def xs(col, row):  # static row slice, fused
        return freqs_t[min(max(col + row * sl - 1, 0), NGmax - 1)]

    # Fully unrolled column sweep (NC <= ~40 static columns): the loop
    # body is a handful of (NL,) vector ops per row, so unrolling lets XLA
    # fuse across columns instead of paying per-iteration loop overhead.
    m_prev = [jnp.zeros((NL,), jnp.uint32)] + [
        jnp.broadcast_to(sentinel, (NL,)) for _ in range(R - 1)
    ]
    vert_list = []
    m_last_list = []
    for col in range(1, NC):
        rows = [jnp.zeros((NL,), jnp.uint32)]
        decisions = [jnp.zeros((NL,), jnp.bool_)]  # row 0: never vertical
        for row in range(1, R):
            with_new = rows[row - 1] + xs(col, row - 1)  # uint32 wrap
            horiz = m_prev[row]
            take_vertical = with_new < horiz
            rows.append(jnp.where(take_vertical, with_new, horiz))
            decisions.append(take_vertical)
        m_prev = rows
        vert_list.append(jnp.stack(decisions, axis=1))
        m_last_list.append(rows[R - 1])
    vert_cols = jnp.stack(vert_list, axis=0)  # (NC-1, NL, R)
    m_last = jnp.stack(m_last_list, axis=0)  # (NC-1, NL)

    # Per-lane true column count and result column.
    nc_lane = group_sizes - S * sl + 2  # (NL,)
    degenerate = nc_lane < 2
    final_col = jnp.clip(nc_lane - 1, 1, NC - 1)
    # m_last: (NC-1, NL); per-lane result column via a select chain
    # instead of a strided per-lane gather.
    min_total = m_last[0]
    for c in range(1, NC - 1):
        min_total = jnp.where(final_col - 1 == c, m_last[c], min_total)
    # Degenerate groups (NC < 2): the reference's DP never runs and its
    # result cell M[R-1][0] is the occurrence_table_size sentinel, which it
    # still adds to the pre-filter counter (src/filter.c:9,202).
    min_total = jnp.where(degenerate, sentinel, min_total)

    # Traceback (src/filter.c:29-41): from (R-1, final_col) slide left over
    # horizontal decisions, take the vertical, move up — S iterations.
    # "Slide left" is precomputed as lastv[row, col] = max col' <= col with
    # a vertical decision in this row (or 0 = the col-0 stop sentinel).
    vert = jnp.concatenate(
        [jnp.zeros((1, NL, R), jnp.bool_), vert_cols], axis=0
    )  # (NC, NL, R), col-0 decisions are stops
    col_ids = jnp.arange(NC, dtype=jnp.int32)[:, None, None]
    lastv = jax.lax.cummax(
        jnp.where(vert, col_ids, 0), axis=0
    )  # (NC, NL, R)

    selected = jnp.full((NL, S), -1, jnp.int32)
    col = final_col
    ok = ~degenerate
    for row in range(R - 1, 0, -1):
        # c* = last vertical column in this row at or left of `col`.
        lv = lastv[:, :, row]  # (NC, NL)
        colc = jnp.clip(col, 0, NC - 1)
        c_star = lv[0]
        for c in range(1, NC):
            c_star = jnp.where(colc == c, lv[c], c_star)
        hit = ok & (c_star > 0)
        pos = c_star + (row - 1) * sl - 1
        slot = (R - 1) - row
        selected = selected.at[:, slot].set(jnp.where(hit, pos, -1))
        col = c_star  # vertical moves up in the same column
        ok = hit
    complete = jnp.all(selected >= 0, axis=1) & ~degenerate
    return SeedSelection(selected, min_total, complete, degenerate)
