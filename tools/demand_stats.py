"""Measure the candidate filter's real slab demand distributions.

The padded per-(read, strand, group) occurrence slab is mostly empty on
real data. This tool quantifies exactly what the device program must
provision, on the bench workload (46 Mb / 30%-repeat genome,
100 bp reads with the HONEST max_errors=e budget):

  * per-(lane, group) ALIGNED occurrence-slot demand (each selected
    seed's occurrence run covers whole 8-pair rows, so demand is the sum
    of per-seed ceil((off%8 + freq)/8)*8 — the quantity cap_occ bounds);
  * per-lane post-vote/dedup candidate count (bounds cap_cand);
  * per-read total candidate count (bounds verify_per_read);
  * per-read accepted-mapping count (bounds accept_per_read).

Runs entirely on CPU (no device compiles). Output: percentile tables +
recommended tier-0 caps and retry-ladder rungs.

Usage: python tools/demand_stats.py [--e 5] [--reads 4096]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def pct_table(name, x, pcts=(50, 90, 99, 99.9, 99.99, 100)):
    x = np.asarray(x)
    vals = [np.percentile(x, p) for p in pcts]
    row = "  ".join(f"p{p}={v:.1f}" for p, v in zip(pcts, vals))
    print(f"{name:34s} mean={x.mean():7.2f}  {row}")
    return dict(zip(pcts, vals))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--e", type=int, default=5)
    ap.add_argument("--a", type=int, default=1)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--max-errors", type=int, default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from fem_tpu.config import FemArgs
    from fem_tpu.ops.hashing import (
        ambiguous_base_counts,
        reverse_complement,
        seed_hashes,
    )
    from fem_tpu.ops.seed_select import select_qgrams
    from fem_tpu.ops.types import FilterParams, device_index_from_host
    from tools.profile_stages import build_workload

    me = args.e if args.max_errors is None else args.max_errors
    ref, index, codes_np, lengths_np = build_workload(args.reads, me)
    fa = FemArgs(error_threshold=args.e, num_additional_qgrams=args.a)
    params = FilterParams.from_args(fa, codes_np.shape[1], cap_occ=8,
                                    cap_cand=8)
    dindex = device_index_from_host(index, ref)

    codes = jnp.asarray(codes_np)
    lengths = jnp.asarray(lengths_np.astype(np.int32))
    neg = reverse_complement(codes, lengths)
    both = jnp.concatenate([codes, neg], axis=0)
    lens2 = jnp.concatenate([lengths, lengths], axis=0)
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)

    # Mirror generate_candidates' geometry up to the selected-seed
    # attributes (fem_tpu/ops/candidates.py:106-175), then compute the
    # aligned demand in numpy.
    NB = both.shape[0]
    G = params.step_size
    NG = params.max_group_size
    S = params.num_qgrams
    num_seeds = lens2 - params.kmer_size + 1
    p = jnp.arange(NG, dtype=jnp.int32)
    si = jnp.arange(G, dtype=jnp.int32)
    read_pos = si[:, None] + p[None, :] * params.step_size
    seed_idx = jnp.clip(read_pos, 0, hashes.shape[1] - 1)
    group_hashes = hashes[:, seed_idx]
    group_sizes = jnp.maximum(
        (num_seeds[:, None] - jnp.arange(G, dtype=jnp.int32)[None, :])
        // params.step_size,
        0,
    )
    freqs = jnp.take(dindex.freq_table, group_hashes, mode="clip").astype(
        jnp.uint32
    )
    sel = select_qgrams(
        freqs.reshape(NB * G, NG), group_sizes.reshape(NB * G),
        dindex.num_occurrences, params,
    )
    sel_p = np.asarray(sel.positions).reshape(NB, G, S)
    complete = np.asarray(sel.complete).reshape(NB, G)

    gh = np.asarray(group_hashes)
    # dindex no longer ships the flat lookup table (csr_rows carries both
    # CSR bounds); rebuild the flat view for the host-side stats.
    csr = np.asarray(dindex.csr_rows)
    lookup = np.concatenate([csr[:, 0], csr[-1:, 1]])
    freq_np = np.asarray(freqs)
    sel_pc = np.clip(sel_p, 0, NG - 1)
    bi = np.arange(NB)[:, None, None]
    gi = np.arange(G)[None, :, None]
    sel_hash = gh[bi, gi, sel_pc]
    sfreq = freq_np[bi, gi, sel_pc].astype(np.int64)
    soff = lookup[np.clip(sel_hash, 0, lookup.shape[0] - 1)].astype(np.int64)
    mappable = (
        (np.asarray(num_seeds) > 0)
        & (S <= np.asarray(num_seeds) // params.step_size)
        & (np.asarray(amb) <= args.e)
    )
    lane_ok = mappable[:, None] & complete
    srow = soff & 7
    fc8 = np.where(
        (sfreq > 0) & lane_ok[..., None], ((srow + sfreq + 7) // 8) * 8, 0
    )
    demand_lg = fc8.sum(axis=2)  # (NB, G) aligned slots per lane-group
    true_lg = np.where(lane_ok[..., None], sfreq, 0).sum(axis=2)

    print(f"\n== workload: {args.reads} reads, e={args.e}, max_errors={me}, "
          f"S={S} seeds/group, G={G} groups ==")
    d = pct_table("aligned occ demand /lane-group", demand_lg.ravel())
    pct_table("true occurrences   /lane-group", true_lg.ravel())
    util = true_lg.sum() / max(demand_lg.sum(), 1)
    print(f"  8-alignment efficiency: {util:.1%} "
          f"(true pairs / aligned slots)")
    for cap in (56, 64, 72, 80, 96, 128, 160, 256):
        ov = (demand_lg > cap).any(axis=1)
        ov_read = ov[: NB // 2] | ov[NB // 2 :]
        print(f"  cap_occ={cap:4d}: lane-group overflow "
              f"{(demand_lg > cap).mean():7.3%}  -> read retry rate "
              f"{ov_read.mean():7.3%}")

    # Candidate counts: run the real filter at generous caps.
    from fem_tpu.ops.candidates import generate_candidates

    params_big = FilterParams.from_args(fa, codes_np.shape[1], cap_occ=1024,
                                        cap_cand=256, cap_vote=1024)
    res = generate_candidates(both, lens2, hashes, amb, dindex, params_big)
    nc = np.asarray(res.num_candidates)
    fb = np.asarray(res.needs_fallback)
    print(f"\n  filter fallbacks at cap 1024/256: {fb.sum()} lanes")
    pct_table("candidates /lane (post vote+dedup)", nc)
    nread = nc[: NB // 2] + nc[NB // 2 :]
    pct_table("candidates /read (both strands)", nread)
    for cc in (8, 16, 32, 64):
        print(f"  cap_cand={cc:3d}: lane overflow {(nc > cc).mean():7.3%}")
    B = NB // 2
    for vpr in (2, 3, 4, 6, 8):
        print(f"  verify_per_read={vpr}: batch demand "
              f"{nread.sum()}/{2 * B * vpr}"
              f" ({nread.sum() / (2 * B * vpr):.1%} of slab)")


if __name__ == "__main__":
    main()
