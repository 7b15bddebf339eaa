"""Bitonic sorting network for the candidate filter's slab sorts.

A hand-rolled bitonic network in place of `lax.sort` inside the fused
candidate pipeline: ordinary vectorized compare-exchange,
log2(n)*(log2(n)+1)/2 stages of reshape-swap + select over the minor
axis, which XLA fuses with the surrounding producers/consumers like any
elementwise chain. How it compares with `lax.sort` on the H100 is not
measured.

Semantics: ascending lexicographic by (key1, key2). Exchanges compare
strictly, so equal keys never swap — with *equal payloads under equal
keys* (the only way the filter uses it: validity is derivable from the
sid sentinel) the result is indistinguishable from stable `lax.sort`.
Width pads to the next power of two with (+inf, +inf) sentinel keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, not jnp: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed bring-up.
_MAX32 = np.int32(2**31 - 1)


def bitonic_sort_2key(k1: jnp.ndarray, k2: jnp.ndarray, *payloads: jnp.ndarray):
    """Sort along the last axis by (k1, k2) ascending, carrying payloads.

    Both keys must be int32 with values < 2^31-1 (the pad sentinel).
    Returns (k1, k2, *payloads) sorted. Not stable, but exchanges are
    tie-consistent: equal-key pairs never move relative to each other.
    """
    n = k1.shape[-1]
    np2 = 1 << (n - 1).bit_length()
    pad = np2 - n
    if pad:
        shape = k1.shape[:-1] + (pad,)
        k1 = jnp.concatenate([k1, jnp.full(shape, _MAX32, k1.dtype)], axis=-1)
        k2 = jnp.concatenate([k2, jnp.full(shape, _MAX32, k2.dtype)], axis=-1)
        payloads = tuple(
            jnp.concatenate([p, jnp.zeros(shape, p.dtype)], axis=-1)
            for p in payloads
        )
    arrs = [k1, k2, *payloads]
    ndim = arrs[0].ndim
    lane = jax.lax.broadcasted_iota(jnp.int32, arrs[0].shape, ndim - 1)

    def exchange(arrs, j, k):
        def partner(x):  # lane ^ j via reshape/reverse (dense, no gather)
            shp = x.shape
            x = x.reshape(shp[:-1] + (np2 // (2 * j), 2, j))
            return x[..., ::-1, :].reshape(shp)

        ps = [partner(x) for x in arrs]
        up = (lane & j) == 0
        asc = (lane & k) == 0
        a1, a2, b1, b2 = arrs[0], arrs[1], ps[0], ps[1]
        gt = (a1 > b1) | ((a1 == b1) & (a2 > b2))
        lt = (a1 < b1) | ((a1 == b1) & (a2 < b2))
        # Ascending block: up lane keeps unless own > partner; down lane
        # keeps unless own < partner. Descending: mirrored.
        keep = jnp.where(asc, jnp.where(up, ~gt, ~lt), jnp.where(up, ~lt, ~gt))
        return [jnp.where(keep, x, px) for x, px in zip(arrs, ps)]

    k = 2
    while k <= np2:
        j = k // 2
        while j >= 1:
            arrs = exchange(arrs, j, k)
            j //= 2
        k *= 2
    if pad:
        arrs = [a[..., :n] for a in arrs]
    return tuple(arrs)
