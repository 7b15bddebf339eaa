"""Pallas kernel (Triton route) for batched banded Myers verification.

The reference verifies 8 candidates per SSE vector with 16-bit lanes
(src/align.c:149-277, NUM_VPU_LANES=8 at src/align.h:11). Here one GPU
thread carries one (read, candidate) band DP: a block of `BLOCK`
candidates walks the read in a `fori_loop`, holding VP, VN, the error
count and the five per-base match bitvectors (the reference's Peq
register file, src/align.c:176-229) in registers. Each step loads one
text byte and one reference byte per candidate, straight from the read
batch and the flat reference by offset, so no (V, L + 2e) window array
and no (V, L) Eq array ever reach device memory. ed and end are stored
once per candidate.

The loop runs to the longest read of the block; candidates with length
0 (the unused tail of the verify slab) cost nothing, so a block of them
exits at once.

The 3e early-exit (src/align.c:247-252) is dropped, as in the plain
path (fem_tpu/ops/verify.py): it only rejects candidates the full run
also rejects.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from fem_tpu.ops.types import DeviceIndex
from fem_tpu.ops.verify import VerifyResult

BLOCK = 128  # candidates per program (a power of two)
NUM_WARPS = 4
_N_CODES = 5  # A, C, G, T, N — N matches N, as in compute_eq


def _myers_kernel(
    ref_ref,  # (R,) uint8 reference codes, windows addressed by offset
    reads_ref,  # (NR,) uint8 read codes, row-major with `read_stride`
    off_ref,  # (BLOCK,) int32 window start in ref
    base_ref,  # (BLOCK,) int32 text start in reads
    len_ref,  # (BLOCK,) int32 text length (0 = unused slot)
    ed_ref,  # (BLOCK,) int32 out
    end_ref,  # (BLOCK,) int32 out
    *,
    error_threshold: int,
    ref_size: int,
):
    e = error_threshold
    band = 2 * e  # bit index of the newest window byte
    off = off_ref[...]
    base = base_ref[...]
    n = len_ref[...]

    def win(k):  # reference byte k of each candidate's window
        addr = off + k
        ok = addr < ref_size
        return plt.load(ref_ref.at[jnp.where(ok, addr, 0)], mask=ok, other=4)

    def peq_init():
        peq = [jnp.zeros(off.shape, jnp.uint32) for _ in range(_N_CODES)]
        for j in range(band + 1):
            w = win(j)
            for c in range(_N_CODES):
                peq[c] = peq[c] | ((w == c).astype(jnp.uint32) << j)
        return peq

    def step(i, carry):
        VP, VN, nerr, *peq = carry
        t = plt.load(reads_ref.at[base + i])
        eq = peq[_N_CODES - 1]
        for c in range(_N_CODES - 1):
            eq = jnp.where(t == c, peq[c], eq)
        X = eq | VN
        D0 = ((VP + (X & VP)) ^ VP) | X
        HN = VP & D0
        HP = VN | ~(VP | D0)
        X2 = D0 >> 1
        VN_n = X2 & HP
        VP_n = HN | ~(X2 | HP)
        nerr_n = nerr + (1 - (D0 & 1)).astype(jnp.int32)
        active = i < n
        # Slide the band one column: window byte i + 1 + 2e enters at the
        # top bit.
        w = win(i + 1 + band)
        peq = [
            (p >> 1) | ((w == c).astype(jnp.uint32) << band)
            for c, p in enumerate(peq)
        ]
        return (
            jnp.where(active, VP_n, VP),
            jnp.where(active, VN_n, VN),
            jnp.where(active, nerr_n, nerr),
            *peq,
        )

    zero = jnp.zeros(off.shape, jnp.uint32)
    VP, VN, nerr, *_ = jax.lax.fori_loop(
        0, jnp.max(n), step,
        (zero, zero, jnp.zeros(off.shape, jnp.int32), *peq_init()),
    )

    # Final band scan (src/align.c:135-146,257-275): the first strict
    # improvement of the running minimum fixes the end position.
    end = n - 1
    min_err = nerr
    for i in range(band):
        nerr = nerr + ((VP >> i) & 1).astype(jnp.int32)
        nerr = nerr - ((VN >> i) & 1).astype(jnp.int32)
        end = jnp.where(nerr < min_err, n + i, end)
        min_err = jnp.minimum(min_err, nerr)
    ed_ref[...] = min_err
    end_ref[...] = end


def myers_by_offset(
    ref_flat: jnp.ndarray,  # (R,) uint8
    reads_flat: jnp.ndarray,  # (NR,) uint8
    offsets: jnp.ndarray,  # (V,) int32 window starts in ref_flat
    text_starts: jnp.ndarray,  # (V,) int32 text starts in reads_flat
    lengths: jnp.ndarray,  # (V,) int32, 0 for slots to skip
    error_threshold: int,
    interpret: bool = False,
) -> VerifyResult:
    """Banded Myers of text[text_starts[v] : + lengths[v]] against the
    window ref_flat[offsets[v] : + lengths[v] + 2e]. The bytes a window
    reads past the end of `ref_flat` count as N."""
    V = offsets.shape[0]
    Vp = -(-V // BLOCK) * BLOCK

    def pad(x):
        return jnp.pad(x.astype(jnp.int32), (0, Vp - V))

    kernel = functools.partial(
        _myers_kernel, error_threshold=error_threshold,
        ref_size=ref_flat.shape[0],
    )
    blk = pl.BlockSpec((BLOCK,), lambda b: (b,))
    whole = pl.no_block_spec
    ed, end = pl.pallas_call(
        kernel,
        grid=(Vp // BLOCK,),
        in_specs=[whole, whole, blk, blk, blk],
        out_specs=[blk, blk],
        out_shape=[
            jax.ShapeDtypeStruct((Vp,), jnp.int32),
            jax.ShapeDtypeStruct((Vp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="banded_myers",
    )(ref_flat, reads_flat, pad(offsets), pad(text_starts), pad(lengths))
    ed, end = ed[:V], end[:V]
    return VerifyResult(ed, end, ed <= error_threshold)


def banded_myers_pallas(
    window: jnp.ndarray,  # (V, L + 2e) uint8
    text: jnp.ndarray,  # (V, L) uint8
    lengths: jnp.ndarray,  # (V,) int32
    error_threshold: int,
    interpret: bool = False,
) -> VerifyResult:
    """The kernel over explicit windows (same contract as
    `banded_myers(compute_eq(window, text, e), lengths, e)`)."""
    V, L = text.shape
    W = window.shape[1]
    v = jnp.arange(V, dtype=jnp.int32)
    return myers_by_offset(
        window.reshape(-1), text.reshape(-1), v * W, v * L, lengths,
        error_threshold, interpret,
    )


def verify_candidates_pallas(
    index: DeviceIndex,
    sid: jnp.ndarray,  # (V,) int32
    pos: jnp.ndarray,  # (V,) int32 band-start positions
    reads: jnp.ndarray,  # (NB, Lmax) uint8 read codes, both strands
    lane: jnp.ndarray,  # (V,) int32 row of `reads` each candidate verifies
    lengths: jnp.ndarray,  # (V,) int32, 0 for unused slots
    error_threshold: int,
    interpret: bool = False,
) -> VerifyResult:
    """Verify candidates against the resident reference: windows are
    read in the kernel from the index's reference bytes by offset."""
    ref_flat = jax.lax.bitcast_convert_type(index.ref_rows, jnp.uint8).reshape(-1)
    base = jnp.take(
        index.ref_offsets, jnp.clip(sid, 0, index.ref_offsets.shape[0] - 1)
    )
    return myers_by_offset(
        ref_flat, reads.reshape(-1), base + pos, lane * reads.shape[1],
        lengths, error_threshold, interpret,
    )
