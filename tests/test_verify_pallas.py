"""Pallas Myers kernel vs the plain jnp reference (`banded_myers`).

The comparison is exact: this is an integer bit-parallel DP with no
floating point and no matrix product, so no tolerance (and no TF32
question) arises. On the CPU the kernel runs through the Pallas
interpreter; `test_kernel_compiled_on_gpu` runs the compiled kernel and
skips without a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.ops.verify import banded_myers, compute_eq
from fem_tpu.ops.verify_pallas import banded_myers_pallas


def _case(rng, V, L, e):
    window = rng.integers(0, 5, size=(V, L + 2 * e)).astype(np.uint8)
    text = rng.integers(0, 5, size=(V, L)).astype(np.uint8)
    # Half the candidates: mutated diagonal copies so some accept.
    for i in range(0, V, 2):
        text[i] = window[i, e : e + L]
        for _ in range(rng.integers(0, e + 2)):
            text[i, rng.integers(0, L)] = rng.integers(0, 4)
    lengths = rng.integers(40, L + 1, size=V).astype(np.int32)
    return window, text, lengths


def _assert_equal(window, text, lengths, e, interpret):
    ref = banded_myers(
        compute_eq(jnp.asarray(window), jnp.asarray(text), e),
        jnp.asarray(lengths), e,
    )
    out = banded_myers_pallas(
        jnp.asarray(window), jnp.asarray(text), jnp.asarray(lengths), e,
        interpret=interpret,
    )
    for field in ("edit_distance", "end_offset", "accepted"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out, field)), np.asarray(getattr(ref, field)),
            err_msg=field,
        )
    assert np.asarray(ref.accepted).sum() > 0


@pytest.mark.parametrize("e", [0, 2, 5, 7])
def test_pallas_matches_jnp(e, rng):
    # V deliberately not a multiple of the kernel's block.
    _assert_equal(*_case(rng, 300, 100, e), e, interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("e", [0, 5])
def test_kernel_compiled_on_gpu(e, gpu):
    _assert_equal(*_case(np.random.default_rng(e), 20_000, 150, e), e,
                  interpret=False)
