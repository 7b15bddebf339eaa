"""Test configuration.

Tests run on the CPU by default, on a virtual 8-device CPU mesh so
multi-device sharding is exercised without accelerators (per SURVEY.md
§4). Tests marked `gpu` need the card: they take the `gpu` fixture,
which skips them without one, and run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from fem_tpu import sim  # noqa: E402
from fem_tpu.config import FemArgs  # noqa: E402
from fem_tpu.index.build import build_index  # noqa: E402
from fem_tpu.io import fastx  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one"
    )


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform!r}")
    return dev


@pytest.fixture(scope="session")
def small_reference(tmp_path_factory):
    """A 200 kb, 2-chromosome random genome with a repeated segment (so
    all-mapping multi-hit behavior is exercised) and a few Ns."""
    seqs = sim.random_genome(200_000, num_seqs=2, seed=7, n_fraction=0.0005)
    # Plant an exact repeat: copy 300 bases of chr0 into chr1.
    name0, s0 = seqs[0]
    name1, s1 = seqs[1]
    s1 = s1[:40_000] + s0[10_000:10_300] + s1[40_300:]
    seqs = [(name0, s0), (name1, s1)]
    path = tmp_path_factory.mktemp("ref") / "ref.fa"
    sim.write_fasta(str(path), seqs)
    ref = fastx.read_fasta(str(path))
    return seqs, ref


@pytest.fixture(scope="session")
def small_index(small_reference):
    _, ref = small_reference
    return build_index(ref, kmer_size=12, step_size=3)


@pytest.fixture(scope="session")
def default_args():
    return FemArgs(kmer_size=12, step_size=3, error_threshold=2, num_additional_qgrams=1)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
