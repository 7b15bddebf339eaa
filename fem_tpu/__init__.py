"""fem_tpu — an all-mapping short-read engine on JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the FEM
short-read mapper (reference: haowenz/FEM): succinct window/step hash index,
group seeding with optimal prefix q-gram selection, q-gram pigeonhole
candidate filtering, banded Myers bit-parallel edit-distance verification
(edit distance <= 7), CIGAR/MD traceback and SAM output — redesigned for
accelerators: fixed-shape batched device pipelines, a Pallas verification
kernel, and jax.sharding meshes instead of pthreads.
"""

__version__ = "0.1.0"

from fem_tpu.config import FemArgs

__all__ = ["FemArgs", "__version__"]
