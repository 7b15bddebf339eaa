"""Multi-chip execution: SPMD sharding of the mapping step.

The reference scales with N pthread workers over disjoint 10k-read batches
sharing a read-only index, merging only per-thread counters at join
(src/FEM_map.c:145,182-212, src/map.c) — zero inter-worker communication.
The device equivalent is data parallelism over a `jax.sharding.Mesh`:
reads shard across the `data` axis, the index is replicated per device,
and the five MappingStats counters are `psum`s over the mesh. Per-shard
verify slabs stay sharded; the host drains each shard's accepted hits.

Coordinate-sharded indexes (GRCh38-scale occurrence tables split across
devices by chromosome, SURVEY.md §5.7) layer on top of this: each shard
generates candidates for its coordinate range and hit sets concatenate
along the same lanes; see fem_tpu/parallel/sharded_index.py.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fem_tpu.ops.types import DeviceIndex, FilterParams
from fem_tpu.pipeline.engine import map_core

DATA_AXIS = "data"


def make_mesh(devices: Sequence[jax.Device] | None = None, axis: str = DATA_AXIS) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis,))


def make_sharded_map_fn(
    mesh: Mesh,
    params: FilterParams,
    verify_cap_per_shard: int,
    verify: str,
    accept_cap: int = 4096,
    axis: str = DATA_AXIS,
):
    """Build a jitted, shard_mapped full mapping step.

    Inputs: (index replicated, codes/lengths sharded on the batch axis).
    Outputs: verify slabs concatenated across shards (lane ids globalized),
    per-read arrays in global batch order, and psum'd scalar totals.
    """
    n = mesh.shape[axis]

    def shard_fn(index: DeviceIndex, packed_in: jnp.ndarray):
        codes = packed_in[:, :-4]
        lb = packed_in[:, -4:].astype(jnp.int32)
        lengths = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
        out = map_core(
            index, codes, lengths, params, verify_cap_per_shard, verify,
            accept_cap,
        )
        # Globalize accepted-hit lane ids: local lanes are [0, 2*Bloc) with
        # strand-major halves; global ids keep strand-major halves over the
        # global batch so the host's grouping logic is shard-agnostic.
        Bloc = codes.shape[0]
        shard = jax.lax.axis_index(axis)
        l = out["a_lane"]
        strand = (l >= Bloc).astype(jnp.int32)
        out["a_lane"] = strand * (n * Bloc) + shard * Bloc + (l - strand * Bloc)
        out["total_candidates"] = jax.lax.psum(out["total_candidates"], axis)
        from fem_tpu.pipeline.engine import pack_outputs

        return pack_outputs(out)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)
