"""Multi-host execution: one process per host, SPMD over a global mesh.

The reference's scaling unit is a pthread worker consuming disjoint read
batches with a replicated read-only index and a stats-only merge at join
(src/FEM_map.c:145,182-212). Across hosts the device equivalent keeps
that shape: every host streams a disjoint, deterministic subset of the
read file into its local devices, writes its own SAM shard (no cross-host
record traffic), and the five MappingStats counters allreduce once at the
end of the stream over the `jax.distributed` coordination service.

Two operating modes:

* **independent** (default): each host runs the single-host engine over a
  host-local mesh. Zero cross-host communication during mapping — the
  exact analogue of the reference's zero inter-worker communication —
  so scaling efficiency is bounded only by input skew.
* **global mesh**: one `Mesh` spanning all hosts' devices (data-parallel
  and/or coordinate-sharded index axes). Each host feeds its addressable
  shard of the global batch via `jax.make_array_from_process_local_data`
  and drains only its addressable output shards. Required when the
  occurrence table is coordinate-sharded across hosts (GRCh38-scale,
  SURVEY.md §5.7) and the filter's lexicographic pmax crosses hosts.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class HostContext:
    num_hosts: int
    host_id: int
    initialized: bool  # jax.distributed active (False for the 1-host path)


def initialize(
    coordinator: Optional[str],
    num_hosts: int,
    host_id: int,
    local_device_count: Optional[int] = None,
) -> HostContext:
    """Bring up jax.distributed. Call before any other JAX use (the
    backend must not be initialized yet). A `num_hosts == 1` context is a
    no-op so single-host runs take the exact same code path.

    With `coordinator=None` and `num_hosts > 1` the context is a *local
    worker*: one of several independent processes that each map an
    interleaved share of the batches on devices of their own. No
    jax.distributed: the caller merges SAM shards and counters."""
    if num_hosts <= 1:
        return HostContext(1, 0, False)
    if coordinator is None:
        return HostContext(num_hosts, host_id, False)
    import jax

    kwargs = {}
    if local_device_count is not None:
        kwargs["num_local_devices"] = local_device_count
    jax.distributed.initialize(
        coordinator, num_processes=num_hosts, process_id=host_id, **kwargs
    )
    return HostContext(num_hosts, host_id, True)


def shard_batches(batches: Iterable, ctx: HostContext) -> Iterator:
    """Deterministic interleaved batch assignment: host h maps batches
    h, h+N, h+2N, ... — disjoint, order-stable, and resumable with the
    same arithmetic the checkpoint file uses."""
    for i, b in enumerate(batches):
        if i % ctx.num_hosts == ctx.host_id:
            yield b


def shard_path(path: str, ctx: HostContext) -> str:
    """Per-host SAM shard name. Each shard carries the full header, so
    shards are independently valid SAM files; `samtools cat`-style
    concatenation (or any record-set consumer) merges them."""
    if ctx.num_hosts == 1 or path == "-":
        return path
    return f"{path}.host{ctx.host_id:04d}"


def allreduce_stats(stats, ctx: HostContext):
    """Sum the five MappingStats counters over all hosts (the reference's
    per-thread stats rollup at join, src/FEM_map.c:200-212, as one
    allgather over the coordination service)."""
    from fem_tpu.golden.model import MappingStats

    if not ctx.initialized:
        return stats
    import jax
    from jax.experimental import multihost_utils

    local = np.array(
        [
            stats.num_reads,
            stats.num_mapped_reads,
            stats.num_candidates_without_additional_qgram_filter,
            stats.num_candidates,
            stats.num_mappings,
        ],
        dtype=np.int64,
    )
    gathered = np.asarray(multihost_utils.process_allgather(local))
    tot = gathered.reshape(ctx.num_hosts, 5).sum(axis=0)
    return MappingStats(
        num_reads=int(tot[0]),
        num_mapped_reads=int(tot[1]),
        num_candidates_without_additional_qgram_filter=int(tot[2]),
        num_candidates=int(tot[3]),
        num_mappings=int(tot[4]),
    )


def allreduce_min(value: int, ctx: HostContext) -> int:
    """Min of an integer over all hosts (used to agree on a common resume
    offset in global-mesh mode, where every submit is a collective and all
    processes must consume the identical batch stream)."""
    if not ctx.initialized:
        return value
    from jax.experimental import multihost_utils

    gathered = np.asarray(
        multihost_utils.process_allgather(np.array([value], dtype=np.int64))
    )
    return int(gathered.min())


def barrier(ctx: HostContext, name: str = "fem") -> None:
    if not ctx.initialized:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def local_data_mesh():
    """Host-local data-parallel mesh (independent mode): shard_map over
    this host's addressable devices only."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.local_devices()), ("data",))


def global_index_mesh(n_index_shards: int):
    """Global ('data', 'index') mesh over ALL processes' devices for the
    coordinate-sharded index (GRCh38-scale occurrence tables, SURVEY.md
    §5.7). Devices are laid out so each data row interleaves processes:
    the index axis (whose lexicographic pmax + row all_gather are the only
    collectives in the mapping step) crosses hosts."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n_proc = max(jax.process_count(), 1)
    total = len(devs)
    if total % n_index_shards:
        raise ValueError(
            f"{total} devices not divisible by {n_index_shards} index shards"
        )
    n_dp = total // n_index_shards
    grid = (
        np.array(devs)
        .reshape(n_proc, total // n_proc)
        .T.reshape(n_dp, n_index_shards)
    )
    return Mesh(grid, ("data", "index"))
