"""The batched mapping engine: device pipeline + host emission.

Replaces the reference's pthread worker loop (src/map.c:3-71): reads are
padded into fixed-shape batches, both strands are mapped by one jitted
device program (hash -> q-gram DP -> candidate filter -> banded Myers),
and the small accepted-hit set comes back to the host for traceback and
SAM emission. Reads that exceed a static device capacity (occurrence slab,
candidate list, or verify slots) fall back to the golden scalar path, so
the ALL-mappings guarantee survives fixed shapes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.config import FemArgs
from fem_tpu.golden.model import GoldenMapper, GoldenMapping, MappingStats, read_strands
from fem_tpu.index.storage import FemIndex
from fem_tpu.io.fastx import ReadBatch, Reference
from fem_tpu.ops.candidates import generate_candidates
from fem_tpu.ops.hashing import ambiguous_base_counts, reverse_complement, seed_hashes
from fem_tpu.ops.types import DeviceIndex, FilterParams, device_index_from_host
from fem_tpu.ops.verify import verify_candidates_jnp


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """One rung of the capacity-retry ladder: a compiled program shape.

    Reads whose occurrence/candidate/verify/accept demand exceeds a tier's
    static slabs are remapped at the next tier (smaller batch, bigger
    caps); beyond the last tier the exact host mapper takes over. This is
    how fixed XLA shapes preserve the reference's unbounded-merge semantics
    (src/filter.c:80-131) on heavy-tailed occurrence distributions
    (satellite repeats: seed frequencies 10^3-10^5)."""

    batch_size: int
    cap_occ: int
    cap_cand: int
    verify_per_read: float  # slab slots per read = 2*batch*value (int'ed)
    accept_per_read: float
    cap_vote: int = 0  # 0 = same as cap_occ (no compaction win, never
    # overflows; tier-0 sets a tight width from the true-pair distribution)


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 10000  # reads per device batch (src/FEM_map.c:151)
    cap_occ: int = 256
    cap_cand: int = 256
    cap_vote: int = 0  # compacted vote-slab width; 0 = cap_occ
    verify_per_read: int = 16  # verify slots per read-strand lane (avg)
    accept_per_read: float = 4  # accepted-mapping slots per read (avg);
    # fractional values right-size the fetch payload: the batch SUM of
    # accepted hits concentrates (sigma ~ sqrt(B)), so e.g. 0.85 (= 1.7
    # slots/read) is ~20 sigma above the bench workload's measured 1.45
    # mappings/read -- and overflow just retries at tier 1
    pipeline_depth: int = 4  # batches in flight (device + drain threads)
    verify: str | None = None  # verify implementation, see resolve_verify
    mesh: object | None = None  # jax.sharding.Mesh for multi-chip data parallelism
    index_mesh: object | None = None  # 2D ('data','index') Mesh: reads data-
    # parallel + coordinate-sharded index (GRCh38-scale genomes)
    tiers: tuple[TierConfig, ...] | None = None  # retry ladder above tier 0;
    # None = auto-derived (see MappingEngine._default_tiers). () disables
    # device retries: overflow reads go straight to the host mapper.


def map_core(
    index: DeviceIndex,
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    params: FilterParams,
    verify_cap: int,
    verify: str = "plain",
    accept_cap: int = 4096,
    index_axis: str | None = None,
):
    """The full per-batch mapping step, both strands, as one traceable
    function: hash -> DP seed selection -> candidate filter -> verify.
    Shard-mappable over the batch (read) axis; `verify_cap` is per shard.
    `verify` is a value returned by `resolve_verify`."""
    e = params.error_threshold
    B, Lmax = codes.shape
    # pack_outputs carries the band-end offset (< Lmax + 2e) in 13 bits.
    assert Lmax + 2 * e < (1 << 13), "read length exceeds packed end field"
    neg = reverse_complement(codes, lengths)
    both = jnp.concatenate([codes, neg], axis=0)  # (2B, Lmax)
    lens2 = jnp.concatenate([lengths, lengths], axis=0)
    hashes = seed_hashes(both, params.kmer_size)
    amb = ambiguous_base_counts(both, lens2, params.kmer_size)
    cand = generate_candidates(
        both, lens2, hashes, amb, index, params, index_axis=index_axis,
    )

    # Compact valid candidates into the verify slab. Flat order is
    # (lane-major, ascending position) — candidate order per strand is
    # preserved, which the mapping sort's stability relies on.
    NB, CC = cand.cand_valid.shape
    flat_valid = cand.cand_valid.reshape(-1)
    order = jnp.cumsum(flat_valid.astype(jnp.int32)) - 1
    total = flat_valid.sum().astype(jnp.int32)
    slot = jnp.where(flat_valid, order, verify_cap)  # OOB scatters drop
    lane_of = jnp.broadcast_to(
        jnp.arange(NB, dtype=jnp.int32)[:, None], (NB, CC)
    ).reshape(-1)
    v_lane = jnp.zeros((verify_cap,), jnp.int32).at[slot].set(lane_of)
    v_sid = jnp.zeros((verify_cap,), jnp.int32).at[slot].set(
        cand.cand_sid.reshape(-1)
    )
    v_pos = jnp.zeros((verify_cap,), jnp.int32).at[slot].set(
        cand.cand_pos.reshape(-1)
    )
    in_use = jnp.arange(verify_cap, dtype=jnp.int32) < jnp.minimum(total, verify_cap)
    with jax.named_scope("verify"):  # trace name read by tools/trace_share.py
        if verify == "plain":
            v_text = jnp.take(both, v_lane, axis=0)
            v_len = jnp.take(lens2, v_lane)
            vres = verify_candidates_jnp(index, v_sid, v_pos, v_text, v_len, e)
        else:
            from fem_tpu.ops.verify_pallas import verify_candidates_pallas

            # Slots past `total` get length 0: the kernel skips their steps.
            v_len = jnp.where(in_use, jnp.take(lens2, v_lane), 0)
            vres = verify_candidates_pallas(
                index, v_sid, v_pos, both, v_lane, v_len, e,
                interpret=verify == "interpret",
            )
    accepted = vres.accepted & in_use

    # Compact accepted hits on-device so the host fetch stays small. Slab
    # order (lane-major, ascending) is preserved.
    acc_cap = max(accept_cap, 8)
    a_order = jnp.cumsum(accepted.astype(jnp.int32)) - 1
    n_accepted = accepted.sum().astype(jnp.int32)
    a_slot = jnp.where(accepted, a_order, acc_cap)  # OOB scatters drop

    def compact(x):
        return jnp.zeros((acc_cap,), x.dtype).at[a_slot].set(x)

    # Per-read full-coverage test: verify slots and accepted-hit slots fill
    # in lane-major slab order, so both truncations (verify_cap, acc_cap)
    # cut a *prefix* of lanes. A read is fully covered iff both of its
    # lanes' candidate spans end within verify_cap AND both lanes' accepted
    # hits end within acc_cap; the rest carry a per-read retry flag and are
    # remapped at a higher-capacity tier (the reference's filter has no
    # static caps at all, src/filter.c:80-131 — this retry ladder is how
    # fixed shapes keep the ALL-mappings guarantee).
    cum_v = jnp.cumsum(cand.cand_valid.sum(axis=1, dtype=jnp.int32))
    ok_v = cum_v <= verify_cap
    acc_per_lane = jnp.zeros((NB,), jnp.int32).at[v_lane].add(
        accepted.astype(jnp.int32)
    )
    ok_a = jnp.cumsum(acc_per_lane) <= acc_cap
    ok_lane = ok_v & ok_a
    retry = ~(ok_lane[:B] & ok_lane[B:])  # (B,) per read

    return {
        "slab_overflow": (
            (total > verify_cap) | (n_accepted > acc_cap)
        ).reshape(1),
        "retry": retry,
        "a_lane": compact(v_lane),
        "a_sid": compact(v_sid),
        "a_pos": compact(v_pos),
        "a_ed": compact(vres.edit_distance),
        "a_end": compact(vres.end_offset),
        "n_accepted": n_accepted.reshape(1),
        "num_candidates": cand.num_candidates,
        "dp_total": cand.dp_total,
        "needs_fallback": cand.needs_fallback,
        "inherent_fallback": cand.inherent_fallback,
        "total_candidates": total,
    }


def pack_outputs(out: dict) -> jnp.ndarray:
    """Fuse all mapping outputs into one uint32 vector, so one fetch
    brings a batch's results to the host. Every field is packed into
    natural u32 words (10 B/hit): per-hit pos, (lane<<16|sid), and a
    16-bit (ed<<13|end) field carried two hits per word (ED <= 7 needs 3
    bits, the band-end offset < Lmax + 2e needs <= 13). Per-lane counters
    collapse to on-device masked sums (lanes of fallback reads excluded —
    those reads are remapped in full at a higher tier), and fallback flags
    travel as a per-read bitmap in u32 words. Whether this layout still
    pays on the H100 is not measured.

    Layout per shard segment (uint32 words):
      [0:6)   header: n_accepted, slab_overflow, total_candidates,
              sum_nc, dp_lo16, dp_hi16 (dp sums split 16/16 so 2^32
              lane-sum overflow is impossible)
      [6:)    a_pos (A) | a_lane<<16|a_sid (A) |
              (ed<<13|end) 16-bit x2 per word (ceil(A/2)) |
              fallback bitmap (ceil(B/32)) | inherent bitmap (ceil(B/32))

    The fallback bitmap marks every read whose records were dropped (its
    lanes overflowed a slab OR hit an inherent limit); the inherent bitmap
    marks the subset no capacity tier can fix (shard-halo risk, incomplete
    DP) — the drain routes those straight to the exact host mapper instead
    of escalating them through the retry ladder (they would re-flag at
    every rung, lazily compiling each tier program for nothing).
    """
    NB = out["num_candidates"].shape[0]
    B = NB // 2
    inh_read = out["inherent_fallback"][:B] | out["inherent_fallback"][B:]
    fb_read = (
        out["needs_fallback"][:B] | out["needs_fallback"][B:] | out["retry"]
        | inh_read
    )
    mask = jnp.concatenate([~fb_read, ~fb_read]).astype(jnp.uint32)
    nc = out["num_candidates"].astype(jnp.uint32) * mask
    dp = out["dp_total"] * mask
    sum_nc = jnp.sum(nc)
    dp_lo = jnp.sum(dp & jnp.uint32(0xFFFF))
    dp_hi = jnp.sum(dp >> 16)
    header = jnp.stack(
        [
            out["n_accepted"].reshape(()).astype(jnp.uint32),
            out["slab_overflow"].reshape(()).astype(jnp.uint32),
            out["total_candidates"].reshape(()).astype(jnp.uint32),
            sum_nc,
            dp_lo,
            dp_hi,
        ]
    )
    pad = (-B) % 32

    def bitmap(bits):
        b = jnp.concatenate([bits, jnp.zeros((pad,), bool)]).reshape(-1, 32)
        return jnp.sum(
            b.astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32), axis=1
        ).astype(jnp.uint32)

    fb_words = bitmap(fb_read)
    inh_words = bitmap(inh_read)
    lane_sid = (
        (out["a_lane"].astype(jnp.uint32) << 16)
        | (out["a_sid"].astype(jnp.uint32) & 0xFFFF)
    )
    ed_end = (
        (out["a_ed"].astype(jnp.uint32) << 13)
        | (out["a_end"].astype(jnp.uint32) & 0x1FFF)
    )
    if ed_end.shape[0] & 1:
        ed_end = jnp.concatenate([ed_end, jnp.zeros((1,), jnp.uint32)])
    ed_end2 = (ed_end[1::2] << 16) | ed_end[0::2]
    vec = jnp.concatenate(
        [header, out["a_pos"].astype(jnp.uint32), lane_sid, ed_end2, fb_words,
         inh_words]
    )
    # (rows, 128) u32 output padded to whole 1024-word blocks. Padding
    # rule must match packed_segment_size.
    size = -(-vec.shape[0] // 1024) * 1024
    vec = jnp.concatenate(
        [vec, jnp.zeros((size - vec.shape[0],), jnp.uint32)]
    )
    return vec.reshape(-1, 128)


def _fb_len(NB: int) -> int:
    return (NB // 2 + 31) // 32


def packed_segment_words(acc_cap: int, NB: int) -> int:
    """True payload length in uint32 words (fallback + inherent bitmaps)."""
    return 6 + 2 * acc_cap + (acc_cap + 1) // 2 + 2 * _fb_len(NB)


def packed_segment_size(acc_cap: int, NB: int) -> int:
    """Padded per-segment element count: rows of 128 u32 words, rows a
    multiple of 8."""
    return -(-packed_segment_words(acc_cap, NB) // 1024) * 1024


def unpack_outputs(flat: np.ndarray, acc_cap: int, NB: int, nshards: int) -> dict:
    """Invert pack_outputs; with nshards > 1 the flat buffer is a
    concatenation of per-shard packed segments. Arrays come back
    per-segment-concatenated; header sums come back per segment."""
    B = NB // 2
    fb_words = (B + 31) // 32
    seg = packed_segment_size(acc_cap, NB)
    w = packed_segment_words(acc_cap, NB)
    flat = np.ascontiguousarray(flat, dtype=np.uint32).reshape(-1)
    assert flat.shape[0] == seg * nshards, (flat.shape, seg, nshards)
    parts = [flat[i * seg : i * seg + w] for i in range(nshards)]

    headers = np.stack([p[:6] for p in parts])  # (nshards, 6)
    o = 6
    a_pos = np.concatenate([p[o : o + acc_cap] for p in parts]).astype(np.int64)
    o += acc_cap
    lane_sid = np.concatenate([p[o : o + acc_cap] for p in parts])
    a_lane = (lane_sid >> 16).astype(np.int64)
    a_sid = (lane_sid & 0xFFFF).astype(np.int64)
    o += acc_cap
    ee_w = (acc_cap + 1) // 2

    def _ee(p):
        w = p[o : o + ee_w]
        ee = np.empty(2 * ee_w, np.uint32)
        ee[0::2] = w & 0xFFFF
        ee[1::2] = w >> 16
        return ee[:acc_cap]

    ed_end = np.concatenate([_ee(p) for p in parts])
    a_ed = (ed_end >> 13).astype(np.int64)
    a_end = (ed_end & 0x1FFF).astype(np.int64)
    o += ee_w

    def bitmaps(off):
        return np.stack(
            [
                np.unpackbits(
                    p[off : off + fb_words].view(np.uint8), bitorder="little"
                )[:B]
                for p in parts
            ]
        ).astype(bool)  # (nshards, B)

    fb = bitmaps(o)
    inh = bitmaps(o + fb_words)
    return {
        # Accepted hits beyond acc_cap were dropped by the OOB scatter (the
        # affected reads carry retry flags in the fallback bitmap).
        "n_accepted": np.minimum(headers[:, 0], acc_cap),
        "slab_overflow": headers[:, 1],
        "total_candidates": headers[:1, 2],
        "sum_nc": headers[:, 3].astype(np.int64),
        "sum_dp": headers[:, 4].astype(np.int64)
        + (headers[:, 5].astype(np.int64) << 16),
        "a_pos": a_pos,
        "a_lane": a_lane,
        "a_sid": a_sid,
        "a_end": a_end,
        "a_ed": a_ed,
        "fb": fb,
        "inherent": inh,
    }


def _make_device_fn(
    params: FilterParams, verify_cap: int, accept_cap: int, verify: str,
):
    @jax.jit
    def run(index: DeviceIndex, packed_in: jnp.ndarray):
        # packed_in: (B, Lmax + 4) uint8 — codes row followed by the read
        # length as 4 little-endian bytes (single H2D transfer).
        codes = packed_in[:, :-4]
        lb = packed_in[:, -4:].astype(jnp.int32)
        lengths = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
        out = map_core(
            index, codes, lengths, params, verify_cap, verify, accept_cap
        )
        return pack_outputs(out)

    return run


def resolve_verify(requested: str | None, platform: str) -> str:
    """The one place that chooses the verify implementation.

    None picks the Pallas kernel on a GPU and the plain XLA path anywhere
    else. "kernel" asks for the compiled kernel and raises off the GPU
    (it compiles for the GPU only). "interpret" runs the kernel through
    the Pallas interpreter; it exists for tests and CPU rehearsals."""
    if requested is None:
        return "kernel" if platform == "gpu" else "plain"
    if requested not in ("plain", "kernel", "interpret"):
        raise ValueError(f"unknown verify implementation {requested!r}")
    if requested == "kernel" and platform != "gpu":
        raise ValueError(
            f"the verify kernel compiles for the GPU only, not {platform!r}"
        )
    return requested


class MappingEngine:
    def __init__(
        self,
        args: FemArgs,
        reference: Reference,
        index: FemIndex,
        config: EngineConfig | None = None,
        use_native: bool | None = None,
    ):
        self.args = args
        self.reference = reference
        self.config = config or EngineConfig()
        # Packed-result width limits (pack_outputs: lane u16, sid u16 —
        # max lane id is 2*batch_size - 1 = 65535).
        if self.config.batch_size > 32768:
            raise ValueError("batch_size must be <= 32768")
        if reference.num_seqs > 65535:
            raise ValueError("references with > 65535 sequences unsupported")
        self.golden = GoldenMapper(args, reference, index)
        self.platform = jax.devices()[0].platform
        self.verify = resolve_verify(self.config.verify, self.platform)
        self._fns: Dict[Tuple[int, int, int], callable] = {}
        import threading

        self._fallback_lock = threading.Lock()
        self.fallback_reads = 0
        # Capacity-retry ladder (tier 0 = the EngineConfig caps themselves).
        if self.config.tiers is None:
            self.tiers = self._default_tiers()
        else:
            self.tiers = tuple(self.config.tiers)
        self.retried_reads = 0  # reads remapped at tier >= 1
        self.tier_dispatches = 0  # device dispatches at tier >= 1 (each one
        # is a full extra program execution — the retry tax a heavy-tailed
        # genome pays; the reference's unbounded merge pays none,
        # src/filter.c:80-131)
        # Stream-mode retry pool + completion watermark (for checkpoints):
        # `_watermark_reads` counts the longest stream prefix whose records
        # have all been emitted, including deferred retries.
        self._pool_lock = threading.Lock()
        self._retry_pool: list | None = None  # set inside map_stream
        self._seq = 0
        self._batch_state: Dict[int, list] = {}  # seq -> [n_reads, outstanding, drained]
        self._watermark_seq = 0
        self._watermark_reads = 0
        self.consumed_reads = 0
        self._tier_warm_started = False
        self._device_args = None  # set for the coordinate-sharded index mode
        self.dindex = None
        self._cross_host = self._mesh_crosses_hosts()
        if self.config.index_mesh is not None:
            self._init_sharded_index(index)
        else:
            sharding = None
            if self.config.mesh is not None:
                # Replicated once at load, not copied from device 0 per call.
                from jax.sharding import NamedSharding, PartitionSpec as P

                sharding = NamedSharding(self.config.mesh, P())
            self.dindex = device_index_from_host(index, reference, sharding)
        self._native = None
        if use_native is None:
            use_native = os.environ.get("FEM_TPU_NO_NATIVE", "") != "1"
        self._cpu_mapper = None
        if use_native:
            try:
                from fem_tpu.native import NativeEmitter, native_available

                if native_available():
                    self._native = NativeEmitter(reference, args.error_threshold)
            except Exception:
                self._native = None
            try:
                from fem_tpu.native.mapper import NativeCpuMapper, mapper_available

                if mapper_available():
                    self._cpu_mapper = NativeCpuMapper(args, reference, index)
            except Exception:
                self._cpu_mapper = None

    def _mesh_crosses_hosts(self) -> bool:
        mesh = self.config.index_mesh or self.config.mesh
        return mesh is not None and any(
            d.process_index != jax.process_index() for d in mesh.devices.flat
        )

    def _global_put(self, mesh, spec, x):
        """Place a host array on a (possibly multi-process) mesh. Every
        process holds the full host copy, so the per-shard callback just
        slices it — no cross-host data movement."""
        from jax.sharding import NamedSharding

        x = np.asarray(x)
        sharding = NamedSharding(mesh, spec)
        if not self._cross_host:
            return jax.device_put(x, sharding)
        return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])

    def _init_sharded_index(self, index: FemIndex) -> None:
        from jax.sharding import PartitionSpec as P

        from fem_tpu.parallel.sharded_index import INDEX_AXIS, build_sharded_index

        mesh = self.config.index_mesh
        n_ip = mesh.shape[INDEX_AXIS]
        sh = build_sharded_index(index, self.reference, n_ip)
        self._sharded_halo = sh.halo
        shard = lambda x: self._global_put(mesh, P(INDEX_AXIS), x)
        repl = lambda x: self._global_put(mesh, P(), x)
        self._device_args = (
            repl(sh.freq_table),
            shard(sh.occ_rows),
            shard(sh.ref_rows),
            shard(sh.ref_offsets),
            repl(sh.ref_lengths),
            repl(sh.num_occurrences),
            shard(sh.own_start),
            shard(sh.own_end),
            shard(sh.halo_lo),
            shard(sh.csr_rows),
        )

    def _mesh_shape(self) -> Tuple[int, int]:
        """(data shards, index shards)."""
        if self.config.index_mesh is not None:
            m = self.config.index_mesh
            return m.shape["data"], m.shape["index"]
        if self.config.mesh is not None:
            return self.config.mesh.devices.size, 1
        return 1, 1

    def _default_tiers(self) -> tuple:
        """Auto retry ladder above tier 0: ~8x caps at 1/16 batch, then a
        64-read heavy-tail tier. Programs compile lazily (first overflow)
        and hit the persistent compile cache afterwards.

        FEM_TPU_TIERS overrides the ladder: semicolon-separated rungs of
        "batch:cap_occ:cap_cand:verify_per_read:accept_per_read" — the
        tuning knob for heavy-tailed genomes where the retry tax
        dominates."""
        c = self.config
        n_dp, _ = self._mesh_shape()

        def align(b):  # batch must split evenly over the data mesh
            return max(-(-b // n_dp) * n_dp, n_dp)

        def cap8(x):  # occurrence slabs are 8-slot-chunk aligned
            return -(-x // 8) * 8

        env = os.environ.get("FEM_TPU_TIERS")
        if env == "none":
            # Route capacity overflow straight to the exact host mapper
            # (no tier programs to compile). The ladder stays the default:
            # hosts with few cores or workloads where overflow reads
            # dominate (whole reads inside satellite arrays at tight slabs)
            # still need device-side escalation. Which wins on the H100 is
            # not measured.
            return ()
        if env:
            rungs = []
            try:
                for spec in env.split(";"):
                    b, occ, cand, vpr, apr = (int(x) for x in spec.split(":"))
                    if min(b, occ, cand, vpr, apr) < 1:
                        raise ValueError("all fields must be >= 1")
                    rungs.append(TierConfig(
                        batch_size=align(b), cap_occ=cap8(occ),
                        cap_cand=cap8(cand), verify_per_read=vpr,
                        accept_per_read=apr,
                    ))
            except ValueError as exc:
                raise ValueError(
                    f"FEM_TPU_TIERS={env!r} is malformed ({exc}); expected "
                    "semicolon-separated rungs of "
                    "'batch:cap_occ:cap_cand:verify_per_read:accept_per_read'"
                ) from exc
            return tuple(rungs)

        t1 = TierConfig(
            batch_size=align(min(c.batch_size, 512)),
            cap_occ=cap8(max(8 * c.cap_occ, 512)),
            cap_cand=cap8(max(8 * c.cap_cand, 512)),
            verify_per_read=max(int(4 * c.verify_per_read), 32),
            accept_per_read=max(int(4 * c.accept_per_read), 16),
        )
        t2 = TierConfig(
            batch_size=align(min(c.batch_size, 64)),
            cap_occ=max(cap8(8 * t1.cap_occ), 4096),
            cap_cand=max(cap8(8 * t1.cap_cand), 4096),
            verify_per_read=max(8 * t1.verify_per_read, 2048),
            accept_per_read=max(8 * t1.accept_per_read, 512),
        )
        return (t1, t2)

    def _tier(self, tier: int) -> TierConfig:
        if tier == 0:
            c = self.config
            return TierConfig(
                batch_size=c.batch_size,
                cap_occ=c.cap_occ,
                cap_cand=c.cap_cand,
                verify_per_read=c.verify_per_read,
                accept_per_read=c.accept_per_read,
                cap_vote=c.cap_vote,
            )
        return self.tiers[tier - 1]

    def _make_fn(self, batch_size: int, max_len: int, tier: int = 0):
        tc = self._tier(tier)
        params = FilterParams.from_args(
            self.args,
            max_len,
            cap_occ=tc.cap_occ,
            cap_cand=tc.cap_cand,
            cap_vote=tc.cap_vote or tc.cap_occ,
        )
        verify_cap = int(2 * batch_size * tc.verify_per_read)
        accept_cap = max(int(2 * batch_size * tc.accept_per_read), 64)
        if self.config.index_mesh is not None:
            from fem_tpu.parallel.sharded_index import make_index_sharded_map_fn

            n_dp, n_ip = self._mesh_shape()
            if batch_size % n_dp:
                raise ValueError(
                    f"batch size {batch_size} not divisible by data mesh {n_dp}"
                )
            e = self.args.error_threshold
            if max_len + 2 * e > self._sharded_halo:
                # Owned candidates' verification bands must stay inside the
                # shard's [start - halo, end + halo) slice.
                raise ValueError(
                    f"read length {max_len} exceeds the sharded-index halo "
                    f"({self._sharded_halo}); rebuild with a larger halo"
                )
            fn = make_index_sharded_map_fn(
                self.config.index_mesh,
                params,
                verify_cap // (n_dp * n_ip),
                max(accept_cap // (n_dp * n_ip), 8),
                self.verify,
                gather_rows=self._cross_host,
            )
        elif self.config.mesh is not None:
            if self._cross_host:
                raise ValueError(
                    "cross-host pure data parallelism uses the independent "
                    "multi-host mode (one engine per host); a cross-host "
                    "mesh is only for the coordinate-sharded index"
                )
            from fem_tpu.parallel.mesh import make_sharded_map_fn

            n = self.config.mesh.devices.size
            if batch_size % n:
                raise ValueError(f"batch size {batch_size} not divisible by mesh size {n}")
            fn = make_sharded_map_fn(
                self.config.mesh, params, verify_cap // n,
                self.verify, accept_cap=accept_cap // n,
            )
        else:
            fn = _make_device_fn(params, verify_cap, accept_cap, self.verify)
        return fn, verify_cap

    def _probe_args(self, batch_size: int, max_len: int, iters: int = 4):
        """Synthetic batches of random base codes (all-N reads would hash
        to one bucket, so every gather would hit the same rows), one
        distinct batch per call."""
        rng = np.random.default_rng(0xFE11)
        out = []
        for _ in range(iters):
            packed = np.empty((batch_size, max_len + 4), np.uint8)
            packed[:, :max_len] = rng.integers(
                0, 4, (batch_size, max_len), np.uint8
            )
            packed[:, max_len:] = (
                np.full((batch_size,), max_len, "<i4")
                .view(np.uint8)
                .reshape(-1, 4)
            )
            if self._device_args is not None:
                out.append((*self._device_args, jnp.asarray(packed)))
            else:
                out.append((self.dindex, jnp.asarray(packed)))
        return out

    def compiled(self, max_len: int, tier: int = 0):
        """The ahead-of-time compiled program of one tier (for
        `memory_analysis()`; the persistent cache makes it cheap)."""
        B = self._tier(tier).batch_size
        fn, _ = self._fn_for(B, max_len, tier)
        return fn.lower(*self._probe_args(B, max_len, iters=1)[0]).compile()

    def _fn_for(self, batch_size: int, max_len: int, tier: int = 0):
        key = (batch_size, max_len, tier)
        if key not in self._fns:
            self._fns[key] = self._make_fn(batch_size, max_len, tier)
        return self._fns[key]

    def warm_tiers(self, max_len: int) -> None:
        """Compile-and-execute the retry-tier programs once, synchronously,
        before the stream's first dispatch, so they do not compile at the
        first overflow in the middle of the stream. A warm persistent
        cache makes this cheap on reruns; a failure raises.

        Runs on an accelerator only: on the CPU the tier programs compile
        quickly on demand. Mesh modes skip it: every mesh process must
        join each dispatch, so a per-process warm would desynchronize the
        collectives."""
        if (
            self._tier_warm_started
            or self.platform == "cpu"
            or not self.tiers
            or self.config.mesh is not None
            or self.config.index_mesh is not None
            or os.environ.get("FEM_TPU_NO_TIER_WARM") == "1"
        ):
            return
        self._tier_warm_started = True
        Lmax_t = max(128, -(-max_len // 32) * 32)  # _subbatch's padding rule
        for t in range(1, len(self.tiers) + 1):
            B_t = self._tier(t).batch_size
            fn, _ = self._fn_for(B_t, Lmax_t, t)
            args = self._probe_args(B_t, Lmax_t, iters=1)[0]
            np.asarray(fn(*args))  # exec + fetch warm

    def submit_batch(self, batch: ReadBatch, tier: int = 0):
        """Dispatch one batch to the device without blocking; pair with
        `drain_batch`. Keeping a batch in flight while the host emits the
        previous one is the device equivalent of the reference's reader/
        mapper/writer thread overlap (src/FEM_map.c:174-198). `tier`
        selects the capacity rung: 0 = the main program, >= 1 = the retry
        ladder for reads that overflowed a smaller tier's slabs."""
        B = self._tier(tier).batch_size
        n = batch.num_reads
        assert n <= B, (n, B, tier)
        if tier > 0:
            with self._fallback_lock:
                self.tier_dispatches += 1
        Lmax = batch.codes.shape[1]
        if batch.packed is not None and batch.packed.shape[0] == B:
            packed = batch.packed  # native reader already built the upload
        else:
            # Single fused H2D buffer: codes + 4 little-endian length bytes.
            packed = np.full((B, Lmax + 4), 4, np.uint8)
            packed[:n, :Lmax] = batch.codes
            packed[n:, Lmax:] = 0
            packed[:n, Lmax:] = (
                batch.lengths.astype("<i4").view(np.uint8).reshape(n, 4)
            )
        fn, verify_cap = self._fn_for(B, Lmax, tier)
        if self._cross_host:
            from jax.sharding import PartitionSpec as P

            from fem_tpu.parallel.sharded_index import DATA_AXIS

            dev_in = self._global_put(
                self.config.index_mesh, P(DATA_AXIS), packed
            )
        else:
            dev_in = jnp.asarray(packed)
        if self._device_args is not None:
            out = fn(*self._device_args, dev_in)
        else:
            out = fn(self.dindex, dev_in)
        # Start the D2H transfer as soon as the program finishes, so it
        # overlaps the previous batch's host emission. (Cross-host outputs
        # are fetched shard-wise in drain instead.)
        if not self._cross_host:
            out.copy_to_host_async()
        return self._register_pending(batch, out, tier)

    def _register_pending(self, batch, out, tier):
        seq = None
        if tier == 0:
            with self._pool_lock:
                seq = self._seq
                self._seq += 1
                self._batch_state[seq] = [batch.num_reads, 0, False]
        return batch, out, tier, seq

    def _map_read_fallback(self, name, seq, qual) -> Tuple[List[bytes], MappingStats]:
        """Exact host mapping of one read: in-process C++ mapper when
        available, golden scalar oracle otherwise."""
        with self._fallback_lock:
            self.fallback_reads += 1
        if self._cpu_mapper is not None:
            blob, st = self._cpu_mapper.map_reads([name], [seq], [qual])
            stats = MappingStats(
                num_reads=int(st[0]),
                num_mapped_reads=int(st[1]),
                num_candidates_without_additional_qgram_filter=int(st[2]),
                num_candidates=int(st[3]),
                num_mappings=int(st[4]),
            )
            return ([blob] if blob else []), stats
        return self.golden.map_read(name, seq, qual)

    def drain_batch(self, pending) -> Tuple[List[bytes], MappingStats]:
        if self._cross_host:
            return self._drain_cross_host(pending)
        return self._drain(pending, per_read=False)

    def _drain_stream(self, pending):
        """Stream-mode drain: completion marks (batch drained / retry
        resolved / watermark advance) are DEFERRED into `acks` closures
        that map_stream runs only after the consumer has pulled the NEXT
        item — i.e. after it had the chance to write this one's records.
        Marking at drain time (executor threads run up to pipeline_depth
        batches ahead of the consumer) would let a checkpoint taken right
        after a crash skip drained-but-unwritten reads on resume."""
        acks: list = []
        if self._cross_host:
            recs, stats = self._drain_cross_host(pending, acks=acks)
        else:
            recs, stats = self._drain(pending, per_read=False, acks=acks)
        # Stream position: original (tier-0) batches advance it; retry
        # batches re-emit reads already counted by their origin batch.
        nreads = pending[0].num_reads if pending[2] == 0 else 0
        return recs, stats, acks, nreads

    def _allgather_row_bitmaps(self, fb_own: np.ndarray, inh_own: np.ndarray):
        """OR the per-process owned-row fallback/inherent bitmaps into the
        global per-read bitmaps (every process sees every row's flags).
        One tiny (2, B) u8 allgather per batch over the coordination
        service; dispatched only from the ordered cross-host drain so every
        process issues it at the same stream position."""
        from jax.experimental import multihost_utils

        both = np.stack([fb_own, inh_own]).astype(np.uint8)
        g = np.asarray(multihost_utils.process_allgather(both))
        g = g.reshape(-1, 2, fb_own.shape[0])
        return g[:, 0].max(axis=0).astype(bool), g[:, 1].max(axis=0).astype(bool)

    def _drain_cross_host(
        self, pending, acks: list | None = None
    ) -> Tuple[List[bytes], MappingStats]:
        """Drain on a mesh spanning jax.distributed processes: the program
        all_gathered each data row's index-shard segments (gather_rows), so
        any device in a row holds the row's complete results. This process
        fetches only its addressable shards and emits the rows it *owns*
        (deterministic round-robin over the processes present in each row);
        counters cover owned reads only and allreduce at stream end
        (fem_tpu/parallel/multihost.allreduce_stats).

        Capacity-overflow reads ride the SAME retry ladder as the
        single-host path (the reference's filter has no caps at any thread
        count, src/filter.c:80-131): the owned-row overflow bitmaps
        allgather into a global bitmap, so every process derives the
        identical retry read list and joins the identical tier-program
        dispatches (collectives require every process to enqueue the same
        programs in the same order — which is also why cross-host drains
        run on the consumer thread in stream order, see map_stream).
        Inherent-limit reads (shard halo / incomplete DP) go to the exact
        host mapper of the row owner; reads still overflowing past the
        last tier round-robin over all processes."""
        batch, flat, tier, seq = pending
        mesh = self.config.index_mesh
        n_dp, n_ip = self._mesh_shape()
        tc = self._tier(tier)
        B = tc.batch_size
        Bloc = B // n_dp
        acc_cap = max(max(int(2 * B * tc.accept_per_read), 64) // (n_dp * n_ip), 8)
        seg = packed_segment_size(acc_cap, 2 * Bloc)
        rows_per_d = n_ip * seg // 128  # segments are (rows, 128) u32 tiles
        row_bytes = {}
        for sh in flat.addressable_shards:
            # With n_dp == 1 JAX reports the unpartitioned dim as
            # slice(None) — start is None, meaning offset 0.
            d = (sh.index[0].start or 0) // rows_per_d
            if d not in row_bytes:
                row_bytes[d] = np.asarray(sh.data).reshape(-1)
        me = jax.process_index()
        records: List[bytes] = []
        stats = MappingStats()
        n = batch.num_reads
        fb_own = np.zeros((B,), bool)
        inh_own = np.zeros((B,), bool)
        outs = {}
        owned_rows = []
        for d in sorted(row_bytes):
            procs = sorted({dev.process_index for dev in mesh.devices[d]})
            if procs[d % len(procs)] != me:
                continue
            owned_rows.append(d)
            out = unpack_outputs(row_bytes[d], acc_cap, 2 * Bloc, n_ip)
            outs[d] = out
            lo = d * Bloc
            fb_own[lo : lo + Bloc] = out["fb"][0]
            inh_own[lo : lo + Bloc] = out["inherent"][0]
        fb_all, inh_all = self._allgather_row_bitmaps(fb_own, inh_own)
        for d in owned_rows:
            lo = d * Bloc
            n_row = min(max(n - lo, 0), Bloc)
            if n_row == 0:
                continue
            out = outs[d]
            # Index shards carry identical psum'd/pmax'd per-row values.
            sum_nc = int(out["sum_nc"][0])
            sum_dp = int(out["sum_dp"][0])
            fb = out["fb"][0]
            inh = out["inherent"][0]
            rb = ReadBatch(
                batch.names[lo : lo + n_row],
                batch.seqs[lo : lo + n_row],
                batch.quals[lo : lo + n_row],
                batch.codes[lo : lo + n_row] if batch.codes is not None else None,
                batch.lengths[lo : lo + n_row] if batch.lengths is not None else None,
            )
            fb_idx = np.flatnonzero(fb[:n_row])
            segs, st = self._emit(
                rb, out, sum_nc, sum_dp, fb, Bloc, fb_idx.size > 0
            )
            st.num_reads = n_row - int(fb_idx.size)
            # Row owner host-maps its rows' inherent-limit reads; capacity
            # overflow is handled collectively below.
            for i in fb_idx[inh[fb_idx]]:
                r, s = self._map_read_fallback(
                    rb.names[i], rb.seqs[i], rb.quals[i]
                )
                segs[i] = r
                st += s
            stats += st
            if fb_idx.size:
                records.extend(rec for rsegs in segs for rec in rsegs)
            else:
                records.extend(segs)

        # Collective capacity retry: identical on every process (derived
        # from the allgathered bitmap), so tier dispatches stay in lockstep.
        cap_idx = np.flatnonzero(fb_all[:n] & ~inh_all[:n])
        if cap_idx.size:
            reads = [
                (batch.names[i], batch.seqs[i], batch.quals[i]) for i in cap_idx
            ]
            if tier < len(self.tiers):
                with self._fallback_lock:
                    self.retried_reads += len(reads)
                B_t = self._tier(tier + 1).batch_size
                for lo2 in range(0, len(reads), B_t):
                    sub = self._subbatch(reads[lo2 : lo2 + B_t])
                    r2, s2 = self._drain_cross_host(
                        self.submit_batch(sub, tier + 1)
                    )
                    records.extend(r2)
                    stats += s2
            else:
                nproc = max(jax.process_count(), 1)
                for j, (nm, sq, ql) in enumerate(reads):
                    if j % nproc != me:
                        continue
                    r, s = self._map_read_fallback(nm, sq, ql)
                    records.extend(r)
                    stats += s

        def mark():
            if seq is not None:
                with self._pool_lock:
                    self._batch_state[seq][2] = True
            self._advance_watermark()

        if acks is None:
            mark()
        else:
            acks.append(mark)
        return records, stats

    def _drain(self, pending, per_read: bool, acks: list | None = None):
        """Unpack one dispatched batch, emit its covered reads, and route
        overflow reads (the device's per-read fallback/retry bitmap) to the
        next capacity tier — pooled for pipelined retry in stream mode,
        mapped synchronously otherwise (records spliced back in read
        order). With `per_read`, returns one record list per read."""
        batch, flat, tier, seq = pending
        tc = self._tier(tier)
        B = tc.batch_size
        n_dp, n_ip = self._mesh_shape()
        nseg = n_dp * n_ip
        acc_cap = max(max(int(2 * B * tc.accept_per_read), 64) // nseg, 8)
        flat = np.asarray(flat)
        out = unpack_outputs(flat, acc_cap, 2 * B // n_dp, nseg)

        # Header sums / fallback bitmap: segments are data-shard-major;
        # index shards carry identical copies (nc psum'd, dp identical,
        # fallback pmax'd over the index axis) — keep index shard 0's.
        sum_nc = int(out["sum_nc"].reshape(n_dp, n_ip)[:, 0].sum())
        sum_dp = int(out["sum_dp"].reshape(n_dp, n_ip)[:, 0].sum())
        fb = out["fb"].reshape(n_dp, n_ip, -1)[:, 0].reshape(-1)  # (B,) reads
        inh = out["inherent"].reshape(n_dp, n_ip, -1)[:, 0].reshape(-1)
        n = batch.num_reads
        fb_idx = np.flatnonzero(fb[:n])

        want_per_read = per_read or fb_idx.size > 0
        segs, stats = self._emit(
            batch, out, sum_nc, sum_dp, fb, B, want_per_read
        )
        # A read is counted by whichever drain finally emits it.
        stats.num_reads = n - int(fb_idx.size)

        if fb_idx.size:
            # Inherent-limit reads (shard halo / incomplete DP) go straight
            # to the exact host mapper — no capacity tier can fix them.
            inh_idx = fb_idx[inh[fb_idx]]
            cap_idx = fb_idx[~inh[fb_idx]]
            for i in inh_idx:
                r, s = self._map_read_fallback(
                    batch.names[i], batch.seqs[i], batch.quals[i]
                )
                segs[i] = r
                stats += s
            reads = [
                (batch.names[i], batch.seqs[i], batch.quals[i]) for i in cap_idx
            ]
            if tier == 0 and self._retry_pool is not None and self.tiers:
                # Stream mode: defer to the pipelined retry pool.
                with self._pool_lock:
                    self._batch_state[seq][1] = len(reads)
                    self._retry_pool.extend(
                        (seq, nm, sq, ql) for nm, sq, ql in reads
                    )
            elif reads:
                fb_segs, fb_stats = self._map_reads_at_tier(reads, tier + 1)
                for i, rsegs in zip(cap_idx, fb_segs):
                    segs[i] = rsegs
                stats += fb_stats

        def mark():
            origins = getattr(batch, "origin_seqs", None)
            if origins is not None:
                with self._pool_lock:
                    for s0 in origins:
                        st = self._batch_state.get(s0)
                        if st is not None:
                            st[1] -= 1
            if seq is not None:
                with self._pool_lock:
                    self._batch_state[seq][2] = True
            self._advance_watermark()

        if acks is None:
            mark()
        else:
            acks.append(mark)

        if per_read:
            return segs, stats
        if want_per_read:
            return [r for rsegs in segs for r in rsegs], stats
        return segs, stats

    def _advance_watermark(self) -> None:
        with self._pool_lock:
            while True:
                st = self._batch_state.get(self._watermark_seq)
                if st is None or not st[2] or st[1] > 0:
                    break
                self._watermark_reads += st[0]
                del self._batch_state[self._watermark_seq]
                self._watermark_seq += 1

    @property
    def watermark_reads(self) -> int:
        """Reads in the longest fully-emitted stream prefix — the safe
        resume offset for checkpointing (deferred retries included)."""
        return self._watermark_reads

    def _subbatch(self, reads) -> ReadBatch:
        """Build a device batch from [(name, seq, qual)] triples."""
        from fem_tpu.core.encoding import encode

        lengths = np.array([len(sq) for _, sq, _ in reads], np.int32)
        Lmax = max(128, -(-int(lengths.max()) // 32) * 32)
        codes = np.full((len(reads), Lmax), 4, np.uint8)
        for i, (_, sq, _) in enumerate(reads):
            codes[i, : len(sq)] = encode(sq)
        return ReadBatch(
            [nm for nm, _, _ in reads],
            [sq for _, sq, _ in reads],
            [ql for _, _, ql in reads],
            codes,
            lengths,
        )

    def _map_reads_at_tier(self, reads, tier):
        """Exactly remap `reads` [(name, seq, qual)] at the given retry
        tier, synchronously (the exact host mapper past the last tier).
        Returns one record list per read + their recomputed stats."""
        stats = MappingStats()
        if tier > len(self.tiers):
            per = []
            for nm, sq, ql in reads:
                r, s = self._map_read_fallback(nm, sq, ql)
                per.append(r)
                stats += s
            return per, stats
        with self._fallback_lock:
            self.retried_reads += len(reads)
        B_t = self._tier(tier).batch_size
        per = []
        for lo in range(0, len(reads), B_t):
            sub = self._subbatch(reads[lo : lo + B_t])
            segs, s = self._drain(self.submit_batch(sub, tier), per_read=True)
            per.extend(segs[: sub.num_reads])
            stats += s
        return per, stats

    def map_batch(self, batch: ReadBatch) -> Tuple[List[bytes], MappingStats]:
        """Map one read batch synchronously; SAM chunks in read order
        (capacity-overflow reads are remapped on higher tiers and their
        records spliced back in place) + stats."""
        return self.drain_batch(self.submit_batch(batch))

    def map_stream(self, batches, depth: int | None = None,
                   ordered: bool = False):
        """Map a stream of batches keeping `depth` batches in flight.

        With `ordered`, capacity-overflow reads are remapped synchronously
        inside each batch's drain and their records spliced back in read
        order, so the output stream is an exact read-order prefix at every
        yield — the property checkpoint/resume needs to truncate-and-resume
        without record loss or duplication. Costs serialization only on
        the (rare) overflow reads; unordered mode pipelines them instead.

        Fetch+emit of one batch overlaps the next batches' device compute
        on a small thread pool (the reference's reader/mapper/writer
        thread overlap, src/FEM_map.c:174-198).

        Capacity-overflow reads from drained batches accumulate in a retry
        pool and re-dispatch as pipelined tier-1 batches (deeper tiers run
        synchronously inside those drains), so heavy-tailed genomes keep
        the pipeline full instead of serializing host fallbacks. Original
        batches yield in submission order with overflow reads' records
        omitted; retry batches yield as extra (records, stats) items —
        record-set and counter totals are exact, matching the reference's
        unordered t>1 emission contract (src/FEM_map.c:182-189)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        depth = depth or self.config.pipeline_depth
        pool: list = []
        self._retry_pool = None if (ordered or self._cross_host) else pool
        retry_B = (
            self._tier(1).batch_size
            if self.tiers and not ordered and not self._cross_host
            else 0
        )
        self.consumed_reads = 0  # stream position of the last consumed item

        def consume(items):
            # Completion marks run only after the consumer pulls the NEXT
            # item — by then it has had the chance to persist this one's
            # records, so the checkpoint watermark never runs ahead of the
            # output file (see _drain_stream). `consumed_reads` advances
            # BEFORE the yield: it is the stream position INCLUDING the
            # item the consumer is handling (in ordered mode, the exact
            # read count whose records the consumer will have written once
            # it processes the item — what a checkpoint must pair with the
            # flushed byte offset; stats.num_reads can't serve: on a
            # global mesh it counts only this host's owned rows).
            for recs, stats, acks, nreads in items:
                self.consumed_reads += nreads
                yield recs, stats
                for a in acks:
                    a()

        class _Lazy:
            """Future evaluated at .result() on the consumer thread. Used
            in cross-host mode: the drain dispatches collectives (bitmap
            allgather, tier retries), and every process must enqueue those
            in the same order — executor threads would race, the consumer
            loop is deterministic."""

            def __init__(self, fn, *a):
                self._fn, self._a = fn, a

            def result(self):
                return self._fn(*self._a)

        q: deque = deque()
        try:
            with ThreadPoolExecutor(max_workers=max(2, depth)) as ex:

                def enqueue(pending):
                    if self._cross_host:
                        q.append(_Lazy(lambda p: [self._drain_stream(p)], pending))
                    else:
                        q.append(
                            ex.submit(lambda p: [self._drain_stream(p)], pending)
                        )

                def flush_retries(min_fill: int):
                    while True:
                        with self._pool_lock:
                            if len(pool) < max(min_fill, 1):
                                return
                            take = pool[:retry_B]
                            del pool[:retry_B]
                        rb = self._subbatch(
                            [(nm, sq, ql) for _, nm, sq, ql in take]
                        )
                        rb.origin_seqs = [s for s, *_ in take]
                        with self._fallback_lock:
                            self.retried_reads += rb.num_reads
                        pending = self.submit_batch(rb, tier=1)
                        q.append(
                            ex.submit(lambda p: [self._drain_stream(p)], pending)
                        )

                for batch in batches:
                    if batch.codes is not None:
                        # Before the first dispatch, so no tier program
                        # compiles mid-stream (see warm_tiers).
                        self.warm_tiers(batch.codes.shape[1])
                    enqueue(self.submit_batch(batch))
                    if retry_B:
                        flush_retries(retry_B)
                    while len(q) > depth:
                        yield from consume(q.popleft().result())
                while q or pool:
                    while q:
                        yield from consume(q.popleft().result())
                    if retry_B:
                        flush_retries(1)
        finally:
            self._retry_pool = None

    def _emit(
        self, batch: ReadBatch, out: dict, sum_nc: int, sum_dp: int,
        fb: np.ndarray, B: int, want_per_read: bool,
    ) -> Tuple[list, MappingStats]:
        """Emit SAM records for the batch's covered (non-fallback) reads.
        Returns (segs, stats): flat record chunks when `want_per_read` is
        false, else one record-chunk list per read (empty for fb reads —
        the retry/fallback path fills those in). `stats.num_reads` is left
        at 0 for the caller to account."""
        if self._native is not None:
            return self._emit_native(batch, out, sum_nc, sum_dp, fb, B,
                                     want_per_read)
        return self._emit_python(batch, out, sum_nc, sum_dp, fb, B,
                                 want_per_read)

    def _emit_native(
        self, batch: ReadBatch, out: dict, sum_nc: int, sum_dp: int,
        fb: np.ndarray, B: int, want_per_read: bool,
    ) -> Tuple[list, MappingStats]:
        """Vectorized stats + one native call for mapping sort, traceback
        and SAM formatting (no per-read Python)."""
        n = batch.num_reads
        stats = MappingStats(
            num_candidates=sum_nc,
            num_candidates_without_additional_qgram_filter=sum_dp,
        )
        a_lane, a_sid, a_pos, a_ed, a_end = self._accepted_arrays(out)
        read_id = a_lane % B
        # Generation order per read: + strand then - strand, each ascending
        # (src/map.c:29-49); stable sort by read id preserves exactly that.
        order = np.argsort(read_id, kind="stable")
        read_id = read_id[order]
        # Hits of fallback/retry reads are incomplete; drop them (their
        # reads re-emit in full at the next tier).
        ok = ~fb[read_id]
        order = order[ok]
        read_id = read_id[ok]
        map_counts = np.bincount(read_id, minlength=B)[:n].astype(np.int32)
        stats.num_mappings = int(map_counts.sum())
        stats.num_mapped_reads = int((map_counts > 0).sum())
        res = self._native.emit(
            batch,
            map_counts,
            (a_lane[order] >= B).astype(np.uint8),
            a_ed[order].astype(np.uint8),
            a_sid[order].astype(np.int32),
            a_pos[order].astype(np.int64),
            a_end[order].astype(np.int32),
            want_read_ends=want_per_read,
        )
        if want_per_read:
            blob, ends = res
            segs, prev = [], 0
            for r in range(n):
                e_ = int(ends[r])
                segs.append([blob[prev:e_]] if e_ > prev else [])
                prev = e_
            return segs, stats
        return ([res] if res else []), stats

    def _accepted_arrays(self, out: dict):
        """Accepted-hit arrays trimmed to true counts and stable-sorted by
        lane (on a mesh the shards concatenate shard-major; stability keeps
        each lane's candidates in ascending band-position order)."""
        n_acc = out["n_accepted"]
        if n_acc.shape[0] > 1:  # per-shard compacted segments
            cap = out["a_lane"].shape[0] // n_acc.shape[0]
            keep = np.concatenate(
                [
                    np.arange(int(c)) + i * cap
                    for i, c in enumerate(n_acc)
                ]
            ).astype(np.int64)
        else:
            keep = np.arange(int(n_acc[0]))
        a_lane = out["a_lane"][keep]
        a_sid = out["a_sid"][keep]
        a_pos = out["a_pos"][keep]
        a_ed = out["a_ed"][keep]
        a_end = out["a_end"][keep]
        sort = np.argsort(a_lane, kind="stable")
        return a_lane[sort], a_sid[sort], a_pos[sort], a_ed[sort], a_end[sort]

    def _emit_python(
        self, batch: ReadBatch, out: dict, sum_nc: int, sum_dp: int,
        fb: np.ndarray, B: int, want_per_read: bool,
    ) -> Tuple[list, MappingStats]:
        n = batch.num_reads
        # Device sums already cover every non-fallback read (lanes of
        # fallback/retry reads were masked out on device; those reads
        # re-emit in full — records AND counters — at the next tier).
        stats = MappingStats(
            num_candidates=sum_nc,
            num_candidates_without_additional_qgram_filter=sum_dp,
        )
        a_lane, a_sid, a_pos, a_ed, a_end = self._accepted_arrays(out)
        bounds = np.searchsorted(a_lane, np.arange(2 * B + 1))
        segs: list = []
        for r in range(n):
            if fb[r]:
                segs.append([])
                continue
            mappings: List[GoldenMapping] = []
            for lane in (r, r + B):  # + strand then - strand (src/map.c:29-49)
                direction = 0 if lane < B else 1
                for i in range(bounds[lane], bounds[lane + 1]):
                    mappings.append(
                        GoldenMapping(
                            direction=direction,
                            edit_distance=int(a_ed[i]),
                            candidate_position=(int(a_sid[i]) << 32)
                            | int(a_pos[i]),
                            end_position_offset=int(a_end[i]),
                        )
                    )
            stats.num_mappings += len(mappings)
            if not mappings:
                segs.append([])
                continue
            stats.num_mapped_reads += 1
            rc, rcod, nc, ncod = read_strands(batch.seqs[r])
            segs.append(
                self.golden.emit_records(
                    batch.names[r], batch.seqs[r], batch.quals[r],
                    rc, rcod, nc, ncod, mappings,
                )
            )
        if want_per_read:
            return segs, stats
        return [rec for rsegs in segs for rec in rsegs], stats
