"""Command-line interface.

Mirrors the reference binary's surface (src/FEM.c:23-51):
    fem index <window_size> <step_size> <reference> <output>   (src/FEM_index.c:7-22)
    fem map -e INT -t INT -a INT -f g --ref R --index I --read1 Q -o OUT
                                                               (src/FEM_map.c:10-133)
plus the same exit summary (version/CMD/wall+CPU time) and the five
MappingStats counters (src/FEM_map.c:214-219).

Behavioral improvement over the reference, preserved intentionally: the
reference *ignores* the k/step stored in the index header and filters with
its hardcoded defaults (SURVEY.md §5.6); we take k/step from the index
file, which is the only correct interpretation.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import resource
import sys
import time


@contextlib.contextmanager
def _env_defaults(values: dict):
    """Set environment variables for the duration of a run, except those
    the caller already set."""
    added = [k for k in values if k not in os.environ]
    os.environ.update({k: values[k] for k in added})
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)


def _cpu_time() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _read_checkpoint(path: str) -> list[tuple[int, int]]:
    """Parse a checkpoint file into [(reads, bytes)] history (oldest
    first). Legacy format (a single read count, no byte offset) yields
    [(reads, -1)] — resume then appends without truncating."""
    hist: list[tuple[int, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            hist.append(
                (int(parts[0]), int(parts[1]) if len(parts) > 1 else -1)
            )
    return hist


def _write_checkpoint(path: str, hist: list[tuple[int, int]]) -> None:
    """Atomically persist the (reads, bytes) history (last 256 entries —
    global-mesh resume needs a window because hosts crash at different
    stream positions and must rendezvous on the minimum)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for reads, nbytes in hist[-256:]:
            f.write(f"{reads} {nbytes}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def index_main(argv: list[str]) -> int:
    if len(argv) < 4:
        print(
            "Usage: fem index <window_size> <step_size> <reference> <output>",
            file=sys.stderr,
        )
        return 1
    kmer_size, step_size = int(argv[0]), int(argv[1])
    reference_path, output_path = argv[2], argv[3]
    print(
        f"k: {kmer_size}, step size: {step_size}, reference: {reference_path}, "
        f"output: {output_path}",
        file=sys.stderr,
    )
    from fem_tpu.index.build import build_index
    from fem_tpu.index.storage import save_index
    from fem_tpu.io.fastx import read_fasta

    t0 = time.time()
    reference = read_fasta(reference_path)
    index = build_index(reference, kmer_size, step_size)
    print(
        f"Collected {index.num_occurrences} seeds.\n"
        f"Lookup table size: {index.lookup.shape[0]}, occurrence table size: "
        f"{index.num_occurrences}.\nBuilt index in {time.time() - t0:f}s.",
        file=sys.stderr,
    )
    save_index(index, output_path)
    return 0


def map_main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="fem map", add_help=True)
    p.add_argument("-e", type=int, default=2, help="error threshold")
    p.add_argument("-t", type=int, default=1,
                   help="number of host threads (SAM emission and batch "
                        "drains); 1 keeps the automatic counts")
    p.add_argument("-a", type=int, default=1, help="# additional q-grams")
    p.add_argument("-f", default="g", help='seeding algorithm ("g" group seeding)')
    p.add_argument("--ref", required=True, help="input reference file")
    p.add_argument("--index", required=True, help="input index file")
    p.add_argument("--read1", required=True, help="input read1 file")
    p.add_argument("-o", dest="output", required=True, help="output SAM file")
    p.add_argument("--batch-size", type=int, default=10000)
    p.add_argument("--cap-occ", type=int, default=None,
                   help="tier-0 occurrence-slab capacity (engine tuning)")
    p.add_argument("--cap-vote", type=int, default=None,
                   help="tier-0 compacted vote-slab width (engine tuning)")
    p.add_argument("--cap-cand", type=int, default=None,
                   help="tier-0 candidate capacity (engine tuning)")
    p.add_argument("--verify-per-read", type=int, default=None,
                   help="tier-0 verify slots per read-strand (engine tuning)")
    p.add_argument("--accept-per-read", type=int, default=None,
                   help="tier-0 accepted-hit slots per read (engine tuning)")
    p.add_argument(
        "--engine",
        choices=["device", "golden"],
        default="device",
        help="device = accelerator pipeline, golden = scalar oracle",
    )
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace to this directory")
    p.add_argument("--stats-json", default=None,
                   help="write pipeline metrics + counters as JSON")
    p.add_argument("--checkpoint", default=None,
                   help="progress file enabling resume after interruption")
    p.add_argument("--verbose-batches", action="store_true",
                   help="log per-batch mapping time (reference map.c:57)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host run: total number of host processes")
    p.add_argument("--host-id", type=int, default=0,
                   help="multi-host run: this process's id in [0, num-hosts)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host run: jax.distributed coordinator host:port")
    p.add_argument("--local-devices", type=int, default=None,
                   help="multi-host run: devices owned by this process")
    p.add_argument("--index-shards", type=int, default=1,
                   help="coordinate-shard the index over this many mesh "
                        "shards (whole-genome scale; spans hosts when run "
                        "under --coordinator)")
    args = p.parse_args(argv)

    # Constraint surface of check_args (src/FEM_map.c:29-55).
    if not (0 <= args.e <= 7):
        print("Wrong error threshold.", file=sys.stderr)
        return 1
    if args.t <= 0:
        print("Wrong number of threads.", file=sys.stderr)
        return 1
    if not (0 <= args.a <= 2):
        print("Wrong number of additional q-grams.", file=sys.stderr)
        return 1
    if args.f not in ("g", "v"):
        # The reference accepts both flags but only ever wires group
        # seeding (src/FEM_map.c:109-117 leaves the 'v' branch empty).
        print("Wrong name of seeding algorithm!", file=sys.stderr)
        return 1

    # The reference's -t runs t pthread mappers (src/FEM_map.c:182-189).
    # Here one process drives the device; -t sets the host threads around
    # it: native SAM emission threads and concurrent batch drains. The
    # output contract is unchanged (record multiset + counters).
    threads = {"FEM_TPU_EMIT_THREADS": str(args.t)} if args.t > 1 else {}
    with _env_defaults(threads):
        return _map(args)


def _map(args) -> int:
    from fem_tpu.config import FemArgs
    from fem_tpu.golden.model import GoldenMapper, MappingStats
    from fem_tpu.index.storage import load_index
    from fem_tpu.io.fastx import read_fasta, stream_fastq_batches
    from fem_tpu.io.sam import SamWriter
    from fem_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    # Multi-host bring-up must precede any JAX backend use. Each host maps
    # a disjoint interleaved batch subset, writes its own SAM shard, and
    # the counters allreduce at the end (fem_tpu/parallel/multihost.py).
    from fem_tpu.parallel import multihost

    ctx = multihost.initialize(
        args.coordinator, args.num_hosts, args.host_id, args.local_devices
    )

    reference = read_fasta(args.ref)
    index = load_index(args.index)
    fem_args = FemArgs(
        kmer_size=index.kmer_size,
        step_size=index.step_size,
        error_threshold=args.e,
        num_additional_qgrams=args.a,
        num_threads=args.t,
    )
    total = MappingStats()
    t0 = time.time()

    # Resume support (aux: persisted read-stream offset; the reference's
    # only checkpoint is the index itself — mapping is a stateless stream,
    # so resume = skip already-processed reads).
    # Global-mesh mode: the index is coordinate-sharded over a mesh
    # spanning all processes, so every host consumes the SAME batch stream
    # (each host uploads its addressable slice and emits the data rows it
    # owns) instead of the interleaved disjoint-batch assignment of the
    # independent mode.
    global_mesh_mode = args.index_shards > 1 and ctx.initialized

    # Resume: the checkpoint stores (reads, output-bytes) pairs taken when
    # the output prefix was exactly the records of that read prefix
    # (map_stream runs `ordered` under --checkpoint). Resume truncates the
    # SAM shard to the stored byte offset, so a crash between checkpoints
    # neither loses nor duplicates records.
    skip_reads = 0
    resume_bytes = -1
    ckpt_path = multihost.shard_path(args.checkpoint, ctx) if args.checkpoint else None
    ckpt_hist: list[tuple[int, int]] = []
    if ckpt_path and os.path.exists(ckpt_path):
        ckpt_hist = _read_checkpoint(ckpt_path)
        if ckpt_hist:
            skip_reads, resume_bytes = ckpt_hist[-1]
    if global_mesh_mode and args.checkpoint:
        # Every submit_batch is a collective: all processes MUST resume
        # from the same stream position. Hosts crash at different stream
        # positions, so rendezvous on the minimum; each host truncates its
        # own shard to its byte offset AT that common position (from its
        # checkpoint history — positions are batch boundaries identical
        # across hosts).
        common = multihost.allreduce_min(skip_reads, ctx)
        if common != skip_reads:
            at = [h for h in ckpt_hist if h[0] == common]
            if not at:
                print(
                    f"Checkpoint history too short to rewind from "
                    f"{skip_reads} to the fleet minimum {common}; delete "
                    f"the checkpoints and restart the run.",
                    file=sys.stderr,
                )
                return 1
            skip_reads, resume_bytes = at[0]
            ckpt_hist = [h for h in ckpt_hist if h[0] <= common]
    if skip_reads and not os.path.exists(out_path_exists := multihost.shard_path(args.output, ctx)):
        print(f"Checkpoint present but {out_path_exists} is missing; "
              f"restarting from 0.", file=sys.stderr)
        skip_reads, resume_bytes, ckpt_hist = 0, -1, []
    if skip_reads:
        print(f"Resuming after {skip_reads} reads.", file=sys.stderr)

    from fem_tpu.utils.metrics import PipelineMetrics, Timer

    metrics = PipelineMetrics()

    def batches():
        skipped = 0
        stream = stream_fastq_batches(args.read1, batch_size=args.batch_size)
        if not global_mesh_mode:
            stream = multihost.shard_batches(stream, ctx)
        for batch in stream:
            # Native reader batches carry the packed upload buffer.
            metrics.native_reader = batch.packed is not None
            if skipped + batch.num_reads <= skip_reads:
                skipped += batch.num_reads
                continue
            yield batch

    out_path = multihost.shard_path(args.output, ctx)
    if skip_reads:
        writer_file = open(out_path, "r+b")
        if resume_bytes >= 0:
            # Drop any records written after the checkpointed prefix (the
            # crash window) — resume re-maps those reads.
            writer_file.truncate(resume_bytes)
        writer_file.seek(0, os.SEEK_END)
        writer = None
    else:
        writer = SamWriter(out_path, reference.names, reference.lengths.tolist())
        writer_file = None

    def write_chunks(recs):
        if writer is not None:
            for r in recs:
                writer.write_record(r)
        else:
            for r in recs:
                writer_file.write(r)

    def out_flush_tell() -> int:
        if writer is not None:
            return writer.tell()
        writer_file.flush()
        return writer_file.tell()

    profiling = False
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
        profiling = True
    processed = skip_reads
    try:
        if args.engine == "golden":
            mapper = GoldenMapper(fem_args, reference, index)
            for batch in batches():
                bt = Timer()
                recs, stats = mapper.map_reads(batch.names, batch.seqs, batch.quals)
                write_chunks(recs)
                total += stats
                processed += batch.num_reads
                metrics.batch(batch.num_reads, len(recs), 0.0, bt.elapsed())
                if args.verbose_batches:
                    print(f"Mapped read batch in {bt.elapsed():f}s.", file=sys.stderr)
        else:
            from fem_tpu.pipeline.engine import EngineConfig, MappingEngine
            from fem_tpu.pipeline.prefetch import ThreadedBatchSource

            # Host-local data-parallel mesh when this process owns several
            # devices (reads shard across them; index replicated).
            import jax

            mesh = None
            index_mesh = None
            if args.index_shards > 1:
                index_mesh = multihost.global_index_mesh(args.index_shards)
                n_dp = index_mesh.shape["data"]
                if args.batch_size % n_dp:
                    print(
                        f"--batch-size must be divisible by the data mesh "
                        f"({n_dp}).",
                        file=sys.stderr,
                    )
                    return 1
            else:
                n_local = len(jax.local_devices())
                if n_local > 1 and args.batch_size % n_local == 0:
                    mesh = multihost.local_data_mesh()
            tune = {
                k: v
                for k, v in (
                    ("cap_occ", args.cap_occ),
                    ("cap_vote", args.cap_vote),
                    ("cap_cand", args.cap_cand),
                    ("verify_per_read", args.verify_per_read),
                    ("accept_per_read", args.accept_per_read),
                )
                if v is not None
            }
            engine = MappingEngine(
                fem_args, reference, index,
                EngineConfig(
                    batch_size=args.batch_size, mesh=mesh,
                    index_mesh=index_mesh,
                    pipeline_depth=max(4, args.t), **tune,
                ),
            )
            metrics.platform = engine.platform
            metrics.verify = engine.verify
            metrics.native_emitter = engine._native is not None
            metrics.native_mapper = engine._cpu_mapper is not None
            source = ThreadedBatchSource(batches())
            bt = Timer()
            # Checkpointing needs read-order output (see map_stream); the
            # watermark then equals the reads whose records this loop has
            # already written, and the flushed byte offset pairs with it.
            for recs, stats in engine.map_stream(
                source, ordered=ckpt_path is not None,
            ):
                write_chunks(recs)
                total += stats
                processed += stats.num_reads
                dt = bt.reset()
                metrics.batch(stats.num_reads, len(recs), 0.0, dt)
                if args.verbose_batches:
                    print(f"Mapped read batch in {dt:f}s.", file=sys.stderr)
                if ckpt_path:
                    # engine.consumed_reads = stream position through the
                    # item just written (full batches even on a global
                    # mesh, where stats.num_reads covers only owned rows);
                    # in ordered mode the flushed file prefix is exactly
                    # this host's records for reads [0, position).
                    pos = skip_reads + engine.consumed_reads
                    ckpt_hist.append((pos, out_flush_tell()))
                    del ckpt_hist[:-256]
                    _write_checkpoint(ckpt_path, ckpt_hist)
    finally:
        if profiling:
            import jax

            jax.profiler.stop_trace()
    if writer is not None:
        writer.close()
    else:
        writer_file.close()
    metrics.wall_total_s = time.time() - t0
    if args.engine == "device":
        metrics.fallback_reads = engine.fallback_reads
        metrics.retried_reads = engine.retried_reads

    # Cross-host counter rollup (the reference's per-thread stats merge at
    # join, src/FEM_map.c:200-212, as one allgather over all hosts).
    total = multihost.allreduce_stats(total, ctx)
    if args.stats_json:
        metrics.dump_json(multihost.shard_path(args.stats_json, ctx), total)
    if ctx.host_id != 0:
        print(f"[host {ctx.host_id}] wrote {out_path}", file=sys.stderr)
        return 0

    # The five oracle counters (src/FEM_map.c:214-219).
    print(f"The number of read: {total.num_reads}", file=sys.stderr)
    print(f"The number of mapped read: {total.num_mapped_reads}", file=sys.stderr)
    print(
        "The number of candidate before additional q-gram filter: "
        f"{total.num_candidates_without_additional_qgram_filter}",
        file=sys.stderr,
    )
    print(f"The number of candidate: {total.num_candidates}", file=sys.stderr)
    print(f"The number of mapping: {total.num_mappings}", file=sys.stderr)
    print(f"Time: {time.time() - t0:f}s", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(
            "Program: fem_tpu (accelerator Fast and Efficient short read Mapper)\n"
            "Usage:   fem <command> [options]\n\n"
            "Command: index   build index for reference\n"
            "         map     map reads",
            file=sys.stderr,
        )
        return 1
    real0, cpu0 = time.time(), _cpu_time()
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        rc = index_main(rest)
    elif cmd == "map":
        rc = map_main(rest)
    else:
        print(f"[main] unrecognized command '{cmd}'", file=sys.stderr)
        return 1
    if rc == 0:
        from fem_tpu import __version__

        print(f"[main] Version: {__version__}", file=sys.stderr)
        print(f"[main] CMD: fem {' '.join(argv)}", file=sys.stderr)
        print(
            f"[main] Real time: {time.time() - real0:.3f} sec; "
            f"CPU: {_cpu_time() - cpu0:.3f} sec",
            file=sys.stderr,
        )
    return rc


if __name__ == "__main__":
    sys.exit(main())
