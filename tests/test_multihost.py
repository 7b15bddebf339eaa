"""True multi-host execution: 2 jax.distributed processes on CPU.

Each process owns 4 virtual CPU devices, maps an interleaved half of the
read stream over its host-local data mesh, writes its own SAM shard, and
the five counters allreduce across hosts. The merged shard record set and
the merged counters must equal a single-host run (the reference's t>1
guarantee is record-set equality, SURVEY.md §2.4)."""

import os
import re
import socket
import subprocess
import sys

import pytest

from fem_tpu import sim
from fem_tpu.pipeline import cli

_DRIVER = """\
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
from fem_tpu.pipeline.cli import main
sys.exit(main(sys.argv[1:]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _records(path: str) -> set:
    with open(path, "rb") as f:
        return {line for line in f if not line.startswith(b"@")}


def _counters(stderr: str) -> dict:
    out = {}
    for key, pat in [
        ("reads", r"The number of read: (\d+)"),
        ("mapped", r"The number of mapped read: (\d+)"),
        ("cand_pre", r"additional q-gram filter: (\d+)"),
        ("cand", r"The number of candidate: (\d+)"),
        ("mappings", r"The number of mapping: (\d+)"),
    ]:
        m = re.search(pat, stderr)
        assert m, f"missing counter {key} in stderr:\n{stderr}"
        out[key] = int(m.group(1))
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    seqs = sim.random_genome(150_000, num_seqs=2, seed=11)
    sim.write_fasta(str(d / "ref.fa"), seqs)
    reads = sim.simulate_reads(seqs, 300, read_length=100, max_errors=2, seed=12)
    sim.write_fastq(str(d / "reads.fq"), reads)
    assert cli.main(["index", "12", "3", str(d / "ref.fa"), str(d / "ref.index")]) == 0
    driver = d / "driver.py"
    driver.write_text(_DRIVER)
    return d


def test_two_host_map_equals_single_host(workdir, capsys):
    d = workdir
    base = [
        "map", "-e", "2", "-a", "1",
        "--ref", str(d / "ref.fa"), "--index", str(d / "ref.index"),
        "--read1", str(d / "reads.fq"), "--batch-size", "64",
    ]
    # Single-host reference run (in-process).
    assert cli.main(base + ["-o", str(d / "single.sam")]) == 0
    single_counters = _counters(capsys.readouterr().err)

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [
                sys.executable, str(d / "driver.py"), *base,
                "-o", str(d / "multi.sam"),
                "--num-hosts", "2", "--host-id", str(i),
                "--coordinator", f"localhost:{port}",
            ],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err

    shard0 = str(d / "multi.sam.host0000")
    shard1 = str(d / "multi.sam.host0001")
    merged = _records(shard0) | _records(shard1)
    assert _records(shard0) and _records(shard1), "both hosts must map reads"
    assert merged == _records(str(d / "single.sam"))

    # Host 0 prints the allreduced counters; they equal the 1-host run's.
    host0_counters = _counters(outs[0][1])
    assert host0_counters == single_counters


def test_threads_t2_single_process(workdir, capsys, monkeypatch):
    """`fem map -t 2` stays in one process (the device belongs to one JAX
    process); -t sets host threads only. Records and counters equal the
    -t 1 run (the reference's t>1 contract: record-set equality)."""
    d = workdir
    base = [
        "map", "-e", "2", "-a", "1",
        "--ref", str(d / "ref.fa"), "--index", str(d / "ref.index"),
        "--read1", str(d / "reads.fq"), "--batch-size", "64",
    ]
    assert cli.main(base + ["-o", str(d / "t1.sam"), "-t", "1"]) == 0
    t1_counters = _counters(capsys.readouterr().err)

    def no_child(*a, **k):
        raise AssertionError("fem map -t 2 started a child process")

    monkeypatch.setattr(subprocess, "Popen", no_child)
    assert cli.main(base + ["-o", str(d / "t2.sam"), "-t", "2"]) == 0
    t2_counters = _counters(capsys.readouterr().err)
    assert _records(str(d / "t2.sam")) == _records(str(d / "t1.sam"))
    assert t2_counters == t1_counters
    assert "FEM_TPU_EMIT_THREADS" not in os.environ  # restored after the run
    with open(str(d / "t2.sam"), "rb") as f:
        assert f.readline().startswith(b"@SQ"), "SAM keeps the header"
