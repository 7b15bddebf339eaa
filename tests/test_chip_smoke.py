"""chip_smoke.py and bench.py off the GPU: both refuse to run without
one, chip_smoke's CPU rehearsal runs every phase at toy size, and the
record digest they share is a multiset digest."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, *args, timeout, script="chip_smoke.py"):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


def _has_ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_no_gpu_exits_nonzero_without_ok_line(tmp_path):
    p = _run(tmp_path, timeout=300)
    assert p.returncode != 0
    assert not _has_ok_line(p.stdout)
    assert "not a GPU" in p.stderr


def test_rehearse_runs_every_phase(tmp_path):
    p = _run(tmp_path, "--rehearse", timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    for phase in ("kernels", "main", "repeats"):
        assert f"[{phase}] phase passed" in p.stdout
    assert "records_equal=True counters_equal=True" in p.stdout
    assert not _has_ok_line(p.stdout)


def test_bench_no_gpu_exits_nonzero_without_result(tmp_path):
    p = _run(tmp_path, timeout=300, script="bench.py")
    assert p.returncode != 0
    assert p.stdout.strip() == ""  # no headline or auxiliary JSON line
    assert "needs a GPU" in p.stderr


def test_record_digest_is_order_free(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke

    recs = [b"r1\t0\tchr1\t5", b"r2\t16\tchr1\t9", b"r1\t0\tchr1\t5"]
    sam = tmp_path / "a.sam"
    sam.write_bytes(b"@HD\tVN:1.6\n" + b"\n".join(recs) + b"\n")
    fwd = chip_smoke.digest_lines([b"\n".join(recs) + b"\n"])
    assert fwd[1] == 3
    assert chip_smoke.digest_lines([r + b"\n" for r in recs[::-1]]) == fwd
    assert chip_smoke.digest_sam(str(sam)) == fwd
    # A duplicate counts: two copies differ from one.
    assert chip_smoke.digest_lines([b"\n".join(recs[:2])]) != fwd
