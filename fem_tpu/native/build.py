"""On-demand build of the native host code (g++ -O3).

No pybind11 in this environment; the C API is consumed via ctypes.
Artifacts go to `_build/<key>/` beside the sources (listed in
.gitignore), where the key hashes the sources, the compiler flags and
the host CPU's model and feature flags. `-march=native` code built on
one machine is therefore never loaded on another: a checkout copied to
a different host builds its own artifacts on first use.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_ROOT = os.path.join(os.path.dirname(__file__), "_build")
_lock = threading.Lock()

_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-Wall"]
_TSAN_FLAGS = ["-O1", "-g", "-std=c++17", "-Wall", "-fsanitize=thread"]

_MAINS = ("baseline.cpp", "tsan_stress.cpp")  # standalone binaries


def cpu_id() -> str:
    """The host CPU's model name and feature flags."""
    model = flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key == "model name" and not model:
                    model = val.strip()
                elif key in ("flags", "Features") and not flags:
                    flags = val.strip()
                if model and flags:
                    break
    except OSError:
        pass
    return f"{platform.machine()}|{model or platform.processor()}|{flags}"


def build_key(flags: list[str]) -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(_SRC_DIR)):
        h.update(f.encode() + b"\0")
        with open(os.path.join(_SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode() + b"\0")
    h.update(cpu_id().encode())
    return h.hexdigest()[:16]


def _sources(exclude_main: bool) -> list[str]:
    return [
        os.path.join(_SRC_DIR, f)
        for f in sorted(os.listdir(_SRC_DIR))
        if f.endswith(".cpp") and (not exclude_main or f not in _MAINS)
    ]


def _build(name: str, flags: list[str], args: list[str], force: bool) -> str:
    """Compile `name` under this host's key unless it is already there.
    The compiler writes a temporary file that is renamed into place, so
    concurrent builders never load a half-written artifact."""
    with _lock:
        target = os.path.join(_BUILD_ROOT, build_key(flags), name)
        if force or not os.path.exists(target):
            os.makedirs(os.path.dirname(target), exist_ok=True)
            tmp = f"{target}.tmp{os.getpid()}"
            subprocess.run(
                ["g++", *flags, "-o", tmp, *args, "-lz"],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, target)
        return target


def build_native(force: bool = False) -> str:
    """Build the shared library consumed via ctypes."""
    return _build(
        "libfemtpu.so", _CXXFLAGS,
        ["-pthread", "-shared", "-fPIC", *_sources(exclude_main=True)], force,
    )


def build_baseline(force: bool = False) -> str:
    """Build the standalone fem_baseline CPU mapper binary."""
    return _build(
        "fem_baseline", _CXXFLAGS,
        ["-pthread", os.path.join(_SRC_DIR, "baseline.cpp")], force,
    )


def build_tsan_stress(force: bool = False) -> str:
    """Build the ThreadSanitizer stress binary (tsan_stress.cpp + the
    library sources, -O1 -fsanitize=thread). Raises on toolchains without
    TSAN support; callers (tests/test_native.py) skip in that case."""
    return _build(
        "tsan_stress", _TSAN_FLAGS,
        ["-pthread", os.path.join(_SRC_DIR, "tsan_stress.cpp"),
         *_sources(exclude_main=True)],
        force,
    )
