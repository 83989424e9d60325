"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries go to ``_build/`` beside this file, named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  Several sources build in parallel: one compiler
process each, all started together.

``load_host`` builds a ``.cpp`` file with ``g++`` the same way; the CPU tests
use it to run the kernel's code (``csrc/demod_step.cuh`` in the layouts of
``csrc/demod_tiles.cuh``) on the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# --fmad=false and no fast math: every float operation rounds as the plain
# PyTorch version's does, so squelch decisions and integer state match it
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

KERNEL_SOURCES = ("demod.cu", "chain_probe.cu")


@dataclass
class Built:
    path: Path
    seconds: float  # compile time; 0.0 when an earlier build was reused
    log: str  # the compiler's output (nvcc: ptxas registers / spills)


_LOADED: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): cannot build the CUDA kernels")


def _target(source: str, flags: tuple[str, ...]) -> Path:
    src = CSRC / source
    h = hashlib.sha256(" ".join(flags).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build(sources: tuple[str, ...], compiler: str, flags: tuple[str, ...]) -> dict[str, Built]:
    BUILD_DIR.mkdir(exist_ok=True)
    done: dict[str, Built] = {}
    running = []
    t0 = time.perf_counter()
    for source in sources:
        out = _target(source, flags)
        if out.exists():
            done[source] = Built(out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [compiler, *flags, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, out, tmp, proc))
    for source, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {source} failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial library
        done[source] = Built(out, time.perf_counter() - t0, log)
    return done


def build_kernels(sources: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, Built]:
    """Compile every CUDA source not yet built, nvcc processes in parallel."""
    return _build(sources, _nvcc(), NVCC_FLAGS)


def _load(path: Path) -> ctypes.CDLL:
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(str(path))
    return _LOADED[path]


def load_kernel(source: str) -> ctypes.CDLL:
    """The shared library of one CUDA source, built first if needed."""
    return _load(build_kernels((source,))[source].path)


def load_host(source: str) -> ctypes.CDLL:
    """A host build (g++) of one ``.cpp`` source, for the CPU tests."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: cannot build the host test library")
    return _load(_build((source,), gxx, GXX_FLAGS)[source].path)
