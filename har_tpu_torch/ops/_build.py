"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``_build/lib<name>-<hash>.so`` inside the package (a directory
git ignores), where ``<hash>`` is a digest of the source and the flags, so
an edited source never loads a stale library.  Nothing is built at import:
a kernel's wrapper calls :func:`load` at its first launch, and
``chip_smoke.py`` calls :func:`build_all` to compile every source at once,
one nvcc process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("hist", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) per kernel built by
# this process
PTXAS_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then PATH, then PyTorch's CUDA_HOME guess."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from har_tpu_torch/csrc at first use"
    )


def library_path(name: str) -> Path:
    source = (SOURCE_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns the
    process, its temporary output and the final path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    final = library_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, final


def _finish(name: str, proc, tmp: str, final: Path) -> Path:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    PTXAS_LOG[name] = log
    os.replace(tmp, final)  # atomic: a reader never sees a partial file
    return final


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together."""
    started = {
        name: _start(name)
        for name in names
        if not library_path(name).exists()
    }
    built = {
        name: _finish(name, *started[name]) for name in started
    }
    return {name: built.get(name, library_path(name)) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
