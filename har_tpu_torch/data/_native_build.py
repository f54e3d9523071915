"""Build and load the port's host C++ libraries (g++, ctypes).

Two sources in ``har_tpu_torch/csrc/`` have a plain C interface and run
on the host: ``rawloader.cpp`` (the raw WISDM stream parser) and
``mllibmath.cpp`` (the JVM-parity math of the bit-exact MLlib replays).  Each compiles on first
use into ``har_tpu_torch/_build/native/`` (git-ignored), never next to its
source, with ``g++ -O2 -std=c++17 -shared -fPIC -pthread`` and the
library's own extra flags.

Every library exports the sha256 of the source it was compiled from
(``har_native_source_hash``); a library whose hash differs from the
source on disk is rebuilt once before it is used.  A build that fails
raises with g++'s message: no caller switches to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build" / "native"
BASE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

# The exported symbol holding the sha256 of the source a library was built
# from.  The non-brace ``extern "C"`` form gives the array external linkage,
# so it reaches the dynamic symbol table.
_HASH_SYMBOL = "har_native_source_hash"


class NativeLib:
    """One host library: built on first :meth:`load`, then cached for the
    process.  ``build_seconds`` is the time of this process's g++ run
    (None when a current library was already on disk)."""

    def __init__(
        self,
        source: str | Path,
        library: str | Path,
        configure: Callable[[ctypes.CDLL], None],
        extra_flags: tuple[str, ...] = (),
    ):
        self.source = SOURCE_DIR / source
        self.path = BUILD_DIR / library
        self._configure = configure
        self.extra_flags = tuple(extra_flags)
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.build_seconds: float | None = None

    @property
    def command(self) -> list[str]:
        """The g++ command line, without the hash unit and output."""
        return ["g++", *BASE_FLAGS, *self.extra_flags, str(self.source)]

    def _source_hash(self) -> str:
        return hashlib.sha256(self.source.read_bytes()).hexdigest()

    def _build(self) -> None:
        """Compile to a temporary file and move it into place, so no
        process loads a half-written library; raises with g++'s message."""
        out_dir = self.path.parent
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, hash_src = tempfile.mkstemp(suffix=".cpp", dir=out_dir)
        with os.fdopen(fd, "w") as f:
            f.write(
                f'extern "C" const char {_HASH_SYMBOL}[] = '
                f'"{self._source_hash()}";\n'
            )
        tmp = out_dir / f".{self.path.name}.{os.getpid()}.tmp"
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [*self.command, hash_src, "-o", str(tmp)],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {self.path.name} from "
                    f"csrc/{self.source.name}:\n{proc.stderr}"
                )
            os.replace(tmp, self.path)
            self.build_seconds = time.perf_counter() - t0
        finally:
            for leftover in (hash_src, tmp):
                if os.path.exists(leftover):
                    os.remove(leftover)

    def _open(self) -> ctypes.CDLL | None:
        """The library on disk if it was built from the present source,
        else None (it is unloaded again, so a rebuild is not shadowed by
        dlopen's cache of this path)."""
        lib = ctypes.CDLL(str(self.path))
        try:
            symbol = ctypes.c_char.in_dll(lib, _HASH_SYMBOL)
            current = ctypes.string_at(ctypes.addressof(symbol)).decode("ascii")
        except ValueError:  # built without the hash symbol
            current = None
        if current == self._source_hash():
            return lib
        import _ctypes

        _ctypes.dlclose(lib._handle)
        return None

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = self._open() if self.path.exists() else None
                if lib is None:
                    self._build()
                    lib = self._open()
                    if lib is None:
                        raise RuntimeError(
                            f"{self.path} does not carry the hash of "
                            f"csrc/{self.source.name} after a fresh build"
                        )
                self._configure(lib)
                self._lib = lib
            return self._lib
