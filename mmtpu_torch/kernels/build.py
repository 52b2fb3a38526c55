"""Build and load the port's CUDA kernels (``mmtpu_torch/csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with :mod:`ctypes`.  The library is built at
first use into ``mmtpu_torch/_build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses what is there.  A missing ``nvcc`` or a failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "mmtpu_torch are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmmtpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the hashed target exists; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(s) for s in sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a process loading concurrently never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.angular_fwd.argtypes = [vp] * 5 + [i] * 5 + [vp]
        lib.angular_fwd.restype = i
        lib.angular_bwd.argtypes = [vp] * 7 + [i] * 5 + [vp]
        lib.angular_bwd.restype = i
        for fn in ("angular_max_depth", "angular_row_tile", "angular_vocab_tile"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.angular_error_string.argtypes = [i]
        lib.angular_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
