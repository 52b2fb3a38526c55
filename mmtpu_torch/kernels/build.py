"""Build and load the port's CUDA kernels (``mmtpu_torch/csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with :mod:`ctypes`: one ``nvcc -c`` per
source, all started together, then one link.  The library is built at first
use into ``mmtpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed
by a hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags, so an edit rebuilds and an unchanged tree reuses what is there.  A
missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
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
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


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
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmmtpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> None:
    """Run the commands side by side; raise with the output of the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}"
    if failed:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile the library unless the hashed target exists; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmpdir, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: a process loading concurrently never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.angular_fwd.argtypes = [vp] * 6 + [i] * 5 + [vp]
        lib.angular_fwd.restype = i
        lib.angular_bwd.argtypes = [vp] * 6 + [i] * 5 + [vp]
        lib.angular_bwd.restype = i
        for fn in ("angular_fwd_blocks_per_sm", "angular_bwd_blocks_per_sm"):
            getattr(lib, fn).argtypes = [i]
            getattr(lib, fn).restype = i
        for fn in ("angular_max_depth", "angular_row_tile", "angular_vocab_tile"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        f = ctypes.c_float
        lib.dec_update_adam.argtypes = [vp] * 5 + [vp, f] * 4 + [vp] * 6 + [i] * 5 + [vp]
        lib.dec_update_adam.restype = i
        lib.dec_update_sgd.argtypes = [vp] * 3 + [vp, f] * 2 + [vp] * 4 + [i] * 5 + [vp]
        lib.dec_update_sgd.restype = i
        lib.dec_update_blocks_per_sm.argtypes = [i]
        lib.dec_update_blocks_per_sm.restype = i
        for fn in ("dec_update_d_tile", "dec_update_f_tile", "dec_update_batch_chunk"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA card ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(query: str, index: int, arg: int) -> int:
    """Resident blocks per SM that the library's occupancy query ``query``
    (``angular_fwd_blocks_per_sm`` and the like) reports on card ``index``
    for ``arg``, once per (query, card, arg)."""
    import torch

    with torch.cuda.device(index):
        n = getattr(load(), query)(arg)
    if n < 1:
        raise RuntimeError(f"{query}({arg}) returned {n}")
    return n


class Tickets:
    """A kernel's int32 tickets on each (card, stream): zeros that the kernel
    takes and sets back to 0 before it ends, so calls queued on one stream
    each find them at 0.  Allocated at first use, grown, never shrunk; each
    kernel that counts its blocks this way keeps its own."""

    def __init__(self) -> None:
        self._bufs: dict = {}

    def __call__(self, device, stream: int, n: int):
        import torch

        t = self._bufs.get((device.index, stream))
        if t is None or t.numel() < n:
            t = torch.zeros(n, dtype=torch.int32, device=device)
            self._bufs[(device.index, stream)] = t
        return t


def check_launch(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({err})")
