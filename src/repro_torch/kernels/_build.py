"""Build of the port's CUDA kernels: `nvcc` into a shared library, at first use.

Every `*.cu` file under `csrc/` is compiled for `sm_90a` into one shared
library with a plain C interface, loaded with `ctypes`.  The library goes into
`build/` at the repository root (git-ignored), under a key made from a hash of
the sources and the flags, so an edited source rebuilds and an unchanged one
is reused within a checkout.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # imported only where a build runs
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in this process."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        sources = _sources()
        out_dir = BUILD_ROOT / _key()
        lib_path = out_dir / "librepro_torch_kernels.so"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, lib_path)
        _library = _bind(ctypes.CDLL(str(lib_path)))
        return _library


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) for the current sources."""
    return (BUILD_ROOT / _key() / "nvcc.log").read_text()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.flash_attention_fwd
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, i, p]
    fn.restype = i
    return lib
