"""Build of the port's CUDA kernels: `nvcc` into a shared library, at first use.

Every `*.cu` file under `csrc/` is compiled for `sm_90a` into an object file,
one `nvcc` process per source, all started together; the objects are then
linked into one shared library with a plain C interface, loaded with
`ctypes`.  The library goes into `build/` at the repository root
(git-ignored), under a key made from a hash of the sources and the flags, so
an edited source rebuilds and an unchanged one is reused within a checkout.
A failed build raises with nvcc's output.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
            nvcc = _nvcc()
            # objects in a directory of this process's own, so that ranks
            # building at once do not write over each other's files
            work = Path(tempfile.mkdtemp(dir=out_dir))
            objs = [work / f"{src.stem}.o" for src in sources]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(sources, objs, strict=True)]
            logs = [(proc.args, proc.communicate()[0], proc.returncode) for proc in procs]
            if all(rc == 0 for _, _, rc in logs):
                link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(work / lib_path.name),
                        *map(str, objs)]
                proc = subprocess.run(link, capture_output=True, text=True, check=False)
                logs.append((link, proc.stdout + proc.stderr, proc.returncode))
            (work / "nvcc.log").write_text("".join(out for _, out, _ in logs))
            os.replace(work / "nvcc.log", out_dir / "nvcc.log")
            failed = [(cmd, out, rc) for cmd, out, rc in logs if rc != 0]
            if failed:
                shutil.rmtree(work, ignore_errors=True)
                cmd, out, rc = failed[0]
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
            os.replace(work / lib_path.name, lib_path)
            shutil.rmtree(work, ignore_errors=True)
        _library = _bind(ctypes.CDLL(str(lib_path)))
        return _library


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) for the current sources."""
    return (BUILD_ROOT / _key() / "nvcc.log").read_text()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    fn = lib.flash_attention_fwd
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, i, p]
    fn.restype = i
    fn = lib.flash_attention_bwd_dkv
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, i, p]
    fn.restype = i
    fn = lib.flash_attention_bwd_dq
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, i, p]
    fn.restype = i
    fn = lib.rg_lru_fwd
    fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    fn = lib.wkv6_fwd
    fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.rg_lru_bwd
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    fn = lib.wkv6_bwd
    fn.argtypes = [p, p, p, p, p, p, p, p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.fabric_playback  # the float64 scalars as doubles: a float would round them
    fn.argtypes = [p, p, p, p, p, p, d, d, d, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = i
    fn = lib.fabric_playback_max_clusters
    fn.argtypes = [i, i, i, i, i, p]
    fn.restype = i
    return lib
