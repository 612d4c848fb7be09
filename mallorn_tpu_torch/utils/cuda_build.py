"""Build the port's CUDA sources into one shared library and load it.

Plain ``nvcc`` with a C interface, bound with ``ctypes``: no PyTorch C++
headers and no PyTorch extension builder (a source that includes the
PyTorch headers takes minutes to compile; these take seconds).

- The library is ``build/mallorn_tpu_torch/libmallorn_kernels_<sha>.so``
  under the repository root, keyed by a digest of every source and the
  compiler flags, and built on first use in the process.
- Every source compiles to an object in parallel (one ``nvcc`` each, all
  started together), then one ``nvcc -shared`` links them.
- Outputs go to temporary names and ``os.replace`` moves them into place,
  so two processes building at once never see a partial file and nobody
  waits on a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "mallorn_tpu_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-lineinfo"]
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install location; raises when none exists."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmallorn_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed, logs = [], []
    for cmd, p in zip(cmds, procs):
        try:
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed.append((cmd, f"timed out after {BUILD_TIMEOUT_S} s\n{out}"))
            continue
        if p.returncode != 0:
            failed.append((cmd, out))
        logs.append(out)
    if failed:
        msg = "\n".join(f"$ {' '.join(c)}\n{o}" for c, o in failed)
        raise RuntimeError(f"CUDA kernel build failed:\n{msg}")
    return "".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile and link the library if it is not built yet; returns its
    path. ``verbose`` prints the compiler's report (``-Xptxas -v``:
    registers, shared memory and spills of each kernel)."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    extra = ["-Xptxas", "-v"] if verbose else []
    objs, cmds = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)])
    try:
        log = _run_all(cmds)
        if verbose:
            print(log, end="", flush=True)
        tmp = so.with_name(f"{so.stem}.{tag}.tmp.so")
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs),
                   "-o", str(tmp)]])
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The built library with every entry point's ``argtypes`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.mallorn_chol_inv.argtypes = [p, p, p, i, i, p]
            lib.mallorn_chol_inv.restype = ctypes.c_int
            lib.mallorn_chol_inv_tiled.argtypes = [p, p, p, p, i, i, ctypes.POINTER(i), p]
            lib.mallorn_chol_inv_tiled.restype = ctypes.c_int
            lib.mallorn_chol_inv_cluster.argtypes = [p, p, p, i, i, i, p]
            lib.mallorn_chol_inv_cluster.restype = ctypes.c_int
            lib.mallorn_chol_cluster.argtypes = [p, p, i, i, i, p]
            lib.mallorn_chol_cluster.restype = ctypes.c_int
            lib.mallorn_chol_cluster_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
            lib.mallorn_chol_cluster_occupancy.restype = ctypes.c_int
            lib.mallorn_chol.argtypes = [p, p, i, i, p]
            lib.mallorn_chol.restype = ctypes.c_int
            lib.mallorn_chol_tiled.argtypes = [p, p, p, i, i, ctypes.POINTER(i), p]
            lib.mallorn_chol_tiled.restype = ctypes.c_int
            lib.mallorn_hist.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, i, p]
            lib.mallorn_hist.restype = ctypes.c_int
            lib.mallorn_hist_group_rows.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
            lib.mallorn_hist_group_rows.restype = ctypes.c_int
            lib.mallorn_hist_wide.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p]
            lib.mallorn_hist_wide.restype = ctypes.c_int
            lib.mallorn_seg_hist.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, i, p]
            lib.mallorn_seg_hist.restype = ctypes.c_int
            lib.mallorn_hist_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.mallorn_hist_bf16.restype = ctypes.c_int
            lib.mallorn_hist_i8.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.mallorn_hist_i8.restype = ctypes.c_int
            lib.mallorn_digit_prep.argtypes = [p, p, p, p, i, i, i, p]
            lib.mallorn_digit_prep.restype = ctypes.c_int
            lib.mallorn_cuda_error_string.argtypes = [i]
            lib.mallorn_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = load().mallorn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
