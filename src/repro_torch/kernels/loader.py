"""Build and load the port's CUDA kernels.

Every ``.cu`` file under ``src/repro_torch/csrc/`` is listed in
:data:`SOURCES`.  :func:`library` compiles them with ``nvcc`` at first use,
one ``nvcc`` process per source, all started together, links the objects
into one shared library with a plain C interface under
``src/repro_torch/_build/`` (named by a hash of the sources and flags, so a
stale library is never loaded), and opens it with ``ctypes``.  Nothing is
built at import time: a machine without ``nvcc`` imports every module and
runs the plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

SOURCES = ("embedding_bag.cu", "filtered_topk.cu", "gather_distance.cu",
           "neighbor_expand.cu", "pna_aggregate.cu")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the element types a kernel reads as stored, by the code its C entry
# point takes (fp32 0, bf16 1, fp16 2)
FLOAT_TYPES = ("float32", "bfloat16", "float16")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# filled by the build that loaded the library (None when it was reused)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Start every command at once, wait for all; raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path."""
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", o]
                         for s, o in zip(SOURCES, objs)])
        tmp_lib = os.path.join(tmp, lib_path.name)
        logs += _run_all([[nvcc, "-shared", *objs, "-o", tmp_lib]])
        os.replace(tmp_lib, lib_path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      log="\n".join(l for l in logs if l))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.repro_gather_distance.argtypes = [p, p, p, p, i, i, i, i, i, p]
            lib.repro_gather_distance.restype = i
            lib.repro_neighbor_expand.argtypes = [p, p, p, p, p, p, p, i, i,
                                                  i, i, i, i, i, p]
            lib.repro_neighbor_expand.restype = i
            lib.repro_neighbor_expand_smem_bytes.argtypes = [i, i]
            lib.repro_neighbor_expand_smem_bytes.restype = i
            lib.repro_neighbor_expand_set_words.argtypes = [i, i]
            lib.repro_neighbor_expand_set_words.restype = ctypes.c_longlong
            lib.repro_filtered_topk.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                                i, i, i, i, p]
            lib.repro_filtered_topk.restype = i
            lib.repro_filtered_topk_workspace.argtypes = [i, i, i]
            lib.repro_filtered_topk_workspace.restype = ctypes.c_longlong
            lib.repro_pna_aggregate.argtypes = [p, p, p, i, i, i, p]
            lib.repro_pna_aggregate.restype = i
            lib.repro_embedding_bag.argtypes = [p, p, p, i, i, i, i, i, i,
                                                p]
            lib.repro_embedding_bag.restype = i
            _LIB = lib
        return _LIB


def float_code(t) -> int:
    """The C entry points' code of a tensor of one of ``FLOAT_TYPES``."""
    return FLOAT_TYPES.index(str(t.dtype).rsplit(".", 1)[-1])


def floats():
    """The dtypes of ``FLOAT_TYPES``, for :func:`check_tensors`."""
    import torch
    return tuple(getattr(torch, name) for name in FLOAT_TYPES)


def check_tensors(fn: str, dev, named) -> None:
    """Raise unless each ``(name, tensor, dtype, ndim)`` of ``named`` is a
    contiguous ``ndim``-D tensor of ``dtype`` (or of one of a tuple of
    dtypes) on the CUDA device ``dev``: ``ValueError`` for the device, the
    rank or the layout, ``TypeError`` for the dtype (no cast)."""
    for name, t, dt, nd in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, expected {dev} "
                             "(cuda)")
        allowed = dt if isinstance(dt, tuple) else (dt,)
        if t.dtype not in allowed:
            want = " or ".join(str(a) for a in allowed)
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {want}")
        if t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {nd}-D "
                             "tensor")


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaError_t)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
