"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) into one shared
library with a plain C interface, ``build/kernels/<hash>/libokst_kernels.so``
under the checkout, keyed by a hash of the sources and flags, at first use:
one ``nvcc -c`` per source, all started together, then one link. A build
takes seconds because no source includes PyTorch's headers. The library is
loaded once per process; every pointer and the stream are passed as
``ctypes.c_void_p``, so no pointer is cut to 32 bits."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libokst_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each launcher: every one returns its cudaError_t as int
SIGNATURES = {
    # q, table, gold, gold_ids, counts, C, D, n_ent, sign, p, stream
    "okst_count_better_transe": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, table, ids, out, C, K, D, rows, sign, p, stream
    "okst_transe_score_ids": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, w, table, gold, gold_ids, counts, C, D, n_ent, sign, p, stream
    "okst_count_better_transh": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                                 _P),
    # q, w, table, ids, out, C, K, D, rows, sign, p, stream
    "okst_transh_score_ids": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, rp, table, cdot, gold, gold_ids, counts, C, D, n_ent, sign, p,
    # stream
    "okst_count_better_transd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                 _I, _P),
    # q, rp, table, cdot, ids, out, C, K, D, rows, sign, p, stream
    "okst_transd_score_ids": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                              _P),
    # q, table, gold, gold_ids, counts, C, d, n_ent, sign, stream
    "okst_count_better_rotate": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # q, table, ids, out, C, K, d, rows, sign, stream
    "okst_rotate_score_ids": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # m3, x, rel_off, y, rows, de, dr, stream
    "okst_grouped_project_fwd": (_P, _P, _P, _P, _I, _I, _I, _P),
    # m3, x, g, rel_off, dx, dm, rows, de, dr, stream
    "okst_grouped_project_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # table, delta, order, off, rows, width, stream
    "okst_scatter_add_rows_sorted": (_P, _P, _P, _P, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}   # path, seconds (0.0 when cached) and nvcc's log


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the "
                       "CUDA kernels are built with nvcc at first use")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Raises with nvcc's output if the build fails."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, log="(cached)")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one compiler per source, all running at once; a private temporary
    # directory, then a rename: a concurrent build never loads a
    # half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in (s for s in srcs if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compiler before raising, so none outlives a failure
        log = [f"$ {' '.join(cmd)}\n{proc.communicate()[0]}"
               for cmd, _, proc in jobs]
        for (_, _, proc), out in zip(jobs, log):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {out}")
        so = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, "-shared", "-o", so, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        os.replace(so, lib)
    build_info.update(path=str(lib), seconds=time.perf_counter() - t0,
                      log="".join(log))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensor(name: str, t, dtype, shape: tuple, device) -> None:
    """Raise unless tensor ``t`` lies on ``device`` with ``dtype``,
    ``shape`` and a contiguous layout: what a kernel given its raw
    pointer assumes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
