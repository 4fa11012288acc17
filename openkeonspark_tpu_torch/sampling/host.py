"""The native C++ host sampler through ctypes, and the pipeline that feeds
its batches to the device.

Counterpart of ``openkeonspark_tpu/sampling/host.py``: the same library
source (``native/sampler.cpp``), the same ctypes signatures (``:44-60``),
the same flat reference layout and its split into a structured batch
(``:137-152``), and the prefetch pipeline (``:154-211``).

The library is compiled from ``native/sampler.cpp`` with g++ at first use,
into the port's build tree (``ops/build.py``'s ``BUILD_ROOT``, under a
directory named by a hash of the source and the flags). The tracked
``native/libokst_sampler.so`` is never loaded and ``native/`` is never
written: that library was built with ``-march=native`` on another CPU. The
port's build leaves ``-march=native`` out of the Makefile's flags, because
the build tree may travel with a copy of the checkout to another machine;
the sampler's arithmetic (integer draws, a double compared with a float)
gives the same batches either way.

:class:`HostPipeline` keeps ``depth`` items sampled ahead in a worker
thread. On a card each item goes through a pinned host staging buffer and
a ``non_blocking`` copy on a side stream, whose recorded event the
consumer's stream waits on (:meth:`HostPipeline.next`); a staging buffer
is refilled only after its last copy's event has completed. On the CPU
the items are plain tensors and no stream is used."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import queue
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu_torch.data.dataset import Dataset
from openkeonspark_tpu_torch.data.index import KGIndex
from openkeonspark_tpu_torch.ops.build import BUILD_ROOT
from openkeonspark_tpu_torch.sampling.device import SampledBatch

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sampler.cpp"
LIB_NAME = "libokst_sampler.so"
# native/Makefile's CXXFLAGS without -march=native, plus -shared
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-Wextra",
             "-shared")

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# path of the library this process loaded and whether it was built now
build_info: dict = {}


def build() -> Path:
    """Compile ``native/sampler.cpp`` unless a library for this source and
    these flags exists; returns its path. Raises with g++'s output if the
    build fails."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join((cxx, platform.machine()) + CXX_FLAGS)
                       .encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / ("sampler-" + h.hexdigest()[:16])
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), built=False)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # a private temporary directory, then a rename: a concurrent build
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = os.path.join(tmp, LIB_NAME)
        cmd = [cxx, *CXX_FLAGS, "-o", so, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):"
                               f"\n{proc.stderr}{proc.stdout}")
        os.replace(so, lib)
    build_info.update(path=str(lib), built=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded sampler library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.okst_create.restype = ctypes.c_void_p
            lib.okst_create.argtypes = (
                _i32p, _i32p, _i32p, ctypes.c_int64,
                _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
                _i32p, ctypes.c_int64, _i32p, ctypes.c_int64,
                _f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32)
            lib.okst_destroy.argtypes = (ctypes.c_void_p,)
            lib.okst_sample.argtypes = (
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64,
                _i32p, _i32p, _i32p, _f32p)
            lib.okst_version.restype = ctypes.c_int32
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


class HostSampler:
    """Threaded native sampler over the shared group indexes."""

    def __init__(self, ds: Dataset, index: KGIndex, n_threads: int = 4):
        self.n_ent, self.n_rel, self.n_train = ds.n_ent, ds.n_rel, ds.n_train
        self._lib = library()
        rows = index.train_row_tables(ds.train, with_rel=True)
        hr_adj = index.hr.adj.astype(np.int32)
        tr_adj = index.tr.adj.astype(np.int32)
        ent_adj = np.concatenate([hr_adj, tr_adj]) if len(tr_adj) else hr_adj
        tr_off = (rows["tr_off"].astype(np.int64) + len(hr_adj)).astype(
            np.int32)
        c = lambda a, dt=np.int32: np.ascontiguousarray(a, dt)  # noqa: E731
        args = [c(rows["train_h"]), c(rows["train_t"]), c(rows["train_r"]),
                c(rows["hr_off"]), c(rows["hr_cnt"]), c(tr_off),
                c(rows["tr_cnt"]), c(rows["ht_off"]), c(rows["ht_cnt"]),
                c(ent_adj), c(index.ht.adj), c(index.p_corrupt_head,
                                               np.float32)]
        (h, t, r, hr_off, hr_cnt, tr_off, tr_cnt, ht_off, ht_cnt,
         ent_adj, rel_adj, p) = args
        self._handle = self._lib.okst_create(
            _ptr(h, _i32p), _ptr(t, _i32p), _ptr(r, _i32p),
            ctypes.c_int64(self.n_train),
            _ptr(hr_off, _i32p), _ptr(hr_cnt, _i32p),
            _ptr(tr_off, _i32p), _ptr(tr_cnt, _i32p),
            _ptr(ht_off, _i32p), _ptr(ht_cnt, _i32p),
            _ptr(ent_adj, _i32p), ctypes.c_int64(len(ent_adj)),
            _ptr(rel_adj, _i32p), ctypes.c_int64(len(rel_adj)),
            _ptr(p, _f32p), self.n_ent, self.n_rel, n_threads)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.okst_destroy(handle)

    def sample_flat(self, seed: int, batch_size: int, negative_ent: int,
                    negative_rel: int, bern: bool,
                    partition: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, np.ndarray]:
        """The reference's buffer layout: batch_h/t/r ``[B·(1+negs)]``,
        batch_y ±1 (``Base.cpp::sampling``'s output contract)."""
        n = batch_size * (1 + negative_ent + negative_rel)
        h, t, r = (np.empty(n, np.int32) for _ in range(3))
        y = np.empty(n, np.float32)
        ps, sz = partition if partition else (0, 0)
        self._lib.okst_sample(
            self._handle, ctypes.c_uint64(seed), batch_size, negative_ent,
            negative_rel, int(bern), ctypes.c_int64(ps), ctypes.c_int64(sz),
            _ptr(h, _i32p), _ptr(t, _i32p), _ptr(r, _i32p), _ptr(y, _f32p))
        return {"batch_h": h, "batch_t": t, "batch_r": r, "batch_y": y}

    def sample(self, seed: int, batch_size: int, negative_ent: int,
               negative_rel: int, bern: bool,
               partition: Optional[Tuple[int, int]] = None) -> SampledBatch:
        """The structured layout of ``DeviceSampler.sample``, as int32
        numpy arrays: positives [B], ``neg_h``/``neg_t`` [B, negE],
        ``neg_rel`` [B, negR]."""
        flat = self.sample_flat(seed, batch_size, negative_ent, negative_rel,
                                bern, partition)
        B = batch_size
        h, t, r = flat["batch_h"], flat["batch_t"], flat["batch_r"]
        neg_h = neg_t = neg_rel = None
        if negative_ent:
            neg_h = h[B:B * (1 + negative_ent)].reshape(negative_ent, B).T
            neg_t = t[B:B * (1 + negative_ent)].reshape(negative_ent, B).T
        if negative_rel:
            neg_rel = r[B * (1 + negative_ent):].reshape(negative_rel, B).T
        return SampledBatch(h=h[:B], t=t[:B], r=r[:B], neg_h=neg_h,
                            neg_t=neg_t, neg_rel=neg_rel)


FIELDS = SampledBatch.FIELDS


def _stack(singles: List[SampledBatch]) -> SampledBatch:
    return SampledBatch(**{
        f: None if getattr(singles[0], f) is None
        else np.stack([getattr(b, f) for b in singles]) for f in FIELDS})


class _Staging:
    """Pinned host buffers of one item's shapes and the event of their
    last copy to the card."""

    def __init__(self, item: SampledBatch):
        self.bufs = item.map(lambda a: torch.empty(
            a.shape, dtype=torch.int32).pin_memory())
        self.event: Optional[torch.cuda.Event] = None


class HostPipeline:
    """Prefetch: a worker thread keeps ``depth`` sampled items ready on the
    device ahead of the consumer (:meth:`next`).

    With ``group_sizes`` the worker stacks that many consecutive batches per
    item, cycling through the list, into one ``[S, …]`` batch and moves it
    in one transfer; the consumer runs the group's S steps
    (``train/step.py::build_host_scan_steps``). Batch ``k`` of the stream
    is sampled with seed ``seed + k``, so a run resumed at global step
    ``s`` with ``seed = cfg.seed + s`` replays the uninterrupted run's
    data. Ids arrive as int64 tensors on ``device``."""

    def __init__(self, sampler: HostSampler, batch_size: int,
                 negative_ent: int, negative_rel: int, bern: bool,
                 seed: int = 0, depth: int = 2,
                 partition: Optional[Tuple[int, int]] = None,
                 group_sizes: Optional[list] = None,
                 device: torch.device = torch.device("cpu")):
        self.device = device
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        # staging buffers per item shape: the queue's items, the consumer's
        # and the one being filled each hold one
        self._pools: Dict[tuple, List[_Staging]] = {}
        self._turn: Dict[tuple, int] = {}
        self._slots = depth + 2

        def one(s):
            return sampler.sample(s, batch_size, negative_ent, negative_rel,
                                  bern, partition)

        def worker():
            s, gi = seed, 0
            try:
                while not self._stop.is_set():
                    if group_sizes:
                        size = group_sizes[gi % len(group_sizes)]
                        gi += 1
                        item = _stack([one(s + k) for k in range(size)])
                        s += size
                    else:
                        item = one(s)
                        s += 1
                    self._put(self._to_device(item))
            except BaseException as e:   # surfaced by next(), never lost
                self._put((None, e))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, entry) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.1)
                return
            except queue.Full:
                continue

    def _staging(self, item: SampledBatch) -> _Staging:
        key = tuple(getattr(item.map(lambda a: a.shape), f) for f in FIELDS)
        pool = self._pools.setdefault(key, [])
        if len(pool) < self._slots:
            pool.append(_Staging(item))
            return pool[-1]
        i = self._turn.get(key, 0)
        self._turn[key] = (i + 1) % self._slots
        return pool[i]

    def _to_device(self, item: SampledBatch):
        if self._stream is None:
            return item.map(lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).long()), None
        st = self._staging(item)
        if st.event is not None:
            st.event.synchronize()   # its last copy has left the buffer
        with torch.cuda.stream(self._stream):
            for f in FIELDS:
                if getattr(item, f) is not None:
                    getattr(st.bufs, f).numpy()[...] = getattr(item, f)
            out = st.bufs.map(lambda b: b.to(self.device,
                                              non_blocking=True).long())
            st.event = torch.cuda.Event()
            st.event.record(self._stream)
        return out, st.event

    def next(self) -> SampledBatch:
        """The next item, usable on the current stream."""
        batch, event = self._q.get()
        if batch is None:
            raise RuntimeError("host sampler worker failed") from event
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            batch.map(lambda x: x.record_stream(stream))
        return batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if self._stream is not None:
            self._stream.synchronize()
