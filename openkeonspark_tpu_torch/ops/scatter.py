"""Sorted-run scatter-add into wide table rows: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``openkeonspark_tpu/ops/pallas_scatter.py``
(``scatter_add_rows_sorted`` ``:142-189``, ``_kernel`` ``:42-138``). In
place, ``table[ids] += delta``: ids outside ``[0, rows)`` are dropped (the
sharded step's discard sentinel is ``rows``), and the duplicates of a row
are added one at a time, starting from the table's value, in stable-sorted
order — ``row ← ((row + d₀) + d₁) + …``, as the JAX kernel adds them. Both
versions take the same stable sort and the same run offsets
(``ops/grouped.py::run_offsets``), so the kernel and the plain version
agree bit for bit, and the result does not depend on the order in which
the card runs its blocks (a masked ``index_add_`` adds with atomics in no
fixed order).

The kernel source is ``csrc/scatter_rows.cu``. CUDA tensors go through the
kernel (or raise); CPU tensors go through the plain version. The TPU
kernel's 128-lane pad-and-slice, its ``[rows, 1, W]`` reshape and its DMA
ring are TPU artifacts and have no counterpart here."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu_torch.ops.build import check_tensor as _check
from openkeonspark_tpu_torch.ops.grouped import run_offsets

# launches of the kernel since the last reset_launch_counts(); the wrapper
# adds one where it launches the kernel and nowhere else
LAUNCHES: Dict[str, int] = {"scatter_add_rows_sorted": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sorted_runs(ids: torch.Tensor, rows: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sorted ids, order, off): the stable sort of ``ids`` and int32
    ``off [rows + 1]``, row ρ owning sorted positions ``[off[ρ],
    off[ρ+1])``; ids outside ``[0, rows)`` lie in no run. No host sync."""
    sids, order = torch.sort(ids, stable=True)
    return sids, order, run_offsets(sids, rows)


def scatter_add_rows_sorted_ref(table: torch.Tensor, ids: torch.Tensor,
                                delta: torch.Tensor) -> torch.Tensor:
    """Plain version, in place: round j adds the j-th member of every run
    (one ``index_add_`` whose ids are distinct, so each row takes exactly
    one rounded add per round, in run order). Returns ``table``."""
    rows = table.shape[0]
    sids, order, off = sorted_runs(ids, rows)
    lo, hi = int(off[0]), int(off[rows])           # the valid ids
    if hi <= lo:
        return table
    sids, order = sids[lo:hi], order[lo:hi]
    off = off.long()
    rank = torch.arange(lo, hi, device=ids.device) - off[sids]
    by_round = torch.sort(rank, stable=True).indices
    ends = torch.cumsum(torch.bincount(rank), 0).tolist()
    start = 0
    for end in ends:
        sel = by_round[start:end]
        table.index_add_(0, sids[sel], delta[order[sel]])
        start = end
    return table


def scatter_add_rows_sorted(table: torch.Tensor, ids: torch.Tensor,
                            delta: torch.Tensor) -> torch.Tensor:
    """In place ``table[ids] += delta`` in sorted-run order; ``table``
    ``[rows, W]`` f32, ``ids`` ``[N]`` int64, ``delta`` ``[N, W]`` f32, all
    contiguous on one device. Returns ``table``. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"table {tuple(table.shape)} and ids "
                         f"{tuple(ids.shape)} must be [rows, W] and [N]")
    rows, width = table.shape
    n = ids.shape[0]
    dev = table.device
    _check("table", table, torch.float32, (rows, width), dev)
    _check("ids", ids, torch.int64, (n,), dev)
    _check("delta", delta, torch.float32, (n, width), dev)
    if dev.type == "cpu":
        return scatter_add_rows_sorted_ref(table, ids, delta)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n == 0 or rows == 0:
        return table
    from openkeonspark_tpu_torch.ops.build import check_launch, library
    _, order, off = sorted_runs(ids, rows)
    with torch.cuda.device(dev):
        err = library().okst_scatter_add_rows_sorted(
            table.data_ptr(), delta.data_ptr(), order.data_ptr(),
            off.data_ptr(), rows, width,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("okst_scatter_add_rows_sorted", err)
    LAUNCHES["scatter_add_rows_sorted"] += 1
    return table
