"""Sparse SGD: a step touches only the sampled rows.

Counterpart of ``openkeonspark_tpu/train/optim.py`` (``DenseUpdate``
``:36-48``, ``scatter_add_rows`` ``:73-97``, ``SparseSGD`` ``:116-142``).
An update is, per table, either a list of ``(ids, row_grads)`` pairs,
applied as ``table[ids] -= α·g`` with duplicate ids summed and ids ≥ rows
dropped, or a :class:`DenseUpdate` (the grouped TransR step's
``transfer_matrix`` gradient), applied as one streaming add.

Unlike the JAX package, which returns new tables, the port updates the
tables in place: the dense ``transfer_matrix`` update would otherwise
allocate and write a second 107.7 MB table every step at the TransR
config. The JAX package's one-hot MXU route for small tables is a TPU
scatter workaround and is not ported. Its wide-row route (rows ≥ 4096
floats) runs the Pallas kernel ``ops/pallas_scatter.py`` (B5), which the
port does not have yet: a wide-row scatter into a CUDA table raises.
Lazy Adam, Adagrad and Adadelta are not ported yet."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple, Union

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.runtime import NotPortedError

# rows at least this wide take the JAX package's Pallas scatter kernel
# (optim.py:56-70), which is ROADMAP B5 for the port
WIDE_SCATTER_MIN_WIDTH = 4096


class DenseUpdate(NamedTuple):
    """A full-table gradient (untouched rows exactly zero) and the touched
    mask."""
    grad: torch.Tensor      # [rows, dim] f32
    touched: torch.Tensor   # [rows] bool


# table name -> [(ids [N], row_grads [N, dim]), …] or a DenseUpdate
Updates = Dict[str, Union[List[Tuple[torch.Tensor, torch.Tensor]],
                          DenseUpdate]]


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor) -> None:
    """In place ``table[ids] += delta``; ids ≥ the table's rows are
    dropped (masked to a zero add, so no host sync), duplicates sum."""
    if table.is_cuda and table.shape[1] >= WIDE_SCATTER_MIN_WIDTH:
        raise NotPortedError(
            f"scatter into {table.shape[1]}-wide rows: the JAX package runs "
            "its Pallas kernel ops/pallas_scatter.py here, not yet ported "
            "(ROADMAP.md queue B5)")
    rows = table.shape[0]
    valid = (ids < rows)[:, None]
    table.index_add_(0, torch.clamp(ids, max=rows - 1),
                     torch.where(valid, delta, 0.0))


class SparseSGD:
    """α-scaled row updates; no state (reference ``opt_method='SGD'``)."""

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha

    def init(self, params) -> dict:
        return {}

    def apply(self, params, state, updates: Updates, step):
        """Update ``params`` in place; returns (params, state)."""
        for table, pairs in updates.items():
            t = params[table]
            if isinstance(pairs, DenseUpdate):
                # streaming dense add: untouched rows carry exact zeros
                t.add_(pairs.grad, alpha=-self.lr)
                continue
            # one scatter per table, not one per id stream
            ids = torch.cat([i for i, _ in pairs])
            g = torch.cat([gg for _, gg in pairs])
            scatter_add_rows(t, ids, -self.lr * g)
        return params, state


def make_optimizer(cfg: Config) -> SparseSGD:
    if cfg.opt_method.lower() != "sgd":
        raise NotPortedError(
            f"opt_method {cfg.opt_method!r} is not yet ported (only sgd); "
            "see ROADMAP.md queue A")
    return SparseSGD(cfg)
