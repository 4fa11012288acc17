"""The psum step: tables row-sharded over ``'model'``, batches over
``'data'``.

Counterpart of ``openkeonspark_tpu/parallel/sharded.py:74-158``, one
process per grid cell instead of one ``shard_map`` program:

- **Positives**: data row ``d`` draws ``batch_size // D`` positives from
  its own contiguous triple slice (``partition``); every rank of the row
  draws the same bits, from a generator seeded by (seed, step, d)
  (``train/loop.py::group_generator``), the counterpart of
  ``fold_in(key, d)``. A grid with one data row draws what one device
  draws.
- **Gather**: each rank takes the rows it owns of every distinct id stream
  (masked, the rest zero) and one ``all_reduce`` over ``'model'``
  assembles the full rows (``:109-118``). Streams are gathered as
  ``train/step.py::gather_slots_structured`` gathers them, so a (1, 1)
  grid runs the single-device step's arithmetic bit for bit.
- **Update**: the merged (ids, row grads) streams are ``all_gather``-ed
  over ``'data'`` (``:123-141``; their lengths are fixed by the batch
  shape, equal on every rank), the ids a rank does not own go to the
  optimizer's discard sentinel, and the optimizer applies them to the
  local rows. Gradients sum over data rows. The loss is summed over
  ``'data'`` (``:144``).

TransR takes the generic slot route here, with entity negatives too, as
in the JAX package (``:120``): its ``transfer_matrix`` rows go through
``train/optim.py::scatter_add_rows``, kernel B5 on a card."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import KGEModel
from openkeonspark_tpu_torch.parallel.mesh import (DATA, MODEL, Grid,
                                                   all_gather, all_gather_ids,
                                                   all_reduce)
from openkeonspark_tpu_torch.sampling.device import (DeviceSampler,
                                                     SampledBatch)
from openkeonspark_tpu_torch.train.optim import Updates, make_optimizer
from openkeonspark_tpu_torch.train.step import (TrainState,
                                                check_train_supported,
                                                gather_slots_structured,
                                                merged_row_updates,
                                                slot_loss_and_grads)


def data_partition(n_train: int, grid: Grid) -> Tuple[int, int]:
    """(start, size) of this rank's data row's triple slice; the last row
    takes the remainder (``:99-101``)."""
    base = n_train // grid.data
    start = grid.d_idx * base
    size = n_train - start if grid.d_idx == grid.data - 1 else base
    return start, size


def masked_take(local: torch.Tensor, ids: torch.Tensor, first: int
                ) -> torch.Tensor:
    """Rows of ``ids`` held locally (rows ``[first, first + Lp)``), zeros
    for the rest."""
    lp = local.shape[0]
    lid = ids - first
    owned = (lid >= 0) & (lid < lp)
    rows = local[lid.clamp(0, lp - 1)]
    return torch.where(owned[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def owned_or_sentinel(ids: torch.Tensor, first: int, lp: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local ids, the ids ≥ first and < first + lp; ``lp`` — the
    optimizer's discard sentinel — for the rest, ownership mask)."""
    lid = ids - first
    owned = (lid >= 0) & (lid < lp)
    return torch.where(owned, lid, lp), owned


def build_sharded_train_step(model: KGEModel, cfg: Config, grid: Grid,
                             batch_size: int, n_train: int,
                             opt=None) -> Callable:
    """``(state, sampler, bits) → (state, global loss)``, with ``bits`` the
    data row's u32 draws ``[batch_size // D, cols]``; ``step.batch_step
    (state, batch)`` runs it on a given data-row batch. ``batch_size`` is
    global. State from ``shard_state(state, grid, flat=False)``. ``opt``:
    the optimizer that applies the local updates (``make_optimizer(cfg)``
    by default)."""
    check_train_supported(cfg)
    B_local = max(1, batch_size // grid.data)
    partition = data_partition(n_train, grid)
    opt = opt or make_optimizer(cfg)

    def batch_step(state: TrainState, batch: SampledBatch):
        m_idx = grid.m_idx

        def take(table, ids):
            local = state.params[table]
            rows = masked_take(local, ids, m_idx * local.shape[0])
            return all_reduce(rows, grid, MODEL)

        slots, n_neg = gather_slots_structured(model, state.params, batch,
                                               take=take)
        loss, g_slots = slot_loss_and_grads(model, cfg, slots, B_local,
                                            n_neg)
        updates: Updates = {}
        for table, pairs in merged_row_updates(model.gathers(), batch,
                                               g_slots).items():
            lp = state.params[table].shape[0]
            for uid, ug in pairs:
                gid = all_gather_ids(uid, grid, DATA)
                gg = all_gather(ug, grid, DATA)
                lid, owned = owned_or_sentinel(gid, m_idx * lp, lp)
                updates.setdefault(table, []).append(
                    (lid, torch.where(owned[:, None], gg, 0.0)))
        params, opt_state = opt.apply(state.params, state.opt_state,
                                      updates, state.step)
        return (TrainState(params, opt_state, state.step + 1),
                all_reduce(loss, grid, DATA))

    def step_fn(state: TrainState, sampler: DeviceSampler,
                bits: torch.Tensor):
        return batch_step(state, sampler.sample(
            B_local, cfg.negative_ent, cfg.negative_rel, cfg.bern,
            bits=bits, partition=partition))

    step_fn.bits_shape = (B_local, DeviceSampler.bits_cols(
        cfg.negative_ent, cfg.negative_rel))
    step_fn.batch_step = batch_step
    return step_fn
