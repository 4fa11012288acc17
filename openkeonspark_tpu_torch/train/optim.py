"""Sparse optimizers: a step touches only the sampled rows.

Counterpart of ``openkeonspark_tpu/train/optim.py:50-313``. An update is,
per table, either a list of ``(ids, row_grads)`` pairs (duplicate ids sum,
ids ≥ rows are dropped) or a :class:`DenseUpdate` (the grouped TransR
step's ``transfer_matrix`` gradient).

- **SGD** (the reference's default): ``table[ids] -= α·g``, or one
  streaming add of a dense gradient.
- **Lazy Adam, Adagrad and Adadelta** (the reference's ``set_opt_method``
  family): state tables change only at touched rows; duplicate ids are
  summed first, so each touched row takes one update; Adam's bias
  correction uses the global step in fp32.

Row scatters go through :func:`scatter_add_rows`: rows at least
``WIDE_SCATTER_MIN_WIDTH`` floats wide (TransR's ``transfer_matrix``) take
kernel B5 (``ops/scatter.py``), the sorted-run scatter that the JAX
package runs as its Pallas kernel; narrower rows take a masked
``index_add_``.

Unlike the JAX package, which returns new tables, the port updates tables
and optimizer state in place: a dense ``transfer_matrix`` update would
otherwise allocate and write a second 107.7 MB table every step at the
TransR config. The JAX package's one-hot MXU route for small tables is a
TPU scatter workaround and is not ported."""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Tuple, Union

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.ops.scatter import (scatter_add_rows_sorted,
                                                 scatter_add_rows_sorted_ref)

# rows at least this wide take kernel B5, as the JAX package's take its
# Pallas kernel (optim.py:56-70)
WIDE_SCATTER_MIN_WIDTH = 4096


class DenseUpdate(NamedTuple):
    """A full-table gradient (untouched rows exactly zero) and the touched
    mask."""
    grad: torch.Tensor      # [rows, dim] f32
    touched: torch.Tensor   # [rows] bool


# table name -> [(ids [N], row_grads [N, dim]), …] or a DenseUpdate
Updates = Dict[str, Union[List[Tuple[torch.Tensor, torch.Tensor]],
                          DenseUpdate]]


def use_wide_kernel(table: torch.Tensor) -> bool:
    """Whether :func:`scatter_add_rows` sends ``table`` to B5.
    ``OKST_NO_WIDE_SCATTER=1`` is the user's A/B switch to the masked
    scatter (the JAX package's ``optim.py:65-70``); nothing else sets it."""
    if os.environ.get("OKST_NO_WIDE_SCATTER") == "1":
        return False
    return table.dim() == 2 and table.shape[1] >= WIDE_SCATTER_MIN_WIDTH


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor, plain: bool = False) -> None:
    """In place ``table[ids] += delta``; ids ≥ the table's rows are
    dropped, duplicates sum. Wide rows (:func:`use_wide_kernel`) take B5:
    the kernel for a CUDA table, its plain version for a CPU table or when
    ``plain`` (the reference the kernel is held to); both add in
    stable-sorted order. Other rows take a masked ``index_add_`` (no host
    sync; on the card its atomics add in no fixed order)."""
    if use_wide_kernel(table):
        # an id stream may be a column of the sampler's batch (a strided
        # view); B5 reads ids and deltas through raw pointers
        ids, delta = ids.contiguous(), delta.contiguous()
        if plain:
            scatter_add_rows_sorted_ref(table, ids, delta)
        else:
            scatter_add_rows_sorted(table, ids, delta)
        return
    rows = table.shape[0]
    valid = (ids < rows)[:, None]
    table.index_add_(0, torch.clamp(ids, max=rows - 1),
                     torch.where(valid, delta, 0.0))


def _merged(pairs) -> Tuple[torch.Tensor, torch.Tensor]:
    """One id stream and one gradient stream per table."""
    if len(pairs) == 1:
        return pairs[0]
    return (torch.cat([i for i, _ in pairs]),
            torch.cat([g for _, g in pairs]))


def aggregate_duplicates(ids: torch.Tensor, grads: torch.Tensor,
                         sentinel: int, plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum gradient rows with equal ids: (uids [N], agg [N, d]), where
    slots past the number of unique ids hold ``sentinel`` / zeros. The
    segment sum goes through :func:`scatter_add_rows`."""
    s_ids, order = torch.sort(ids, stable=True)
    first = torch.ones_like(s_ids, dtype=torch.bool)
    first[1:] = s_ids[1:] != s_ids[:-1]
    seg = torch.cumsum(first, 0) - 1
    agg = torch.zeros_like(grads)
    scatter_add_rows(agg, seg, grads[order], plain)
    uids = torch.full_like(ids, sentinel).scatter_(0, seg, s_ids)
    return uids, agg


class SparseSGD:
    """α-scaled row updates; no state (reference ``opt_method='SGD'``)."""

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha

    def init(self, params) -> dict:
        return {}

    def apply(self, params, state, updates: Updates, step,
              plain: bool = False):
        """Update ``params`` in place; returns (params, state). ``plain``
        sends wide rows through B5's plain version on any device."""
        for table, pairs in updates.items():
            t = params[table]
            if isinstance(pairs, DenseUpdate):
                # streaming dense add: untouched rows carry exact zeros
                t.add_(pairs.grad, alpha=-self.lr)
                continue
            # one scatter per table, not one per id stream
            ids, g = _merged(pairs)
            scatter_add_rows(t, ids, -self.lr * g, plain)
        return params, state


class _LazyRowOptimizer:
    """Stateful optimizers with lazy (touched-rows-only) semantics, the
    reference's TF sparse apply: duplicate ids are summed first, so each
    touched row takes one read-modify-write.

    Subclasses declare ``state_slots`` (one table per parameter table
    each, filled with ``slot_init`` or 0) and implement ``_row_update(G,
    rows, step) → (delta, new_rows)``, the per-row math at touched rows.

    Three application paths, with the same semantics:

    - :class:`DenseUpdate`: the gradient is already dense (grouped TransR)
      — one masked elementwise pass;
    - dense G (tables of at most ``DENSE_MOMENT_MAX_ELEMS`` elements): the
      gradient rows are summed into a zeroed table with
      :func:`scatter_add_rows` (B5 for wide rows) and a touched mask is
      counted, then one masked elementwise pass;
    - sort aggregation (larger tables): :func:`aggregate_duplicates`, then
      masked delta-adds at the unique rows, bounding scratch memory to
      the update stream."""

    state_slots: Tuple[str, ...] = ()
    slot_init: Dict[str, float] = {}

    # tables up to this many elements take the dense-G path (its scratch
    # table costs rows·dim f32, 256 MB at the cap)
    DENSE_MOMENT_MAX_ELEMS = 64 * 1024 * 1024

    def init(self, params) -> dict:
        return {s: {k: torch.full_like(v, self.slot_init.get(s, 0.0))
                    for k, v in params.items()}
                for s in self.state_slots}

    def _row_update(self, G, rows: Dict[str, torch.Tensor], step):
        raise NotImplementedError

    def _apply_masked(self, p, slots, G, touched, step) -> None:
        delta, new = self._row_update(G, slots, step)
        for s, t in slots.items():
            t.copy_(torch.where(touched, new[s], t))
        p.add_(torch.where(touched, delta, 0.0))

    def apply(self, params, state, updates: Updates, step,
              plain: bool = False):
        """Update ``params`` and ``state`` in place; returns (params,
        state). ``plain`` sends wide rows through B5's plain version."""
        for table, pairs in updates.items():
            p = params[table]
            slots = {s: state[s][table] for s in self.state_slots}
            if isinstance(pairs, DenseUpdate):
                self._apply_masked(p, slots, pairs.grad,
                                   pairs.touched[:, None], step)
                continue
            ids, g = _merged(pairs)
            rows = p.shape[0]
            if p.numel() <= self.DENSE_MOMENT_MAX_ELEMS:
                G = torch.zeros_like(p)
                scatter_add_rows(G, ids, g, plain)
                hits = torch.zeros(rows, 1, device=p.device)
                hits.index_add_(0, torch.clamp(ids, max=rows - 1),
                                (ids < rows)[:, None].float())
                self._apply_masked(p, slots, G, hits > 0, step)
                continue
            # sort aggregation; `rows` itself is the discard sentinel
            uids, agg = aggregate_duplicates(ids, g, rows, plain)
            valid = (uids < rows)[:, None]
            uc = torch.clamp(uids, max=rows - 1)
            old = {s: t[uc] for s, t in slots.items()}
            delta, new = self._row_update(agg, old, step)
            # collision-safe masked delta-adds: invalid lanes add exact 0
            for s, t in slots.items():
                t.index_add_(0, uc, torch.where(valid, new[s] - old[s], 0.0))
            p.index_add_(0, uc, torch.where(valid, delta, 0.0))
        return params, state


class SparseAdam(_LazyRowOptimizer):
    """Lazy Adam over touched rows (reference ``opt_method='Adam'``); bias
    correction uses the global step."""

    state_slots = ("m", "v")

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha
        self.b1 = cfg.adam_beta1
        self.b2 = cfg.adam_beta2
        self.eps = cfg.adam_eps

    def _row_update(self, G, rows, step):
        # in fp32, as the JAX package computes it from its int32 step
        t = torch.tensor(step + 1, dtype=torch.float32)
        lr_t = float(self.lr * torch.sqrt(1.0 - self.b2 ** t)
                     / (1.0 - self.b1 ** t))
        m_new = self.b1 * rows["m"] + (1.0 - self.b1) * G
        v_new = self.b2 * rows["v"] + (1.0 - self.b2) * (G * G)
        delta = -lr_t * m_new / (torch.sqrt(v_new) + self.eps)
        return delta, {"m": m_new, "v": v_new}


class SparseAdagrad(_LazyRowOptimizer):
    """Lazy Adagrad (reference ``opt_method='Adagrad'``): TF1
    ``AdagradOptimizer(alpha, initial_accumulator_value=1e-20)`` —
    ``accum += G²; param -= α·G/√accum`` at touched rows."""

    state_slots = ("accum",)

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha
        self.slot_init = {"accum": cfg.adagrad_init_acc}

    def _row_update(self, G, rows, step):
        a_new = rows["accum"] + G * G
        delta = -self.lr * G / torch.sqrt(a_new)
        return delta, {"accum": a_new}


class SparseAdadelta(_LazyRowOptimizer):
    """Lazy Adadelta (reference ``opt_method='Adadelta'``), TF1 defaults
    ρ=0.95, ε=1e-8. At touched rows: ``accum = ρ·accum + (1−ρ)G²``;
    ``u = G·√(accum_update+ε)/√(accum+ε)``; ``param -= α·u``;
    ``accum_update = ρ·accum_update + (1−ρ)u²``."""

    state_slots = ("accum", "accum_update")

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha
        self.rho = cfg.adadelta_rho
        self.eps = cfg.adadelta_eps

    def _row_update(self, G, rows, step):
        a_new = self.rho * rows["accum"] + (1.0 - self.rho) * (G * G)
        u = (G * torch.sqrt(rows["accum_update"] + self.eps)
             / torch.sqrt(a_new + self.eps))
        delta = -self.lr * u
        return delta, {"accum": a_new,
                       "accum_update": self.rho * rows["accum_update"]
                       + (1.0 - self.rho) * (u * u)}


_OPTIMIZERS = {"sgd": SparseSGD, "adam": SparseAdam,
               "adagrad": SparseAdagrad, "adadelta": SparseAdadelta}


def make_optimizer(cfg: Config):
    return _OPTIMIZERS[cfg.opt_method.lower()](cfg)
