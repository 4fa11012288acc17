"""The training step: sample → gather → score → loss → sparse update, and
a group runner that advances many steps from one draw of random bits.

Counterpart of ``openkeonspark_tpu/train/step.py:27-328, 366-389``.
Gradients are taken with torch autograd with respect to the *gathered*
slot rows, never the dense tables, and turn into merged per-table row
updates (:func:`merged_row_updates`) for the optimizers of ``optim.py``.
TransE, TransH, TransD and RotatE train through this generic step, as in
the JAX package, where their steps have no Pallas kernel either.

TransR with entity negatives only takes the relation-grouped route
(:func:`use_grouped_transr`): the batch is sorted by relation, every slot
row is projected through the grouped kernels of ``ops/grouped.py`` (plain
versions on the CPU) and the ``transfer_matrix`` gradient comes out dense.
The JAX package's TPU-only gates (``d_ent % 8`` and the backend test) are
dropped. TransR with relation negatives, or with ``grouped_transr=False``,
takes the generic step: it gathers one ``[d_e·d_r]`` matrix per slot row,
and its ``transfer_matrix`` rows are updated through the wide-row scatter
kernel B5 (``optim.scatter_add_rows``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (Gather, KGEModel, Params,
                                                 init_tables, pnorm)
from openkeonspark_tpu_torch.ops.grouped import grouped_project, run_offsets
from openkeonspark_tpu_torch.runtime import (NotPortedError,
                                             check_model_ported)
from openkeonspark_tpu_torch.sampling.device import (DeviceSampler,
                                                     SampledBatch)
from openkeonspark_tpu_torch.train.loss import margin_ranking_loss
from openkeonspark_tpu_torch.train.optim import (DenseUpdate, Updates,
                                                 make_optimizer)


@dataclass
class TrainState:
    params: Params
    opt_state: dict
    step: int          # global step


def init_state(model: KGEModel, cfg: Config, n_ent: int, n_rel: int,
               gen: torch.Generator, device: torch.device,
               pad_to_multiple: int = 1) -> TrainState:
    """Fresh float32 tables from ``gen`` (a seeded CPU generator, so one
    seed gives the same tables on every device) and the optimizer's
    state."""
    params = init_tables(gen, model.tables(cfg, n_ent, n_rel), device,
                         pad_to_multiple=pad_to_multiple)
    return TrainState(params=params, opt_state=make_optimizer(cfg).init(params),
                      step=0)


def _n_neg(batch: SampledBatch) -> Tuple[int, int]:
    return (0 if batch.neg_h is None else batch.neg_h.shape[1],
            0 if batch.neg_rel is None else batch.neg_rel.shape[1])


def gather_slots_structured(model: KGEModel, params: Params,
                            batch: SampledBatch) -> Tuple[Dict, int]:
    """Slot rows in the reference layout (positives, then negative segment
    k at rows ``B·(1+k)``), gathering each distinct id stream once:
    relation rows are gathered for the positives only and, when every
    segment shares r, kept as one ``[B, d]`` block that the scorer
    broadcasts; entity rows are reused across relation negatives."""
    nE, nR = _n_neg(batch)
    slots = {}
    for slot, table, anchor in model.gathers():
        T = params[table]
        if anchor == "r":
            base = T[batch.r]
            if nR == 0:
                slots[slot] = base
                continue
            parts = [base] * (1 + nE)
            parts += [T[batch.neg_rel[:, k]] for k in range(nR)]
        else:
            ids, neg = ((batch.h, batch.neg_h) if anchor == "h"
                        else (batch.t, batch.neg_t))
            base = T[ids]
            parts = [base] + [T[neg[:, k]] for k in range(nE)] + [base] * nR
        slots[slot] = torch.cat(parts) if len(parts) > 1 else parts[0]
    return slots, nE + nR


def slot_loss_and_grads(model: KGEModel, cfg: Config, slots: Dict,
                        B: int, n_neg: int):
    """Scalar loss and its gradients with respect to the gathered slot
    rows. Slots are flat ``[S·B, d]`` or one ``[B, d]`` block shared by all
    segments; both are viewed as ``[S, B, d]``."""
    leaves = {k: v.detach().requires_grad_() for k, v in slots.items()}
    with torch.enable_grad():
        shaped = {k: v.view(v.shape[0] // B, B, v.shape[-1])
                  for k, v in leaves.items()}
        scores = model.score(shaped, cfg).expand(1 + n_neg, B)
        loss = margin_ranking_loss(scores[0], scores[1:].T, cfg.margin,
                                   cfg.loss_mode)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def merged_row_updates(gathers: Tuple[Gather, ...], batch: SampledBatch,
                       g_slots: Dict) -> Updates:
    """(table → [(ids, row grads)]) with structurally duplicate id streams
    merged. An entity-corrupted negative keeps its uncorrupted side equal
    to the positive's id (``ch[k]`` marks head corruption), and relation
    negatives reuse both entities, so the entity update shrinks to
    ``B·(2 + negE)`` rows and the relation update to ``B·(1 + negR)``."""
    B = batch.h.shape[0]
    nE, nR = _n_neg(batch)
    ch = [(batch.neg_h[:, k] != batch.h)[:, None] for k in range(nE)]
    corrupted = [torch.where(ch[k][:, 0], batch.neg_h[:, k],
                             batch.neg_t[:, k]) for k in range(nE)]

    def seg(g, i):  # negative segment i of a slot's gradient stream
        return g[B * (1 + i):B * (2 + i)]

    by_table: Dict[str, Dict[str, torch.Tensor]] = {}
    for slot, table, anchor in gathers:
        by_table.setdefault(table, {})[anchor] = g_slots[slot]

    updates: Updates = {}
    for table, a in by_table.items():
        out = updates.setdefault(table, [])
        if "r" in a:
            g = a["r"]
            if g.shape[0] == B:       # untiled [B, d] slot: its gradient
                out.append((batch.r, g))   # already sums every segment
                continue
            base = g[:B]
            for k in range(nE):
                base = base + seg(g, k)        # entity negatives reuse r
            for k in range(nR):
                out.append((batch.neg_rel[:, k], seg(g, nE + k)))
            out.append((batch.r, base))
        else:  # entity table: one h-anchored and one t-anchored slot
            gh, gt = a["h"], a["t"]
            base_h, base_t = gh[:B], gt[:B]
            for k in range(nE):
                sh, st = seg(gh, k), seg(gt, k)
                base_h = base_h + torch.where(ch[k], 0.0, sh)
                base_t = base_t + torch.where(ch[k], st, 0.0)
                out.append((corrupted[k], torch.where(ch[k], sh, st)))
            for k in range(nE, nE + nR):       # relation negatives reuse h, t
                base_h = base_h + seg(gh, k)
                base_t = base_t + seg(gt, k)
            out.append((batch.h, base_h))
            out.append((batch.t, base_t))
    return updates


def use_grouped_transr(cfg: Config) -> bool:
    """TransR with entity negatives only takes the relation-grouped route
    (every slot row of a batch column then shares the column's r)."""
    return (cfg.model == "transr" and cfg.grouped_transr
            and cfg.negative_rel == 0)


_ENT_REL_GATHERS = (("h_e", "ent_embeddings", "h"),
                    ("t_e", "ent_embeddings", "t"),
                    ("r_e", "rel_embeddings", "r"))


def loss_and_row_grads_transr_grouped(model: KGEModel, cfg: Config,
                                      params: Params, batch: SampledBatch,
                                      plain: bool = False):
    """TransR without per-row projection matrices: sort the batch by
    relation (stably), project every slot row through the grouped kernels
    (each M_ρ read once per run) and take the ``transfer_matrix`` gradient
    dense. The score math is ``models/transr.py``'s. ``plain=True`` runs
    the grouped projection's plain versions on any device (the reference
    the kernels are held to)."""
    B = batch.h.shape[0]
    nE, nR = _n_neg(batch)
    if nR:
        raise ValueError("the grouped TransR step takes entity negatives "
                         "only")
    S = 1 + nE
    de, dr = cfg.d_ent, cfg.d_rel

    order = torch.sort(batch.r, stable=True).indices
    bs = SampledBatch(
        h=batch.h[order], t=batch.t[order], r=batch.r[order],
        neg_h=None if batch.neg_h is None else batch.neg_h[order],
        neg_t=None if batch.neg_t is None else batch.neg_t[order])
    h_ids = [bs.h] + [bs.neg_h[:, k] for k in range(nE)]
    t_ids = [bs.t] + [bs.neg_t[:, k] for k in range(nE)]
    E = params["ent_embeddings"]
    tm = params["transfer_matrix"]
    rows = tm.shape[0]
    leaves = {
        "h_e": E[torch.cat(h_ids)],                          # [S·B, de]
        "t_e": E[torch.cat(t_ids)],
        "r_e": params["rel_embeddings"][bs.r],               # [B, dr]
    }
    leaves = {k: v.requires_grad_() for k, v in leaves.items()}
    m3 = tm.detach().view(rows, de, dr).requires_grad_()     # no copy
    # b-major row stream: column b's 2S slot rows are consecutive, so the
    # sorted relation order carries over to the rows
    rel_rows = bs.r.repeat_interleave(2 * S)
    rel_off = run_offsets(rel_rows, rows)

    with torch.enable_grad():
        x = torch.cat([leaves["h_e"].view(S, B, de),
                       leaves["t_e"].view(S, B, de)])        # [2S, B, de]
        x = x.transpose(0, 1).reshape(2 * S * B, de)
        y = grouped_project(m3, x, rel_rows, rel_off, plain=plain)
        y = y.view(B, 2 * S, dr).transpose(0, 1)             # [2S, B, dr]
        res = y[:S] + leaves["r_e"][None] - y[S:]
        scores = pnorm(res, cfg.p_norm)                      # [S, B]
        loss = margin_ranking_loss(scores[0], scores[1:].T, cfg.margin,
                                   cfg.loss_mode)
        grads = torch.autograd.grad(loss, [*leaves.values(), m3])

    updates = merged_row_updates(_ENT_REL_GATHERS, bs,
                                 dict(zip(leaves, grads[:3])))
    touched = torch.zeros(rows, dtype=torch.bool, device=tm.device)
    touched[bs.r] = True
    updates["transfer_matrix"] = DenseUpdate(
        grad=grads[3].view(rows, de * dr), touched=touched)
    return loss.detach(), updates


def loss_and_row_grads(model: KGEModel, cfg: Config, params: Params,
                       batch: SampledBatch):
    """Scalar loss and the merged (table → [(ids, row grads)]) updates;
    gradients are taken with respect to the gathered rows only."""
    if use_grouped_transr(cfg):
        return loss_and_row_grads_transr_grouped(model, cfg, params, batch)
    B = batch.h.shape[0]
    slots, n_neg = gather_slots_structured(model, params, batch)
    loss, g_slots = slot_loss_and_grads(model, cfg, slots, B, n_neg)
    return loss, merged_row_updates(model.gathers(), batch, g_slots)


def check_train_supported(cfg: Config) -> None:
    """Refuse the training options the port does not cover."""
    check_model_ported(cfg.model)
    refused = {"sampler='host'": cfg.sampler == "host",
               "a mesh": cfg.mesh_shape[0] * cfg.mesh_shape[1] > 1,
               "a coordinator": bool(cfg.coordinator)
               or cfg.num_processes > 1,
               "batch_number (incremental warm start)":
                   cfg.batch_number is not None,
               "type_constrain": cfg.type_constrain,
               "trace_dir": bool(cfg.trace_dir),
               "exchange_hot_rows": cfg.exchange_hot_rows > 0,
               f"dtype {cfg.dtype!r}": cfg.dtype != "float32"}
    for what, on in refused.items():
        if on:
            raise NotPortedError(f"training with {what} is not yet ported; "
                                 "see ROADMAP.md queue A")


def build_train_step(model: KGEModel, cfg: Config, batch_size: int
                     ) -> Callable:
    """One step: ``(state, sampler, bits) → (state, loss)``, with ``bits``
    the step's u32 draws ``[batch_size, 1 + 2·negE + negR]`` (int64). The
    state's tables are updated in place."""
    check_train_supported(cfg)
    opt = make_optimizer(cfg)

    def step_fn(state: TrainState, sampler: DeviceSampler,
                bits: torch.Tensor):
        batch = sampler.sample(batch_size, cfg.negative_ent,
                               cfg.negative_rel, cfg.bern, bits=bits)
        loss, updates = loss_and_row_grads(model, cfg, state.params, batch)
        params, opt_state = opt.apply(state.params, state.opt_state,
                                      updates, state.step)
        return TrainState(params, opt_state, state.step + 1), loss

    step_fn.bits_shape = (batch_size,
                          DeviceSampler.bits_cols(cfg.negative_ent,
                                                  cfg.negative_rel))
    return step_fn


def build_group_runner(step_fn: Callable, steps: int) -> Callable:
    """``steps`` steps from one draw of the group's bits ``[steps, B,
    cols]``: ``(state, sampler, gen) → (state, mean loss)``, the loss a
    device scalar (no host sync). Stands in for the JAX package's
    ``lax.scan`` group (``build_scan_steps``)."""

    def run(state: TrainState, sampler: DeviceSampler,
            gen: torch.Generator):
        bits = sampler.draw_bits((steps,) + step_fn.bits_shape, gen)
        losses = []
        for s in range(steps):
            state, loss = step_fn(state, sampler, bits[s])
            losses.append(loss)
        return state, torch.stack(losses).mean()

    return run
