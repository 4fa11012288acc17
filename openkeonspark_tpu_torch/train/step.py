"""The training step: sample → gather → score → loss → sparse update, and
a group runner that advances many steps from one draw of random bits.

Counterpart of ``openkeonspark_tpu/train/step.py:27-328, 366-389``.
Gradients are taken with torch autograd with respect to the *gathered*
slot rows, never the dense tables, and turn into merged per-table row
updates (:func:`merged_row_updates`) for the optimizers of ``optim.py``.
TransE, TransH, TransD, RotatE, DistMult and ComplEx train through this
generic step, as in the JAX package, where their steps have no Pallas
kernel either.

TransR with entity negatives only takes the relation-grouped route
(:func:`use_grouped_transr`): the batch is sorted by relation, every slot
row is projected through the grouped kernels of ``ops/grouped.py`` (plain
versions on the CPU) and the ``transfer_matrix`` gradient comes out dense.
With relation negatives and fp32 tables it takes that route too
(:func:`use_grouped_transr_relneg`, a port-only route: the JAX package's
step is generic there), the relation negatives' rows a second
relation-sorted stream through the same kernels.
RotatE with fp32 tables and entity negatives only takes its slot route
(:func:`use_rotate_slots`): ``ops/rotate_train.py``'s kernel pair scores
the slots from their ids and writes the merged update rows, with no slot
gathered (the plain versions on the CPU).
The JAX package's TPU-only gates (``d_ent % 8`` and the backend test) are
dropped. TransR with ``grouped_transr=False``, or with relation negatives
and bf16 tables, takes the generic step: it gathers one ``[d_e·d_r]``
matrix per slot row, and its ``transfer_matrix`` rows are updated through
the wide-row scatter kernel B5 (``optim.scatter_add_rows``). The grid
steps (``parallel/``) score their slots through
:func:`slot_loss_and_grads`, the generic step, for every model.

Each stage of a step (sampling, gather, score with the loss inside it,
grad, update with the optimizer inside it), the step and its group open
the ``okst.train.*`` spans of ``obs.py``, which a running profiler records
and which cost one check otherwise."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import (Gather, KGEModel, Params,
                                                 init_tables, pnorm)
from openkeonspark_tpu_torch.models.rotate import RotatE
from openkeonspark_tpu_torch.obs import span
from openkeonspark_tpu_torch.ops import rotate_train
from openkeonspark_tpu_torch.ops.grouped import grouped_project, run_offsets
from openkeonspark_tpu_torch.ops.merge import merge_entity_rows
from openkeonspark_tpu_torch.runtime import (NotPortedError,
                                             check_model_ported, torch_dtype)
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
    """Fresh tables in ``cfg.dtype`` from ``gen`` (a seeded CPU
    generator, so one seed gives the same tables on every device), the
    zeroed ``#hot`` companions when ``cfg.exchange_hot_rows`` is set (on
    one device too, so checkpoints match; ``parallel/hot.py``), and the
    optimizer's state (the reference's ``train/step.py:42-53``)."""
    params = init_tables(gen, model.tables(cfg, n_ent, n_rel), device,
                         pad_to_multiple=pad_to_multiple,
                         dtype=torch_dtype(cfg.dtype))
    if cfg.exchange_hot_rows:
        from openkeonspark_tpu_torch.parallel.hot import init_hot_params
        params = init_hot_params(params, model, cfg, n_ent)
    return TrainState(params=params, opt_state=make_optimizer(cfg).init(params),
                      step=0)


def _n_neg(batch: SampledBatch) -> Tuple[int, int]:
    return (0 if batch.neg_h is None else batch.neg_h.shape[1],
            0 if batch.neg_rel is None else batch.neg_rel.shape[1])


def gather_slots_structured(model: KGEModel, params: Params,
                            batch: SampledBatch,
                            take: Optional[Callable] = None
                            ) -> Tuple[Dict, int]:
    """Slot rows in the reference layout (positives, then negative segment
    k at rows ``B·(1+k)``), gathering each distinct id stream once:
    relation rows are gathered for the positives only and, when every
    segment shares r, kept as one ``[B, d]`` block that the scorer
    broadcasts; entity rows are reused across relation negatives.
    ``take(table, ids)`` gathers rows (default ``params[table][ids]``; the
    sharded step's assembles them from row-sharded tables)."""
    if take is None:
        take = lambda table, ids: params[table][ids]  # noqa: E731
    nE, nR = _n_neg(batch)
    slots = {}
    for slot, table, anchor in model.gathers():
        if anchor == "r":
            base = take(table, batch.r)
            if nR == 0:
                slots[slot] = base
                continue
            parts = [base] * (1 + nE)
            parts += [take(table, batch.neg_rel[:, k]) for k in range(nR)]
        else:
            ids, neg = ((batch.h, batch.neg_h) if anchor == "h"
                        else (batch.t, batch.neg_t))
            base = take(table, ids)
            parts = ([base] + [take(table, neg[:, k]) for k in range(nE)]
                     + [base] * nR)
        slots[slot] = torch.cat(parts) if len(parts) > 1 else parts[0]
    return slots, nE + nR


def slot_loss_and_grads(model: KGEModel, cfg: Config, slots: Dict,
                        B: int, n_neg: int):
    """Scalar loss and its gradients with respect to the gathered slot
    rows. Slots are flat ``[S·B, d]`` or one ``[B, d]`` block shared by all
    segments; both are viewed as ``[S, B, d]``."""
    with torch.enable_grad():
        with span("okst.train.score"):
            leaves = {k: v.detach().requires_grad_()
                      for k, v in slots.items()}
            shaped = {k: v.view(v.shape[0] // B, B, v.shape[-1])
                      for k, v in leaves.items()}
            scores = model.score(shaped, cfg).expand(1 + n_neg, B)
            with span("okst.train.loss"):
                loss = margin_ranking_loss(scores[0], scores[1:].T,
                                           cfg.margin, cfg.loss_mode)
        with span("okst.train.grad"):
            grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def merged_row_updates(gathers: Tuple[Gather, ...], batch: SampledBatch,
                       g_slots: Dict) -> Updates:
    """(table → one (ids, row grads) stream) with structurally duplicate id
    streams merged. An entity-corrupted negative keeps its uncorrupted side
    equal to the positive's id, and relation negatives reuse both
    entities, so the entity update shrinks to ``B·(2 + negE)`` rows
    (``ops/merge.py::merge_entity_rows``: one kernel a table on the card)
    and the relation update to ``B·(1 + negR)``: the relation negatives'
    segments, then ``r`` with its positives' and entity negatives' sum."""
    B = batch.h.shape[0]
    nE, nR = _n_neg(batch)

    by_table: Dict[str, Dict[str, torch.Tensor]] = {}
    for slot, table, anchor in gathers:
        by_table.setdefault(table, {})[anchor] = g_slots[slot]

    updates: Updates = {}
    for table, a in by_table.items():
        if "r" not in a:  # entity table: one h- and one t-anchored slot
            updates[table] = merge_entity_rows(batch.h, batch.t, batch.neg_h,
                                               batch.neg_t, a["h"], a["t"],
                                               nR)
            continue
        g = a["r"]
        if g.shape[0] == B:       # untiled [B, d] slot: its gradient
            updates[table] = (batch.r, g)   # already sums every segment
            continue
        base = g[:B]
        for k in range(nE):
            base = base + g[B * (1 + k):B * (2 + k)]  # negatives reuse r
        updates[table] = (torch.cat([batch.neg_rel.T.reshape(-1), batch.r]),
                          torch.cat([g[B * (1 + nE):], base]))
    return updates


def use_grouped_transr(cfg: Config) -> bool:
    """TransR with entity negatives only takes the relation-grouped route
    (every slot row of a batch column then shares the column's r)."""
    return (cfg.model == "transr" and cfg.grouped_transr
            and cfg.negative_rel == 0)


def use_grouped_transr_relneg(cfg: Config, params: Params) -> bool:
    """TransR with relation negatives and fp32 tables takes the
    relation-grouped route too, its relation negatives projected as a
    second relation-sorted stream. bf16 tables keep the generic step: the
    grouped kernels take fp32 rows, and eager bf16 ops round where a
    kernel would not."""
    return (cfg.model == "transr" and cfg.grouped_transr
            and cfg.negative_rel > 0
            and all(params[k].dtype == torch.float32
                    for k in ("ent_embeddings", "rel_embeddings",
                              "transfer_matrix")))


_ENT_GATHERS = (("h_e", "ent_embeddings", "h"),
                ("t_e", "ent_embeddings", "t"))


def loss_and_row_grads_transr_grouped(model: KGEModel, cfg: Config,
                                      params: Params, batch: SampledBatch,
                                      plain: bool = False):
    """TransR without per-row projection matrices: sort the batch by
    relation (stably), project every slot row through the grouped kernels
    (each M_ρ read once per run) and take the ``transfer_matrix`` gradient
    dense. The score math is ``models/transr.py``'s. ``plain=True`` runs
    the grouped projection's plain versions on any device (the reference
    the kernels are held to).

    Relation negatives reuse their positive's h and t under another
    relation, so their rows cannot share the positives' runs: they form a
    second stream, sorted stably by the negative relation, of one row
    ``h − t`` a slot (the projection is linear), projected by a second call
    on the same ``M`` (autograd sums the two dense gradients). Their scores
    join the generic layout ``[1 + nE + nR, B]`` in the batch's own column
    order, so the loss is reduced as the generic step reduces it, and
    their h, t and relation gradients join the generic update streams."""
    B = batch.h.shape[0]
    nE, nR = _n_neg(batch)
    S = 1 + nE
    de, dr = cfg.d_ent, cfg.d_rel

    with span("okst.train.gather"):
        order = torch.sort(batch.r, stable=True).indices
        bs = batch.map(lambda x: x[order])
        h_ids = [bs.h] + [bs.neg_h[:, k] for k in range(nE)]
        t_ids = [bs.t] + [bs.neg_t[:, k] for k in range(nE)]
        E = params["ent_embeddings"]
        R = params["rel_embeddings"]
        tm = params["transfer_matrix"]
        rows = tm.shape[0]
        leaves = {
            "h_e": E[torch.cat(h_ids)],                      # [S·B, de]
            "t_e": E[torch.cat(t_ids)],
            "r_e": R[bs.r],                                  # [B, dr]
        }
        if nR:
            # segment k of the relation negatives at rows k·B + b (the
            # generic layout over bs), then sorted by relation
            rel_neg = bs.neg_rel.T.reshape(-1)               # [nR·B]
            rel_sorted, o2 = torch.sort(rel_neg, stable=True)
            pair = torch.stack([bs.h, bs.t], 1).expand(nR, B, 2)
            pair = E[pair.reshape(nR * B, 2)[o2]]            # [nR·B, 2, de]
            # h·M − t·M = (h − t)·M: one projected row a slot
            leaves["d_neg"] = pair[:, 0] - pair[:, 1]        # [nR·B, de]
            leaves["r_neg"] = R[rel_sorted]                  # [nR·B, dr]
        leaves = {k: v.requires_grad_() for k, v in leaves.items()}
        m3 = tm.detach().view(rows, de, dr).requires_grad_()  # no copy
        # b-major row stream: column b's 2S slot rows are consecutive, so
        # the sorted relation order carries over to the rows
        rel_rows = bs.r.repeat_interleave(2 * S)
        rel_off = run_offsets(rel_rows, rows)
        if nR:
            neg_off = run_offsets(rel_sorted, rows)

    with torch.enable_grad():
        with span("okst.train.score"):
            x = torch.cat([leaves["h_e"].view(S, B, de),
                           leaves["t_e"].view(S, B, de)])    # [2S, B, de]
            x = x.transpose(0, 1).reshape(2 * S * B, de)
            y = grouped_project(m3, x, rel_rows, rel_off, plain=plain)
            y = y.view(B, 2 * S, dr).transpose(0, 1)         # [2S, B, dr]
            res = y[:S] + leaves["r_e"][None] - y[S:]
            scores = pnorm(res, cfg.p_norm)                  # [S, B]
            if nR:
                y_neg = grouped_project(m3, leaves["d_neg"], rel_sorted,
                                        neg_off, plain=plain)
                s_neg = pnorm(y_neg + leaves["r_neg"], cfg.p_norm)
                s_neg = s_neg.new_empty(nR * B).index_copy_(0, o2, s_neg)
                scores = torch.cat([scores, s_neg.view(nR, B)])
                # bs's columns back to the batch's: the generic step's
                # reduction order
                scores = scores.new_empty(S + nR, B).index_copy_(1, order,
                                                                 scores)
            with span("okst.train.loss"):
                loss = margin_ranking_loss(scores[0], scores[1:].T,
                                           cfg.margin, cfg.loss_mode)
        with span("okst.train.grad"):
            grads = dict(zip([*leaves, "m"], torch.autograd.grad(
                loss, [*leaves.values(), m3])))

    with span("okst.train.update"):
        g_h, g_t, g_r = grads["h_e"], grads["t_e"], grads["r_e"]
        rel_ids = bs.r
        if nR:
            # the sorted rows' gradients back to the generic layout: h's
            # is the difference's, t's its negation
            g_d = grads["d_neg"].new_empty(nR * B, de).index_copy_(
                0, o2, grads["d_neg"])
            g_h = torch.cat([g_h, g_d])
            g_t = torch.cat([g_t, -g_d])
            # the relation negatives' rows in their sorted order
            rel_ids = torch.cat([rel_sorted, bs.r])
            g_r = torch.cat([grads["r_neg"], g_r])
        updates = merged_row_updates(_ENT_GATHERS, bs,
                                     {"h_e": g_h, "t_e": g_t})
        updates["rel_embeddings"] = (rel_ids, g_r)
        # built on the card: an index assignment of True would copy the
        # Python scalar from pageable memory, a blocking copy
        touched = torch.zeros(rows, dtype=torch.bool,
                              device=tm.device).index_fill_(0, rel_ids, True)
        updates["transfer_matrix"] = DenseUpdate(
            grad=grads["m"].view(rows, de * dr), touched=touched)
    return loss.detach(), updates


def use_rotate_slots(model: KGEModel, params: Params,
                     batch: SampledBatch) -> bool:
    """RotatE with fp32 tables and no relation negatives takes its slot
    route (:func:`loss_and_row_grads_rotate`). bf16 tables keep the
    generic step: its eager ops round after every op, and a fused kernel
    would round elsewhere."""
    return (model is RotatE and batch.neg_rel is None
            and params["ent_embeddings"].dtype == torch.float32
            and params["rel_embeddings"].dtype == torch.float32)


def loss_and_row_grads_rotate(cfg: Config, params: Params,
                              batch: SampledBatch):
    """RotatE without gathered slots: the forward kernel scores the
    positives and their entity negatives from their ids, the margin loss
    runs under autograd on those scores alone, and the backward kernel
    turns the scores' gradient into the entity table's merged update
    stream (``merge_entity_rows``' layout) and the phases' ``[B, d]``
    gradient (``ops/rotate_train.py``; its plain versions on the CPU)."""
    with span("okst.train.gather"):
        slots = rotate_train.prepare(
            params["ent_embeddings"], params["rel_embeddings"], batch.h,
            batch.t, batch.r, batch.neg_h, batch.neg_t)
    with torch.enable_grad():
        with span("okst.train.score"):
            scores = rotate_train.rotate_slot_scores(slots).requires_grad_()
            with span("okst.train.loss"):
                loss = margin_ranking_loss(scores[0], scores[1:].T,
                                           cfg.margin, cfg.loss_mode)
        with span("okst.train.grad"):
            (g_scores,) = torch.autograd.grad(loss, [scores])
            ent, g_theta = rotate_train.rotate_slot_grads(slots, g_scores)
    with span("okst.train.update"):
        updates = {"ent_embeddings": ent,
                   "rel_embeddings": (batch.r, g_theta)}
    return loss.detach(), updates


def loss_and_row_grads(model: KGEModel, cfg: Config, params: Params,
                       batch: SampledBatch):
    """Scalar loss and the merged (table → (ids, row grads)) updates;
    gradients are taken with respect to the gathered rows only."""
    if use_grouped_transr(cfg) or use_grouped_transr_relneg(cfg, params):
        return loss_and_row_grads_transr_grouped(model, cfg, params, batch)
    if use_rotate_slots(model, params, batch):
        return loss_and_row_grads_rotate(cfg, params, batch)
    B = batch.h.shape[0]
    with span("okst.train.gather"):
        slots, n_neg = gather_slots_structured(model, params, batch)
    loss, g_slots = slot_loss_and_grads(model, cfg, slots, B, n_neg)
    with span("okst.train.update"):
        return loss, merged_row_updates(model.gathers(), batch, g_slots)


def check_train_supported(cfg: Config) -> None:
    """Refuse the training options the port does not cover. TransR's
    grouped route with bf16 tables is refused as the reference refuses
    it: its grouped step raises on a bf16 table (a dtype mismatch in its
    projection kernel's padding)."""
    check_model_ported(cfg.model)
    torch_dtype(cfg.dtype)
    if use_grouped_transr(cfg) and cfg.dtype != "float32":
        raise NotPortedError(
            f"TransR's grouped step with dtype {cfg.dtype!r} tables: the "
            "JAX package's grouped step raises on them too; such tables "
            "train on the generic step, which TransR takes with "
            "grouped_transr=False, or with --negative_rel > 0 when the "
            "tables are not float32; configurations still to run are "
            "ROADMAP.md queue W")


def build_train_step(model: KGEModel, cfg: Config, batch_size: int
                     ) -> Callable:
    """One step: ``(state, sampler, bits) → (state, loss)``, with ``bits``
    the step's u32 draws ``[batch_size, 1 + 2·negE + negR]`` (int64). The
    state's tables are updated in place."""
    check_train_supported(cfg)
    batch_step = build_batch_step(model, cfg)

    def step_fn(state: TrainState, sampler: DeviceSampler,
                bits: torch.Tensor):
        with span("okst.train.step"):
            with span("okst.train.sampling"):
                batch = sampler.sample(batch_size, cfg.negative_ent,
                                       cfg.negative_rel, cfg.bern, bits=bits)
            return batch_step(state, batch)

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
        with span("okst.train.group"):
            bits = sampler.draw_bits((steps,) + step_fn.bits_shape, gen)
            losses = []
            for s in range(steps):
                state, loss = step_fn(state, sampler, bits[s])
                losses.append(loss)
            # a bf16 table's loss is bf16; the mean is fp32
            return state, torch.stack(losses).float().mean()

    return run


def build_batch_step(model: KGEModel, cfg: Config) -> Callable:
    """One step on a given batch: ``(state, batch) → (state, loss)``.
    Its caller opens the step's span."""
    opt = make_optimizer(cfg)

    def batch_step(state: TrainState, batch: SampledBatch):
        loss, updates = loss_and_row_grads(model, cfg, state.params, batch)
        with span("okst.train.update"), span("okst.train.optim"):
            params, opt_state = opt.apply(state.params, state.opt_state,
                                          updates, state.step)
        return TrainState(params, opt_state, state.step + 1), loss

    return batch_step


def build_host_scan_steps(model: KGEModel, cfg: Config,
                          batch_step: Optional[Callable] = None
                          ) -> Callable:
    """The S steps of one stacked batch group (``[S, …]`` from
    ``sampling/host.py::HostPipeline``): ``(state, batches) → (state, mean
    loss)``, the counterpart of the JAX package's ``lax.scan`` over the
    group (``train/step.py:346-363``). Each step is ``batch_step`` (default
    :func:`build_batch_step`'s, which goes through
    :func:`loss_and_row_grads` as the device-sampler step does); a grid
    passes its own."""
    check_train_supported(cfg)
    if batch_step is None:
        batch_step = build_batch_step(model, cfg)

    def run(state: TrainState, batches: SampledBatch):
        with span("okst.train.group"):
            losses = []
            for s in range(batches.h.shape[0]):
                with span("okst.train.step"):
                    state, loss = batch_step(state,
                                             batches.map(lambda x: x[s]))
                losses.append(loss)
            return state, torch.stack(losses).float().mean()

    return run
