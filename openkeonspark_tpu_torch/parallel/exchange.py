"""The owner-directed exchange step over the flat (data × model) grid.

Counterpart of ``openkeonspark_tpu/parallel/exchange.py`` (``:111-575``).
Tables and optimizer slots are row-sharded over all ``N = D·M`` ranks
(``shard_state(..., flat=True)``): rank ``n`` owns rows ``[n·Lp,
(n+1)·Lp)``, so a routed row crosses the wire once.

- **Sub-batch split.** The M ranks of data row ``d`` draw the same batch
  (the psum step's draw) and rank ``m`` keeps sub-slices
  ``m·mb + c`` of it, one per microbatch ``c`` (``cfg.exchange_microbatches``,
  reduced until it divides). Every microbatch takes its gradients at the
  same tables, so the result does not depend on ``mb``.
- **Gather.** Each distinct id stream of a table is deduplicated
  (``cfg.exchange_dedup``), bucketed by owner into N buckets of capacity
  ``C`` (:func:`capacity_for`), and one ``all_to_all`` over the grid sends
  the requests, a second one the owners' rows back, in the wire dtype.
- **Update.** The merged (ids, row grads) streams are bucketed the same
  way and sent straight to their owners, which apply them.
- **Small tables** (``Lp·N ≤ SMALL_TABLE_ROWS`` physical rows, the bound
  of ``train/optim.py``'s one-hot sum): the whole table is
  ``all_gather``-ed once a step in the wire dtype, and its gradient is one
  dense ``[rows, d + 1]`` sum (the last column counts touches),
  ``all_reduce``-d once a step (``:472-482``). TransR's
  ``transfer_matrix`` takes this path at ``n_rel + pad ≤ 512`` and the
  owner's optimizer apply above it; either way its rows go through
  ``train/optim.py::scatter_add_rows``, kernel B5 on a card.
- **Overflow.** Ids that do not fit their bucket take exact fallbacks:
  the gather an ``all_gather`` of the wanted ids and an owner-served
  ``all_to_all`` summed at the requester (``psum_scatter``), the update
  an ``all_gather`` of the overflow stream folded into the same optimizer
  apply. Whether a fallback runs is one decision for every rank: the
  overflow count is reduced with MAX over the grid, and read on the host,
  before any rank enters the fallback's collectives (``jax.lax.cond`` at
  ``:449`` and ``:545`` in the JAX package).
- **Wire dtype** (``cfg.exchange_wire_dtype``): rows and gradients are
  cast to it before an ``all_to_all`` and back after it, where the JAX
  step casts; every payload travels as raw bytes (``mesh.all_to_all``),
  row ids and overflow counts as int32, the JAX step's dtype. The
  fallbacks and the dense gradient stay in the tables' and the
  gradients' dtypes, as the JAX step's do. The fallbacks' collectives
  run under ``mesh.fallback()``, so a ``parallel.comm`` counter keeps
  their bytes apart, as the JAX count skips ``lax.cond`` branches.

- **Capacities** (``cfg.exchange_capacity``): ``'uniform'`` sizes every
  bucket by the birthday estimate; ``'stats'`` sizes the entity tables'
  buckets from the dataset's degree tables (``parallel/hot.py``,
  ``:348-358``), at the first call, from the state's own local row count
  (the JAX step guesses it from the entity count, ``:353``, which misses
  the pad row and any padding past the grid).

With the fp32 wire the step equals the psum step up to the order in which
duplicate ids are summed (``tests/test_torch_exchange.py``). A (host,
data, model) grid runs the two-stage step of ``parallel/hier.py``
(:func:`build_train_step_for`)."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import KGEModel
from openkeonspark_tpu_torch.parallel.mesh import (
    Grid, all_gather, all_gather_ids, all_reduce, all_to_all, all_to_all_ids,
    fallback)
from openkeonspark_tpu_torch.parallel.sharded import (
    build_sharded_train_step, data_partition, owned_or_sentinel)
from openkeonspark_tpu_torch.sampling.device import (DeviceSampler,
                                                     SampledBatch)
from openkeonspark_tpu_torch.train.optim import (SMALL_TABLE_ROWS, Updates,
                                                 aggregate_duplicates,
                                                 make_optimizer,
                                                 scatter_add_rows)
from openkeonspark_tpu_torch.train.step import (TrainState,
                                                check_train_supported,
                                                merged_row_updates,
                                                slot_loss_and_grads)

GRID = "grid"
# wire dtypes (cfg.exchange_wire_dtype)
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn}


def expected_unique(stream_len: int, n_rows: int) -> float:
    """Birthday estimate of the distinct ids in a ``stream_len`` draw from
    ``n_rows`` (uniform; skew only lowers it)."""
    n = max(1, n_rows)
    return n * (1.0 - math.exp(-stream_len / n))


def capacity_for(n_ids: int, n_parts: int, slack: float,
                 expected: Optional[float] = None,
                 local_rows: Optional[int] = None) -> int:
    """Owner-bucket capacity: ``slack`` × the expected share of an owner,
    rounded up to a multiple of 8, capped at the stream length and, for a
    deduplicated stream, at the owner's rows (``:111-125``)."""
    share = (expected if expected is not None else float(n_ids)) / n_parts
    c = int(math.ceil(slack * share))
    c = -(-c // 8) * 8
    c = max(8, min(n_ids, c))
    if local_rows is not None:
        c = min(c, local_rows)
    return max(1, c)


def dedup_ids(ids: torch.Tensor, sentinel: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uniq [U]: the distinct ids first, ``sentinel``-padded; u_idx [U]:
    each id's position in ``uniq``), as ``:132-145``."""
    u = ids.shape[0]
    s, order = torch.sort(ids, stable=True)
    first = torch.ones(u, dtype=torch.bool, device=ids.device)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1
    u_idx = torch.empty_like(rank).scatter_(0, order, rank)
    uniq = torch.full((u + 1,), sentinel, dtype=ids.dtype, device=ids.device)
    uniq[torch.where(first, rank, u)] = s    # repeats land on the drop slot
    return uniq[:u], u_idx


def _bucket(ids: torch.Tensor, n_parts: int, cap: int, lp: int,
            valid: torch.Tensor, owner: Optional[torch.Tensor] = None):
    """(routed [U] bool, slot [U] in [0, N·C], N·C the sink, overflow
    count): owner ``ids // lp`` unless ``owner`` is given (the
    hierarchical step buckets by relay position and owner host), position
    by order within the owner (``:146-168``)."""
    if owner is None:
        owner = torch.clamp(ids // lp, 0, n_parts - 1)
    onehot = ((owner[:, None] == torch.arange(n_parts, device=ids.device))
              & valid[:, None])
    pos = ((torch.cumsum(onehot.long(), 0) - 1) * onehot).sum(1)
    fits = pos < cap
    routed = valid & fits
    slot = torch.where(routed, owner * cap + pos, n_parts * cap)
    return routed, slot, (valid & ~fits).sum()


def _route_gather(grid: Grid, local: torch.Tensor, ids: torch.Tensor,
                  routed: torch.Tensor, slot: torch.Tensor, cap: int,
                  wire_dt) -> torch.Tensor:
    """Rows of ``ids`` from their owners (zeros where not routed),
    ``:171-187``."""
    lp, d = local.shape
    n = grid.size
    req = torch.full((n * cap + 1,), -1, dtype=ids.dtype, device=ids.device)
    req[slot] = ids
    req_r = all_to_all_ids(req[:n * cap], grid, GRID)
    lid = req_r - grid.rank * lp
    ok = (lid >= 0) & (lid < lp) & (req_r >= 0)
    rows = torch.where(ok[:, None], local[lid.clamp(0, lp - 1)],
                       torch.zeros((), dtype=local.dtype,
                                   device=local.device)).to(wire_dt)
    resp = all_to_all(rows, grid, GRID)
    out = resp[torch.where(routed, slot, 0)].to(local.dtype)
    return torch.where(routed[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _gather_fallback(grid: Grid, local: torch.Tensor, ids: torch.Tensor,
                     routed: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """Exact rows of the overflowed requests (``valid & ~routed``): the
    wanted ids ``all_gather``-ed, served by their owners, and summed at
    the requester (``psum_scatter``: an ``all_to_all`` of every
    requester's block, then a sum over senders), ``:190-204``."""
    lp, d = local.shape
    n, u = grid.size, ids.shape[0]
    with fallback():
        all_ids = all_gather_ids(torch.where(valid & ~routed, ids, -1),
                                 grid, GRID)
        lid = all_ids - grid.rank * lp
        ok = (lid >= 0) & (lid < lp) & (all_ids >= 0)
        rows = torch.where(ok[:, None], local[lid.clamp(0, lp - 1)],
                           torch.zeros((), dtype=local.dtype,
                                       device=local.device))
        return all_to_all(rows, grid, GRID).view(n, u, d).sum(0)


def _route_update(grid: Grid, lp: int, ids: torch.Tensor,
                  grads: torch.Tensor, valid: torch.Tensor, cap: int,
                  wire_dt):
    """(local ids [N·C] with the sentinel ``lp`` for padding, grads [N·C,
    d] in the gradients' dtype, this rank's overflowed ids with the global
    sentinel for the rest, overflow count), ``:207-239``."""
    n, u = grid.size, ids.shape[0]
    d = grads.shape[1]
    sent = n * lp
    routed, slot, n_ovf = _bucket(ids, n, cap, lp, valid)
    src = torch.full((n * cap + 1,), u, dtype=torch.long, device=ids.device)
    src[slot] = torch.arange(u, device=ids.device)
    src = src[:n * cap]
    buf_ids = torch.cat([ids, ids.new_full((1,), sent)])[src]
    buf_ids = torch.where(buf_ids >= sent, sent, buf_ids)
    buf_g = torch.cat([grads, grads.new_zeros((1, d))])[src].to(wire_dt)
    rid = all_to_all_ids(buf_ids, grid, GRID)
    rg = all_to_all(buf_g, grid, GRID).to(grads.dtype)
    lid, _ = owned_or_sentinel(rid, grid.rank * lp, lp)
    ovf_ids = torch.where(routed | ~valid, sent, ids)
    return lid, rg, ovf_ids, n_ovf


def _gather_plan(model: KGEModel, batch: SampledBatch):
    """Per table, one stream of its distinct slot id streams, and the
    recipe that assembles the slots from the fetched rows in
    ``train/step.py::gather_slots_structured``'s layout (``:242-283``)."""
    b = batch.h.shape[0]
    n_e = 0 if batch.neg_h is None else batch.neg_h.shape[1]
    n_r = 0 if batch.neg_rel is None else batch.neg_rel.shape[1]
    pieces: Dict[str, List[torch.Tensor]] = {}
    offs: Dict[str, int] = {}
    recipes = []   # (slot, table, offset, anchor, length)
    for slot, table, anchor in model.gathers():
        if anchor == "r":
            parts = [batch.r] + [batch.neg_rel[:, k] for k in range(n_r)]
        elif anchor == "h":
            parts = [batch.h] + [batch.neg_h[:, k] for k in range(n_e)]
        else:
            parts = [batch.t] + [batch.neg_t[:, k] for k in range(n_e)]
        ids = torch.cat(parts) if len(parts) > 1 else parts[0]
        off = offs.get(table, 0)
        offs[table] = off + ids.shape[0]
        pieces.setdefault(table, []).append(ids)
        recipes.append((slot, table, off, anchor, ids.shape[0]))
    table_ids = {t: (torch.cat(p) if len(p) > 1 else p[0]).contiguous()
                 for t, p in pieces.items()}

    def assemble(rows_by_table: Dict[str, torch.Tensor]):
        slots = {}
        for slot, table, off, anchor, n in recipes:
            rows = rows_by_table[table][off:off + n]
            if anchor == "r":
                if n_r == 0:
                    slots[slot] = rows          # one [B, d] block
                    continue
                parts = [rows[:b]] * (1 + n_e) + [
                    rows[b * (1 + k):b * (2 + k)] for k in range(n_r)]
            else:
                parts = [rows] + [rows[:b]] * n_r
            slots[slot] = torch.cat(parts) if len(parts) > 1 else parts[0]
        return slots

    return table_ids, assemble


def plan_sharded_step(cfg: Config, batch_size: int, grid: Grid) -> str:
    """``'hier'``, ``'exchange'`` or ``'psum'``: the step a (cfg, batch,
    grid) runs (``:289-311``); a (host, data, model) grid runs the
    hierarchical step or raises. The state must be sharded to match:
    ``flat=(kind != 'psum')``."""
    if grid.hosts is not None:
        b_local = max(1, batch_size // grid.data)
        if cfg.sharded_step != "exchange" or b_local % grid.model:
            raise ValueError(
                "a (host, data, model) grid needs sharded_step='exchange' "
                f"with a per-data-shard batch ({b_local}) divisible by the "
                f"model axis ({grid.model})")
        return "hier"
    if grid.size == 1:
        return "psum"
    b_local = max(1, batch_size // grid.data)
    if cfg.sharded_step == "exchange" and b_local % grid.model == 0:
        return "exchange"
    return "psum"


def _max_over_grid(grid: Grid, count: torch.Tensor) -> int:
    """One decision for every rank: the largest count on the grid (an
    int32 reduction, the JAX step's ``psum`` of an int32 count)."""
    return int(all_reduce(count.reshape(1).int(), grid, GRID,
                          op=torch.distributed.ReduceOp.MAX))


def microbatches(cfg: Config, per_rank: int) -> int:
    """The microbatches a step of ``per_rank`` positives a rank runs:
    ``cfg.exchange_microbatches`` lowered until it divides (``:272-275``;
    an odd count runs one). The step exposes it as ``microbatches``."""
    mb = cfg.exchange_microbatches
    while per_rank % mb:
        mb -= 1
    return mb


def check_degrees(cfg: Config, degrees) -> None:
    """The degree tables a step needs for hot rows or ``'stats'``
    capacities (``parallel/hot.py::degree_stats``)."""
    if degrees is None and (cfg.exchange_hot_rows
                            or cfg.exchange_capacity == "stats"):
        raise ValueError("exchange_hot_rows and exchange_capacity='stats' "
                         "need the dataset's degree tables: pass "
                         "degrees=parallel.hot.degree_stats(ds)")


def build_exchange_train_step(model: KGEModel, cfg: Config, grid: Grid,
                              batch_size: int, n_train: int,
                              opt=None, degrees=None) -> Callable:
    """``(state, sampler, bits) → (state, global loss)`` over the flat
    grid; ``step.batch_step(state, batch)`` runs it on a given data-row
    batch (``:314-575``). ``batch_size`` is global; each data row draws
    ``batch_size // D`` positives, which must divide by M. State from
    ``shard_state(state, grid, flat=True)``, tables padded to a multiple
    of D·M. ``opt``: the optimizer that applies the owners' updates
    (``make_optimizer(cfg)`` by default); ``degrees``
    (``parallel/hot.py::degree_stats``) for ``'stats'`` capacities.
    ``step.microbatches`` is the count the step runs; ``step.stats_caps``
    the degree-table capacities, set at the first call."""
    check_train_supported(cfg)
    check_degrees(cfg, degrees)
    n_grid = grid.size
    b_local = max(1, batch_size // grid.data)
    if n_grid == 1:
        return build_sharded_train_step(model, cfg, grid, batch_size,
                                        n_train, opt)
    if b_local % grid.model:
        raise ValueError(
            f"exchange step needs per-data-shard batch ({b_local}) divisible"
            f" by the model axis ({grid.model}); pick batch_size accordingly"
            " or use sharded_step='psum'")
    mb = microbatches(cfg, b_local // grid.model)
    b_sub = b_local // grid.model // mb
    partition = data_partition(n_train, grid)
    opt = opt or make_optimizer(cfg)
    slack = cfg.exchange_slack
    wire_dt = WIRE_DTYPES[cfg.exchange_wire_dtype]
    dedup_gather = cfg.exchange_dedup in ("gather", "both")
    dedup_update = cfg.exchange_dedup == "both"
    n_neg = cfg.negative_ent + cfg.negative_rel
    # times each exact fallback ran (the same on every rank)
    fallbacks = {"gather": 0, "update": 0}

    def stats_caps(P) -> Dict[str, Dict[str, int]]:
        """The degree-table capacities at the state's local rows."""
        if cfg.exchange_capacity != "stats":
            return {}
        from openkeonspark_tpu_torch.parallel.hot import (entity_table_names,
                                                          flat_stats_caps)
        lp = P[entity_table_names(model)[0]].shape[0]
        if step_fn.stats_caps is None or step_fn.stats_caps[0] != lp:
            step_fn.stats_caps = (lp, flat_stats_caps(
                model, cfg, degrees, b_sub, lp, n_grid)
                if lp * n_grid > SMALL_TABLE_ROWS else {})
        return step_fn.stats_caps[1]

    def batch_step(state: TrainState, batch: SampledBatch):
        P = state.params
        caps = stats_caps(P)
        # one all_gather of each small table serves every microbatch
        small_full = {t: all_gather(P[t].to(wire_dt), grid, GRID).to(
            P[t].dtype) for t in sorted({tb for _, tb, _ in model.gathers()})
            if P[t].shape[0] * n_grid <= SMALL_TABLE_ROWS}
        loss = torch.zeros((), dtype=torch.float32, device=grid.device)
        main_pairs: Dict[str, list] = {}
        ovf_pairs: Dict[str, list] = {}
        dense_grads: Dict[str, torch.Tensor] = {}
        n_ovf_upd = torch.zeros((), dtype=torch.long, device=grid.device)

        for c in range(mb):
            lo = (grid.m_idx * mb + c) * b_sub
            sub = batch.map(lambda x: x[lo:lo + b_sub])
            table_ids, assemble = _gather_plan(model, sub)

            # owner-directed gather, then the exact fallback if any id
            # overflowed its bucket anywhere on the grid
            fetched: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]
            fetched, fb_args = {}, {}
            n_ovf = torch.zeros((), dtype=torch.long, device=grid.device)
            for table, ids in table_ids.items():
                local = P[table]
                lp = local.shape[0]
                if table in small_full:
                    fetched[table] = (small_full[table][ids], None)
                    continue
                rows_phys = lp * n_grid
                if dedup_gather:
                    uniq, u_idx = dedup_ids(ids, sentinel=rows_phys)
                    valid = uniq < rows_phys
                    cap = (max(8, min(caps[table]["g"], uniq.shape[0]))
                           if table in caps else capacity_for(
                        uniq.shape[0], n_grid, slack,
                        expected=expected_unique(ids.shape[0], rows_phys),
                        local_rows=lp))
                    req = uniq
                else:
                    u_idx = None
                    valid = torch.ones(ids.shape, dtype=torch.bool,
                                       device=ids.device)
                    cap = capacity_for(ids.shape[0], n_grid, slack)
                    req = ids
                routed, slot, novf = _bucket(req, n_grid, cap, lp, valid)
                fetched[table] = (_route_gather(grid, local, req, routed,
                                                slot, cap, wire_dt), u_idx)
                fb_args[table] = (req, routed, valid)
                n_ovf = n_ovf + novf
            if fb_args and _max_over_grid(grid, n_ovf) > 0:
                fallbacks["gather"] += 1
                for t in sorted(fb_args):
                    rows, u_idx = fetched[t]
                    fetched[t] = (rows + _gather_fallback(grid, P[t],
                                                          *fb_args[t]),
                                  u_idx)
            rows_by_table = {t: rows if u_idx is None else rows[u_idx]
                             for t, (rows, u_idx) in fetched.items()}

            closs, g_slots = slot_loss_and_grads(
                model, cfg, assemble(rows_by_table), b_sub, n_neg)
            loss = loss + closs.float()

            # owner-directed update routing
            for table, pairs in merged_row_updates(model.gathers(), sub,
                                                   g_slots).items():
                uid = torch.cat([i for i, _ in pairs]).contiguous()
                ug = torch.cat([g for _, g in pairs])
                lp = P[table].shape[0]
                rows_phys = lp * n_grid
                if table in small_full:
                    # a dense [rows, d + 1] gradient, its last column the
                    # touch count; one all_reduce after the microbatches
                    g_dense = torch.zeros(rows_phys, ug.shape[1] + 1,
                                          dtype=ug.dtype, device=ug.device)
                    scatter_add_rows(g_dense, uid, torch.cat(
                        [ug, ug.new_ones((ug.shape[0], 1))], 1))
                    dense_grads[table] = (dense_grads[table] + g_dense
                                          if table in dense_grads
                                          else g_dense)
                    continue
                if dedup_update:
                    uid, ug = aggregate_duplicates(uid, ug,
                                                   sentinel=rows_phys)
                    valid = uid < rows_phys
                    cap = capacity_for(
                        uid.shape[0], n_grid, slack,
                        expected=expected_unique(uid.shape[0], rows_phys),
                        local_rows=lp)
                else:
                    valid = torch.ones(uid.shape, dtype=torch.bool,
                                       device=uid.device)
                    cap = capacity_for(uid.shape[0], n_grid, slack)
                if table in caps:
                    cap = max(8, min(caps[table]["u"], uid.shape[0]))
                lid, rg, ovf_ids, novf = _route_update(
                    grid, lp, uid, ug, valid, cap, wire_dt)
                main_pairs.setdefault(table, []).append((lid, rg))
                ovf_pairs.setdefault(table, []).append((ovf_ids, ug))
                n_ovf_upd = n_ovf_upd + novf

        updates: Updates = {}
        for table, pairs in main_pairs.items():
            updates[table] = [(torch.cat([i for i, _ in pairs]),
                               torch.cat([g for _, g in pairs]))]
        for table, g_dense in dense_grads.items():
            lp = P[table].shape[0]
            g_local = all_reduce(g_dense, grid, GRID)[
                grid.rank * lp:(grid.rank + 1) * lp]
            touched = g_local[:, -1] > 0
            lid = torch.where(touched, torch.arange(lp, device=grid.device),
                              lp)
            updates[table] = [(lid, g_local[:, :-1])]
        if ovf_pairs and _max_over_grid(grid, n_ovf_upd) > 0:
            fallbacks["update"] += 1
            for table, pairs in ovf_pairs.items():
                lp = P[table].shape[0]
                for oid, og in pairs:
                    with fallback():
                        gid = all_gather_ids(oid, grid, GRID)
                        gg = all_gather(og, grid, GRID)
                    lid, owned = owned_or_sentinel(gid, grid.rank * lp, lp)
                    updates[table].append(
                        (lid, torch.where(owned[:, None], gg, 0.0)))
        params, opt_state = opt.apply(P, state.opt_state, updates,
                                      state.step)
        return (TrainState(params, opt_state, state.step + 1),
                all_reduce(loss, grid, GRID))

    def step_fn(state: TrainState, sampler: DeviceSampler,
                bits: torch.Tensor):
        return batch_step(state, sampler.sample(
            b_local, cfg.negative_ent, cfg.negative_rel, cfg.bern,
            bits=bits, partition=partition))

    step_fn.bits_shape = (b_local, DeviceSampler.bits_cols(
        cfg.negative_ent, cfg.negative_rel))
    step_fn.batch_step = batch_step
    step_fn.fallbacks = fallbacks
    step_fn.microbatches = mb
    step_fn.stats_caps = None      # (lp, caps), set at the first call
    return step_fn


def build_train_step_for(model: KGEModel, cfg: Config, grid: Grid,
                         batch_size: int, n_train: int, opt=None,
                         degrees=None) -> Callable:
    """The grid's step per :func:`plan_sharded_step` (``:577-592``)."""
    kind = plan_sharded_step(cfg, batch_size, grid)
    if kind == "hier":
        from openkeonspark_tpu_torch.parallel.hier import \
            build_hier_train_step
        return build_hier_train_step(model, cfg, grid, batch_size, n_train,
                                     opt, degrees)
    if kind == "exchange":
        return build_exchange_train_step(model, cfg, grid, batch_size,
                                         n_train, opt, degrees)
    return build_sharded_train_step(model, cfg, grid, batch_size, n_train,
                                    opt)
