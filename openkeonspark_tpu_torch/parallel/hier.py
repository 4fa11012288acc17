"""The hierarchical exchange step: a two-stage relay over a (host, data,
model) grid, so that a row crosses between hosts once per host, not once
per rank.

Counterpart of ``openkeonspark_tpu/parallel/hier.py:111-524``, one
process per rank instead of one ``shard_map`` program. Tables and
optimizer slots are row-sharded over the whole grid, host-major
(``shard_state(..., flat=True)``): rank ``n = h·L + l`` owns rows ``[n·Lp,
(n+1)·Lp)``. The relay of row ``id`` on a host is the rank at local
position ``(id // Lp) % L``, the position its owner has on the owner's
host, so a request routed to the relay over ``'local'`` and then across
hosts over ``'host'`` lands on the owner with no third hop.

- **Gather.** Each rank deduplicates its id stream
  (``cfg.exchange_dedup``) and sends the ids to their relays; the relay
  deduplicates the host's union and sends it to the owner hosts; the
  owner serves its rows with one local take; the rows come back across
  hosts, and the relay fans them out to the requesters. A per-entry
  success flag travels back through the first hop, so an id dropped at
  either stage is served by the exact fallback (``:276-283``).
- **Update.** The merged (id, row gradient) streams go to the relays in
  ``cfg.exchange_ici_wire_dtype``; the relay sums the host's duplicates
  (``train/optim.py::aggregate_duplicates``, kernel B5 for TransR's
  ``transfer_matrix`` on a card) and sends one row per id and host to the
  owner in ``cfg.exchange_wire_dtype``, where the optimizer applies it
  (B5 again for ``transfer_matrix``).
- **Small tables** (``Lp·N ≤ SMALL_TABLE_ROWS``) take one grid-wide
  ``all_gather`` and a dense ``[rows, d + 1]`` gradient, reduced once.
- **Hot rows** (``cfg.exchange_hot_rows``, ``parallel/hot.py``): hot ids
  are read from the replicated ``#hot`` companions and never routed;
  their gradients sum into one dense ``[K, d + 1]`` buffer, reduced once
  over the grid, applied as a ``DenseUpdate`` to every replica alike, and
  each owner mirrors its hot rows (and slots) back into the sharded
  tables (``:489-509``).
- **Overflow.** Both stages carry the flat step's exact fallbacks, each
  decided once for every rank: the overflow count is reduced with MAX
  over the grid and read on the host before any rank enters a fallback's
  collectives (``:315-326``, ``:466-488``).
- **Reductions.** A dense gradient (small tables, hot rows) is rounded to
  the wire dtype once on each rank, as routed rows are once a hop, and
  summed in fp32 (the JAX step sums in the wire dtype, ``:447``,
  ``:459``, which rounds every partial sum; at the fp32 wire the two are
  the same).
- **Capacities.** ``'stats'`` capacities and the hot set come from
  :class:`~openkeonspark_tpu_torch.parallel.hot.HotPlan`, built at the
  first call from the state's own local row counts (the JAX step guesses
  them from the entity count, ``:153``, which misses the pad row and any
  padding past the grid).

Draws equal the flat ``(H·Di, M)`` grid's (the data row is ``n // M``,
``:180-181``), so at the fp32 wire the step equals the flat exchange step
up to the order in which duplicate rows are summed
(``tests/test_torch_hier.py``)."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import KGEModel
from openkeonspark_tpu_torch.parallel.exchange import (
    GRID, WIRE_DTYPES, _bucket, _gather_fallback, _gather_plan,
    _max_over_grid, capacity_for, check_degrees, dedup_ids, expected_unique,
    microbatches)
from openkeonspark_tpu_torch.parallel.hot import (HOT_SUFFIX, HotPlan,
                                                  entity_table_names)
from openkeonspark_tpu_torch.parallel.mesh import (
    HOST, LOCAL, Grid, all_gather, all_gather_ids, all_reduce, all_to_all,
    all_to_all_ids, fallback)
from openkeonspark_tpu_torch.parallel.sharded import (data_partition,
                                                      owned_or_sentinel)
from openkeonspark_tpu_torch.sampling.device import (DeviceSampler,
                                                     SampledBatch)
from openkeonspark_tpu_torch.train.optim import (SMALL_TABLE_ROWS,
                                                 DenseUpdate, Updates,
                                                 aggregate_duplicates,
                                                 make_optimizer,
                                                 scatter_add_rows)
from openkeonspark_tpu_torch.train.step import (TrainState,
                                                check_train_supported,
                                                merged_row_updates,
                                                slot_loss_and_grads)


def _scatter_ids(ids: torch.Tensor, slot: torch.Tensor, n_slots: int,
                 fill: int) -> torch.Tensor:
    """[n_slots] buffer with ``ids`` at their slots, ``fill`` elsewhere
    (slot ``n_slots`` is the drop sink), ``:88-93``."""
    buf = ids.new_full((n_slots + 1,), fill)
    buf[slot] = ids
    return buf[:n_slots]


def _scatter_pairs(ids: torch.Tensor, grads: torch.Tensor,
                   slot: torch.Tensor, n_slots: int, sent: int):
    """Bucketed (ids, grads) buffers through one inverse permutation; an
    empty slot holds ``sent`` and a zero row (``:96-108``)."""
    u = ids.shape[0]
    src = torch.full((n_slots + 1,), u, dtype=torch.long, device=ids.device)
    src[slot] = torch.arange(u, device=ids.device)
    src = src[:n_slots]
    buf_ids = torch.cat([ids, ids.new_full((1,), sent)])[src]
    buf_ids = torch.where(buf_ids >= sent, sent, buf_ids)
    buf_g = torch.cat([grads, grads.new_zeros((1, grads.shape[1]))])[src]
    return buf_ids, buf_g


def wire_sum(buf: torch.Tensor, grid: Grid, wire_dt) -> torch.Tensor:
    """The grid's fp32 sum of every rank's ``buf`` rounded once to the
    wire dtype: a dense gradient quantized where a routed row is."""
    return all_reduce(buf.to(wire_dt).float(), grid, GRID)


def build_hier_train_step(model: KGEModel, cfg: Config, grid: Grid,
                          batch_size: int, n_train: int, opt=None,
                          degrees=None) -> Callable:
    """``(state, sampler, bits) → (state, global loss)`` on a (host, data,
    model) grid (``make_mesh((H, Di, M))``); ``step.batch_step(state,
    batch)`` runs it on a given data-row batch. ``batch_size`` is global;
    each of the H·Di data rows draws ``batch_size // (H·Di)`` positives,
    which must divide by M. State from ``shard_state(state, grid,
    flat=True)``, tables padded to a multiple of the grid size, companions
    filled by ``parallel.hot.sync_hot_cache``. ``opt``: the optimizer of
    the owners' and the replicas' updates (``make_optimizer(cfg)`` by
    default); ``degrees`` (``parallel/hot.py::degree_stats``) for hot
    rows and ``'stats'`` capacities.

    The step exposes ``bits_shape``, ``batch_step``, ``fallbacks`` (times
    each exact fallback ran, the same on every rank), ``overflow`` (ids
    this rank's buckets dropped, per stage), ``microbatches`` (the count
    it runs) and ``plan`` (the :class:`HotPlan`, set at the first
    call)."""
    check_train_supported(cfg)
    check_degrees(cfg, degrees)
    if grid.hosts is None:
        raise ValueError("the hierarchical step needs a (host, data, model) "
                         "grid: make_mesh((H, Di, M))")
    H, L, M = grid.hosts, grid.local, grid.model
    n_grid = grid.size
    b_local = max(1, batch_size // grid.data)
    if b_local % M:
        raise ValueError(
            f"hier step needs per-data-shard batch ({b_local}) divisible "
            f"by the model axis ({M}); pick batch_size accordingly")
    mb = microbatches(cfg, b_local // M)
    b_sub = b_local // M // mb
    partition = data_partition(n_train, grid)
    opt = opt or make_optimizer(cfg)
    slack = cfg.exchange_slack
    wire_dt = WIRE_DTYPES[cfg.exchange_wire_dtype]
    ici_dt = WIRE_DTYPES[cfg.exchange_ici_wire_dtype]
    dedup_gather = cfg.exchange_dedup in ("gather", "both")
    dedup_update = cfg.exchange_dedup == "both"
    n_neg = cfg.negative_ent + cfg.negative_rel
    n_idx = grid.rank
    fallbacks = {"gather": 0, "update": 0}
    zero = torch.zeros((), dtype=torch.long, device=grid.device)
    overflow = {k: zero.clone() for k in ("gather1", "gather2", "update1",
                                          "update2")}

    def get_plan(P) -> HotPlan:
        """The hot set and stage capacities at the state's own local rows
        of every entity table past ``SMALL_TABLE_ROWS`` physical rows."""
        lps = {t: P[t].shape[0] for t in entity_table_names(model)
               if P[t].shape[0] * n_grid > SMALL_TABLE_ROWS}
        if step_fn.plan is None or step_fn.plan.lp_by_table != lps:
            step_fn.plan = HotPlan(model, cfg, degrees, b_sub, lps, L, H)
            step_fn.plan.hot_ids = torch.from_numpy(
                step_fn.plan.hot_ids_np).long().to(grid.device)
        return step_fn.plan

    def batch_step(state: TrainState, batch: SampledBatch):
        P = state.params
        plan = (get_plan(P) if cfg.exchange_hot_rows
                or cfg.exchange_capacity == "stats" else None)
        caps = plan.caps if plan is not None else {}
        hot_tables = plan.hot_tables if plan is not None else ()
        hot_ids = plan.hot_ids if hot_tables else None
        k_hot = plan.k if hot_tables else 0

        def hot_mask(ids, sentinel):
            """(is_hot, companion slot, ids with hot ones as the
            sentinel) against the ascending hot set (``:165-172``)."""
            pos = torch.searchsorted(hot_ids, ids).clamp(max=k_hot - 1)
            is_hot = hot_ids[pos] == ids
            return is_hot, pos, torch.where(is_hot, sentinel, ids)

        # one grid-wide all_gather of each small table serves every
        # microbatch
        small_full = {t: all_gather(P[t].to(wire_dt), grid, GRID).to(
            P[t].dtype) for t in sorted({tb for _, tb, _ in model.gathers()})
            if P[t].shape[0] * n_grid <= SMALL_TABLE_ROWS}
        loss = torch.zeros((), dtype=torch.float32, device=grid.device)
        # per table: the routed (ids, grads) of each microbatch, then any
        # fallback rows, joined into one stream after the microbatches
        main_pairs: Dict[str, List] = {}
        ovf_pairs: Dict[str, List] = {}
        dense_grads: Dict[str, torch.Tensor] = {}
        hot_grads: Dict[str, torch.Tensor] = {}   # table -> [K, d+1] fp32
        n_ovf_upd = zero.clone()

        def hier_gather(table, ids):
            """Two-stage gather of one id stream: (rows [U, d], zero where
            not served; dedup index or None; fallback arguments; overflow
            count), ``:209-285``."""
            local = P[table]
            lp, d = local.shape
            rows_phys = lp * n_grid
            if dedup_gather:
                work, u_idx = dedup_ids(ids, sentinel=rows_phys)
                exp1 = expected_unique(ids.shape[0], rows_phys)
            else:
                work, u_idx, exp1 = ids, None, None
            # `< rows_phys` also drops hot ids masked to the sentinel
            valid = work < rows_phys
            u = work.shape[0]

            # stage 1: ids to their relays on this host
            if table in caps:
                cap1 = max(8, min(caps[table]["g1"], u))
            else:
                cap1 = capacity_for(u, L, slack, expected=exp1,
                                    local_rows=H * lp if dedup_gather
                                    else None)
            routed1, slot1, novf1 = _bucket(work, L, cap1, lp, valid,
                                            owner=(work // lp) % L)
            recv1 = all_to_all_ids(_scatter_ids(work, slot1, L * cap1,
                                                -1), grid, LOCAL)

            # stage 2 at the relay: the host's union deduplicated, ids to
            # their owner hosts
            runiq, r_uidx = dedup_ids(
                torch.where(recv1 >= 0, recv1, rows_phys),
                sentinel=rows_phys)
            rvalid = runiq < rows_phys
            if table in caps:
                cap2 = max(8, min(caps[table]["c2"], L * cap1, lp))
            else:
                cap2 = capacity_for(
                    L * cap1, H, slack,
                    expected=expected_unique(L * ids.shape[0],
                                             rows_phys) / L,
                    local_rows=lp)
            routed2, slot2, novf2 = _bucket(runiq, H, cap2, lp, rvalid,
                                            owner=runiq // (L * lp))
            recv2 = all_to_all_ids(_scatter_ids(runiq, slot2, H * cap2,
                                                -1), grid, HOST)

            # serve: the receiver is the owner (the relay's local position
            # is the owner's), so one local take
            lid = recv2 - n_idx * lp
            ok = (lid >= 0) & (lid < lp) & (recv2 >= 0)
            srows = torch.where(ok[:, None], local[lid.clamp(0, lp - 1)],
                                torch.zeros((), dtype=local.dtype,
                                            device=local.device)).to(wire_dt)

            # rows back across hosts, then out to the requesters
            resp2 = all_to_all(srows, grid, HOST)
            rows_runiq = torch.where(routed2[:, None],
                                     resp2[torch.where(routed2, slot2, 0)],
                                     torch.zeros((), dtype=resp2.dtype,
                                                 device=resp2.device))
            resp1 = all_to_all(rows_runiq[r_uidx], grid, LOCAL)
            # the relay's success flag travels back the first hop, so a
            # stage-2 drop reaches the requester's fallback
            flag1 = all_to_all(routed2.to(torch.int8)[r_uidx], grid, LOCAL)
            at1 = torch.where(routed1, slot1, 0)
            served = routed1 & (flag1[at1] > 0)
            out = torch.where(served[:, None], resp1[at1].to(local.dtype),
                              torch.zeros((), dtype=local.dtype,
                                          device=local.device))
            overflow["gather1"] += novf1
            overflow["gather2"] += novf2
            return out, u_idx, (work, served, valid), novf1 + novf2

        for c in range(mb):
            lo = (grid.m_idx * mb + c) * b_sub
            sub = batch.map(lambda x: x[lo:lo + b_sub])
            table_ids, assemble = _gather_plan(model, sub)

            fetched, fb_args, hot_info = {}, {}, {}
            n_ovf = zero.clone()
            for table, ids in table_ids.items():
                if table in small_full:
                    fetched[table] = (small_full[table][ids], None)
                    continue
                if table in hot_tables:
                    # hot ids: a read of the local companion; the routed
                    # stream sees the sentinel
                    is_hot, slot_h, ids = hot_mask(
                        ids, P[table].shape[0] * n_grid)
                    hot_info[table] = (is_hot, P[table + HOT_SUFFIX][slot_h])
                rows, u_idx, fb, novf = hier_gather(table, ids)
                fetched[table] = (rows, u_idx)
                fb_args[table] = fb
                n_ovf = n_ovf + novf
            if fb_args and _max_over_grid(grid, n_ovf) > 0:
                fallbacks["gather"] += 1
                for t in sorted(fb_args):
                    rows, u_idx = fetched[t]
                    fetched[t] = (rows + _gather_fallback(grid, P[t],
                                                          *fb_args[t]),
                                  u_idx)
            rows_by_table = {}
            for t, (rows, u_idx) in fetched.items():
                rows = rows if u_idx is None else rows[u_idx]
                if t in hot_info:
                    is_hot, hot_rows = hot_info[t]
                    rows = torch.where(is_hot[:, None],
                                       hot_rows.to(rows.dtype), rows)
                rows_by_table[t] = rows

            closs, g_slots = slot_loss_and_grads(
                model, cfg, assemble(rows_by_table), b_sub, n_neg)
            loss = loss + closs.float()

            # two-stage update routing
            for table, (uid, ug) in merged_row_updates(model.gathers(), sub,
                                                       g_slots).items():
                lp = P[table].shape[0]
                rows_phys = sent = lp * n_grid
                if table in small_full:
                    # a dense [rows, d + 1] gradient, the last column its
                    # touch count; one reduction after the microbatches
                    g_dense = torch.zeros(rows_phys, ug.shape[1] + 1,
                                          dtype=ug.dtype, device=ug.device)
                    scatter_add_rows(g_dense, uid, torch.cat(
                        [ug, ug.new_ones((ug.shape[0], 1))], 1))
                    dense_grads[table] = (dense_grads[table] + g_dense
                                          if table in dense_grads
                                          else g_dense)
                    continue
                if table in hot_tables:
                    # hot rows: a dense [K, d + 1] gradient (the last column
                    # counts touches for the lazy optimizers), never routed
                    is_hot, slot_h, uid = hot_mask(uid, sent)
                    acc = hot_grads.get(table)
                    if acc is None:
                        acc = hot_grads[table] = torch.zeros(
                            k_hot, ug.shape[1] + 1, dtype=torch.float32,
                            device=ug.device)
                    scatter_add_rows(acc, torch.where(is_hot, slot_h, k_hot),
                                     torch.cat([ug, ug.new_ones(
                                         (ug.shape[0], 1))], 1))
                if dedup_update:
                    uid, ug = aggregate_duplicates(uid, ug, sentinel=sent)
                    exp1 = expected_unique(uid.shape[0], rows_phys)
                else:
                    exp1 = None
                # `< sent` also drops hot ids masked to the sentinel
                valid = uid < sent

                # stage 1, in the ICI wire dtype: (id, grad) to the relay
                if table in caps:
                    cap1 = max(8, min(caps[table]["u1"], uid.shape[0]))
                else:
                    cap1 = capacity_for(uid.shape[0], L, slack,
                                        expected=exp1)
                routed1, slot1, novf1 = _bucket(uid, L, cap1, lp, valid,
                                                owner=(uid // lp) % L)
                b_ids, b_g = _scatter_pairs(uid, ug, slot1, L * cap1, sent)
                rid = all_to_all_ids(b_ids, grid, LOCAL)
                rg = all_to_all(b_g.to(ici_dt), grid, LOCAL).to(ug.dtype)

                # the relay sums the host's duplicates, then one hop across
                # hosts straight to the owner
                auid, aagg = aggregate_duplicates(rid, rg, sentinel=sent)
                avalid = auid < sent
                if table in caps:
                    cap2 = max(8, min(caps[table]["c2"], L * cap1, lp))
                else:
                    cap2 = capacity_for(
                        L * cap1, H, slack,
                        expected=expected_unique(L * uid.shape[0],
                                                 rows_phys) / L,
                        local_rows=lp)
                routed2, slot2, novf2 = _bucket(auid, H, cap2, lp, avalid,
                                                owner=auid // (L * lp))
                b2_ids, b2_g = _scatter_pairs(auid, aagg, slot2, H * cap2,
                                              sent)
                rid2 = all_to_all_ids(b2_ids, grid, HOST)
                rg2 = all_to_all(b2_g.to(wire_dt), grid, HOST).to(ug.dtype)
                lid, _ = owned_or_sentinel(rid2, n_idx * lp, lp)
                main_pairs.setdefault(table, []).append((lid, rg2))
                # overflow streams: this rank's unrouted rows and the
                # relay's unrouted sums
                ovf_pairs.setdefault(table, []).extend([
                    (torch.where(routed1 | ~valid, sent, uid), ug),
                    (torch.where(routed2 | ~avalid, sent, auid), aagg)])
                n_ovf_upd = n_ovf_upd + novf1 + novf2
                overflow["update1"] += novf1
                overflow["update2"] += novf2

        updates: Updates = {}
        for table, g_dense in dense_grads.items():
            lp = P[table].shape[0]
            g_local = wire_sum(g_dense, grid, wire_dt)[
                n_idx * lp:(n_idx + 1) * lp]
            touched = g_local[:, -1] > 0
            lid = torch.where(touched, torch.arange(lp, device=grid.device),
                              lp)
            updates[table] = (lid, g_local[:, :-1])
        for table, g_hot in hot_grads.items():
            # one reduction carries every hot-row gradient; every rank
            # applies the same update to its replica
            g_sum = wire_sum(g_hot, grid, wire_dt)
            updates[table + HOT_SUFFIX] = DenseUpdate(
                grad=g_sum[:, :-1], touched=g_sum[:, -1] > 0)
        if ovf_pairs and _max_over_grid(grid, n_ovf_upd) > 0:
            fallbacks["update"] += 1
            for table, pairs in ovf_pairs.items():
                lp = P[table].shape[0]
                for oid, og in pairs:
                    with fallback():
                        gid = all_gather_ids(oid, grid, GRID)
                        gg = all_gather(og, grid, GRID)
                    lid, owned = owned_or_sentinel(gid, n_idx * lp, lp)
                    main_pairs[table].append(
                        (lid, torch.where(owned[:, None], gg, 0.0)))
        for table, parts in main_pairs.items():
            ids, grads = zip(*parts)
            updates[table] = (torch.cat(ids), torch.cat(grads))
        params, opt_state = opt.apply(P, state.opt_state, updates,
                                      state.step)
        for table in hot_grads:
            # owner mirror: the owned hot rows and slots, from the updated
            # companions into the sharded tables
            lp = params[table].shape[0]
            lid = hot_ids - n_idx * lp
            owned = (lid >= 0) & (lid < lp)
            tgt = lid[owned]
            for tree in (params, *opt_state.values()):
                tree[table][tgt] = tree[table + HOT_SUFFIX][owned].to(
                    tree[table].dtype)
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
    step_fn.overflow = overflow
    step_fn.microbatches = mb
    step_fn.plan = None
    return step_fn
