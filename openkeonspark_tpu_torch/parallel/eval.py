"""Link prediction and triple scoring on the grid: candidate rows sharded
over ``'model'``, query chunks over ``'data'``.

Counterpart of ``openkeonspark_tpu/parallel/eval.py:56-402``. The global
chunk is ``eval_chunk × D`` test triples; data row ``d`` ranks the d-th
slice of every global chunk (``:193-197``):

- the query rows are assembled from the row-sharded tables by a masked
  take and an ``all_reduce`` over ``'model'``;
- each rank sweeps its own candidate rows in blocks of ``cfg.eval_block``
  through ``eval/scoring.py``'s ``score_block``, as the port's generic
  route (``eval/link_prediction.py::_rank_chunk``) sweeps the whole table;
  the JAX evaluator counts with the same generic arithmetic and no Pallas
  kernel, and so does this one;
- the gold and known-true scores are read from the owning rank's sweep
  and summed over ``'model'`` (scores cross the wire, not rows,
  ``:98-116``); the strict count never counts the gold against itself;
- the counts are summed over ``'model'`` and every rank gathers the ranks
  of all data rows.

Type-constrained link prediction shards the per-relation masks along the
entity axis with the rows (``:58-63``). Both read the sharded tables
only: the replicated ``#hot`` companions of hot-row replication are
dropped first (``:48-53``). :class:`ShardedTripleScorer`
scores id triples against either layout (``:337-402``) and plugs into
``eval/classification.py``'s ``score_fn``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data.dataset import Dataset, H, R, T
from openkeonspark_tpu_torch.data.index import KGIndex
from openkeonspark_tpu_torch.eval.link_prediction import (
    LinkPredictionResult, _swept_scorers, guard_finite_params, known_matrix,
    known_windows)
from openkeonspark_tpu_torch.eval.scoring import (CANDIDATE_TABLES,
                                                  build_queries, score_block)
from openkeonspark_tpu_torch.models.base import get_model
from openkeonspark_tpu_torch.parallel.hot import drop_hot
from openkeonspark_tpu_torch.parallel.mesh import (DATA, MODEL, Sharding,
                                                   all_gather, all_reduce)
from openkeonspark_tpu_torch.parallel.sharded import masked_take
from openkeonspark_tpu_torch.runtime import (check_supported, eval_chunk_size,
                                             full_fp32_matmul, torch_dtype)


def model_layout(params: Dict[str, torch.Tensor], sharding: Sharding
                 ) -> Dict[str, torch.Tensor]:
    """``params`` in the ``'model'``-only layout the evaluator sweeps: a
    flat layout over more than one data row is gathered and cut again (a
    collective)."""
    if not sharding.flat or sharding.grid.data == 1:
        return params
    return Sharding(sharding.grid, False).shard(sharding.gather(params))


def _ranker(params, cfg: Config, grid, n_ent: int, n_rel: int):
    """``rank(h, t, r, replace, gold, known, allowed)`` → (raw, filtered)
    counts of this rank's query slice, every argument ``[C]`` or ``[C,
    K]`` on the device (``ShardedRanker._body``, ``:70-169``)."""
    dt = torch_dtype(cfg.eval_dtype)
    specs = get_model(cfg.model).tables(cfg, n_ent, n_rel)
    lp = params["ent_embeddings"].shape[0]
    first = grid.m_idx * lp
    n_local = max(0, min(lp, n_ent - first))
    cand = {n: params[n].to(dt) for n in CANDIDATE_TABLES[cfg.model]}

    def owned(ids):
        local = ids.long() - first
        return local, (local >= 0) & (local < lp)

    def from_owner(values, own):
        return all_reduce(torch.where(own, values, 0.0), grid, MODEL)

    def rank(h, t, r, replace, gold, known, allowed=None):
        C = h.shape[0]
        # the queries' rows: entity tables at h and t, relation tables at
        # r, assembled over 'model'; the queries index them in order
        ent_ids = torch.cat([h, t]).long()
        rows = {k: all_reduce(masked_take(
            v, ent_ids if specs[k].kind == "ent" else r.long(),
            grid.m_idx * v.shape[0]), grid, MODEL) for k, v in params.items()}
        pos = torch.arange(C, device=h.device)
        q = build_queries(rows, pos, C + pos, pos, replace, cfg)

        def block_scores(c0, c1):
            return score_block(q, {n: v[c0:c1] for n, v in cand.items()},
                               replace, cfg)

        count, scores = _swept_scorers(block_scores, C, lp, cfg.eval_block,
                                       n_local, h.device, allowed)
        g_local, g_own = owned(gold)
        gold_s = from_owner(scores(g_local), g_own)
        raw = all_reduce(count(gold_s), grid, MODEL)
        k_local, k_own = owned(known)
        ks = from_owner(scores(k_local), k_own)
        kvalid = (known < n_ent) & (known != gold[:, None])
        if allowed is not None:
            bit = allowed.gather(1, k_local.clamp(0, lp - 1)).int()
            kvalid &= from_owner(bit, k_own) > 0
        known_better = ((ks < gold_s[:, None]) & kvalid).sum(
            1, dtype=torch.int32)
        return raw, raw - known_better

    return rank


def _sharded_ranks(params, cfg: Config, ds: Dataset, index: KGIndex,
                   sharding: Sharding, triples, masks=None, log=None,
                   label: str = "sharded link-pred"):
    """Ranks of ``triples`` on the grid (``sharded_link_prediction``'s
    loop, ``:172-253``); ``masks`` {replace: [R, rows] uint8} for type
    constraints."""
    check_supported(cfg)
    if triples is None:
        triples = ds.test
    if triples is None or len(triples) == 0:
        raise ValueError("no test triples")
    grid = sharding.grid
    params = model_layout(drop_hot(params), sharding)
    guard_finite_params(params)
    dev = grid.device
    D, d = grid.data, grid.d_idx
    lp = params["ent_embeddings"].shape[0]
    rows_phys = lp * grid.model
    offs, k_max, vals_t, vals_h = known_windows(index, triples, dev)
    chunk = eval_chunk_size(cfg)
    n = len(triples)
    glob = chunk * D
    nc = -(-n // glob)
    # pad to whole global chunks with the first triple; row d ranks slice
    # d of every global chunk
    pos = np.concatenate([np.arange(n), np.zeros(nc * glob - n, np.int64)])
    mine = pos.reshape(nc, D, chunk)[:, d].reshape(-1)
    on = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a[mine], dtype=np.int32)).to(dev)
    h, t, r = on(triples[:, H]), on(triples[:, T]), on(triples[:, R])
    ot, ct, oh, ch = (on(a) for a in offs)
    local_masks = None
    if masks is not None:
        first = grid.m_idx * lp
        local_masks = {k: torch.from_numpy(np.ascontiguousarray(
            m[:, first:first + lp])).to(dev) for k, m in masks.items()}
    rank = _ranker(params, cfg, grid, ds.n_ent, ds.n_rel)
    out = {k: [] for k in ("raw_tail", "filt_tail", "raw_head", "filt_head")}
    with full_fp32_matmul():
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            kt = known_matrix(vals_t, ot[sl], ct[sl], k_max, rows_phys)
            kh = known_matrix(vals_h, oh[sl], ch[sl], k_max, rows_phys)
            for replace, gold, known in (("tail", t[sl], kt),
                                         ("head", h[sl], kh)):
                allowed = (None if local_masks is None
                           else local_masks[replace][r[sl].long()])
                raw, filt = rank(h[sl], t[sl], r[sl], replace, gold, known,
                                 allowed)
                out[f"raw_{replace}"].append(raw)
                out[f"filt_{replace}"].append(filt)
    ranks = {}
    for k, v in out.items():
        # [D, nc, chunk] in data-row order → global chunk order
        got = all_gather(torch.cat(v), grid, DATA).view(D, nc, chunk)
        ranks[k] = got.permute(1, 0, 2).reshape(-1)[:n].cpu().numpy() \
            .astype(np.int64)
    if log is not None:
        for replace in ("tail", "head"):
            log(f"{label} {replace} done ({n} triples)")
    return LinkPredictionResult.from_ranks(ranks)


@torch.no_grad()
def sharded_link_prediction(params: Dict[str, torch.Tensor], cfg: Config,
                            ds: Dataset, index: KGIndex, sharding: Sharding,
                            triples: Optional[np.ndarray] = None, log=None
                            ) -> LinkPredictionResult:
    """Link prediction over row-sharded ``params`` (laid out as
    ``sharding`` says); every rank calls it and gets every rank
    (``:172-253``)."""
    return _sharded_ranks(params, cfg, ds, index, sharding, triples,
                          log=log)


@torch.no_grad()
def sharded_type_constrained_link_prediction(
        params: Dict[str, torch.Tensor], cfg: Config, ds: Dataset,
        index: KGIndex, tc, sharding: Sharding,
        triples: Optional[np.ndarray] = None, log=None
) -> LinkPredictionResult:
    """Type-constrained link prediction on the grid, the allowed masks
    sharded along the entity axis with the rows (``:256-334``)."""
    rows_phys = params["ent_embeddings"].shape[0] * sharding.parts
    masks = {}
    for replace, m in (("tail", tc.tail_mask(ds.n_ent)),
                       ("head", tc.head_mask(ds.n_ent))):
        full = np.zeros((ds.n_rel, rows_phys), np.uint8)
        full[:, :ds.n_ent] = m
        masks[replace] = full
    return _sharded_ranks(params, cfg, ds, index, sharding, triples, masks,
                          log, label="sharded type-constrained")


class ShardedTripleScorer:
    """Scores of id triples against row-sharded tables in ``sharding``'s
    layout (``:337-402``): each slot's rows by a masked take and an
    ``all_reduce`` over the layout's axis, then the model's own score, so
    the scores equal ``eval/classification.py::score_triples`` on the
    full tables bit for bit. Triples are replicated. ``score_fn`` of
    ``fit_thresholds`` and ``triple_classification``."""

    def __init__(self, cfg: Config, sharding: Sharding):
        self.cfg = cfg
        self.sharding = sharding

    @torch.no_grad()
    def __call__(self, params: Dict[str, torch.Tensor], triples: np.ndarray,
                 batch: int = 65536) -> np.ndarray:
        model = get_model(self.cfg.model)
        sh = self.sharding
        outs = []
        for s in range(0, len(triples), batch):
            chunk = torch.from_numpy(np.ascontiguousarray(
                triples[s:s + batch], np.int64)).to(sh.grid.device)
            ids = {"h": chunk[:, H], "t": chunk[:, T], "r": chunk[:, R]}
            slots = {}
            for slot, table, anchor in model.gathers():
                local = params[table]
                slots[slot] = all_reduce(masked_take(
                    local, ids[anchor], sh.index * local.shape[0]),
                    sh.grid, sh.axis)
            outs.append(model.score(slots, self.cfg).float().cpu().numpy())
        return np.concatenate(outs) if outs else np.empty(0, np.float32)
