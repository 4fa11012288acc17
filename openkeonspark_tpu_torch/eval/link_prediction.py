"""Link-prediction evaluation: raw + filtered MR / MRR / Hits@1/3/10,
head / tail / averaged.

Counterpart of ``openkeonspark_tpu/eval/link_prediction.py`` (``:50-110``,
``:212-258``, ``:295-431``, ``:491-644``) for TransE, TransH, TransR, TransD
and RotatE. The rank of the gold entity is ``1 + #{candidates scoring
strictly better}``: a chunk of test triples is counted against the whole
entity table in one fused pass by the model's count kernel
(``ops/rank.py``: B1 TransE, B6 TransH, B2 TransD, B3 RotatE; CUDA on the
card). The filtered rank subtracts the known-true candidates (all splits)
that score better: their ids are gathered on the device from the group
index into a ``[C, K]`` window padded with ``n_ent`` and scored through
the same arithmetic as the count, so the subtraction is tie-exact.

TransR, and TransH by default, go relation by relation
(:func:`_grouped_link_prediction`), as the reference does: test triples
are sorted by relation into single-relation chunks, the entity table is
projected once per chunk (``E @ M_ρ``, or ``E − (E·ŵ_ρ)ŵ_ρ``) and B1
sweeps the projected table, gold and known-true scores coming from the
same projected table. ``OKST_EVAL_TRANSH_KERNEL=1`` sends TransH chunk by
chunk through B6 instead, as the reference's switch does."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import Dataset, H, R, T
from openkeonspark_tpu.data.index import KGIndex
from openkeonspark_tpu_torch.models.transh import unit
from openkeonspark_tpu_torch.ops import rank as rank_ops
from openkeonspark_tpu_torch.runtime import (check_supported, eval_chunk_size,
                                             full_fp32_matmul)


@dataclass
class DirectionMetrics:
    mr: float
    mrr: float
    hits1: float
    hits3: float
    hits10: float

    @staticmethod
    def from_ranks(ranks: np.ndarray) -> "DirectionMetrics":
        r = ranks.astype(np.float64) + 1.0  # ranks stored 0-based (count of better)
        return DirectionMetrics(
            mr=float(r.mean()),
            mrr=float((1.0 / r).mean()),
            hits1=float((r <= 1).mean()),
            hits3=float((r <= 3).mean()),
            hits10=float((r <= 10).mean()),
        )


@dataclass
class LinkPredictionResult:
    """All 2 (raw/filter) × 2 (head/tail) metric sets + averages, plus the
    per-triple ranks (raw_head/raw_tail/filt_head/filt_tail)."""

    raw_head: DirectionMetrics
    raw_tail: DirectionMetrics
    filt_head: DirectionMetrics
    filt_tail: DirectionMetrics
    ranks: Dict[str, np.ndarray]

    @staticmethod
    def _avg(a: DirectionMetrics, b: DirectionMetrics) -> DirectionMetrics:
        return DirectionMetrics(*[(x + y) / 2 for x, y in
                                  zip(a.__dict__.values(), b.__dict__.values())])

    @property
    def raw_avg(self) -> DirectionMetrics:
        return self._avg(self.raw_head, self.raw_tail)

    @property
    def filt_avg(self) -> DirectionMetrics:
        return self._avg(self.filt_head, self.filt_tail)

    def format_table(self) -> str:
        """The reference's ``test_link_prediction`` table, byte for byte."""
        rows = [
            ("metric", "MR", "MRR", "hit@1", "hit@3", "hit@10"),
        ]
        for label, m in [
            ("l(raw)", self.raw_head), ("r(raw)", self.raw_tail),
            ("averaged(raw)", self.raw_avg),
            ("l(filter)", self.filt_head), ("r(filter)", self.filt_tail),
            ("averaged(filter)", self.filt_avg),
        ]:
            rows.append((label, f"{m.mr:.2f}", f"{m.mrr:.4f}",
                         f"{m.hits1:.4f}", f"{m.hits3:.4f}", f"{m.hits10:.4f}"))
        widths = [max(len(r[i]) for r in rows) for i in range(6)]
        return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                         for r in rows)


def guard_finite_params(params: Dict[str, torch.Tensor]) -> None:
    """Refuse to rank with non-finite embeddings: NaN scores compare False
    against everything, so a diverged model would report a perfect Hits@10.
    One fused reduction and one host read for all tables; the offending
    table is named only on the failure path."""
    bad = torch.stack([(~torch.isfinite(t)).sum() for t in params.values()])
    if int(bad.sum()):
        for name, n in zip(params, bad.tolist()):
            if n:
                raise ValueError(
                    f"param table {name!r} contains non-finite values — "
                    "training diverged (lower alpha?); refusing to evaluate")


def known_matrix(sorted_vals: torch.Tensor, off: torch.Tensor,
                 cnt: torch.Tensor, k_max: int, pad: int) -> torch.Tensor:
    """[C, k_max] known-true ids of each query, gathered on the device from
    the flat group array (``off``/``cnt`` its windows), padded with
    ``pad``: the semantics of the reference's ``_known_matrix``."""
    C = off.shape[0]
    if sorted_vals.numel() == 0:
        return torch.full((C, k_max), pad, dtype=torch.int32,
                          device=off.device)
    lane = torch.arange(k_max, device=off.device)[None, :]
    src = (off.long()[:, None] + lane).clamp_(max=sorted_vals.numel() - 1)
    return torch.where(lane < cnt[:, None], sorted_vals[src], pad)


def _scorers(model: str, ops: tuple, sign: float, p: int, n_ent: int,
             plain: bool):
    """(count(gold, gold_ids), scores(ids)) of one query chunk through the
    model's kernel pair, or its plain versions; ``ops`` are the model's
    leading operands (``ops/rank.py::model_queries``)."""
    count, scores = rank_ops.KERNELS[model][2 * plain:2 * plain + 2]
    norm = () if model == "rotate" else (p,)   # RotatE has no p
    return (lambda gold, gold_ids: count(*ops, gold, gold_ids, sign, *norm,
                                         n_ent),
            lambda ids: scores(*ops, ids, sign, *norm))


def _count_chunk(count, scores, rows: int, gold_ids: torch.Tensor,
                 known: torch.Tensor, n_ent: int):
    """Raw and filtered counts of strictly better candidates for one query
    chunk (:func:`_scorers`); ``gold_ids`` [C] and ``known`` [C, K] int32,
    ``rows`` the swept table's rows."""
    gold_s = scores(gold_ids)
    raw = count(gold_s, gold_ids)
    ks = scores(known.clamp(max=rows - 1))
    kvalid = (known < n_ent) & (known != gold_ids[:, None])
    known_better = ((ks < gold_s[:, None]) & kvalid).sum(1, dtype=torch.int32)
    return raw, raw - known_better


def _chunk_scorers(cfg: Config, params, cdot, h, t, r, replace: str,
                   n_ent: int, plain: bool):
    """The queries of a chunk of test triples and their scorers, by model:
    the JAX package's ``_rank_chunk_kernel`` (``link_prediction.py:212-258``).
    ``cdot`` is TransD's per-entity dot (None otherwise)."""
    ops, sign = rank_ops.model_queries(cfg.model, params, cdot, h.long(),
                                       t.long(), r.long(), replace)
    return _scorers(cfg.model, ops, sign, cfg.p_norm, n_ent, plain)


def _single_relation_chunks(r_all: np.ndarray, chunk: int):
    """Positions of the triples sorted (stably) by relation, cut into
    single-relation chunks of ``chunk``, each relation's last chunk padded
    with its own first triple: (relation [NC], positions [NC, chunk])."""
    order = np.argsort(r_all, kind="stable")
    rs = r_all[order]
    cuts = np.flatnonzero(np.diff(rs)) + 1
    rels, pos = [], []
    for s, e in zip(np.r_[0, cuts], np.r_[cuts, len(rs)]):
        for c in range(s, e, chunk):
            part = order[c:min(c + chunk, e)]
            rels.append(rs[s])
            pos.append(np.r_[part, np.repeat(part[:1], chunk - len(part))])
    return np.asarray(rels, np.int64), np.stack(pos)


def _relation_projection(cfg: Config, params):
    """ρ → the entity table projected for relation ρ: ``E @ M_ρ`` [rows,
    d_r] for TransR, ``E − (E·ŵ_ρ)ŵ_ρ`` [rows, d] for TransH (the JAX
    package's ``_rank_scan_grouped`` ``project``, ``:345-352``)."""
    E = params["ent_embeddings"]
    if cfg.model == "transr":
        TM, de, dr = params["transfer_matrix"], cfg.d_ent, cfg.d_rel
        return lambda rho: E @ TM[rho].view(de, dr)
    W = unit(params["normal_vectors"])
    return lambda rho: E - (E @ W[rho])[:, None] * W[rho]


def use_grouped_route(cfg: Config) -> bool:
    """TransR, and TransH unless ``OKST_EVAL_TRANSH_KERNEL=1`` sends it
    chunk by chunk through B6 (the reference's A/B switch,
    ``link_prediction.py:462-464``), rank relation by relation."""
    return cfg.model == "transr" or (
        cfg.model == "transh"
        and os.environ.get("OKST_EVAL_TRANSH_KERNEL") != "1")


def _grouped_link_prediction(params, cfg: Config, ds: Dataset,
                             triples: np.ndarray, offs, k_max: int,
                             vals_t, vals_h, plain: bool, log=None):
    """Ranks one relation-sharing chunk at a time (the JAX package's
    ``_grouped_link_prediction`` / ``_rank_scan_grouped``): the entity
    table is projected once per chunk and both directions sweep the
    projected table with the TransE count kernel (B1)."""
    dev = params["ent_embeddings"].device
    project = _relation_projection(cfg, params)
    Rt = params["rel_embeddings"]
    chunk = min(eval_chunk_size(cfg), 64)   # small chunks bound the padding
    rel, posm = _single_relation_chunks(triples[:, R], chunk)
    on = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a[posm], dtype=np.int32)).to(dev)
    h, t = on(triples[:, H]), on(triples[:, T])
    ot, ct, oh, ch = (on(a) for a in offs)
    out = {k: [] for k in ("raw_tail", "filt_tail", "raw_head", "filt_head")}
    with full_fp32_matmul():
        for ci, rho in enumerate(rel.tolist()):
            proj = project(rho)                          # [rows, d']
            rvec = Rt[rho]
            hq, tq = h[ci], t[ci]
            kt = known_matrix(vals_t, ot[ci], ct[ci], k_max, ds.n_ent)
            kh = known_matrix(vals_h, oh[ci], ch[ci], k_max, ds.n_ent)
            for keys, q, sign, gold, known in (
                    (("raw_tail", "filt_tail"),
                     proj[hq.long()] + rvec, -1.0, tq, kt),
                    (("raw_head", "filt_head"),
                     rvec - proj[tq.long()], 1.0, hq, kh)):
                count, scores = _scorers("transe", (q.contiguous(), proj),
                                         sign, cfg.p_norm, ds.n_ent, plain)
                for k, v in zip(keys, _count_chunk(count, scores,
                                                   proj.shape[0], gold,
                                                   known, ds.n_ent)):
                    out[k].append(v)
    ranks = {k: np.empty(len(triples), np.int64) for k in out}
    for k, v in out.items():
        # pad slots repeat their chunk's first triple: equal values
        ranks[k][posm.reshape(-1)] = torch.cat(v).cpu().numpy()
    if log is not None:
        log(f"link-pred ({cfg.model} grouped) {len(triples)}/{len(triples)}")
    return ranks


def _chunked_link_prediction(params, cfg: Config, ds: Dataset,
                             triples: np.ndarray, offs, k_max: int, vals_t,
                             vals_h, plain: bool, log=None):
    """Ranks chunk by chunk in the order of ``triples``, each chunk swept
    over the whole entity table by the model's count kernel."""
    dev = params["ent_embeddings"].device
    rows = params["ent_embeddings"].shape[0]
    # TransD's per-entity dot, once per evaluation and shared by every
    # count and id score
    cdot = rank_ops.transd_cdot(params) if cfg.model == "transd" else None
    chunk = eval_chunk_size(cfg)
    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    offt, cntt, offh, cnth = offs
    n = len(triples)
    ranks = {k: np.empty(n, np.int64) for k in
             ("raw_head", "raw_tail", "filt_head", "filt_tail")}
    # groups bound the known-window elements held at once for huge splits;
    # results come back to the host once per group
    group_q = max(chunk, cfg.eval_group_elems // k_max // chunk * chunk)
    for s in range(0, n, group_q):
        e = min(s + group_q, n)
        dv = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[s:e], dtype=np.int32)).to(dev)
        h, t, r = dv(h_all), dv(t_all), dv(r_all)
        ot, ct, oh, ch = dv(offt), dv(cntt), dv(offh), dv(cnth)
        out = {k: [] for k in ranks}
        for c in range(0, e - s, chunk):
            sl = slice(c, c + chunk)
            kt = known_matrix(vals_t, ot[sl], ct[sl], k_max, ds.n_ent)
            kh = known_matrix(vals_h, oh[sl], ch[sl], k_max, ds.n_ent)
            for replace, gold, known in (("tail", t[sl], kt),
                                         ("head", h[sl], kh)):
                count, scores = _chunk_scorers(cfg, params, cdot, h[sl],
                                               t[sl], r[sl], replace,
                                               ds.n_ent, plain)
                raw, filt = _count_chunk(count, scores, rows, gold, known,
                                         ds.n_ent)
                out[f"raw_{replace}"].append(raw)
                out[f"filt_{replace}"].append(filt)
        for k in ranks:
            ranks[k][s:e] = torch.cat(out[k]).cpu().numpy()
        if log is not None:
            log(f"link-pred {e}/{n}")

    return ranks


@torch.no_grad()
def link_prediction(params: Dict[str, torch.Tensor], cfg: Config,
                    ds: Dataset, index: KGIndex,
                    triples: Optional[np.ndarray] = None, log=None,
                    plain: bool = False) -> LinkPredictionResult:
    """Evaluate link prediction over ``triples`` (default: the test split)
    on the device the tables lie on. ``index`` must be built with
    ``for_eval=True`` (all-splits group lists). ``plain=True`` counts
    through the plain PyTorch versions instead of the kernels: the
    reference the kernel path is held to on the card. TransR and TransH
    rank relation by relation over projected tables
    (:func:`use_grouped_route`)."""
    check_supported(cfg)
    if triples is None:
        triples = ds.test
    if triples is None or len(triples) == 0:
        raise ValueError("no test triples")
    if index.hr_all is None or index.tr_all is None:
        raise ValueError("link_prediction needs an eval index "
                         "(build_kg_index(for_eval=True))")
    guard_finite_params(params)

    dev = params["ent_embeddings"].device
    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    # host side: only the (off, cnt) window lookups; the known-id windows
    # are gathered on the device
    offt, cntt = index.hr_all.lookup(h_all, r_all)
    offh, cnth = index.tr_all.lookup(t_all, r_all)
    k_max = int(max(cntt.max(), cnth.max(), 1))
    k_max = -(-k_max // 64) * 64
    vals_t = torch.from_numpy(index.hr_all.sorted_vals.astype(np.int32)).to(dev)
    vals_h = torch.from_numpy(index.tr_all.sorted_vals.astype(np.int32)).to(dev)
    ranks = (_grouped_link_prediction if use_grouped_route(cfg)
             else _chunked_link_prediction)(
        params, cfg, ds, triples, (offt, cntt, offh, cnth), k_max, vals_t,
        vals_h, plain, log)
    return LinkPredictionResult(
        raw_head=DirectionMetrics.from_ranks(ranks["raw_head"]),
        raw_tail=DirectionMetrics.from_ranks(ranks["raw_tail"]),
        filt_head=DirectionMetrics.from_ranks(ranks["filt_head"]),
        filt_tail=DirectionMetrics.from_ranks(ranks["filt_tail"]),
        ranks=ranks,
    )
