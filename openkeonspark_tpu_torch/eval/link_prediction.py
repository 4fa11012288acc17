"""Link-prediction evaluation: raw + filtered MR / MRR / Hits@1/3/10,
head / tail / averaged.

Counterpart of ``openkeonspark_tpu/eval/link_prediction.py`` (``:50-110``,
``:143-199``, ``:212-258``, ``:295-431``, ``:491-644``) for all seven
models. The rank of the gold entity is ``1 + #{candidates scoring
strictly better}``: a chunk of test triples is counted against the whole
entity table in one fused pass by the model's count kernel
(``ops/rank.py``: B1 TransE, B6 TransH, B2 TransD, B3 RotatE; CUDA on the
card). The filtered rank subtracts the known-true candidates (all splits)
that score better: their ids are gathered on the device from the group
index into a ``[C, K]`` window and scored through the same arithmetic as
the count, so the subtraction is tie-exact. The window is padded with the
swept table's row count, an id outside the table: the id scorers give it
NaN without reading a row, and the padding is masked out. Most of a window
is padding (the known-true lists are short beside the longest), so the id
scorers do work only for real ids.

TransR, and TransH by default, go relation by relation
(:func:`_grouped_link_prediction`), as the reference does: test triples
are sorted by relation into single-relation chunks, the entity table is
projected once per chunk (``E @ M_ρ``, or ``E − (E·ŵ_ρ)ŵ_ρ``) and B1
sweeps the projected table, gold and known-true scores coming from the
same projected table.

The routes follow the reference's switches (:func:`eval_route`,
``link_prediction.py:434-471, 531-532``): ``cfg.use_pallas_eval=False``
sends every model to the generic route (:func:`_rank_chunk`, the
reference's ``_rank_chunk``: blocks of ``cfg.eval_block`` candidates
scored through ``eval/scoring.py``, the gold scores read from that sweep,
the known-true ones scored by the model's triple scorer), which runs no
kernel; ``OKST_EVAL_FORCE_GENERIC=1`` sends TransR and TransH there, and
TransH goes chunk by chunk through B6 only when ``OKST_EVAL_TRANSH_KERNEL=1``
is set beside it. The reference's chunk caps (a chunk over 1,024, or 512
for RotatE, falls back to its generic path) guard the TPU's VMEM and are
not ported.

``cfg.eval_dtype`` acts where it acts in the reference: the generic route
and the bilinear route score in it, and the relation-by-relation routes
project the entity table from operands rounded to it (products summed in
fp32, an fp32 projected table). The kernel routes (B1, B2, B3, B6) rank
in fp32 whatever it says, as the reference's kernels do
(``pallas_rank.py:231-233, 345``). Tables of any dtype are read as fp32
(exact for bf16) before a route starts.

DistMult and ComplEx have no count kernel in either package (the JAX
package ranks them on its generic path, ``_rank_scan``): their scores are
one full-fp32 product per query chunk and direction, ``S = −(q @ Eᵀ)``
(:func:`_bilinear_scorers`), and the gold and known-true scores are
gathered from the same ``S``, so the subtraction is tie-exact here too
(the JAX package scores the known-true ids elementwise through
``score_triples``; the two can differ only on near-ties). This route is
their generic route too. Ids ≥ n_ent are masked out of the count: the zero
pad rows score 0, which beats any gold of positive dot product. ``S`` is
held to :data:`BILINEAR_SWEEP_ELEMS` elements: a larger entity table is
swept in blocks of rows, twice (the gold and known-true scores first, then
the count)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data.dataset import Dataset, H, R, T
from openkeonspark_tpu_torch.data.index import KGIndex
from openkeonspark_tpu_torch.eval.scoring import (BILINEAR,
                                                  CANDIDATE_TABLES,
                                                  build_queries, eval_dot,
                                                  score_block)
from openkeonspark_tpu_torch.models.base import get_model
from openkeonspark_tpu_torch.models.transh import unit
from openkeonspark_tpu_torch.ops import rank as rank_ops
from openkeonspark_tpu_torch.runtime import (check_supported, eval_chunk_size,
                                             full_fp32_matmul, torch_dtype)


# elements of the candidate scores [C, rows] a swept route keeps at once:
# 256 queries against 65,536 entities (64 MiB of fp32); FB15K-237's
# 14,541 are kept whole, a larger table is swept twice
BILINEAR_SWEEP_ELEMS = 1 << 24


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

    @staticmethod
    def from_ranks(ranks: Dict[str, np.ndarray]) -> "LinkPredictionResult":
        return LinkPredictionResult(
            raw_head=DirectionMetrics.from_ranks(ranks["raw_head"]),
            raw_tail=DirectionMetrics.from_ranks(ranks["raw_tail"]),
            filt_head=DirectionMetrics.from_ranks(ranks["filt_head"]),
            filt_tail=DirectionMetrics.from_ranks(ranks["filt_tail"]),
            ranks=ranks)

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


def _count_chunk(count, scores, gold_ids: torch.Tensor, known: torch.Tensor,
                 n_ent: int):
    """Raw and filtered counts of strictly better candidates for one query
    chunk (:func:`_scorers`); ``gold_ids`` [C] and ``known`` [C, K] int32,
    the window padded with the swept table's row count (scored NaN)."""
    gold_s = scores(gold_ids)
    raw = count(gold_s, gold_ids)
    ks = scores(known)
    kvalid = (known < n_ent) & (known != gold_ids[:, None])
    known_better = ((ks < gold_s[:, None]) & kvalid).sum(1, dtype=torch.int32)
    return raw, raw - known_better


def _swept_scorers(block_scores, C: int, rows: int, block: int,
                   n_ent: int, dev, allowed=None):
    """(count, scores) of one query chunk, with the signatures of
    :func:`_scorers`, over candidate scores ``block_scores(c0, c1)`` [C,
    c1 − c0] swept in blocks of ``block`` rows. The id scorer gathers from
    the sweep (fp32; NaN for an id outside [0, rows), unread); the count
    compares the sweep with the gold scores, ids ≥ n_ent masked, and with
    ``allowed`` [C, rows] also the candidates it marks 0. The sweep is kept
    for both while ``C · rows`` is at most :data:`BILINEAR_SWEEP_ELEMS`,
    and computed again for the count otherwise."""
    starts = range(0, rows, block)
    keep = C * rows <= BILINEAR_SWEEP_ELEMS
    kept = {}

    def sweep(c0):
        if c0 in kept:
            return kept[c0]
        S = block_scores(c0, min(c0 + block, rows))
        if keep:
            kept[c0] = S
        return S

    def scores(ids):
        flat = ids.reshape(C, -1).long()
        out = torch.full(flat.shape, float("nan"), device=dev)
        for c0 in starts:
            S = sweep(c0)
            local = flat - c0
            inside = (local >= 0) & (local < S.shape[1])
            got = S.gather(1, local.clamp(0, S.shape[1] - 1))
            out = torch.where(inside, got, out)
        return out.view(ids.shape)

    def count(gold, gold_ids=None):
        raw = torch.zeros(C, dtype=torch.int32, device=dev)
        for c0 in starts:
            S = sweep(c0)
            c1 = c0 + S.shape[1]
            better = (S < gold[:, None]) & (
                torch.arange(c0, c1, device=dev) < n_ent)[None]
            if allowed is not None:
                better &= allowed[:, c0:c1] > 0
            raw += better.sum(1, dtype=torch.int32)
        return raw

    return count, scores


def _bilinear_scorers(q: torch.Tensor, table: torch.Tensor, n_ent: int):
    """(count, scores) of one query chunk of DistMult or ComplEx
    (:func:`_swept_scorers`): candidate scores are ``S = −(q @ tableᵀ)``
    in the queries' dtype, the eval dtype (the table rounded to it, the
    products summed in fp32 and rounded once, as the reference's
    ``scoring.py:194-200``), in blocks of rows that keep ``S`` under
    :data:`BILINEAR_SWEEP_ELEMS` elements."""
    C, rows = q.shape[0], table.shape[0]

    def block_scores(c0, c1):
        return -eval_dot(q, table[c0:c1].to(q.dtype).T).to(q.dtype)

    return _swept_scorers(block_scores, C, rows,
                          max(1, BILINEAR_SWEEP_ELEMS // max(C, 1)), n_ent,
                          q.device)


def _known_scores(params, cfg: Config, h, t, r, known: torch.Tensor,
                  replace: str, n_ent: int) -> torch.Tensor:
    """[C, K] scores of the known-true ids through the model's triple
    scorer (the reference's ``score_triples`` at ``:190-209``); ids ≥
    n_ent score the zero pad row. Laid out [K, C] against relation rows
    gathered once a query ([1, C]), so TransR's matrices are never
    gathered K times."""
    Model = get_model(cfg.model)
    ids = {"h": h.long()[None, :], "t": t.long()[None, :],
           "r": r.long()[None, :]}
    ids["t" if replace == "tail" else "h"] = known.long().clamp(max=n_ent).T
    slots = {slot: params[table][ids[anchor]]
             for slot, table, anchor in Model.gathers()}
    return Model.score(slots, cfg).T


def _rank_chunk(params, cfg: Config, h, t, r, gold: torch.Tensor,
                known: torch.Tensor, replace: str, n_ent: int,
                allowed: Optional[torch.Tensor] = None):
    """The generic route's raw and filtered counts of one query chunk, the
    reference's ``_rank_chunk`` (``link_prediction.py:150-210``):
    ``params`` in the eval dtype; candidates swept in blocks of
    ``cfg.eval_block`` through ``build_queries`` / ``score_block``, the
    gold scores read from that sweep (pass 1), the candidates with id <
    n_ent that score strictly better counted (pass 2), and the known-true
    ids scored by the model's triple scorer (:func:`_known_scores`), not
    read from the sweep. ``allowed`` [C, rows] (type constraints) is
    conjoined with the count and with the known-true ids. No kernel."""
    C, dev = h.shape[0], h.device
    names = CANDIDATE_TABLES[cfg.model]
    q = build_queries(params, h.long(), t.long(), r.long(), replace, cfg)

    def block_scores(c0, c1):
        return score_block(q, {n: params[n][c0:c1] for n in names}, replace,
                           cfg)

    count, scores = _swept_scorers(
        block_scores, C, params["ent_embeddings"].shape[0], cfg.eval_block,
        n_ent, dev, allowed)
    gold_s = scores(gold)
    raw = count(gold_s)
    ks = _known_scores(params, cfg, h, t, r, known, replace, n_ent).float()
    kvalid = (known < n_ent) & (known != gold[:, None])
    if allowed is not None:
        kvalid &= allowed.gather(1, known.long().clamp(
            max=allowed.shape[1] - 1)) > 0
    known_better = ((ks < gold_s[:, None]) & kvalid).sum(1, dtype=torch.int32)
    return raw, raw - known_better


def _chunk_scorers(cfg: Config, params, cdot, h, t, r, replace: str,
                   n_ent: int, plain: bool):
    """The queries of a chunk of test triples and their scorers on the
    kernel routes, by model: the JAX package's ``_rank_chunk_kernel``
    (``link_prediction.py:212-258``) and, for DistMult and ComplEx, the
    bilinear route (no kernel, so ``plain`` changes nothing there).
    ``cdot`` is TransD's per-entity dot (None otherwise)."""
    if cfg.model in BILINEAR:
        q = build_queries(params, h.long(), t.long(), r.long(), replace,
                          cfg)["q"]
        return _bilinear_scorers(q, params["ent_embeddings"], n_ent)
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
    package's ``_rank_scan_grouped`` ``project``, ``:342-352``): operands
    rounded to ``cfg.eval_dtype``, products summed in fp32, the projected
    table fp32."""
    ed = torch_dtype(cfg.eval_dtype)
    E = params["ent_embeddings"].to(ed)
    if cfg.model == "transr":
        TM, de, dr = params["transfer_matrix"], cfg.d_ent, cfg.d_rel
        return lambda rho: eval_dot(E, TM[rho].view(de, dr).to(ed))
    Ef, W = E.float(), unit(params["normal_vectors"])

    def project(rho):
        w = W[rho].to(ed).float()
        return Ef - eval_dot(Ef, w)[:, None] * w

    return project


def eval_route(cfg: Config) -> str:
    """The route ``cfg.model`` ranks on, by the reference's switches
    (``link_prediction.py:434-471, 531-532``): ``"grouped"`` (relation by
    relation, B1 on projected tables) for TransR and TransH unless
    ``OKST_EVAL_FORCE_GENERIC=1``; ``"bilinear"`` for DistMult and ComplEx
    (their generic route too); ``"generic"`` (:func:`_rank_chunk`, no
    kernel) for every other model when ``cfg.use_pallas_eval`` is False,
    for TransR under ``OKST_EVAL_FORCE_GENERIC=1``, and for TransH under it
    unless ``OKST_EVAL_TRANSH_KERNEL=1`` is set too; else ``"kernel"`` (B1
    TransE, B2 TransD, B3 RotatE, B6 TransH) chunk by chunk."""
    if cfg.model in BILINEAR:
        return "bilinear"
    if not cfg.use_pallas_eval:
        return "generic"
    forced = os.environ.get("OKST_EVAL_FORCE_GENERIC") == "1"
    if cfg.model in ("transr", "transh") and not forced:
        return "grouped"
    if cfg.model == "transr" or (
            cfg.model == "transh"
            and os.environ.get("OKST_EVAL_TRANSH_KERNEL") != "1"):
        return "generic"
    return "kernel"


def _grouped_link_prediction(params, cfg: Config, ds: Dataset,
                             triples: np.ndarray, offs, k_max: int,
                             vals_t, vals_h, plain: bool, log=None):
    """Ranks one relation-sharing chunk at a time (the JAX package's
    ``_grouped_link_prediction`` / ``_rank_scan_grouped``): the entity
    table is projected once per chunk and both directions sweep the
    projected table with the TransE count kernel (B1)."""
    dev = params["ent_embeddings"].device
    rows = params["ent_embeddings"].shape[0]    # the projected tables' too
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
            kt = known_matrix(vals_t, ot[ci], ct[ci], k_max, rows)
            kh = known_matrix(vals_h, oh[ci], ch[ci], k_max, rows)
            for keys, q, sign, gold, known in (
                    (("raw_tail", "filt_tail"),
                     proj[hq.long()] + rvec, -1.0, tq, kt),
                    (("raw_head", "filt_head"),
                     rvec - proj[tq.long()], 1.0, hq, kh)):
                count, scores = _scorers("transe", (q.contiguous(), proj),
                                         sign, cfg.p_norm, ds.n_ent, plain)
                for k, v in zip(keys, _count_chunk(count, scores, gold,
                                                   known, ds.n_ent)):
                    out[k].append(v)
    ranks = {k: np.empty(len(triples), np.int64) for k in out}
    for k, v in out.items():
        # pad slots repeat their chunk's first triple: equal values
        ranks[k][posm.reshape(-1)] = torch.cat(v).cpu().numpy()
    if log is not None:
        log(f"link-pred ({cfg.model} grouped) {len(triples)}/{len(triples)}")
    return ranks


def _chunked_link_prediction(cfg: Config, triples: np.ndarray, offs,
                             k_max: int, vals_t, vals_h, rows: int, dev,
                             rank_chunk, log=None, label: str = "link-pred"):
    """Ranks chunk by chunk in the order of ``triples``:
    ``rank_chunk(h, t, r, replace, gold, known)`` gives a chunk's raw and
    filtered counts for one direction, ``known`` its [C, k_max] known-true
    window padded with ``rows`` (the swept table's row count)."""
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
            kt = known_matrix(vals_t, ot[sl], ct[sl], k_max, rows)
            kh = known_matrix(vals_h, oh[sl], ch[sl], k_max, rows)
            for replace, gold, known in (("tail", t[sl], kt),
                                         ("head", h[sl], kh)):
                raw, filt = rank_chunk(h[sl], t[sl], r[sl], replace, gold,
                                       known)
                out[f"raw_{replace}"].append(raw)
                out[f"filt_{replace}"].append(filt)
        for k in ranks:
            ranks[k][s:e] = torch.cat(out[k]).cpu().numpy()
        if log is not None:
            log(f"{label} {e}/{n}")
    return ranks


def known_windows(index: KGIndex, triples: np.ndarray, dev):
    """What every route needs of the all-splits group index: the (off,
    cnt) windows of each test triple's known tails and heads (host
    lookups), ``k_max`` (the longest, rounded up to 64) and the flat
    group arrays on the device, from which the windows are gathered."""
    if index.hr_all is None or index.tr_all is None:
        raise ValueError("link prediction needs an eval index "
                         "(build_kg_index(for_eval=True))")
    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    offt, cntt = index.hr_all.lookup(h_all, r_all)
    offh, cnth = index.tr_all.lookup(t_all, r_all)
    k_max = int(max(cntt.max(), cnth.max(), 1))
    k_max = -(-k_max // 64) * 64
    vals_t, vals_h = (torch.from_numpy(g.sorted_vals.astype(np.int32)).to(dev)
                      for g in (index.hr_all, index.tr_all))
    return (offt, cntt, offh, cnth), k_max, vals_t, vals_h


@torch.no_grad()
def link_prediction(params: Dict[str, torch.Tensor], cfg: Config,
                    ds: Dataset, index: KGIndex,
                    triples: Optional[np.ndarray] = None, log=None,
                    plain: bool = False) -> LinkPredictionResult:
    """Evaluate link prediction over ``triples`` (default: the test split)
    on the device the tables lie on. ``index`` must be built with
    ``for_eval=True`` (all-splits group lists). The route follows
    :func:`eval_route`. ``plain=True`` counts through the plain PyTorch
    versions instead of the kernels: the reference the kernel routes are
    held to on the card (the generic and bilinear routes run no kernel,
    so it changes nothing there)."""
    check_supported(cfg)
    if triples is None:
        triples = ds.test
    if triples is None or len(triples) == 0:
        raise ValueError("no test triples")
    dev = params["ent_embeddings"].device
    offs, k_max, vals_t, vals_h = known_windows(index, triples, dev)
    guard_finite_params(params)
    params = {k: v.float() for k, v in params.items()}
    route = eval_route(cfg)
    if route == "grouped":
        ranks = _grouped_link_prediction(params, cfg, ds, triples, offs,
                                         k_max, vals_t, vals_h, plain, log)
        return LinkPredictionResult.from_ranks(ranks)
    if route == "generic":
        dt = torch_dtype(cfg.eval_dtype)
        gp = {k: v.to(dt) for k, v in params.items()}

        def rank_chunk(h, t, r, replace, gold, known):
            return _rank_chunk(gp, cfg, h, t, r, gold, known, replace,
                               ds.n_ent)
    else:
        # TransD's per-entity dot, once per evaluation and shared by every
        # count and id score
        cdot = rank_ops.transd_cdot(params) if cfg.model == "transd" \
            else None

        def rank_chunk(h, t, r, replace, gold, known):
            count, scores = _chunk_scorers(cfg, params, cdot, h, t, r,
                                           replace, ds.n_ent, plain)
            return _count_chunk(count, scores, gold, known, ds.n_ent)

    return LinkPredictionResult.from_ranks(_chunked_link_prediction(
        cfg, triples, offs, k_max, vals_t, vals_h,
        params["ent_embeddings"].shape[0], dev, rank_chunk, log))
