"""Ad-hoc top-k prediction — the reference's "serving" path.

Counterpart of ``openkeonspark_tpu/eval/predict.py``: the query is built
once (``eval/scoring.py::build_queries``; TransR's anchor projected
through M_ρ), every candidate entity is scored block by block
(``score_block``; TransR's blocks projected through M_ρ, so the whole
table once a query), in ``cfg.eval_dtype``, and the k best (lowest score)
of the ids < n_ent are taken, read as fp32 (the reference's
``predict.py:37-38``), by a stable sort: equal scores (common in bf16) come
lowest id first, as ``lax.top_k`` gives them in the reference. A query
and its stages (build, score, select, fetch) open the ``okst.topk.*``
spans of ``obs.py``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.eval.classification import (Thresholds,
                                                         score_triples)
from openkeonspark_tpu_torch.eval.scoring import (CANDIDATE_TABLES,
                                                  build_queries, score_block)
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.obs import span
from openkeonspark_tpu_torch.runtime import check_supported


@torch.no_grad()
def _topk_entities(params: Dict[str, torch.Tensor], cfg: Config, n_ent: int,
                   h: int, t: int, r: int, replace: str,
                   k: int) -> Tuple[np.ndarray, np.ndarray]:
    with span("okst.topk.query"):
        dev = params["ent_embeddings"].device
        with span("okst.topk.build"):
            ids = lambda x: torch.tensor(  # noqa: E731
                [x], dtype=torch.long, device=dev)
            q = build_queries(params, ids(h), ids(t), ids(r), replace, cfg)
        block = cfg.eval_block
        with span("okst.topk.score"):
            scores = torch.cat([
                score_block(q, {name: params[name][c0:c0 + block]
                                for name in CANDIDATE_TABLES[cfg.model]},
                            replace, cfg)[0].float()
                for c0 in range(0, n_ent, block)])[:n_ent]
        with span("okst.topk.select"):
            best, idx = torch.sort(scores, stable=True)
            k = min(k, n_ent)
            top_ids, top_scores = idx[:k].to(torch.int32), best[:k]
        with span("okst.topk.fetch"):
            return top_ids.cpu().numpy(), top_scores.cpu().numpy()


def predict_tail_entity(params, cfg: Config, n_ent: int, n_rel: int,
                        h: int, r: int, k: int = 10
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k tails for (h, r, ?) → (ids [k], scores [k])."""
    return _topk_entities(params, cfg, n_ent, h, 0, r, "tail", k)


def predict_head_entity(params, cfg: Config, n_ent: int, n_rel: int,
                        t: int, r: int, k: int = 10
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k heads for (?, r, t)."""
    return _topk_entities(params, cfg, n_ent, 0, t, r, "head", k)


def predict_relation(params, cfg: Config, n_ent: int, n_rel: int,
                     h: int, t: int, k: int = 10
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k relations for (h, ?, t): every relation id scored directly."""
    check_supported(cfg)
    trip = np.stack([np.full(n_rel, h), np.full(n_rel, t),
                     np.arange(n_rel)], axis=1)
    scores = score_triples(params, cfg, n_ent, n_rel, trip)
    order = np.argsort(scores, kind="stable")[:min(k, n_rel)]
    return order.astype(np.int32), scores[order]


def predict_triple(params, cfg: Config, h: int, t: int, r: int,
                   thresholds: Optional[Thresholds] = None,
                   threshold: Optional[float] = None) -> Dict[str, object]:
    """Classify one triple (reference ``predict_triple(h, t, r, thresh)``):
    score < threshold ⇒ true. Give either fitted :class:`Thresholds` or an
    explicit scalar threshold. The scorer's entity and relation counts
    are read from the tables (:func:`_table_counts`); the score does not
    depend on them."""
    check_supported(cfg)
    n_ent, n_rel = _table_counts(params, cfg)
    score = float(score_triples(params, cfg, n_ent, n_rel,
                                np.array([[h, t, r]]))[0])
    if threshold is None:
        if thresholds is None:
            raise ValueError("need thresholds or an explicit threshold")
        threshold = float(np.where(thresholds.has_rel[r],
                                   thresholds.per_rel[r],
                                   thresholds.fallback))
    return {"score": score, "threshold": threshold,
            "is_true": bool(score < threshold)}


def _table_counts(params, cfg: Config) -> Tuple[int, int]:
    """(entities, relations) that ``params`` holds for ``cfg.model``: the
    fewest rows of each kind's tables, less the pad row every table has
    (there may be more pad rows; the model only needs one)."""
    specs = get_model(cfg.model).tables(cfg, 0, 0)
    rows = {"ent": [], "rel": []}
    for name, spec in specs.items():
        rows[spec.kind].append(params[name].shape[0] - 1)
    return min(rows["ent"]), min(rows["rel"])
