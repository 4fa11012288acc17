"""Ad-hoc top-k prediction — the reference's "serving" path.

Counterpart of ``openkeonspark_tpu/eval/predict.py``: every candidate
entity is scored with the blocked scorer of ``eval/scoring.py`` and the k
best (lowest score) are taken with ``torch.topk`` over the scores of ids
< n_ent."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.eval.classification import (Thresholds,
                                                         score_triples)
from openkeonspark_tpu_torch.eval.scoring import candidate_scores
from openkeonspark_tpu_torch.runtime import check_predict_supported


@torch.no_grad()
def _topk_entities(params: Dict[str, torch.Tensor], cfg: Config, n_ent: int,
                   h: int, t: int, r: int, replace: str,
                   k: int) -> Tuple[np.ndarray, np.ndarray]:
    dev = params["ent_embeddings"].device
    ids = lambda x: torch.tensor([x], dtype=torch.long, device=dev)  # noqa: E731
    block = cfg.eval_block
    scores = torch.cat([
        candidate_scores(params, ids(h), ids(t), ids(r), c0, block, replace,
                         cfg)[0]
        for c0 in range(0, n_ent, block)])[:n_ent]
    best, idx = torch.topk(scores, min(k, n_ent), largest=False)
    return idx.to(torch.int32).cpu().numpy(), best.cpu().numpy()


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
    check_predict_supported(cfg)
    trip = np.stack([np.full(n_rel, h), np.full(n_rel, t),
                     np.arange(n_rel)], axis=1)
    scores = score_triples(params, cfg, n_ent, n_rel, trip)
    order = np.argsort(scores, kind="stable")[:min(k, n_rel)]
    return order.astype(np.int32), scores[order]


def predict_triple(params, cfg: Config, n_ent: int, n_rel: int, h: int,
                   t: int, r: int, thresholds: Optional[Thresholds] = None,
                   threshold: Optional[float] = None) -> Dict[str, object]:
    """Classify one triple: score < threshold ⇒ true. Give either fitted
    :class:`Thresholds` or an explicit scalar threshold."""
    check_predict_supported(cfg)
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
