"""Blocked candidate scoring: queries against a block of candidate
entities, for the top-k ``predict_*`` queries.

Counterpart of the TransE branches of ``openkeonspark_tpu/eval/scoring.py``
(``build_queries`` ``:66-69``, ``score_block`` ``:166-174``), in plain
PyTorch. For p=2 the residual is squared directly, Σ(q + s·e)², instead of
the reference's GEMM identity ‖q‖² + 2s·q·e + ‖e‖², which loses digits to
cancellation. Link prediction does not come through here: it counts ranks
with the fused kernel of ``ops/rank.py``."""

from __future__ import annotations

from typing import Dict

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import pnorm
from openkeonspark_tpu_torch.runtime import check_predict_supported


def build_queries(params: Dict[str, torch.Tensor], h: torch.Tensor,
                  t: torch.Tensor, r: torch.Tensor, replace: str,
                  cfg: Config) -> Dict[str, torch.Tensor]:
    check_predict_supported(cfg)
    E, R = params["ent_embeddings"], params["rel_embeddings"]
    if replace == "tail":
        return {"q": E[h] + R[r]}
    return {"q": R[r] - E[t]}


def score_block(q: Dict[str, torch.Tensor], cand: Dict[str, torch.Tensor],
                replace: str, cfg: Config) -> torch.Tensor:
    """[C, E_blk] scores of ``cand['ent_embeddings']`` [E_blk, d];
    ``replace`` fixes the residual's sign."""
    sign = -1.0 if replace == "tail" else 1.0
    ce = cand["ent_embeddings"]
    return pnorm(q["q"][:, None, :] + sign * ce[None, :, :], cfg.p_norm)


def candidate_scores(params: Dict[str, torch.Tensor], h: torch.Tensor,
                     t: torch.Tensor, r: torch.Tensor, cand0: int,
                     block: int, replace: str, cfg: Config) -> torch.Tensor:
    """Scores [C, ≤block] of the queries with the ``replace`` slot swept
    over entity rows [cand0, cand0 + block); the caller masks ids ≥ n_ent."""
    q = build_queries(params, h, t, r, replace, cfg)
    cand = {"ent_embeddings": params["ent_embeddings"][cand0:cand0 + block]}
    return score_block(q, cand, replace, cfg)
