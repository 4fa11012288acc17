"""Blocked candidate scoring: queries against a block of candidate
entities, for the top-k ``predict_*`` queries.

Counterpart of ``openkeonspark_tpu/eval/scoring.py`` (``build_queries``
``:55-149``, ``score_block`` ``:156-209``) for TransE, TransH, TransD and
RotatE, in plain PyTorch; the reference has no Pallas kernel here. For p=2
the residual is squared directly, Σ(q + s·e)², instead of the reference's
GEMM identity ‖q‖² + 2s·q·e + ‖e‖², which loses digits to cancellation.
Link prediction does not come through here: it counts ranks with the
fused kernels of ``ops/rank.py``."""

from __future__ import annotations

from typing import Dict

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import pnorm
from openkeonspark_tpu_torch.models.rotate import modulus_sum
from openkeonspark_tpu_torch.ops import rank as rank_ops
from openkeonspark_tpu_torch.runtime import check_predict_supported

# tables whose rows form the candidate axis, per model
CANDIDATE_TABLES = {
    "transe": ("ent_embeddings",),
    "transh": ("ent_embeddings",),
    "transd": ("ent_embeddings", "ent_transfer"),
    "rotate": ("ent_embeddings",),
}


def build_queries(params: Dict[str, torch.Tensor], h: torch.Tensor,
                  t: torch.Tensor, r: torch.Tensor, replace: str,
                  cfg: Config) -> Dict[str, torch.Tensor]:
    """Per-query tensors: ``q`` so that the candidate residual is
    ``q + sign·(projected candidate)``, plus ``w`` (TransH) or ``rp``
    (TransD). RotatE's head queries are −rot(t, −θ) (``ops/rank.py``)."""
    check_predict_supported(cfg)
    if cfg.model == "transh":
        q, w, _ = rank_ops.transh_queries(params, h, t, r, replace)
        return {"q": q, "w": w}
    if cfg.model == "transd":
        q, rp, _ = rank_ops.transd_queries(params, h, t, r, replace)
        return {"q": q, "rp": rp}
    build = (rank_ops.rotate_queries if cfg.model == "rotate"
             else rank_ops.transe_queries)
    return {"q": build(params, h, t, r, replace)[0]}


def score_block(q: Dict[str, torch.Tensor], cand: Dict[str, torch.Tensor],
                replace: str, cfg: Config) -> torch.Tensor:
    """[C, E_blk] scores of ``cand['ent_embeddings']`` [E_blk, d] (and
    ``cand['ent_transfer']`` for TransD); ``replace`` fixes the residual's
    sign."""
    sign = -1.0 if replace == "tail" else 1.0
    ce = cand["ent_embeddings"][None, :, :]              # [1, E, d]
    if cfg.model == "rotate":
        res = q["q"][:, None, :] + sign * ce
        d = res.shape[-1] // 2
        return modulus_sum(res[..., :d], res[..., d:])
    if cfg.model == "transh":
        w = q["w"][:, None, :]
        ce = ce - (ce * w).sum(-1, keepdim=True) * w     # [C, E, d]
    elif cfg.model == "transd":
        cdot = (cand["ent_embeddings"] * cand["ent_transfer"]).sum(-1)
        ce = ce + cdot[None, :, None] * q["rp"][:, None, :]
    return pnorm(q["q"][:, None, :] + sign * ce, cfg.p_norm)


def candidate_scores(params: Dict[str, torch.Tensor], h: torch.Tensor,
                     t: torch.Tensor, r: torch.Tensor, cand0: int,
                     block: int, replace: str, cfg: Config) -> torch.Tensor:
    """Scores [C, ≤block] of the queries with the ``replace`` slot swept
    over entity rows [cand0, cand0 + block); the caller masks ids ≥ n_ent."""
    q = build_queries(params, h, t, r, replace, cfg)
    cand = {name: params[name][cand0:cand0 + block]
            for name in CANDIDATE_TABLES[cfg.model]}
    return score_block(q, cand, replace, cfg)
