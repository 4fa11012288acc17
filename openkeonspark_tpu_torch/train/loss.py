"""Ranking losses.

Counterpart of ``openkeonspark_tpu/train/loss.py:32-48``. Scores are
distances (lower = better), so positives enter with +:

- ``mean_neg``: one hinge per positive against its mean negative score,
  ``Σ_i max(γ + s⁺_i − mean_j s⁻_ij, 0)`` (the reference's ``loss_def``);
- ``pairwise``: ``Σ_ij max(γ + s⁺_i − s⁻_ij, 0)``;
- ``self_adv``: the self-adversarial loss of the RotatE paper,
  ``−log σ(γ − s⁺) − Σ_j w_j log σ(s⁻_j − γ)`` with
  ``w = softmax(α(γ − s⁻))`` held constant (``.detach()``, the JAX
  package's stop-gradient), α = 1."""

from __future__ import annotations

import torch
import torch.nn.functional as F

SELF_ADV_ALPHA = 1.0


def margin_ranking_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                        margin: float, mode: str = "mean_neg") -> torch.Tensor:
    """pos_scores [B], neg_scores [B, N] → scalar loss."""
    if mode == "mean_neg":
        neg = neg_scores.mean(dim=1)
        return torch.clamp_min(pos_scores - neg + margin, 0.0).sum()
    if mode == "pairwise":
        return torch.clamp_min(pos_scores[:, None] - neg_scores + margin,
                               0.0).sum()
    if mode == "self_adv":
        w = torch.softmax(SELF_ADV_ALPHA * (margin - neg_scores),
                          dim=1).detach()
        pos_term = F.softplus(pos_scores - margin)          # −logσ(γ−s⁺)
        neg_term = (w * F.softplus(margin - neg_scores)).sum(dim=1)
        return (pos_term + neg_term).sum()
    raise ValueError(f"unknown loss mode {mode!r}")
