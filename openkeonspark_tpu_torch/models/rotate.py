"""RotatE: relations rotate entities in the complex plane;
score(h, r, t) = Σ_l |h_l·e^{iθ_l} − t_l| (lower = better).

Counterpart of ``openkeonspark_tpu/models/rotate.py:36-78``: entities are
``[*, 2d]`` rows (first d lanes real, last d imaginary), relations are
phase vectors ``θ [*, d]``, so the relation table is d wide. Each complex
lane's modulus takes ε = 1e-12 inside its sqrt, which keeps the gradient
finite at a zero residual."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (KGEModel, Slots, TableSpec,
                                                 register)

EPS = 1e-12


def _halves(x: torch.Tensor):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def rotate_residual(h_e: torch.Tensor, theta: torch.Tensor,
                    t_e: torch.Tensor):
    """(re, im) of ``rot(h, θ) − t``, broadcasting."""
    hr, hi = _halves(h_e)
    tr, ti = _halves(t_e)
    cos, sin = torch.cos(theta), torch.sin(theta)
    return hr * cos - hi * sin - tr, hr * sin + hi * cos - ti


def modulus_sum(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(re * re + im * im + EPS).sum(-1)


@register
class RotatE(KGEModel):
    name = "rotate"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        return {
            "ent_embeddings": TableSpec(n_ent, 2 * cfg.hidden_size, "ent"),
            "rel_embeddings": TableSpec(n_rel, cfg.hidden_size, "rel"),
        }

    @staticmethod
    def gathers() -> Tuple:
        return (
            ("h_e", "ent_embeddings", "h"),
            ("t_e", "ent_embeddings", "t"),
            ("r_e", "rel_embeddings", "r"),
        )

    @staticmethod
    def score(slots: Slots, cfg: Config) -> torch.Tensor:
        re, im = rotate_residual(slots["h_e"], slots["r_e"], slots["t_e"])
        return modulus_sum(re, im)
