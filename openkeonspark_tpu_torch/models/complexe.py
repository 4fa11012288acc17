"""ComplEx: score(h, r, t) = −Re⟨e_h, v_r, conj(e_t)⟩ (lower = better).

Counterpart of ``openkeonspark_tpu/models/complexe.py:28-58``: entities
and relations are complex vectors stored as ``[*, 2d]`` tables, the first
d lanes real and the last d imaginary (``hidden_size`` is d). Expanded,

    Re⟨h, r, t̄⟩ = Σ (h_re·r_re·t_re + h_im·r_re·t_im
                    + h_re·r_im·t_im − h_im·r_im·t_re),

which is bilinear in the raw ``[2d]`` rows of either entity slot, so
evaluation is one ``[C, 2d] @ [2d, E]`` product per direction
(``eval/scoring.py::build_queries``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import (KGEModel, Slots, TableSpec,
                                                 register)


def _halves(x: torch.Tensor):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


@register
class ComplEx(KGEModel):
    name = "complex"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        d2 = 2 * cfg.hidden_size
        return {
            "ent_embeddings": TableSpec(n_ent, d2, "ent"),
            "rel_embeddings": TableSpec(n_rel, d2, "rel"),
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
        hr, hi = _halves(slots["h_e"])
        rr, ri = _halves(slots["r_e"])
        tr, ti = _halves(slots["t_e"])
        return -(hr * rr * tr + hi * rr * ti + hr * ri * ti
                 - hi * ri * tr).sum(-1)
