"""DistMult: score(h, r, t) = −Σ_d e_h·v_r·e_t (lower = better).

Counterpart of ``openkeonspark_tpu/models/distmult.py:22-43``: tables
``ent_embeddings [nE, d]`` and ``rel_embeddings [nR, d]``; the bilinear
product is negated so that lower stays better, as for every model.
Evaluation reduces to one ``[C, d] @ [d, E]`` product per direction
(``eval/link_prediction.py``'s bilinear route)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import (KGEModel, Slots, TableSpec,
                                                 register)


@register
class DistMult(KGEModel):
    name = "distmult"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        d = cfg.hidden_size
        return {
            "ent_embeddings": TableSpec(n_ent, d, "ent"),
            "rel_embeddings": TableSpec(n_rel, d, "rel"),
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
        return -(slots["h_e"] * slots["r_e"] * slots["t_e"]).sum(-1)
