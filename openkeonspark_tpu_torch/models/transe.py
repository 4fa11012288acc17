"""TransE: score(h, r, t) = ‖e_h + v_r − e_t‖_p (lower = better).

Counterpart of ``openkeonspark_tpu/models/transe.py``: tables
``ent_embeddings [nE, d]`` and ``rel_embeddings [nR, d]``; the score is
the p-norm (p=1: Σ|·|, p=2: Σ·²) of the translation residual."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (KGEModel, Slots, TableSpec,
                                                 pnorm, register)


@register
class TransE(KGEModel):
    name = "transe"

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
        return pnorm(slots["h_e"] + slots["r_e"] - slots["t_e"], cfg.p_norm)
