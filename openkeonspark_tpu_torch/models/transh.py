"""TransH: entities are projected onto the relation's hyperplane before the
translation; score(h, r, t) = ‖h⊥ + v_r − t⊥‖_p with e⊥ = e − (ŵ_r·e)ŵ_r.

Counterpart of ``openkeonspark_tpu/models/transh.py:27-64``: tables
``ent_embeddings [nE, d]``, ``rel_embeddings [nR, d]`` and
``normal_vectors [nR, d]``. The normal is unit-normalised where it is used
(:func:`unit`); the stored table stays raw, so checkpoints carry over."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (KGEModel, Slots, TableSpec,
                                                 pnorm, register)


def unit(w: torch.Tensor) -> torch.Tensor:
    """ŵ = w·rsqrt(Σw² + 1e-12) over the last axis."""
    return w * torch.rsqrt((w * w).sum(-1, keepdim=True) + 1e-12)


def _project(e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return e - (e * w).sum(-1, keepdim=True) * w


@register
class TransH(KGEModel):
    name = "transh"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        d = cfg.hidden_size
        return {
            "ent_embeddings": TableSpec(n_ent, d, "ent"),
            "rel_embeddings": TableSpec(n_rel, d, "rel"),
            "normal_vectors": TableSpec(n_rel, d, "rel"),
        }

    @staticmethod
    def gathers() -> Tuple:
        return (
            ("h_e", "ent_embeddings", "h"),
            ("t_e", "ent_embeddings", "t"),
            ("r_e", "rel_embeddings", "r"),
            ("w_r", "normal_vectors", "r"),
        )

    @staticmethod
    def score(slots: Slots, cfg: Config) -> torch.Tensor:
        w = unit(slots["w_r"])
        h = _project(slots["h_e"], w)
        t = _project(slots["t_e"], w)
        return pnorm(h + slots["r_e"] - t, cfg.p_norm)
