"""TransD: a per-pair mapping built from transfer vectors,
e' = e + (e·e_p)·r_p; score(h, r, t) = ‖h' + v_r − t'‖_p.

Counterpart of ``openkeonspark_tpu/models/transd.py:22-56``: tables
``ent_embeddings``, ``rel_embeddings``, ``ent_transfer`` and
``rel_transfer``, all d wide. The mapping matrix ``r_p e_pᵀ + I`` is never
built."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (KGEModel, Slots, TableSpec,
                                                 pnorm, register)


def _transfer(e: torch.Tensor, e_p: torch.Tensor,
              r_p: torch.Tensor) -> torch.Tensor:
    return e + (e * e_p).sum(-1, keepdim=True) * r_p


@register
class TransD(KGEModel):
    name = "transd"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        d = cfg.hidden_size
        return {
            "ent_embeddings": TableSpec(n_ent, d, "ent"),
            "rel_embeddings": TableSpec(n_rel, d, "rel"),
            "ent_transfer": TableSpec(n_ent, d, "ent"),
            "rel_transfer": TableSpec(n_rel, d, "rel"),
        }

    @staticmethod
    def gathers() -> Tuple:
        return (
            ("h_e", "ent_embeddings", "h"),
            ("t_e", "ent_embeddings", "t"),
            ("r_e", "rel_embeddings", "r"),
            ("h_p", "ent_transfer", "h"),
            ("t_p", "ent_transfer", "t"),
            ("r_p", "rel_transfer", "r"),
        )

    @staticmethod
    def score(slots: Slots, cfg: Config) -> torch.Tensor:
        r_p = slots["r_p"]
        h = _transfer(slots["h_e"], slots["h_p"], r_p)
        t = _transfer(slots["t_e"], slots["t_p"], r_p)
        return pnorm(h + slots["r_e"] - t, cfg.p_norm)
