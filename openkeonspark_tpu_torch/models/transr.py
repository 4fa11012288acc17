"""TransR: entities in R^{d_e}, relations in R^{d_r}, and a per-relation
projection ``M_r`` [d_e, d_r]; score(h, r, t) = ‖h·M_r + v_r − t·M_r‖_p.

Counterpart of ``openkeonspark_tpu/models/transr.py:22-64``: tables
``ent_embeddings [nE, d_e]``, ``rel_embeddings [nR, d_r]`` and
``transfer_matrix [nR, d_e·d_r]`` (row r is M_r, row-major). The training
step does not score through here: it projects relation-sorted rows with
the grouped kernels (``ops/grouped.py``); this scorer serves the generic
step, classification and the parity tests."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (KGEModel, Slots, TableSpec,
                                                 pnorm, register)


@register
class TransR(KGEModel):
    name = "transr"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        de, dr = cfg.d_ent, cfg.d_rel
        return {
            "ent_embeddings": TableSpec(n_ent, de, "ent"),
            "rel_embeddings": TableSpec(n_rel, dr, "rel"),
            "transfer_matrix": TableSpec(n_rel, de * dr, "rel"),
        }

    @staticmethod
    def gathers() -> Tuple:
        return (
            ("h_e", "ent_embeddings", "h"),
            ("t_e", "ent_embeddings", "t"),
            ("r_e", "rel_embeddings", "r"),
            ("m_r", "transfer_matrix", "r"),
        )

    @staticmethod
    def score(slots: Slots, cfg: Config) -> torch.Tensor:
        de, dr = cfg.d_ent, cfg.d_rel
        m = slots["m_r"].reshape(slots["m_r"].shape[:-1] + (de, dr))
        h_e, t_e = slots["h_e"], slots["t_e"]
        if m.dim() == h_e.dim() + 1 and m.shape[0] == 1 and h_e.shape[0] != 1:
            # untiled [1, B, d_e·d_r] slot (every segment shares r):
            # contract each segment against the one matrix per column
            # instead of broadcasting the matrices S times
            h = torch.einsum("sbe,ber->sbr", h_e, m[0])
            t = torch.einsum("sbe,ber->sbr", t_e, m[0])
        else:
            h = torch.einsum("...e,...er->...r", h_e, m)
            t = torch.einsum("...e,...er->...r", t_e, m)
        return pnorm(h + slots["r_e"] - t, cfg.p_norm)
