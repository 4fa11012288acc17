"""Model contract: the table layout and the triple scorer.

Counterpart of ``openkeonspark_tpu/models/base.py``. Every table is
``[rows + pad, dim]`` with at least one zero padding row appended, as in
the reference, so that parameter dicts pass between the two packages
unchanged. A :class:`KGEModel` is an ``nn.Module`` that holds those tables
and scores id triples (lower = better)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.runtime import check_model_ported

Params = Dict[str, torch.Tensor]
Slots = Dict[str, torch.Tensor]
Gather = Tuple[str, str, str]  # (slot, table, anchor)


@dataclass(frozen=True)
class TableSpec:
    rows: int          # logical rows (entities or relations), pad excluded
    dim: int
    kind: str          # "ent" | "rel"


def xavier_uniform(gen: torch.Generator, rows: int, dim: int) -> torch.Tensor:
    """TF ``xavier_initializer(uniform=True)`` on a [rows, dim] table
    (fan_in=rows, fan_out=dim), drawn from ``gen`` (a CPU generator, so one
    seed gives the same tables whatever device they end up on)."""
    limit = math.sqrt(6.0 / (rows + dim))
    out = torch.empty(rows, dim, dtype=torch.float32)
    return out.uniform_(-limit, limit, generator=gen)


def padded_rows(rows: int, multiple: int = 1) -> int:
    """Physical row count: logical rows + ≥1 pad row, rounded up."""
    total = rows + 1
    return ((total + multiple - 1) // multiple) * multiple


def init_tables(gen: torch.Generator, specs: Dict[str, TableSpec],
                device: torch.device, pad_to_multiple: int = 1) -> Params:
    """Xavier-initialised tables with zero padding rows appended, in sorted
    table-name order (the reference's order of key splits)."""
    params: Params = {}
    for name in sorted(specs):
        spec = specs[name]
        body = xavier_uniform(gen, spec.rows, spec.dim)
        pad = torch.zeros(padded_rows(spec.rows, pad_to_multiple) - spec.rows,
                          spec.dim)
        params[name] = torch.cat([body, pad]).to(device)
    return params


def strip_padding(params: Params, specs: Dict[str, TableSpec]
                  ) -> Dict[str, np.ndarray]:
    """Drop padding rows, as numpy on the host (export and tests)."""
    return {name: params[name][: specs[name].rows].detach().cpu().numpy()
            for name in specs}


def pnorm(x: torch.Tensor, p: int, dim: int = -1) -> torch.Tensor:
    """Reference score reduction: p=1 → Σ|x|; p=2 → Σx² (squared L2)."""
    if p == 1:
        return x.abs().sum(dim)
    return (x * x).sum(dim)


class KGEModel(nn.Module):
    """Holds a model's tables and scores triples. Subclasses set ``name``
    and implement :meth:`tables`, :meth:`gathers` and :meth:`score`, which
    is static (slots and config in, scores out) as in the JAX package, so
    the training step scores gathered rows without a module instance."""

    name: str = ""

    def __init__(self, cfg: Config, n_ent: int, n_rel: int, params: Params):
        super().__init__()
        self.cfg = cfg
        self.n_ent, self.n_rel = n_ent, n_rel
        specs = self.tables(cfg, n_ent, n_rel)
        if set(params) != set(specs):
            raise ValueError(f"{self.name}: tables {sorted(params)} != "
                             f"{sorted(specs)}")
        for k, spec in specs.items():
            t = params[k]
            if t.dim() != 2 or t.shape[1] != spec.dim \
                    or t.shape[0] <= spec.rows:
                raise ValueError(
                    f"{self.name}: table {k!r} has shape {tuple(t.shape)}, "
                    f"needs [>{spec.rows}, {spec.dim}] (rows + pad row)")
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in params.items()})

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        raise NotImplementedError

    @staticmethod
    def gathers() -> Tuple[Gather, ...]:
        raise NotImplementedError

    @staticmethod
    def score(slots: Slots, cfg: Config) -> torch.Tensor:
        raise NotImplementedError

    def gather_slots(self, h: torch.Tensor, t: torch.Tensor,
                     r: torch.Tensor) -> Slots:
        ids = {"h": h, "t": t, "r": r}
        return {slot: self.params[table][ids[anchor]]
                for slot, table, anchor in self.gathers()}

    def score_triples(self, h: torch.Tensor, t: torch.Tensor,
                      r: torch.Tensor) -> torch.Tensor:
        """predict_def parity: score arbitrary id triples (lower=better)."""
        return self.score(self.gather_slots(h, t, r), self.cfg)


_REGISTRY: Dict[str, type] = {}


def register(model_cls: type) -> type:
    _REGISTRY[model_cls.name] = model_cls
    return model_cls


def get_model(name: str) -> type:
    from openkeonspark_tpu_torch.models import (rotate, transd,  # noqa: F401
                                                transe, transh, transr)
    check_model_ported(name)
    return _REGISTRY[name]
