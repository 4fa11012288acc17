"""Parameter export / import and the port's own checkpoints.

Counterpart of the export half of ``openkeonspark_tpu/ckpt/checkpoint.py``:
``embedding.vec.json`` and ``embedding.npz`` are written and read exactly
as the reference writes them, so exports pass between the two packages.
The reference's orbax ``step_N`` checkpoints need jax to read; the port
evaluates from an export instead (``cli.train`` writes one every run) or
from its own ``torch.save`` file (:func:`save_params`)."""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (Params, padded_rows,
                                                 strip_padding)

# checkpoint-directory files the evaluator looks for, in order
EXPORT_NAMES = ("embedding.npz", "embedding.vec.json", "params.pt")


def export_parameters(params: Params, model, cfg: Config, n_ent: int,
                      n_rel: int, path: str, fmt: str = "json") -> None:
    """Export stripped tables: ``fmt='json'`` writes the reference's
    ``embedding.vec.json`` layout ({table_name: [[row floats] …]}),
    ``fmt='npz'`` compressed numpy."""
    tables = strip_padding(params, model.tables(cfg, n_ent, n_rel))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if fmt == "json":
        with open(path, "w") as f:
            json.dump({k: np.asarray(v, np.float32).tolist()
                       for k, v in tables.items()}, f)
    elif fmt == "npz":
        np.savez_compressed(path, **{k: np.asarray(v, np.float32)
                                     for k, v in tables.items()})
    else:
        raise ValueError(f"unknown export format {fmt!r}")


def import_parameters(path: str) -> Dict[str, np.ndarray]:
    """Load an export back (either format): table name → [rows, dim]."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    with open(path) as f:
        return {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}


def save_params(params: Params, path: str) -> None:
    """The port's own checkpoint: the padded tables as a state dict."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_params(path: str) -> Dict[str, np.ndarray]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in state.items()}


def read_parameters(checkpoint: str) -> Tuple[Dict[str, np.ndarray], str]:
    """Tables from a checkpoint file (``.npz``, ``.json``, ``.pt``) or from
    the first of :data:`EXPORT_NAMES` in a directory; returns (tables,
    the file read)."""
    path = checkpoint
    if os.path.isdir(checkpoint):
        found = [os.path.join(checkpoint, n) for n in EXPORT_NAMES
                 if os.path.exists(os.path.join(checkpoint, n))]
        if not found:
            raise FileNotFoundError(
                f"no {' / '.join(EXPORT_NAMES)} in {checkpoint}: the port "
                "reads exports, not orbax step_N checkpoints (those need "
                "jax); cli.train writes embedding.vec.json (or .npz with "
                "--export_format npz) beside them")
        path = found[0]
    if path.endswith(".pt"):
        return load_params(path), path
    return import_parameters(path), path


def params_from_numpy(np_params: Dict[str, np.ndarray], model, cfg: Config,
                      n_ent: int, n_rel: int,
                      device: torch.device) -> Params:
    """Carry tables across from numpy (an export, the reference package's
    params, or a ``.pt``): with or without pad rows in, exactly one zero
    pad row out, float32 on ``device``.

    A table with fewer logical rows than the dataset's vocabulary, or with
    non-zero rows past it, belongs to another vocabulary and is refused
    (the reference refuses the same at ``ckpt/checkpoint.py:109-115``)."""
    specs = model.tables(cfg, n_ent, n_rel)
    missing = sorted(set(specs) - set(np_params))
    if missing:
        raise ValueError(f"checkpoint lacks tables {missing} for "
                         f"model {model.name!r}")
    out: Params = {}
    for name, spec in specs.items():
        arr = np.asarray(np_params[name], np.float32)
        if arr.ndim != 2 or arr.shape[1] != spec.dim:
            raise ValueError(f"table {name!r} has shape {arr.shape}, the "
                             f"model needs width {spec.dim}")
        if arr.shape[0] < spec.rows or np.any(arr[spec.rows:]):
            raise ValueError(
                f"checkpoint table {name!r} holds {arr.shape[0]} rows but "
                f"the dataset has {spec.rows} — a vocabulary mismatch, "
                "not padding")
        body = torch.tensor(arr[:spec.rows])
        pad = torch.zeros(padded_rows(spec.rows) - spec.rows, spec.dim)
        out[name] = torch.cat([body, pad]).to(device)
    return out
