"""Parameter export / import and the port's own checkpoints.

Counterpart of ``openkeonspark_tpu/ckpt/checkpoint.py``:
``embedding.vec.json`` and ``embedding.npz`` are written and read exactly
as the reference writes them, so exports pass between the two packages.
Training checkpoints (:class:`CheckpointManager`) are numbered ``step_N/``
directories, as in the reference, each holding a torch state dict of the
tables, the optimizer state and the global step (``state.pt``) and a JSON
manifest. The reference's orbax ``step_N`` checkpoints need jax to read
and are refused; the port evaluates from an export (``cli.train`` writes
one every run) or from its own ``torch.save`` file (:func:`save_params`)."""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu_torch.models.base import (Params, padded_rows,
                                                 strip_padding)

# checkpoint-directory files the evaluator looks for, in order
EXPORT_NAMES = ("embedding.npz", "embedding.vec.json", "params.pt")
_STEP_DIR = re.compile(r"^step_(\d+)$")
STATE_NAME = "state.pt"
MANIFEST_NAME = "manifest.json"


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


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _fit_rows(name: str, stored: torch.Tensor, like: torch.Tensor,
              logical_rows: Optional[Dict[str, int]]) -> torch.Tensor:
    """``stored`` in the template's row layout: tables and optimizer slots
    written with another pad layout share their logical rows as a prefix,
    so they are prefix-copied; extra pad rows keep the template's values
    (zero in a table, the optimizer's initial value in a slot, such as
    Adagrad's accumulator). Fewer stored rows than the template's logical
    rows is a vocabulary mismatch and raises."""
    if tuple(stored.shape) == tuple(like.shape):
        return stored.to(like.device, like.dtype)
    if stored.dim() != like.dim() or stored.shape[1:] != like.shape[1:]:
        raise ValueError(f"checkpoint table {name!r} has shape "
                         f"{tuple(stored.shape)}, the template "
                         f"{tuple(like.shape)}")
    need = (logical_rows or {}).get(name)
    if need is not None and stored.shape[0] < need:
        raise ValueError(
            f"checkpoint table {name!r} holds {stored.shape[0]} rows but "
            f"the template needs {need} logical rows — a vocabulary "
            "mismatch, not padding")
    n = min(stored.shape[0], like.shape[0])
    out = like.clone()
    out[:n] = stored[:n].to(like.device, like.dtype)
    return out


class CheckpointManager:
    """Numbered ``step_N/`` checkpoints under a directory, keeping the last
    ``keep`` (the reference's Saver kept 5)."""

    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, state, extra: Optional[dict] = None) -> None:
        """Save the train state (tables, optimizer state, step) and a JSON
        manifest holding ``extra``."""
        path = self._path(int(step))
        os.makedirs(path, exist_ok=True)
        tree = {"params": _to_cpu(state.params),
                "opt_state": _to_cpu(state.opt_state),
                "step": int(state.step)}
        tmp = os.path.join(path, STATE_NAME + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(path, STATE_NAME))
        with open(os.path.join(path, MANIFEST_NAME), "w") as f:
            json.dump({"step": int(step), **(extra or {})}, f)
        self._gc()

    def restore(self, state, step: Optional[int] = None,
                logical_rows: Optional[Dict[str, int]] = None):
        """Restore into the template ``state`` (its tables give the device
        and row layout); returns (state, manifest). ``logical_rows``
        (table → logical row count) guards the pad-layout prefix copy
        against a vocabulary mismatch."""
        if step is None:
            step = latest_step(self.directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._path(step)
        state_file = os.path.join(path, STATE_NAME)
        if not os.path.exists(state_file):
            raise ValueError(
                f"{path} holds no {STATE_NAME}: not a checkpoint of the port "
                "(the JAX package's orbax step_N checkpoints need jax; "
                "evaluate from its embedding export instead)")
        raw = torch.load(state_file, map_location="cpu", weights_only=True)
        params = {k: _fit_rows(k, raw["params"][k], v, logical_rows)
                  for k, v in state.params.items()}
        opt_state = {s: {k: _fit_rows(k, raw["opt_state"][s][k], v,
                                      logical_rows)
                         for k, v in slots.items()}
                     for s, slots in state.opt_state.items()}
        manifest = {}
        mpath = os.path.join(path, MANIFEST_NAME)
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        return (type(state)(params=params, opt_state=opt_state,
                            step=int(raw["step"])), manifest)

    def _gc(self) -> None:
        steps = sorted(all_steps(self.directory))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return [int(m.group(1)) for m in map(_STEP_DIR.match,
                                          os.listdir(directory)) if m]


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None
