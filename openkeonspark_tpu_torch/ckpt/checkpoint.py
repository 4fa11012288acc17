"""Parameter export / import and the port's own checkpoints.

Counterpart of ``openkeonspark_tpu/ckpt/checkpoint.py``:
``embedding.vec.json`` and ``embedding.npz`` are written and read exactly
as the reference writes them, so exports pass between the two packages.
Training checkpoints (:class:`CheckpointManager`) are numbered ``step_N/``
directories, as in the reference, each holding a torch state dict of the
tables (in their dtype, bf16 included), the optimizer state and the global
step (``state.pt``) and a JSON manifest. Exports are float32 whatever the
tables' dtype, as the reference's are. The incremental mode's warm start
(:func:`warm_start_path`, :func:`warm_start_from`) carries one batch
folder's checkpoint into the next batch's possibly larger state. The reference's orbax ``step_N``
checkpoints need jax to read and are refused; the port evaluates from an
export (``cli.train`` writes one every run) or from its own
``torch.save`` file (:func:`save_params`). On a grid, rank 0 writes what
a single-device run writes (:class:`CheckpointManager`), with its own
replica of each ``#hot`` companion of hot-row replication
(``parallel/hot.py``). Export and the readers take the model's tables
only, never a companion."""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import (Params, padded_rows,
                                                 strip_padding)
from openkeonspark_tpu_torch.parallel.mesh import HOT_SUFFIX

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
    """The tables of a ``.pt`` file as float32 numpy (bf16 exactly)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in state.items()}


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


def _table_tensor(arr) -> torch.Tensor:
    """A numpy table as a CPU tensor: bf16 for a bf16 array (the JAX
    package's ``ml_dtypes.bfloat16``, recognised by its dtype name and
    itemsize and read through its uint16 bits, so ``ml_dtypes`` is not
    imported), float32 for anything else."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(np.asarray(arr, np.float32))


def params_from_numpy(np_params: Dict[str, np.ndarray], model, cfg: Config,
                      n_ent: int, n_rel: int,
                      device: torch.device) -> Params:
    """Carry tables across from numpy (an export, the reference package's
    params, or a ``.pt``): with or without pad rows in, exactly one zero
    pad row out, on ``device``; bf16 tables stay bf16, any other table is
    float32.

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
        t = _table_tensor(np_params[name])
        if t.dim() != 2 or t.shape[1] != spec.dim:
            raise ValueError(f"table {name!r} has shape {tuple(t.shape)}, "
                             f"the model needs width {spec.dim}")
        if t.shape[0] < spec.rows or bool((t[spec.rows:] != 0).any()):
            raise ValueError(
                f"checkpoint table {name!r} holds {t.shape[0]} rows but "
                f"the dataset has {spec.rows} — a vocabulary mismatch, "
                "not padding")
        pad = torch.zeros(padded_rows(spec.rows) - spec.rows, spec.dim,
                          dtype=t.dtype)
        out[name] = torch.cat([t[:spec.rows], pad]).to(device)
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
    ``keep`` (the reference's Saver kept 5).

    With ``sharding`` (``parallel.mesh.Sharding``, the state's row layout
    on a grid) :meth:`save` is a collective: every rank calls it, rank 0
    gathers the global tables, pad rows included, and writes the files a
    single-device run writes. A grid restores with :meth:`restore` into a
    full template and then keeps its rows (``parallel.shard_state``), so
    either kind of run resumes from the other's checkpoint."""

    def __init__(self, directory: str, keep: int = 5, sharding=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.sharding = sharding
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, state, extra: Optional[dict] = None) -> None:
        """Save the train state (tables, optimizer state, step) and a JSON
        manifest holding ``extra``."""
        if self.sharding is not None:
            from openkeonspark_tpu_torch.parallel.mesh import unshard_state
            state = unshard_state(state, self.sharding)
            if self.sharding.grid.rank != 0:
                return
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

        def fit(stored, tree):
            # a checkpoint written without hot rows lacks the #hot
            # companions: they restore as zeros and sync_hot_cache fills
            # them (the JAX restore raises a KeyError,
            # ckpt/checkpoint.py:125-131)
            return {k: (torch.zeros_like(v) if k.endswith(HOT_SUFFIX)
                        and k not in stored
                        else _fit_rows(k, stored[k], v, logical_rows))
                    for k, v in tree.items()}

        params = fit(raw["params"], state.params)
        opt_state = {s: fit(raw["opt_state"][s], slots)
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


def warm_start_path(out_path: str, batch_number: Optional[int]
                    ) -> Optional[str]:
    """Incremental mode: training on batch folder *n* warm-starts from
    batch *n − 1*'s output directory when it holds a checkpoint (the
    reference's ``ckpt/checkpoint.py:170-176``)."""
    if batch_number is None or batch_number <= 0:
        return None
    prev = os.path.join(out_path, str(batch_number - 1))
    return prev if latest_step(prev) is not None else None


def checkpoint_vocabulary(raw: dict, manifest: dict, model, cfg: Config
                          ) -> Tuple[int, int]:
    """(n_ent, n_rel) of a stored checkpoint: the manifest's, which
    ``cli.train`` and the training loop write into every checkpoint, else
    the stored tables' rows less the one pad row the port appends (a
    manifest written before the loop recorded them)."""
    if "n_ent" in manifest and "n_rel" in manifest:
        return int(manifest["n_ent"]), int(manifest["n_rel"])
    rows = {"ent": [], "rel": []}
    for name, spec in model.tables(cfg, 0, 0).items():
        if name not in raw["params"]:
            raise ValueError(f"checkpoint lacks table {name!r} for model "
                             f"{model.name!r}")
        rows[spec.kind].append(raw["params"][name].shape[0] - 1)
    return min(rows["ent"]), min(rows["rel"])


def warm_start_from(new_state, ckpt_dir: str, model, cfg: Config):
    """Incremental-mode warm start (the reference's
    ``ckpt/checkpoint.py:179-216``): the previous batch's latest
    checkpoint copied into ``new_state``, a fresh state for this batch's
    vocabulary, which may be larger. Only the old *logical* rows are
    copied, so new entities and relations keep their fresh init; the
    optimizer slots are carried the same way, and the global step is the
    checkpoint's. Returns (state, the checkpoint's manifest)."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    state_file = os.path.join(path, STATE_NAME)
    if not os.path.exists(state_file):
        raise ValueError(f"{path} holds no {STATE_NAME}: not a checkpoint "
                         "of the port")
    raw = torch.load(state_file, map_location="cpu", weights_only=True)
    manifest = {}
    mpath = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    old_n_ent, old_n_rel = checkpoint_vocabulary(raw, manifest, model, cfg)
    specs = model.tables(cfg, old_n_ent, old_n_rel)

    def copy_rows(new_tree, old_tree):
        out = dict(new_tree)
        for name, spec in specs.items():
            if name in new_tree and name in old_tree:
                new, old = new_tree[name], old_tree[name]
                if old.shape[0] < spec.rows or old.shape[1:] != new.shape[1:]:
                    raise ValueError(
                        f"checkpoint table {name!r} has shape "
                        f"{tuple(old.shape)}, expected {spec.rows} logical "
                        f"rows of width {tuple(new.shape[1:])}")
                n = min(spec.rows, new.shape[0])
                out[name] = new.clone()
                out[name][:n] = old[:n].to(new.device, new.dtype)
        return out

    params = copy_rows(new_state.params, raw["params"])
    opt_state = {s: copy_rows(slots, raw["opt_state"].get(s, {}))
                 for s, slots in new_state.opt_state.items()}
    return (type(new_state)(params=params, opt_state=opt_state,
                            step=int(raw["step"])), manifest)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return [int(m.group(1)) for m in map(_STEP_DIR.match,
                                          os.listdir(directory)) if m]


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None
