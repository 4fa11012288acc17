"""Device and evaluation-size resolution for the port.

The device is resolved once, at the entry point, and passed down
explicitly. Nothing falls back to the CPU silently: asking for ``cuda``
on a machine without a usable card raises."""

from __future__ import annotations

import contextlib

import torch

from openkeonspark_tpu.config import Config

# test triples ranked per query chunk. The reference's Config.eval_chunk_size
# is not called: it imports jax and caps chunks for the TPU's VMEM.
DEFAULT_EVAL_CHUNK = 256

# the models the port evaluates and trains: get_model, check_supported and
# check_train_supported refuse any other, naming these
PORTED_MODELS = ("transe", "transh", "transr", "transd", "rotate")
# the top-k predict_* queries: TransR's candidate scorer is not ported
PREDICT_MODELS = ("transe", "transh", "transd", "rotate")


class NotPortedError(NotImplementedError):
    """An option the port does not cover yet (see ROADMAP.md queue A)."""


def resolve_device(name: str = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} was asked for but torch.cuda.is_available() "
            "is False; pass --device cpu to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def eval_chunk_size(cfg: Config) -> int:
    return cfg.eval_chunk if cfg.eval_chunk is not None else DEFAULT_EVAL_CHUNK


def check_model_ported(name: str) -> None:
    if name not in PORTED_MODELS:
        raise NotPortedError(
            f"model {name!r} is not yet ported to openkeonspark_tpu_torch "
            f"(only {', '.join(PORTED_MODELS)}); see ROADMAP.md queue A")


def check_supported(cfg: Config) -> None:
    """Refuse the options the evaluation slice does not cover, instead of
    ignoring them."""
    check_model_ported(cfg.model)
    if cfg.mesh_shape[0] * cfg.mesh_shape[1] > 1 or cfg.num_processes > 1:
        raise NotPortedError(
            f"multi-device evaluation (mesh {cfg.mesh_shape}, "
            f"{cfg.num_processes} processes) is not yet ported; "
            "see ROADMAP.md queue A")
    if cfg.type_constrain:
        raise NotPortedError(
            "type-constrained link prediction is not yet ported; "
            "see ROADMAP.md queue A")
    if cfg.eval_dtype != "float32":
        raise NotPortedError(
            f"eval_dtype {cfg.eval_dtype!r} is not yet ported (the port "
            "scores in float32); see ROADMAP.md queue A")


def check_predict_supported(cfg: Config) -> None:
    """The top-k ``predict_*`` queries cover :data:`PREDICT_MODELS`."""
    check_supported(cfg)
    if cfg.model not in PREDICT_MODELS:
        raise NotPortedError(
            f"predict_* for model {cfg.model!r} is not yet ported (only "
            f"{', '.join(PREDICT_MODELS)}); see ROADMAP.md queue A")


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 matrix products on the card in full fp32 (no TF32), whatever
    the process-wide setting; restores it on exit."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
