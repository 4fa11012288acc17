"""Device and evaluation-size resolution for the port.

The device is resolved once, at the entry point, and passed down
explicitly. Nothing falls back to the CPU silently: asking for ``cuda``
on a machine without a usable card raises."""

from __future__ import annotations

import contextlib

import torch

from openkeonspark_tpu_torch.config import Config

# test triples ranked per query chunk. The reference's Config.eval_chunk_size
# is not called: it imports jax and caps chunks for the TPU's VMEM.
DEFAULT_EVAL_CHUNK = 256

# table and scoring dtypes the port takes (Config.dtype, Config.eval_dtype)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the models the port evaluates, trains and answers predict_* queries for
# (all seven of the JAX package): get_model, check_supported and
# check_train_supported refuse any other, naming these
PORTED_MODELS = ("transe", "transh", "transr", "transd", "distmult",
                 "complex", "rotate")


class NotPortedError(NotImplementedError):
    """An option the port refuses; its message names the reason."""


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
            f"model {name!r} is not one of the models ported to "
            f"openkeonspark_tpu_torch ({', '.join(PORTED_MODELS)}), the "
            "models of the JAX package; configurations still to run are "
            "ROADMAP.md queue W")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``Config.dtype`` / ``Config.eval_dtype`` name;
    the port takes float32 and bfloat16."""
    if name not in DTYPES:
        raise NotPortedError(
            f"dtype {name!r} is not ported (the port's tables and kernels "
            f"take {', '.join(DTYPES)}); configurations still to run are "
            "ROADMAP.md queue W")
    return DTYPES[name]


def check_supported(cfg: Config) -> None:
    """Refuse the options the evaluation slice does not cover, instead of
    ignoring them."""
    check_model_ported(cfg.model)
    torch_dtype(cfg.eval_dtype)


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
