"""RotatE's training slots scored and differentiated straight from their
ids: the CUDA kernel pair's wrappers and their plain PyTorch version.

A RotatE training step scores, for each of its ``B`` positives, the
positive and its ``nE`` entity negatives (``1 + nE`` slots), and needs
only three things from them: the scores ``[1 + nE, B]``, the entity
table's merged update stream (``ops/merge.py``'s layout: for each negative
its corrupted ids and rows, then ``h`` with ``base_h`` and ``t`` with
``base_t``) and the gradient of the positives' phases ``[B, d]``. The
plain version gathers every slot row, runs ``models/rotate.py`` under
autograd and merges the slot gradients (``merge_entity_rows_ref``), which
at the RotatE cell's shape writes and reads back several GB a step. The
kernels (``csrc/rotate_slots.cu``; no TPU kernel: the JAX package leaves
the step to XLA's fusion) read the rows by id: :func:`rotate_slot_scores`
writes the scores, :func:`rotate_slot_grads` the update rows and the
phase gradient, given the loss's gradient with respect to the scores.

:func:`prepare` checks a batch's tables and ids and, on the card,
allocates the kernels' outputs: one id buffer ``[(nE + 2)·B]`` and one
row buffer ``[(nE + 2)·B, 2d]`` (the update stream, as
``merge_entity_rows`` returns it), the phase gradient and the scores.
CUDA tensors launch the kernels (or raise), CPU tensors take the plain
version. Given the same gradient of the scores, the two give the same
update rows bit for bit; the scores and the phase gradient differ by the
order of fp32 sums (over the lanes, and over the slots), as
``csrc/rotate_slots.cu`` says."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from openkeonspark_tpu_torch.models.rotate import (modulus_sum,
                                                   rotate_residual)
from openkeonspark_tpu_torch.ops.merge import merge_entity_rows_ref

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {"rotate_slot_scores": 0, "rotate_slot_grads": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class RotateSlots(NamedTuple):
    """A batch's tables, ids and (on the card) the kernels' outputs."""
    E: torch.Tensor          # [rows, 2d] fp32 entity rows [re | im]
    theta: torch.Tensor      # [rows, d] fp32 phases
    h: torch.Tensor          # [B] int64
    t: torch.Tensor
    r: torch.Tensor
    neg_h: torch.Tensor      # [B, nE] int64 (nE may be 0)
    neg_t: torch.Tensor
    scores: Optional[torch.Tensor] = None     # [1 + nE, B]
    ids: Optional[torch.Tensor] = None        # [(nE + 2)·B]
    rows: Optional[torch.Tensor] = None       # [(nE + 2)·B, 2d]
    g_theta: Optional[torch.Tensor] = None    # [B, d]


def _check(name: str, x: torch.Tensor, dtype, shape: tuple, dev) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def prepare(E: torch.Tensor, theta: torch.Tensor, h: torch.Tensor,
            t: torch.Tensor, r: torch.Tensor, neg_h: Optional[torch.Tensor],
            neg_t: Optional[torch.Tensor]) -> RotateSlots:
    """The batch checked (fp32 tables on one device, ``E`` twice as wide
    as ``theta``, int64 ids of any strides; ``neg_h``, ``neg_t`` None for
    a batch without negatives) and, for CUDA tensors, the kernels' output
    buffers."""
    dev = E.device
    if E.dim() != 2 or theta.dim() != 2:
        raise ValueError("E and theta must be 2-D tables")
    d = theta.shape[1]
    rows_e, rows_t = E.shape[0], theta.shape[0]
    _check("E", E, torch.float32, (rows_e, 2 * d), dev)
    _check("theta", theta, torch.float32, (rows_t, d), dev)
    B = h.shape[0]
    if neg_h is None:
        neg_h = neg_t = h.new_empty((B, 0))
    nE = neg_h.shape[1]
    for name, x, shape in (("h", h, (B,)), ("t", t, (B,)), ("r", r, (B,)),
                           ("neg_h", neg_h, (B, nE)),
                           ("neg_t", neg_t, (B, nE))):
        _check(name, x, torch.int64, shape, dev)
    s = RotateSlots(E, theta, h, t, r, neg_h, neg_t)
    if dev.type != "cuda":
        return s
    return s._replace(
        scores=torch.empty((1 + nE, B), dtype=torch.float32, device=dev),
        ids=torch.empty((nE + 2) * B, dtype=torch.int64, device=dev),
        rows=torch.empty(((nE + 2) * B, 2 * d), dtype=torch.float32,
                         device=dev),
        g_theta=torch.empty((B, d), dtype=torch.float32, device=dev))


def _slot_rows(s: RotateSlots):
    """The gathered slots: head and tail rows ``[1 + nE, B, 2d]`` and the
    phases ``[1, B, d]``, the generic step's layout (slot 0 the
    positives, slot 1 + k negative k)."""
    h_ids = torch.cat([s.h[None], s.neg_h.T])
    t_ids = torch.cat([s.t[None], s.neg_t.T])
    return s.E[h_ids], s.E[t_ids], s.theta[s.r][None]


def rotate_slot_scores_ref(s: RotateSlots) -> torch.Tensor:
    """Plain version: the slots' scores ``[1 + nE, B]``
    (``models/rotate.py`` on the gathered rows)."""
    hs, ts, th = _slot_rows(s)
    return modulus_sum(*rotate_residual(hs, th, ts))


def rotate_slot_grads_ref(s: RotateSlots, g_scores: torch.Tensor
                          ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                     torch.Tensor]:
    """Plain version: (the entity table's update stream ``(ids, rows)``,
    the phase gradient ``[B, d]``) of the loss whose gradient with respect to
    the scores is ``g_scores`` ``[1 + nE, B]``: autograd through
    ``models/rotate.py`` on the gathered rows, then
    ``merge_entity_rows_ref``."""
    hs, ts, th = (x.requires_grad_() for x in _slot_rows(s))
    with torch.enable_grad():
        scores = modulus_sum(*rotate_residual(hs, th, ts))
        gh, gt, gth = torch.autograd.grad(scores, [hs, ts, th], g_scores)
    w = s.E.shape[1]
    return (merge_entity_rows_ref(s.h, s.t, s.neg_h, s.neg_t, gh.view(-1, w),
                                  gt.view(-1, w), 0), gth[0])


def _launch(symbol: str, s: RotateSlots, *tail) -> None:
    from openkeonspark_tpu_torch.ops.build import check_launch, library
    E, th = s.E, s.theta
    # the kernels take row strides; columns must be adjacent
    E, th = (x if x.stride(1) == 1 else x.contiguous() for x in (E, th))
    B, nE = s.neg_h.shape
    with torch.cuda.device(E.device):
        err = getattr(library(), symbol)(
            E.data_ptr(), E.stride(0), th.data_ptr(), th.stride(0),
            s.h.data_ptr(), s.h.stride(0), s.t.data_ptr(), s.t.stride(0),
            s.r.data_ptr(), s.r.stride(0), s.neg_h.data_ptr(),
            *s.neg_h.stride(), s.neg_t.data_ptr(), *s.neg_t.stride(), *tail,
            B, nE, th.shape[1],
            torch.cuda.current_stream(E.device).cuda_stream)
    check_launch(symbol, err)
    LAUNCHES[symbol[len("okst_"):]] += 1


def _device(s: RotateSlots) -> str:
    kind = s.E.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {s.E.device}")
    return kind


def rotate_slot_scores(s: RotateSlots) -> torch.Tensor:
    """The slots' scores ``[1 + nE, B]``: the forward kernel into
    ``s.scores`` for CUDA tensors, the plain version for CPU tensors."""
    if _device(s) == "cpu":
        return rotate_slot_scores_ref(s)
    if s.h.shape[0]:
        _launch("okst_rotate_slot_scores", s, s.scores.data_ptr())
    return s.scores


def rotate_slot_grads(s: RotateSlots, g_scores: torch.Tensor
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                 torch.Tensor]:
    """(update stream, phase gradient) as :func:`rotate_slot_grads_ref`
    gives them: the backward kernel into ``s.ids``, ``s.rows`` and
    ``s.g_theta`` for CUDA tensors, the plain version for CPU tensors."""
    if _device(s) == "cpu":
        return rotate_slot_grads_ref(s, g_scores)
    B, nE = s.neg_h.shape
    _check("g_scores", g_scores, torch.float32, (1 + nE, B), s.E.device)
    g_scores = g_scores.contiguous()
    if B:
        _launch("okst_rotate_slot_grads", s, g_scores.data_ptr(),
                s.ids.data_ptr(), s.rows.data_ptr(), s.g_theta.data_ptr())
    return (s.ids, s.rows), s.g_theta
