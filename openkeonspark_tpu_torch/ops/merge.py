"""Merge of an entity table's slot gradients into its update rows: the CUDA
kernel's wrapper and its plain PyTorch version.

A training step gathers an entity table twice a slot column, through an
h-anchored and a t-anchored slot, and gets one gradient stream for each,
``[(1 + nE + nR)·B, d]``: the positives, then segment k of each entity
negative, then the relation negatives. An entity-corrupted negative keeps
its uncorrupted side equal to the positive's id (``neg_h[:, k] != h`` marks
head corruption), and a relation negative reuses both entities, so the
merge folds those rows into the positives' and leaves ``B·(nE + 2)`` update
rows: for each entity negative its corrupted id and row, then ``h`` with
``base_h`` and ``t`` with ``base_t``. Counterpart of the entity branch of
``openkeonspark_tpu/train/step.py::merged_row_updates``, which XLA fuses.

The kernel (``csrc/merge_rows.cu``) makes that in one pass, where the plain
version takes about seven small kernels a negative. Both return the
table's update as one ``(ids [(nE + 2)·B], grads [(nE + 2)·B, d])``
stream, the optimizers' format (``train/optim.py``): the kernel writes its
two buffers in the plain version's order, summed in the same order, so the
two agree bit for bit in fp32 and bf16. CUDA tensors go through the kernel
(or raise); CPU tensors, and a batch without negatives, whose stream is the
slot gradients' positive blocks joined once, go through the plain
version."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# launches of the kernel since the last reset_launch_counts(); the wrapper
# adds one where it launches the kernel and nowhere else
LAUNCHES: Dict[str, int] = {"merge_entity_rows": 0,
                            "merge_entity_rows_bf16": 0}
# gradient dtype -> (launcher, launch counter)
_LAUNCHERS = {
    torch.float32: ("okst_merge_entity_rows", "merge_entity_rows"),
    torch.bfloat16: ("okst_merge_entity_rows_bf16", "merge_entity_rows_bf16"),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def merge_entity_rows_ref(h: torch.Tensor, t: torch.Tensor,
                          neg_h: Optional[torch.Tensor],
                          neg_t: Optional[torch.Tensor], gh: torch.Tensor,
                          gt: torch.Tensor, n_rel_neg: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the corrupted ids and rows of negative k for each k <
    nE, then ``h`` with ``base_h`` and ``t`` with ``base_t``, each base
    summed negative by negative, joined into one stream."""
    B = h.shape[0]
    nE = 0 if neg_h is None else neg_h.shape[1]

    def seg(g, i):  # negative segment i of a slot's gradient stream
        return g[B * (1 + i):B * (2 + i)]

    base_h, base_t = gh[:B], gt[:B]
    ids, rows = [], []
    for k in range(nE):
        ch = (neg_h[:, k] != h)[:, None]
        sh, st = seg(gh, k), seg(gt, k)
        base_h = base_h + torch.where(ch, 0.0, sh)
        base_t = base_t + torch.where(ch, st, 0.0)
        ids.append(torch.where(ch[:, 0], neg_h[:, k], neg_t[:, k]))
        rows.append(torch.where(ch, sh, st))
    for k in range(nE, nE + n_rel_neg):      # relation negatives reuse h, t
        base_h = base_h + seg(gh, k)
        base_t = base_t + seg(gt, k)
    return torch.cat(ids + [h, t]), torch.cat(rows + [base_h, base_t])


def _ids_check(name: str, x: torch.Tensor, shape: tuple, dev) -> None:
    if x.device != dev or x.dtype != torch.int64 or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be int64 {shape} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def merge_entity_rows(h: torch.Tensor, t: torch.Tensor,
                      neg_h: Optional[torch.Tensor],
                      neg_t: Optional[torch.Tensor], gh: torch.Tensor,
                      gt: torch.Tensor, n_rel_neg: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table's update stream, as :func:`merge_entity_rows_ref` gives
    it. ``h``, ``t`` ``[B]`` and ``neg_h``, ``neg_t`` ``[B, nE]``
    int64, any strides; ``gh``, ``gt`` ``[(1 + nE + n_rel_neg)·B, d]``
    f32 or bf16, any row stride. CUDA tensors launch the kernel of the
    gradients' dtype, CPU tensors take the plain version."""
    B = h.shape[0]
    nE = 0 if neg_h is None else neg_h.shape[1]
    dev = gh.device
    if dev.type == "cpu" or nE + n_rel_neg == 0:
        return merge_entity_rows_ref(h, t, neg_h, neg_t, gh, gt, n_rel_neg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if gh.dtype not in _LAUNCHERS:
        raise TypeError(f"gradients must be float32 or bfloat16, got "
                        f"{gh.dtype}")
    if gh.dim() != 2 or gh.shape[0] != (1 + nE + n_rel_neg) * B:
        raise ValueError(f"gh {tuple(gh.shape)} must be [(1 + {nE} + "
                         f"{n_rel_neg})·{B}, d]")
    if gt.shape != gh.shape or gt.dtype != gh.dtype or gt.device != dev:
        raise ValueError(f"gt {gt.dtype} {tuple(gt.shape)} on {gt.device} "
                         f"must match gh {gh.dtype} {tuple(gh.shape)} on "
                         f"{dev}")
    for name, x, shape in (("h", h, (B,)), ("t", t, (B,)),
                           ("neg_h", neg_h, (B, nE)),
                           ("neg_t", neg_t, (B, nE))):
        if x is not None:
            _ids_check(name, x, shape, dev)
    if nE == 0:          # the kernel reads no negative id: any pointer does
        neg_h = neg_t = h.new_empty((B, 0))
    # the kernel takes row strides; columns must be adjacent
    gh, gt = (g if g.stride(1) == 1 else g.contiguous() for g in (gh, gt))
    d = gh.shape[1]
    ids = torch.empty((nE + 2) * B, dtype=torch.int64, device=dev)
    grads = torch.empty(((nE + 2) * B, d), dtype=gh.dtype, device=dev)
    if B and d:
        from openkeonspark_tpu_torch.ops.build import check_launch, library
        symbol, counter = _LAUNCHERS[gh.dtype]
        with torch.cuda.device(dev):
            err = getattr(library(), symbol)(
                h.data_ptr(), h.stride(0), t.data_ptr(), t.stride(0),
                neg_h.data_ptr(), *neg_h.stride(), neg_t.data_ptr(),
                *neg_t.stride(), gh.data_ptr(), gh.stride(0), gt.data_ptr(),
                gt.stride(0), ids.data_ptr(), grads.data_ptr(), B, nE,
                n_rel_neg, d, torch.cuda.current_stream(dev).cuda_stream)
        check_launch(symbol, err)
        LAUNCHES[counter] += 1
    return ids, grads
