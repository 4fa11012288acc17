"""Relation-grouped projection for TransR training: the CUDA kernels'
wrappers, their plain PyTorch versions, and the autograd function that
ties forward and backward together.

Counterpart of ``openkeonspark_tpu/ops/pallas_grouped.py``
(``_grouped_project_fwd_impl`` ``:255``, ``_grouped_project_bwd_impl``
``:284``, the custom VJP ``:325-348``, ``grouped_project_ref`` ``:351``).
The kernel source is ``csrc/grouped_project.cu``. Rows arrive sorted by
relation, and :func:`run_offsets` gives each relation its run of rows
(the counterpart of ``plan_runs``), computed on the device with no host
sync. ``m3`` is the ``transfer_matrix`` table viewed as ``[rows, d_e,
d_r]``: no copy, no padding. The TPU kernel's 128-row blocks, its padding
of the inputs and of d_r to 128 lanes, and its aliased zeros operand are
grid artifacts of the TPU and have no counterpart here. Both kernels put
the relations on the grid and stream ``M_ρ`` once, as contiguous spans in
16-byte ``cp.async`` copies, into register-tiled products: the forward
over a grid of (relation, chunk of its run, column tile) with ``M_ρ``
passing through a ring of shared-memory stages, the backward over
(relation, row tile of ``M_ρ``) with dx and dM from one launch.

CUDA tensors go through the kernels (or raise); CPU tensors, or a caller
that asks for ``plain=True`` to hold the kernels against it, go through
the plain versions. The kernels sum in fp32 FMA in a fixed order; the
plain versions sum in float64 and round once, so they are the closer of
the two to the exact result, and the two agree to a tolerance
(``rtol = atol = 1e-5`` at the training slice's scales), not bit for bit.
Both give a dense ``dM`` whose rows of absent relations are exactly
zero."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openkeonspark_tpu_torch.ops.build import check_tensor as _check

# launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {"grouped_project_fwd": 0,
                            "grouped_project_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def run_offsets(rel_sorted: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32 ``[n_rows + 1]``: relation ρ owns rows ``[off[ρ], off[ρ+1])``
    of the ascending stream ``rel_sorted`` (ids in ``[0, n_rows)``)."""
    grid = torch.arange(n_rows + 1, device=rel_sorted.device,
                        dtype=rel_sorted.dtype)
    return torch.searchsorted(rel_sorted, grid, out_int32=True)


# --------------------------------------------------------------------------
# plain versions


def grouped_project_ref(m3: torch.Tensor, x: torch.Tensor,
                        rel: torch.Tensor) -> torch.Tensor:
    """``y[n] = x[n] @ m3[rel[n]]`` by gather + einsum (materializes
    ``m3[rel]``, ``[N, d_e, d_r]``), summed in float64."""
    return torch.einsum("ne,ner->nr", x.double(),
                        m3[rel].double()).to(x.dtype)


def grouped_project_bwd_ref(m3: torch.Tensor, x: torch.Tensor,
                            rel: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dM): ``dx[n] = g[n] @ m3[rel[n]]ᵀ`` and the dense
    ``dM[ρ] = Σ_{rel[n]=ρ} x[n]ᵀ g[n]`` by ``index_add_`` of outer
    products (absent relations stay exactly zero), summed in float64."""
    m, g64 = m3[rel].double(), g.double()
    dx = torch.einsum("nr,ner->ne", g64, m).to(x.dtype)
    dm = torch.zeros(m3.shape, dtype=torch.float64, device=m3.device)
    dm.index_add_(0, rel, torch.einsum("ne,nr->ner", x.double(), g64))
    return dx, dm.to(m3.dtype)


# --------------------------------------------------------------------------
# kernel wrappers


def _check_common(m3: torch.Tensor, x: torch.Tensor,
                  rel_off: torch.Tensor) -> Tuple[int, int, int, int]:
    if m3.dim() != 3 or x.dim() != 2 or x.shape[1] != m3.shape[1]:
        raise ValueError(f"m3 {tuple(m3.shape)} and x {tuple(x.shape)} must "
                         "be [rows, d_e, d_r] and [N, d_e]")
    rows, de, dr = m3.shape
    dev = m3.device
    if dev.type != "cuda":
        raise ValueError(f"the grouped-projection kernels take CUDA "
                         f"tensors, got {dev}")
    _check("m3", m3, torch.float32, (rows, de, dr), dev)
    _check("x", x, torch.float32, (x.shape[0], de), dev)
    _check("rel_off", rel_off, torch.int32, (rows + 1,), dev)
    return rows, de, dr, x.shape[0]


def grouped_project_fwd(m3: torch.Tensor, x: torch.Tensor,
                        rel_off: torch.Tensor) -> torch.Tensor:
    """Forward kernel: ``y`` ``[N, d_r]`` for rows sorted by relation with
    run offsets ``rel_off`` (:func:`run_offsets`). Rows outside every run
    (a relation id outside ``[0, rows)``) are not written."""
    rows, de, dr, n = _check_common(m3, x, rel_off)
    from openkeonspark_tpu_torch.ops.build import check_launch, library
    y = torch.empty(n, dr, dtype=torch.float32, device=m3.device)
    lib = library()
    with torch.cuda.device(m3.device):
        err = lib.okst_grouped_project_fwd(
            m3.data_ptr(), x.data_ptr(), rel_off.data_ptr(), y.data_ptr(),
            rows, de, dr, torch.cuda.current_stream(m3.device).cuda_stream)
    check_launch("okst_grouped_project_fwd", err)
    LAUNCHES["grouped_project_fwd"] += 1
    return y


def grouped_project_bwd(m3: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                        rel_off: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel, one launch for both products: (dx ``[N, d_e]``,
    dense dM ``[rows, d_e, d_r]``), every dM element written once, zero for
    an absent relation, each run summed in a fixed order (two launches give
    the same bits). Takes ``d_r`` up to 1,024."""
    rows, de, dr, n = _check_common(m3, x, rel_off)
    _check("g", g, torch.float32, (n, dr), m3.device)
    from openkeonspark_tpu_torch.ops.build import check_launch, library
    dx = torch.empty(n, de, dtype=torch.float32, device=m3.device)
    dm = torch.empty(rows, de, dr, dtype=torch.float32, device=m3.device)
    lib = library()
    with torch.cuda.device(m3.device):
        err = lib.okst_grouped_project_bwd(
            m3.data_ptr(), x.data_ptr(), g.data_ptr(), rel_off.data_ptr(),
            dx.data_ptr(), dm.data_ptr(), rows, de, dr,
            torch.cuda.current_stream(m3.device).cuda_stream)
    check_launch("okst_grouped_project_bwd", err)
    LAUNCHES["grouped_project_bwd"] += 1
    return dx, dm


class _GroupedProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m3, x, rel, rel_off, plain):
        ctx.save_for_backward(m3, x, rel, rel_off)
        ctx.plain = plain or x.device.type == "cpu"
        if ctx.plain:
            return grouped_project_ref(m3, x, rel)
        return grouped_project_fwd(m3, x, rel_off)

    @staticmethod
    def backward(ctx, gy):
        m3, x, rel, rel_off = ctx.saved_tensors
        g = gy.contiguous()
        if ctx.plain:
            dx, dm = grouped_project_bwd_ref(m3, x, rel, g)
        else:
            dx, dm = grouped_project_bwd(m3, x, g, rel_off)
        return dm, dx, None, None, None


def grouped_project(m3: torch.Tensor, x: torch.Tensor, rel: torch.Tensor,
                    rel_off: torch.Tensor, plain: bool = False
                    ) -> torch.Tensor:
    """``y[n] = x[n] @ m3[rel[n]]`` for ``rel`` sorted ascending, with
    ``rel_off = run_offsets(rel, m3.shape[0])``. Differentiable in ``m3``
    (a dense gradient, no scatter) and ``x``. CUDA tensors launch the
    kernels unless ``plain``; CPU tensors take the plain versions."""
    if rel.dim() != 1 or rel.shape[0] != x.shape[0]:
        raise ValueError(f"rel has shape {tuple(rel.shape)}, expected "
                         f"[{x.shape[0]}]")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return _GroupedProject.apply(m3, x, rel, rel_off, plain)
