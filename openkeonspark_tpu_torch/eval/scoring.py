"""Blocked candidate scoring: queries against a block of candidate
entities, for the top-k ``predict_*`` queries and the bilinear models'
link prediction.

Counterpart of ``openkeonspark_tpu/eval/scoring.py`` (``build_queries``
``:55-149``, ``score_block`` ``:156-209``) for all seven models, in plain
PyTorch; the reference has no Pallas kernel here. For p=2 the residual is
squared directly, Σ(q + s·e)², instead of the reference's GEMM identity
‖q‖² + 2s·q·e + ‖e‖², which loses digits to cancellation. TransR projects
the candidate rows with one matrix product per query (``E_blk @ M_ρ``)
where the reference contracts an ``einsum``: the same products, summed in
another order. DistMult and ComplEx score a block as ``−(q @ E_blkᵀ)``,
the bilinear form's one product. Every product runs in full fp32
(``runtime.full_fp32_matmul``), as the reference asks for
``Precision.HIGHEST``: with TF32 multiplies near-ties flip ranks.

Queries and candidate scores are computed in ``cfg.eval_dtype``, as the
reference's are (``scoring.py:63, 161, 223``): the tables are cast to it,
and a matrix product takes the rounded operands as fp32 products summed in
fp32 (:func:`eval_dot`, the reference's ``preferred_element_type=f32``),
cast back to the eval dtype where the reference casts. Link prediction's
kernel routes do not come through here: they count ranks with the fused
kernels of ``ops/rank.py``, in fp32. Its generic route
(``eval/link_prediction.py::_rank_chunk``) does."""

from __future__ import annotations

from typing import Dict

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import pnorm
from openkeonspark_tpu_torch.models.rotate import modulus_sum
from openkeonspark_tpu_torch.ops import rank as rank_ops
from openkeonspark_tpu_torch.runtime import (check_supported,
                                             full_fp32_matmul, torch_dtype)

# tables whose rows form the candidate axis, per model
CANDIDATE_TABLES = {
    "transe": ("ent_embeddings",),
    "transh": ("ent_embeddings",),
    "transr": ("ent_embeddings",),
    "transd": ("ent_embeddings", "ent_transfer"),
    "distmult": ("ent_embeddings",),
    "complex": ("ent_embeddings",),
    "rotate": ("ent_embeddings",),
}
# the models whose score is bilinear in the swept entity row: a block's
# scores are one matrix product −(q @ E_blkᵀ)
BILINEAR = ("distmult", "complex")


def eval_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as fp32 products of the operands' values summed in fp32
    (exact products of bf16 operands; no TF32): the reference's
    ``jnp.dot(..., preferred_element_type=jnp.float32)``. A product of
    two bf16 tensors would round its result to bf16."""
    with full_fp32_matmul():
        return torch.matmul(a.float(), b.float())


def build_queries(params: Dict[str, torch.Tensor], h: torch.Tensor,
                  t: torch.Tensor, r: torch.Tensor, replace: str,
                  cfg: Config) -> Dict[str, torch.Tensor]:
    """Per-query tensors: ``q`` so that the candidate residual is
    ``q + sign·(projected candidate)``, plus ``w`` (TransH), ``rp``
    (TransD) or ``m`` (TransR's ``[C, d_e, d_r]`` matrices). RotatE's head
    queries are −rot(t, −θ) (``ops/rank.py``). For DistMult and ComplEx
    ``q`` is the vector whose dot with a candidate row is the bilinear
    form: ``e_anchor ⊙ r``, and for ComplEx ``[hr·rr − hi·ri, hi·rr +
    hr·ri]`` (tail) or ``[rr·tr + ri·ti, rr·ti − ri·tr]`` (head), the
    reference's ``scoring.py:90-112``."""
    check_supported(cfg)
    dt = torch_dtype(cfg.eval_dtype)
    params = {k: v.to(dt) for k, v in params.items()}
    E, R = params["ent_embeddings"], params["rel_embeddings"]
    if cfg.model == "transr":
        m = params["transfer_matrix"][r].view(-1, cfg.d_ent, cfg.d_rel)
        anchor = E[h] if replace == "tail" else E[t]
        pa = eval_dot(anchor[:, None, :], m)[:, 0].to(dt)
        q = pa + R[r] if replace == "tail" else R[r] - pa
        return {"q": q, "m": m}
    if cfg.model == "distmult":
        return {"q": (E[h] if replace == "tail" else E[t]) * R[r]}
    if cfg.model == "complex":
        d = E.shape[1] // 2
        rr, ri = R[r][:, :d], R[r][:, d:]
        if replace == "tail":
            hr, hi = E[h][:, :d], E[h][:, d:]
            return {"q": torch.cat([hr * rr - hi * ri, hi * rr + hr * ri],
                                   1)}
        tr, ti = E[t][:, :d], E[t][:, d:]
        return {"q": torch.cat([rr * tr + ri * ti, rr * ti - ri * tr], 1)}
    if cfg.model == "transh":
        q, w, _ = rank_ops.transh_queries(params, h, t, r, replace)
        return {"q": q, "w": w}
    if cfg.model == "transd":
        q, rp, _ = rank_ops.transd_queries(params, h, t, r, replace)
        return {"q": q, "rp": rp}
    build = (rank_ops.rotate_queries if cfg.model == "rotate"
             else rank_ops.transe_queries)
    return {"q": build(params, h, t, r, replace)[0]}


def score_block(q: Dict[str, torch.Tensor], cand: Dict[str, torch.Tensor],
                replace: str, cfg: Config) -> torch.Tensor:
    """[C, E_blk] scores of ``cand['ent_embeddings']`` [E_blk, d] (and
    ``cand['ent_transfer']`` for TransD); ``replace`` fixes the residual's
    sign. Scores are in ``cfg.eval_dtype``."""
    dt = torch_dtype(cfg.eval_dtype)
    cand = {k: v.to(dt) for k, v in cand.items()}
    if cfg.model in BILINEAR:
        return -eval_dot(q["q"], cand["ent_embeddings"].T).to(dt)
    sign = -1.0 if replace == "tail" else 1.0
    if cfg.model == "transr":
        pce = eval_dot(cand["ent_embeddings"], q["m"]).to(dt)   # [C, E, dr]
        return pnorm(q["q"][:, None, :] + sign * pce, cfg.p_norm)
    ce = cand["ent_embeddings"][None, :, :]              # [1, E, d]
    if cfg.model == "rotate":
        res = q["q"][:, None, :] + sign * ce
        d = res.shape[-1] // 2
        return modulus_sum(res[..., :d], res[..., d:])
    if cfg.model == "transh":
        w = q["w"][:, None, :]
        ce = ce - (ce * w).sum(-1, keepdim=True) * w     # [C, E, d]
    elif cfg.model == "transd":
        cdot = (cand["ent_embeddings"] * cand["ent_transfer"]).sum(-1)
        ce = ce + cdot[None, :, None] * q["rp"][:, None, :]
    return pnorm(q["q"][:, None, :] + sign * ce, cfg.p_norm)

