"""Step groups of training, plainly: TransE and TransR under SGD.

Scores are distances, lower is better (Bordes et al. 2013; Lin et al.
2015): TransE ``‖h + r − t‖₁``, TransR ``‖h·M_r + r − t·M_r‖₁`` with
``M_r`` the ``[d_e, d_r]`` row ``r`` of ``transfer_matrix``. The loss is
one hinge per (positive, negative) pair, ``Σ max(γ + s⁺ − s⁻, 0)``
(OpenKE's ``MarginLoss`` over its pairs, summed rather than averaged: the
port's ``loss_mode`` ``"pairwise"``). Gradients come from autograd on the
dense tables, and SGD subtracts ``α·g``.

A group of ``S`` steps draws its u32 bits ``[S, B, 1 + 2·negE]`` in one
``torch.randint`` call from the group's generator, as the port's
``build_group_runner`` is documented to; step ``s`` takes the batch that
row ``s`` of them selects (:mod:`.sampler`). The reference draws them
itself from a generator seeded as the program's was.

``mode`` sets the precision: ``"fp32"`` (TF32 off: the configuration's
precision) or ``"tf32"`` (TransR's projections take their operands
rounded to TF32's 10-bit mantissa, as tensor cores read them, products
summed in fp32), which serves as TransR's control."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch

from kgbench.reference.sampler import TrainSampler


def tables_spec(config: dict, n_ent: int, n_rel: int) -> Dict[str, tuple]:
    """(rows, width) of each table the model keeps, a zero pad row not
    counted."""
    if config["model"] == "transe":
        d = config["hidden_size"]
        return {"ent_embeddings": (n_ent, d), "rel_embeddings": (n_rel, d)}
    if config["model"] == "transr":
        de, dr = config["ent_size"], config["rel_size"]
        return {"ent_embeddings": (n_ent, de), "rel_embeddings": (n_rel, dr),
                "transfer_matrix": (n_rel, de * dr)}
    raise ValueError(f"no reference for model {config['model']!r}")


def draw_bits(gen: torch.Generator, steps: int, batch: int,
              negative_ent: int, dev: torch.device) -> torch.Tensor:
    """A group's u32 draws, int64 ``[steps, batch, 1 + 2·negE]``."""
    return torch.randint(0, 1 << 32, (steps, batch, 1 + 2 * negative_ent),
                         generator=gen, device=dev, dtype=torch.int64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero), as a tensor core reads an fp32 operand."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Bmm(torch.autograd.Function):
    """``bmm`` whose three products (forward, dx, dM) read their operands
    rounded to TF32."""

    @staticmethod
    def forward(ctx, x, m):
        ctx.save_for_backward(x, m)
        return torch.bmm(tf32(x), tf32(m))

    @staticmethod
    def backward(ctx, gy):
        x, m = ctx.saved_tensors
        g = tf32(gy)
        return (torch.bmm(g, tf32(m).transpose(1, 2)),
                torch.bmm(tf32(x).transpose(1, 2), g))


@contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _project(x: torch.Tensor, rel: torch.Tensor, M: torch.Tensor,
             mode: str) -> torch.Tensor:
    """``x[i]·M_{rel[i]}``: the rows sorted by relation and padded into one
    ``[relations present, most rows of one, d_e]`` block, so that each
    ``M_r`` is read once and never copied per row."""
    order = torch.argsort(rel, stable=True)
    uniq, counts = torch.unique_consecutive(rel[order], return_counts=True)
    slot = torch.repeat_interleave(
        torch.arange(len(uniq), device=x.device), counts)
    pos = (torch.arange(len(rel), device=x.device)
           - (torch.cumsum(counts, 0) - counts)[slot])
    xp = x.new_zeros(len(uniq), int(counts.max()), x.shape[1])
    xp = xp.index_put((slot, pos), x[order])
    Mu = M[uniq]
    yp = _Tf32Bmm.apply(xp, Mu) if mode == "tf32" else torch.bmm(xp, Mu)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), device=x.device)
    return yp[slot, pos][inv]


def _scores(config: dict, tabs: Dict[str, torch.Tensor], h, t, r,
            mode: str) -> torch.Tensor:
    E, Rt = tabs["ent_embeddings"], tabs["rel_embeddings"]
    if config["model"] == "transe":
        return (E[h] + Rt[r] - E[t]).abs().sum(-1)
    de, dr = config["ent_size"], config["rel_size"]
    M = tabs["transfer_matrix"].view(-1, de, dr)
    y = _project(torch.cat([E[h], E[t]]), torch.cat([r, r]), M, mode)
    n = len(h)
    return (y[:n] + Rt[r] - y[n:]).abs().sum(-1)


def _loss(config: dict, tabs, batch, mode: str) -> torch.Tensor:
    h, t, r, neg_h, neg_t = batch
    B, K = neg_h.shape
    s = _scores(config, tabs, torch.cat([h, neg_h.T.reshape(-1)]),
                torch.cat([t, neg_t.T.reshape(-1)]), r.repeat(K + 1), mode)
    if config["loss_mode"] != "pairwise":
        raise ValueError(f"no reference for loss_mode {config['loss_mode']!r}")
    pos, neg = s[:B], s[B:].view(K, B).T                     # [B], [B, K]
    return torch.clamp_min(pos[:, None] - neg + config["margin"], 0.0).sum()


def follow(config: dict, sampler: TrainSampler, p0: Dict[str, torch.Tensor],
           groups: List[torch.Tensor], mode: str = "fp32") -> dict:
    """Run SGD from the tables ``p0`` (left unchanged) through the step
    groups whose u32 draws are ``groups`` (each ``[steps, B, 1 + 2·negE]``),
    a step on the batch its row of draws selects. Returns each step's
    ``step_loss`` and ``batch`` (numpy ids), each group's mean ``loss`` and
    its tables after it (``tables``, float32 on the CPU), the first step's
    gradient norm ``grad`` by table and the tables after it (``p1``), and
    the distinct entity and relation rows of each step (``rows``)."""
    dev = next(iter(p0.values())).device
    neg = config["negative_ent"]
    tabs = {k: v.detach().clone() for k, v in p0.items()}
    host = lambda d: {k: v.detach().to("cpu", torch.float32, copy=True)  # noqa: E731
                      for k, v in d.items()}
    out = {"loss": [], "tables": [], "step_loss": [], "batch": [], "rows": []}
    with no_tf32():
        for bits in groups:
            bits = bits.cpu().numpy()
            losses = []
            for s in range(len(bits)):
                ids = sampler.batch(bits[s], neg, config["bern"])
                out["batch"].append(ids)
                out["rows"].append((
                    len(np.unique(np.concatenate(
                        [ids[0], ids[1], ids[3].ravel(), ids[4].ravel()]))),
                    len(np.unique(ids[2]))))
                b = [torch.from_numpy(a).to(dev) for a in ids]
                leaves = {k: v.requires_grad_() for k, v in tabs.items()}
                loss = _loss(config, leaves, b, mode)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                losses.append(loss.detach().float())
                with torch.no_grad():
                    tabs = {k: (v - config["alpha"] * g).detach()
                            for (k, v), g in zip(leaves.items(), grads)}
                if "grad" not in out:
                    out["grad"] = {k: float(g.double().norm())
                                   for k, g in zip(leaves, grads)}
                    out["p1"] = host(tabs)
            out["step_loss"] += [float(x) for x in losses]
            out["loss"].append(float(torch.stack(losses).mean()))
            out["tables"].append(host(tabs))
    return out
