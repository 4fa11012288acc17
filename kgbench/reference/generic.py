"""Step groups of the generic training step, plainly: RotatE under the
self-adversarial loss and lazy Adam, and TransR with relation negatives
under SGD. The benchmark's copy of ``tests/plain_generic.py``: the same
equations, with the entity negatives drawn by :mod:`.sampler` and TransR's
projections made by :mod:`.train`'s relation-sorted product, so that each
``M_r`` is read once and the step fits beside nothing else on the card.

- Relation negatives: draw column ``1 + 2·negE + j`` of ``[B, 1 + 2·negE +
  negR]`` picks the ``x``-th relation, ``x = bits % (n_rel − |G|)``,
  outside ``G``, the relations of the train triples on the positive's
  (h, t); a pair that holds every relation gives ``x + (x ≥ r)``
  (``sampling/device.py`` documents the port's draw so).
- RotatE (Sun et al. 2019, arXiv:1902.10197): entity rows ``[re | im]`` of
  d complex lanes, relation rows d phases θ, ``d(h, r, t) = Σ_l
  |h_l·e^{iθ_l} − t_l|``, each modulus with ε = 1e-12 under its root.
- TransR (Lin et al. 2015): ``‖x_h·M_r + r − x_t·M_r‖₁``, each row with the
  matrix of its own relation, the corrupted one for a relation negative.
- Losses, summed over positives: ``self_adv`` ``−log σ(γ − d⁺) − Σ_j w_j
  log σ(d⁻_j − γ)``, ``w = softmax_j(γ − d⁻_j)`` held constant (the
  adversarial temperature 1); ``pairwise`` ``Σ_j max(γ + d⁺ − d⁻_j, 0)``.
- Gradients by autograd on the dense tables; SGD ``p −= α·g``; lazy Adam
  at the rows a step's ids touch (the dense gradient sums duplicates):
  ``m = β₁m + (1 − β₁)g``, ``v = β₂v + (1 − β₂)g²``, ``p += −lr_t·m/(√v +
  ε)``, ``lr_t = lr·√(1 − β₂ᵗ)/(1 − β₁ᵗ)`` at the global step t from 1, in
  float32; other rows keep p, m and v.

Float32 with TF32 off throughout."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from kgbench.reference import train as ref_train
from kgbench.reference.sampler import H, R, T, Groups, TrainSampler

EPS = 1e-12
ADV_TEMPERATURE = 1.0
FIELDS = ("h", "t", "r", "neg_h", "neg_t", "neg_rel")


@contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tables_spec(config: dict, n_ent: int, n_rel: int) -> Dict[str, tuple]:
    """(rows, width) of each table, a zero pad row not counted."""
    if config["model"] == "rotate":
        d = config["hidden_size"]
        return {"ent_embeddings": (n_ent, 2 * d), "rel_embeddings": (n_rel, d)}
    return ref_train.tables_spec(config, n_ent, n_rel)


def bits_cols(config: dict) -> int:
    return 1 + 2 * config["negative_ent"] + config.get("negative_rel", 0)


def draw_bits(gen: torch.Generator, steps: int, batch: int, config: dict,
              dev: torch.device) -> torch.Tensor:
    """A group's u32 draws, int64 ``[steps, batch, 1 + 2·negE + negR]``, in
    one ``torch.randint`` call, as the port's group runner draws them."""
    return torch.randint(0, 1 << 32, (steps, batch, bits_cols(config)),
                         generator=gen, device=dev, dtype=torch.int64)


class Sampler(TrainSampler):
    """:class:`TrainSampler` with the (h, t) → relations groups beside."""

    def __init__(self, train: np.ndarray, n_ent: int, n_rel: int):
        super().__init__(train, n_ent, n_rel)
        tr = self.train
        self.rels = Groups.of(tr[:, H] * n_ent + tr[:, T], tr[:, R], n_rel)

    def batch(self, bits: np.ndarray, negative_ent: int, negative_rel: int,
              bern: bool):
        """(h, t, r, neg_h, neg_t, neg_rel) int64 of the step whose draws
        are ``bits`` [B, 1 + 2·negE + negR]."""
        bits = bits.astype(np.int64)
        n_e = negative_ent
        h, t, r, neg_h, neg_t = super().batch(bits[:, :1 + 2 * n_e], n_e,
                                              bern)
        key = h * self.n_ent + t
        cnt = self.rels.size(key)
        full = cnt >= self.n_rel
        neg_rel = np.zeros((len(h), negative_rel), np.int64)
        for j in range(negative_rel):
            x = bits[:, 1 + 2 * n_e + j] % np.maximum(
                np.where(full, self.n_rel - 1, self.n_rel - cnt), 1)
            neg_rel[:, j] = np.where(full, x + (x >= r),
                                     self.rels.nth_outside(key, x))
        return h, t, r, neg_h, neg_t, neg_rel


def rotate_distance(h: torch.Tensor, theta: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    d = theta.shape[-1]
    z = (torch.complex(h[..., :d], h[..., d:]) * torch.polar(
        torch.ones_like(theta), theta) - torch.complex(t[..., :d], t[..., d:]))
    return torch.sqrt(z.real ** 2 + z.imag ** 2 + EPS).sum(-1)


def distances(config: dict, tabs: Dict[str, torch.Tensor], batch
              ) -> torch.Tensor:
    """``[1 + negE + negR, B]``: the positives, each entity negative, each
    relation negative."""
    h, t, r, neg_h, neg_t, neg_rel = batch
    E, Rt = tabs["ent_embeddings"], tabs["rel_embeddings"]
    n_r = neg_rel.shape[1]
    hs = torch.cat([h[None], neg_h.T, h[None].expand(n_r, -1)])
    ts = torch.cat([t[None], neg_t.T, t[None].expand(n_r, -1)])
    rs = torch.cat([r[None].expand(1 + neg_h.shape[1], -1), neg_rel.T])
    if config["model"] == "rotate":
        # one positive's rows at a time keep the complex intermediates to
        # [B, d] each
        return torch.stack([rotate_distance(E[hs[i]], Rt[rs[i]], E[ts[i]])
                            for i in range(len(hs))])
    if config["model"] == "transr":
        de, dr = config["ent_size"], config["rel_size"]
        M = tabs["transfer_matrix"].view(-1, de, dr)
        hf, tf, rf = hs.reshape(-1), ts.reshape(-1), rs.reshape(-1)
        n = len(hf)
        y = ref_train._project(torch.cat([E[hf], E[tf]]),
                               torch.cat([rf, rf]), M, "fp32")
        return (y[:n] + Rt[rf] - y[n:]).abs().sum(-1).view(hs.shape)
    raise ValueError(f"no reference for model {config['model']!r}")


def loss_of(config: dict, d: torch.Tensor) -> torch.Tensor:
    pos, neg = d[0], d[1:].T
    g = config["margin"]
    if config["loss_mode"] == "self_adv":
        w = torch.softmax(ADV_TEMPERATURE * (g - neg), 1).detach()
        return (-F.logsigmoid(g - pos)
                - (w * F.logsigmoid(neg - g)).sum(1)).sum()
    if config["loss_mode"] == "pairwise":
        return torch.clamp_min(g + pos[:, None] - neg, 0.0).sum()
    raise ValueError(f"no reference for loss_mode {config['loss_mode']!r}")


def touched(tabs: Dict[str, torch.Tensor], batch) -> Dict[str, torch.Tensor]:
    """Each table's rows the step's ids reach, ``[rows, 1]`` bool."""
    h, t, r, neg_h, neg_t, neg_rel = batch
    ent = torch.cat([h, t, neg_h.reshape(-1), neg_t.reshape(-1)])
    rel = torch.cat([r, neg_rel.reshape(-1)])
    out = {}
    for k, v in tabs.items():
        mask = torch.zeros(v.shape[0], 1, dtype=torch.bool, device=v.device)
        mask[ent if k == "ent_embeddings" else rel] = True
        out[k] = mask
    return out


def follow(config: dict, sampler: Sampler, p0: Dict[str, torch.Tensor],
           groups: List[torch.Tensor]) -> dict:
    """Run the configuration's optimizer from the tables ``p0`` (left
    unchanged) through the step groups whose u32 draws are ``groups``,
    a step on the batch its row of draws selects. Returns each step's
    ``step_loss`` and ``batch`` (numpy ids, :data:`FIELDS`), each group's
    mean ``loss`` and its tables after it (``tables``, float32 on the
    CPU), the first step's gradient (``g1``, by table on the CPU) and
    its norms (``grad``), the tables after it (``p1``), and the distinct
    entity and relation rows of each step (``rows``)."""
    dev = next(iter(p0.values())).device
    tabs = {k: v.detach().clone() for k, v in p0.items()}
    adam = config["opt_method"] == "adam"
    m = {k: torch.zeros_like(v) for k, v in tabs.items()} if adam else {}
    v2 = {k: torch.zeros_like(v) for k, v in tabs.items()} if adam else {}
    lr = config["alpha"]
    host = lambda d: {k: v.detach().to("cpu", torch.float32, copy=True)  # noqa: E731
                      for k, v in d.items()}
    out = {"loss": [], "tables": [], "step_loss": [], "batch": [], "rows": []}
    step = 0
    with no_tf32():
        for bits in groups:
            bits = bits.cpu().numpy()
            losses = []
            for s in range(len(bits)):
                ids = sampler.batch(bits[s], config["negative_ent"],
                                    config.get("negative_rel", 0),
                                    config["bern"])
                out["batch"].append(ids)
                out["rows"].append((
                    len(np.unique(np.concatenate(
                        [ids[0], ids[1], ids[3].ravel(), ids[4].ravel()]))),
                    len(np.unique(np.concatenate([ids[2],
                                                  ids[5].ravel()])))))
                b = [torch.from_numpy(a).to(dev) for a in ids]
                leaves = {k: v.requires_grad_() for k, v in tabs.items()}
                loss = loss_of(config, distances(config, leaves, b))
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
                losses.append(loss.detach().float())
                step += 1
                with torch.no_grad():
                    tabs = {k: v.detach() for k, v in leaves.items()}
                    if adam:
                        b1, b2 = config["adam_beta1"], config["adam_beta2"]
                        n = torch.tensor(step, dtype=torch.float32)
                        lr_t = float(lr * torch.sqrt(1.0 - b2 ** n)
                                     / (1.0 - b1 ** n))
                        for k, on in touched(tabs, b).items():
                            g = grads[k]
                            m[k] = torch.where(on, b1 * m[k] + (1 - b1) * g,
                                               m[k])
                            v2[k] = torch.where(
                                on, b2 * v2[k] + (1 - b2) * g * g, v2[k])
                            tabs[k] = tabs[k] + torch.where(
                                on, -lr_t * m[k] / (torch.sqrt(v2[k])
                                                    + config["adam_eps"]),
                                0.0)
                    else:
                        tabs = {k: v - lr * grads[k] for k, v in tabs.items()}
                if "grad" not in out:
                    out["grad"] = {k: float(g.double().norm())
                                   for k, g in grads.items()}
                    out["g1"] = host(grads)
                    out["p1"] = host(tabs)
                del grads, leaves, loss
            out["step_loss"] += [float(x) for x in losses]
            out["loss"].append(float(torch.stack(losses).mean()))
            out["tables"].append(host(tabs))
    return out
