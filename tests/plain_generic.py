"""Plain reference of the generic training step, for the test suite:
RotatE under the self-adversarial loss and lazy Adam, and TransR with
relation negatives under SGD, in plain ``torch`` and float32 with TF32
off. It imports nothing of JAX, of the JAX package or of the port, and
takes nothing the port made: the batch a step's u32 draws select is worked
out here too.

- Sampling (OpenKE's rules, as ``sampling/device.py`` documents them):
  draws ``[B, 1 + 2·negE + negR]`` in [0, 2³²); column 0 picks the
  positive (``bits % n_train``), columns 1..negE the head/tail coin
  (``(bits >> 8)·2⁻²⁴ < p``, p = tph / (tph + hpt) with bern, else 0.5),
  the next negE the corrupted entity, the last negR the corrupted
  relation: the ``x``-th value, ``x = bits % (n − |G|)``, of those outside
  ``G``, the values that form a train triple with what is kept ((h, r) →
  tails, (t, r) → heads, (h, t) → relations). A group that holds every
  value gives ``x + (x ≥ own)``, a uniform draw over the others.
- RotatE (Sun et al. 2019): entity rows are ``[re | im]`` of d complex
  lanes, a relation row holds d phases θ, and
  ``d(h, r, t) = Σ_l |h_l·e^{iθ_l} − t_l|``, each modulus with ε = 1e-12
  under its square root (the port's documented form, which keeps the
  gradient finite at a zero residual).
- TransR (Lin et al. 2015): ``‖x_h·M_r + r − x_t·M_r‖₁`` with the row's own
  ``[d_e, d_r]`` matrix, the corrupted relation's for a relation negative.
- Losses, summed over positives: ``self_adv`` ``−log σ(γ − d⁺) − Σ_j w_j
  log σ(d⁻_j − γ)`` with ``w = softmax_j(α(γ − d⁻_j))`` held constant,
  α = 1; ``pairwise`` ``Σ_j max(γ + d⁺ − d⁻_j, 0)``.
- Gradients: autograd on the dense tables.
- SGD: ``p −= α·g``. Lazy Adam: the rows a step's ids touch (duplicates
  summed by the dense gradient) take ``m = β₁m + (1 − β₁)g``,
  ``v = β₂v + (1 − β₂)g²``, ``p += −lr_t·m/(√v + ε)`` with
  ``lr_t = lr·√(1 − β₂ᵗ)/(1 − β₁ᵗ)`` at the global step t (from 1) in
  float32; other rows keep p, m and v."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-12
ADV_TEMPERATURE = 1.0


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


class PlainSampler:
    """The batch a step's draws select, by sets and sorted lists."""

    def __init__(self, train: np.ndarray, n_ent: int, n_rel: int):
        self.train = np.asarray(train, np.int64)
        self.n_ent, self.n_rel = n_ent, n_rel
        self.tails, self.heads, self.rels = {}, {}, {}
        for h, t, r in self.train:
            self.tails.setdefault((h, r), set()).add(t)
            self.heads.setdefault((t, r), set()).add(h)
            self.rels.setdefault((h, t), set()).add(r)
        tph = np.ones(n_rel, np.float32)
        hpt = np.ones(n_rel, np.float32)
        for r in range(n_rel):
            rows = self.train[self.train[:, 2] == r]
            if len(rows):
                tph[r] = np.float32(len(rows) / len(set(rows[:, 0])))
                hpt[r] = np.float32(len(rows) / len(set(rows[:, 1])))
        self.p_head = (tph / (tph + hpt)).astype(np.float32)

    @staticmethod
    def _outside(group: set, n: int, bits: int, own: int) -> int:
        if len(group) >= n:
            x = bits % max(n - 1, 1)
            return x + (x >= own)
        x = bits % (n - len(group))
        for v in range(n):
            if v not in group:
                if x == 0:
                    return v
                x -= 1
        raise AssertionError("unreachable")

    def batch(self, bits: np.ndarray, neg_ent: int, neg_rel: int,
              bern: bool) -> Dict[str, np.ndarray]:
        bits = np.asarray(bits, np.int64)
        B = len(bits)
        pos = self.train[bits[:, 0] % len(self.train)]
        h, t, r = pos[:, 0], pos[:, 1], pos[:, 2]
        neg_h = np.repeat(h[:, None], neg_ent, 1)
        neg_t = np.repeat(t[:, None], neg_ent, 1)
        neg_r = np.zeros((B, neg_rel), np.int64)
        for b in range(B):
            p = self.p_head[r[b]] if bern else np.float32(0.5)
            for k in range(neg_ent):
                u = np.float32(bits[b, 1 + k] >> 8) * np.float32(2.0 ** -24)
                x = int(bits[b, 1 + neg_ent + k])
                if u < p:
                    neg_h[b, k] = self._outside(
                        self.heads[(t[b], r[b])], self.n_ent, x, h[b])
                else:
                    neg_t[b, k] = self._outside(
                        self.tails[(h[b], r[b])], self.n_ent, x, t[b])
            for j in range(neg_rel):
                neg_r[b, j] = self._outside(
                    self.rels[(h[b], t[b])], self.n_rel,
                    int(bits[b, 1 + 2 * neg_ent + j]), r[b])
        return {"h": h, "t": t, "r": r, "neg_h": neg_h, "neg_t": neg_t,
                "neg_rel": neg_r}


def rotate_distance(h: torch.Tensor, theta: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    d = theta.shape[-1]
    z = (torch.complex(h[..., :d], h[..., d:]) * torch.polar(
        torch.ones_like(theta), theta) - torch.complex(t[..., :d], t[..., d:]))
    return torch.sqrt(z.real ** 2 + z.imag ** 2 + EPS).sum(-1)


def transr_distance(h: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
                    M: torch.Tensor) -> torch.Tensor:
    """``M`` [n, d_e, d_r]: each row's own matrix."""
    hp = torch.bmm(h[:, None], M)[:, 0]
    tp = torch.bmm(t[:, None], M)[:, 0]
    return (hp + r - tp).abs().sum(-1)


def triples(batch: Dict[str, np.ndarray], dev) -> tuple:
    """(h, t, r) of every scored triple: the positives, then each entity
    negative, then each relation negative, ``[1 + negE + negR, B]``."""
    h, t, r = batch["h"], batch["t"], batch["r"]
    hs = [h] + list(batch["neg_h"].T) + [h] * batch["neg_rel"].shape[1]
    ts = [t] + list(batch["neg_t"].T) + [t] * batch["neg_rel"].shape[1]
    rs = [r] * (1 + batch["neg_h"].shape[1]) + list(batch["neg_rel"].T)
    return tuple(torch.from_numpy(np.stack(x)).to(dev) for x in (hs, ts, rs))


def distances(config: dict, tabs: Dict[str, torch.Tensor], h, t, r
              ) -> torch.Tensor:
    E, R = tabs["ent_embeddings"], tabs["rel_embeddings"]
    if config["model"] == "rotate":
        return rotate_distance(E[h], R[r], E[t])
    if config["model"] == "transr":
        de, dr = config["ent_size"], config["rel_size"]
        flat = lambda x: x.reshape(-1)  # noqa: E731
        M = tabs["transfer_matrix"][flat(r)].view(-1, de, dr)
        return transr_distance(E[flat(h)], R[flat(r)], E[flat(t)],
                               M).view(h.shape)
    raise ValueError(f"no plain reference for {config['model']!r}")


def loss_of(config: dict, d: torch.Tensor) -> torch.Tensor:
    """``d`` [1 + negatives, B]: the summed loss."""
    pos, neg = d[0], d[1:].T
    g = config["margin"]
    if config["loss_mode"] == "self_adv":
        w = torch.softmax(ADV_TEMPERATURE * (g - neg), 1).detach()
        return (-F.logsigmoid(g - pos)
                - (w * F.logsigmoid(neg - g)).sum(1)).sum()
    if config["loss_mode"] == "pairwise":
        return torch.clamp_min(g + pos[:, None] - neg, 0.0).sum()
    raise ValueError(f"no plain reference for {config['loss_mode']!r}")


def touched(config: dict, tabs, batch) -> Dict[str, torch.Tensor]:
    """Each table's rows a step's ids reach, ``[rows, 1]`` bool."""
    ent = np.concatenate([batch["h"], batch["t"], batch["neg_h"].ravel(),
                          batch["neg_t"].ravel()])
    rel = np.concatenate([batch["r"], batch["neg_rel"].ravel()])
    out = {}
    for k, v in tabs.items():
        ids = ent if k == "ent_embeddings" else rel
        mask = torch.zeros(v.shape[0], 1, dtype=torch.bool, device=v.device)
        mask[torch.from_numpy(ids).to(v.device)] = True
        out[k] = mask
    return out


def follow(config: dict, sampler: PlainSampler,
           p0: Dict[str, torch.Tensor], bits: List[np.ndarray]) -> dict:
    """Steps from the tables ``p0`` (left unchanged), one on the batch each
    of ``bits`` selects. Returns each step's ``batch``, ``loss``,
    ``tables`` after it and, under Adam, its ``m`` and ``v``."""
    dev = next(iter(p0.values())).device
    tabs = {k: v.detach().clone() for k, v in p0.items()}
    adam = config["opt_method"] == "adam"
    m = {k: torch.zeros_like(v) for k, v in tabs.items()}
    v2 = {k: torch.zeros_like(v) for k, v in tabs.items()}
    lr = config["alpha"]
    out = {"batch": [], "loss": [], "tables": [], "m": [], "v": []}
    with no_tf32():
        for step, b in enumerate(bits):
            batch = sampler.batch(b, config["negative_ent"],
                                  config.get("negative_rel", 0),
                                  config["bern"])
            leaves = {k: x.requires_grad_() for k, x in tabs.items()}
            loss = loss_of(config, distances(
                config, leaves, *triples(batch, dev)))
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            with torch.no_grad():
                tabs = {k: x.detach() for k, x in leaves.items()}
                if adam:
                    b1, b2 = config["adam_beta1"], config["adam_beta2"]
                    n = torch.tensor(step + 1, dtype=torch.float32)
                    lr_t = float(lr * torch.sqrt(1.0 - b2 ** n)
                                 / (1.0 - b1 ** n))
                    for k, on in touched(config, tabs, batch).items():
                        g = grads[k]
                        m[k] = torch.where(on, b1 * m[k] + (1 - b1) * g, m[k])
                        v2[k] = torch.where(on, b2 * v2[k] + (1 - b2) * g * g,
                                            v2[k])
                        tabs[k] = tabs[k] + torch.where(
                            on, -lr_t * m[k] / (torch.sqrt(v2[k])
                                                + config["adam_eps"]), 0.0)
                else:
                    tabs = {k: x - lr * grads[k] for k, x in tabs.items()}
            out["batch"].append(batch)
            out["loss"].append(float(loss.detach()))
            out["tables"].append({k: x.clone() for k, x in tabs.items()})
            out["m"].append({k: x.clone() for k, x in m.items()})
            out["v"].append({k: x.clone() for k, x in v2.items()})
    return out
