"""On-device negative sampling: uniform positives, the Bernoulli
head/tail choice, and exact filtered corruption.

Counterpart of ``openkeonspark_tpu/sampling/device.py:79-310``. A
corrupted entity is drawn uniformly from the entities that do *not* form a
train triple with the kept side, by the complement "offset trick": draw
``x ~ U[0, n − cnt)`` and return ``x + |{i : adj[i] ≤ x}|`` over the
group's strictly increasing ``adj[i] = g[i] − i`` window. The count is a
per-lane binary search over plain int tensors on the device, or, where
the lanes and the widest window are few (the relation draw), one
comparison of every window slot.

The arithmetic is the JAX package's, bit for bit, so both samplers give
the same batch from the same u32 bits (``sample(..., bits=...)``):
``bits % bound`` range reduction (``:113-116``), the 24-bit Bernoulli flip
``(bits >> 8) · 2⁻²⁴`` (``:262-264``), the full-group fallback
(``:134-140``) and the bit-column layout ``1 + 2·negE + negR``
(``:219-221``). Bits travel as int64 tensors holding values in
``[0, 2³²)``. The JAX package's ``Packed1D`` / ``PackedRecords`` layouts
and its 128-lane window epilogue work around the TPU's scalar gathers and
are not ported: the search runs ``iters`` plain rounds."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openkeonspark_tpu_torch.data.dataset import Dataset
from openkeonspark_tpu_torch.data.index import KGIndex

# column order of DeviceSampler.trip
_H, _T, _R, _HR_OFF, _HR_CNT, _TR_OFF, _TR_CNT, _HT_OFF, _HT_CNT = range(9)


def _ceil_log2(n: int) -> int:
    n = max(int(n), 1)
    return max(1, (n - 1).bit_length())


# lanes × window slots up to which batched_upper_bound compares every slot
# of each window at once (eight launches) instead of searching (twelve
# launches a round); a slot takes a bool and at most one int64 probe
WINDOW_COUNT_MAX_ELEMS = 1 << 22


def batched_upper_bound(arr: torch.Tensor, off: torch.Tensor,
                        cnt: torch.Tensor, x: torch.Tensor,
                        iters: int) -> torch.Tensor:
    """Per lane: ``|{i in [0, cnt): arr[off + i] <= x}|`` for sorted
    windows; ``iters`` ≥ ceil(log2(max cnt + 1)) rounds of binary search
    (every window must lie inside ``arr`` where ``cnt > 0``). Where the
    lanes times ``2**iters − 1`` slots (the widest window) are at most
    ``WINDOW_COUNT_MAX_ELEMS``, every slot is compared at once: the same
    count in a few launches (the relation draw's windows are narrow)."""
    shape = torch.broadcast_shapes(off.shape, cnt.shape, x.shape)
    top = max(arr.numel() - 1, 0)
    width = (1 << iters) - 1
    if width * math.prod(shape) <= WINDOW_COUNT_MAX_ELEMS:
        i = torch.arange(width, device=x.device)
        probe = arr[torch.clamp(off[..., None] + i, max=top)]
        return ((i < cnt[..., None]) & (probe <= x[..., None])).sum(-1)
    lo = torch.zeros(shape, dtype=torch.int64, device=x.device)
    hi = cnt.expand(shape).to(torch.int64)
    last = torch.clamp_min(cnt.to(torch.int64) - 1, 0)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        probe = arr[torch.clamp(off + torch.minimum(mid, last), max=top)]
        go_right = (mid < hi) & (probe <= x)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _mod_range(bits: torch.Tensor, bound) -> torch.Tensor:
    """Uniform int in [0, bound) from 32 random bits mod bound (the
    reference's ``rand_max`` reduction)."""
    if isinstance(bound, torch.Tensor):
        return bits % torch.clamp_min(bound, 1)
    return bits % max(int(bound), 1)


def _complement_sample(bits: torch.Tensor, arr: torch.Tensor,
                       off: torch.Tensor, cnt: torch.Tensor, n_vals: int,
                       iters: int, avoid: torch.Tensor) -> torch.Tensor:
    """Uniform draw from ``[0, n_vals) \\ group`` by the offset trick. A
    group holding every value has an empty complement: then the draw is
    uniform over the domain minus the positive's own value ``avoid``."""
    full = cnt >= n_vals
    space = torch.where(full, torch.full_like(cnt, max(n_vals - 1, 1)),
                        torch.clamp_min(n_vals - cnt, 1))
    x = _mod_range(bits, space)
    k = batched_upper_bound(arr, off, cnt, x, iters)
    fallback = x + (x >= avoid).to(x.dtype)
    return torch.where(full.expand(x.shape), fallback, x + k)


@dataclass
class SampledBatch:
    """Positives [B] and structured negatives ([B, negE] entity-corrupted
    triples sharing r; [B, negR] corrupted relations sharing (h, t)); int64
    ids."""

    h: torch.Tensor
    t: torch.Tensor
    r: torch.Tensor
    neg_h: Optional[torch.Tensor] = None
    neg_t: Optional[torch.Tensor] = None
    neg_rel: Optional[torch.Tensor] = None

    FIELDS = ("h", "t", "r", "neg_h", "neg_t", "neg_rel")

    def map(self, fn) -> "SampledBatch":
        """The batch with ``fn`` applied to every field that is set (a row
        slice, one step of a stacked group, a copy to a device)."""
        return SampledBatch(**{
            f: None if getattr(self, f) is None else fn(getattr(self, f))
            for f in self.FIELDS})


def flatten_reference_layout(b: SampledBatch) -> Dict[str, torch.Tensor]:
    """The reference's slot layout (``Model.py``'s buffers, PARITY.md):
    slot j < B is positive j, negative segment k fills slots ``j + B·(1 +
    k)`` (entity negatives first, then relation negatives), and ``y`` is
    +1 for a positive, −1 for a negative. Counterpart of
    ``openkeonspark_tpu/sampling/device.py:312-336``."""
    B = b.h.shape[0]
    hs, ts, rs = [b.h], [b.t], [b.r]
    if b.neg_h is not None:
        for k in range(b.neg_h.shape[1]):
            hs.append(b.neg_h[:, k])
            ts.append(b.neg_t[:, k])
            rs.append(b.r)
    if b.neg_rel is not None:
        for k in range(b.neg_rel.shape[1]):
            hs.append(b.h)
            ts.append(b.t)
            rs.append(b.neg_rel[:, k])
    batch_h = torch.cat(hs)
    y = torch.full((batch_h.shape[0],), -1.0, device=batch_h.device)
    y[:B] = 1.0
    return {"batch_h": batch_h, "batch_t": torch.cat(ts),
            "batch_r": torch.cat(rs), "batch_y": y}


@dataclass
class DeviceSampler:
    """Device-resident triple store and corruption indexes."""

    # one row per train triple: (h, t, r, hr_off, hr_cnt, tr_off, tr_cnt,
    # ht_off, ht_cnt); one row gather fetches all nine fields
    trip: torch.Tensor        # [n_train, 9] int64
    ent_adj: torch.Tensor     # concat(hr.adj, tr.adj), tr_off pre-shifted
    rel_adj: torch.Tensor     # ht.adj
    p_corrupt_head: torch.Tensor  # [R] float32 (bern)
    n_ent: int
    n_rel: int
    n_train: int
    ent_iters: int
    rel_iters: int

    @classmethod
    def build(cls, ds: Dataset, index: KGIndex,
              device: torch.device) -> "DeviceSampler":
        rows = index.train_row_tables(ds.train, with_rel=True)
        hr_adj, tr_adj = index.hr.adj, index.tr.adj
        ent_adj = np.concatenate([hr_adj, tr_adj]) if len(tr_adj) else hr_adj
        tr_off = rows["tr_off"].astype(np.int64) + len(hr_adj)
        trip = np.stack([rows["train_h"], rows["train_t"], rows["train_r"],
                         rows["hr_off"], rows["hr_cnt"], tr_off,
                         rows["tr_cnt"], rows["ht_off"], rows["ht_cnt"]],
                        axis=1).astype(np.int64)
        dev = lambda a, dt=torch.int64: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(device, dt)
        max_ent_cnt = max(index.hr.max_cnt, index.tr.max_cnt, 1)
        max_rel_cnt = max(index.ht.max_cnt, 1)
        return cls(
            trip=dev(trip), ent_adj=dev(ent_adj), rel_adj=dev(index.ht.adj),
            p_corrupt_head=dev(index.p_corrupt_head, torch.float32),
            n_ent=ds.n_ent, n_rel=ds.n_rel, n_train=len(ds.train),
            ent_iters=_ceil_log2(max_ent_cnt + 1),
            rel_iters=_ceil_log2(max_rel_cnt + 1))

    def store_bytes(self) -> int:
        """Device bytes of the sampler's tensors (triple records, the
        complement adjacencies, the Bernoulli table): the counterpart of
        the JAX package's ``store_bytes`` (``sampling/device.py:179-189``),
        measured on this store's own layout (int64 records and windows)."""
        return sum(t.numel() * t.element_size() for t in
                   (self.trip, self.ent_adj, self.rel_adj,
                    self.p_corrupt_head))

    @staticmethod
    def bits_cols(negative_ent: int, negative_rel: int) -> int:
        """u32 columns one step's draws consume (see :meth:`sample`)."""
        return 1 + 2 * negative_ent + negative_rel

    def draw_bits(self, shape, gen: torch.Generator) -> torch.Tensor:
        """u32 random bits as int64, drawn on the sampler's device."""
        return torch.randint(0, 1 << 32, shape, generator=gen,
                             device=self.trip.device, dtype=torch.int64)

    def sample(self, batch_size: int, negative_ent: int, negative_rel: int,
               bern: bool, gen: Optional[torch.Generator] = None,
               bits: Optional[torch.Tensor] = None,
               partition: Optional[Tuple[int, int]] = None) -> SampledBatch:
        """Draw a batch: ``batch_size`` uniform positives and per-positive
        corrupted negatives. ``bits`` [B, 1 + 2·negE + negR] (values in
        [0, 2³²)) are drawn from ``gen`` unless given: column 0 picks the
        positive, columns 1..negE the Bernoulli flips, the next negE the
        corrupted entities, the last negR the corrupted relations.
        ``partition=(start, size)`` draws the positives from the triples
        ``[start, start + size)`` only (a data row's edge partition, the
        JAX package's ``:244-248``)."""
        n_e, n_r = negative_ent, negative_rel
        if bits is None:
            bits = self.draw_bits(
                (batch_size, self.bits_cols(n_e, n_r)), gen)
        if partition is None:
            idx = _mod_range(bits[:, 0], self.n_train)
        else:
            start, size = partition
            idx = start + _mod_range(bits[:, 0], size)
        rec = self.trip[idx]
        h, t, r = rec[:, _H], rec[:, _T], rec[:, _R]

        neg_h = neg_t = None
        if n_e > 0:
            u = (bits[:, 1:1 + n_e] >> 8).to(torch.float32) * (1.0 / (1 << 24))
            if bern:
                corrupt_head = u < self.p_corrupt_head[r][:, None]
            else:
                corrupt_head = u < 0.5
            # head corruption searches the (t, r) → heads window,
            # tail corruption the (h, r) → tails window
            pick = lambda a, b: torch.where(  # noqa: E731
                corrupt_head, rec[:, a, None], rec[:, b, None])
            corrupted = _complement_sample(
                bits[:, 1 + n_e:1 + 2 * n_e], self.ent_adj,
                pick(_TR_OFF, _HR_OFF), pick(_TR_CNT, _HR_CNT), self.n_ent,
                self.ent_iters, pick(_H, _T))
            neg_h = torch.where(corrupt_head, corrupted, h[:, None])
            neg_t = torch.where(corrupt_head, t[:, None], corrupted)

        neg_rel = None
        if n_r > 0:
            neg_rel = _complement_sample(
                bits[:, 1 + 2 * n_e:], self.rel_adj, rec[:, _HT_OFF, None],
                rec[:, _HT_CNT, None], self.n_rel, self.rel_iters,
                r[:, None])
        return SampledBatch(h=h, t=t, r=r, neg_h=neg_h, neg_t=neg_t,
                            neg_rel=neg_rel)
