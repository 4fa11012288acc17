"""The port's device sampler against the JAX package's: bit-identical
batches from the same u32 bits, and the statistical and filter properties
of ``tests/test_sampling.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.data.dataset import Dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.sampling.device import DeviceSampler as JaxSampler
from openkeonspark_tpu.sampling.device import \
    flatten_reference_layout as jax_flatten
from openkeonspark_tpu_torch.models import TransE
from openkeonspark_tpu_torch.sampling import (DeviceSampler,
                                              flatten_reference_layout)
from openkeonspark_tpu_torch.sampling import device as sampling_device
from openkeonspark_tpu_torch.sampling.device import batched_upper_bound
from openkeonspark_tpu_torch.train.step import gather_slots_structured

CPU = torch.device("cpu")


def _saturated_kg():
    """A KG with full groups: (0, r=0) links head 0 to every entity, and
    the pair (1, 2) is linked by every relation, so complement draws for
    their positives hit the full-group fallback."""
    n_ent, n_rel = 7, 3
    rng = np.random.default_rng(1)
    full_hr = [(0, t, 0) for t in range(n_ent)]
    full_ht = [(1, 2, r) for r in range(n_rel)]
    extra = rng.integers(0, [n_ent, n_ent, n_rel], size=(40, 3))
    train = np.unique(np.concatenate([full_hr, full_ht, extra]), axis=0)
    return Dataset(n_ent=n_ent, n_rel=n_rel, train=train.astype(np.int32),
                   valid=train[:2].astype(np.int32),
                   test=train[2:4].astype(np.int32))


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=120, n_rel=6, n_triples=1500, n_valid=50, n_test=50,
                   seed=7)
    idx = build_kg_index(ds)
    return ds, idx, DeviceSampler.build(ds, idx, CPU)


def _batches(ds, B, n_e, n_r, bern, seed):
    idx = build_kg_index(ds)
    bits = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(B, 1 + 2 * n_e + n_r), dtype=np.uint64)
    want = JaxSampler.build(ds, idx).sample(
        jax.random.key(0), B, n_e, n_r, bern,
        bits=jnp.asarray(bits.astype(np.uint32)))
    got = DeviceSampler.build(ds, idx, CPU).sample(
        B, n_e, n_r, bern, bits=torch.from_numpy(bits.astype(np.int64)))
    return got, want


@pytest.mark.parametrize("bern", [True, False])
@pytest.mark.parametrize("n_r", [0, 1])
@pytest.mark.parametrize("n_e", [1, 2])
@pytest.mark.parametrize("which", ["random", "saturated"])
def test_batches_equal_jax_on_same_bits(which, n_e, n_r, bern):
    ds = (random_kg(n_ent=120, n_rel=6, n_triples=1500, n_valid=50,
                    n_test=50, seed=7) if which == "random"
          else _saturated_kg())
    got, want = _batches(ds, 512, n_e, n_r, bern, seed=n_e * 10 + n_r)
    for name in ("h", "t", "r", "neg_h", "neg_t", "neg_rel"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_saturated_groups_take_the_fallback():
    """Positives whose complement is empty still get a negative that
    differs from the positive."""
    ds = _saturated_kg()
    got, _ = _batches(ds, 2048, 1, 1, False, seed=3)
    full_tail = (got.h == 0) & (got.r == 0) & (got.neg_h[:, 0] == got.h)
    assert full_tail.any()
    assert (got.neg_t[:, 0][full_tail] != got.t[full_tail]).all()
    full_rel = (got.h == 1) & (got.t == 2)
    assert full_rel.any()
    assert (got.neg_rel[:, 0][full_rel] != got.r[full_rel]).all()


def test_batched_upper_bound_matches_searchsorted():
    rng = np.random.default_rng(0)
    windows = [np.sort(rng.choice(100, size=n, replace=False))
               for n in [0, 1, 3, 17, 40]]
    arr = np.concatenate([w for w in windows if len(w)])
    offs = np.cumsum([0] + [len(w) for w in windows[:-1]])
    off_q, cnt_q, queries, want = [], [], [], []
    for wi, w in enumerate(windows):
        for x in rng.integers(-5, 105, size=20):
            off_q.append(offs[wi])
            cnt_q.append(len(w))
            queries.append(x)
            want.append(int(np.searchsorted(w, x, side="right")))
    got = batched_upper_bound(torch.tensor(arr), torch.tensor(off_q),
                              torch.tensor(cnt_q), torch.tensor(queries),
                              iters=6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [0, 1 << 22], ids=["search", "window"])
def test_batched_upper_bound_paths_match_searchsorted(cap, monkeypatch):
    """Both ways of counting, the binary search (lanes × widest window
    over the cap) and the comparison of every window slot, give
    ``searchsorted``'s count on ``[lanes, draws]`` queries against one
    window a lane, windows as the sampler lays them out (empty ones, one
    ending the array, ``cnt`` up to ``2**iters − 1``)."""
    monkeypatch.setattr(sampling_device, "WINDOW_COUNT_MAX_ELEMS", cap)
    rng = np.random.default_rng(5)
    iters = 5
    windows = [np.sort(rng.choice(200, size=n, replace=False))
               for n in rng.integers(0, 32, size=40)] + [np.arange(31)]
    arr = np.concatenate(windows)
    offs = np.cumsum([0] + [len(w) for w in windows[:-1]])
    x = rng.integers(-5, 205, size=(len(windows), 3))
    want = np.array([[np.searchsorted(w, v, side="right") for v in row]
                     for w, row in zip(windows, x)])
    got = batched_upper_bound(
        torch.tensor(arr), torch.tensor(offs)[:, None],
        torch.tensor([len(w) for w in windows])[:, None], torch.tensor(x),
        iters)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_batches_are_the_same_through_either_count(kg, monkeypatch):
    """A batch with entity and relation negatives drawn through the
    window comparison (this KG's windows are narrow) equals the one drawn
    from the same bits through the binary search, id for id."""
    _, _, sampler = kg
    bits = sampler.draw_bits((300, sampler.bits_cols(3, 2)),
                             torch.Generator().manual_seed(6))
    want = sampler.sample(300, 3, 2, True, bits=bits)
    monkeypatch.setattr(sampling_device, "WINDOW_COUNT_MAX_ELEMS", 0)
    got = sampler.sample(300, 3, 2, True, bits=bits)
    for f in got.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_negatives_are_filtered(kg):
    """No corrupted triple is a train triple (the exact filter), and each
    entity negative corrupts exactly one side."""
    ds, _, sampler = kg
    train_set = {tuple(t) for t in ds.train.tolist()}
    b = sampler.sample(512, 4, 2, True, gen=torch.Generator().manual_seed(0))
    h, t, r = b.h.numpy(), b.t.numpy(), b.r.numpy()
    nh, nt, nr = b.neg_h.numpy(), b.neg_t.numpy(), b.neg_rel.numpy()
    for i in range(512):
        assert (h[i], t[i], r[i]) in train_set
        for j in range(4):
            assert (nh[i, j], nt[i, j], r[i]) not in train_set
            assert 0 <= nh[i, j] < ds.n_ent and 0 <= nt[i, j] < ds.n_ent
            assert (nh[i, j] != h[i]) != (nt[i, j] != t[i])
        saturated = len({rr for (hh, tt, rr) in train_set
                         if hh == h[i] and tt == t[i]}) == ds.n_rel
        for j in range(2):
            if not saturated:
                assert (h[i], t[i], nr[i, j]) not in train_set
            assert nr[i, j] != r[i]
            assert 0 <= nr[i, j] < ds.n_rel


def test_bern_head_tail_ratio(kg):
    """The share of head corruptions per relation ≈ tph / (tph + hpt)."""
    ds, idx, sampler = kg
    b = sampler.sample(40000, 1, 0, True, gen=torch.Generator().manual_seed(2))
    r = b.r.numpy()
    head_corrupted = (b.neg_h[:, 0] != b.h).numpy()
    p = idx.p_corrupt_head
    checked = 0
    for rel in range(ds.n_rel):
        m = r == rel
        if m.sum() < 500:
            continue
        assert abs(head_corrupted[m].mean() - p[rel]) < 0.08, rel
        checked += 1
    assert checked >= 3


def test_reference_layout(kg):
    """The step's slot rows follow the reference layout: positive j at
    row j, entity negative k of positive j at row j + B·(1+k), relation
    negatives after them; the shared relation slot stays one [B] block
    when there are no relation negatives."""
    ds, _, sampler = kg
    ids = {"ent_embeddings": torch.arange(ds.n_ent + 1.0)[:, None],
           "rel_embeddings": torch.arange(ds.n_rel + 1.0)[:, None]}
    B = 64
    for n_r in (1, 0):
        b = sampler.sample(B, 2, n_r, True,
                           gen=torch.Generator().manual_seed(4))
        slots, n_neg = gather_slots_structured(TransE, ids, b)
        assert n_neg == 2 + n_r
        h = slots["h_e"][:, 0].long()
        assert h.shape == (B * (1 + n_neg),)
        np.testing.assert_array_equal(h[:B], b.h)
        np.testing.assert_array_equal(h[B:2 * B], b.neg_h[:, 0])
        np.testing.assert_array_equal(slots["t_e"][2 * B:3 * B, 0].long(),
                                      b.neg_t[:, 1])
        r = slots["r_e"][:, 0].long()
        if n_r:
            np.testing.assert_array_equal(r[:3 * B], b.r.repeat(3))
            np.testing.assert_array_equal(r[3 * B:], b.neg_rel[:, 0])
            np.testing.assert_array_equal(h[3 * B:], b.h)
        else:
            np.testing.assert_array_equal(r, b.r)


@pytest.mark.parametrize("n_e,n_r", [(1, 0), (2, 1), (0, 2)])
def test_flatten_reference_layout_equals_jax(n_e, n_r):
    """Equal batches (the same u32 bits) flatten to equal reference
    layouts: the same ``batch_h/t/r`` slots and the same ``batch_y``."""
    ds = random_kg(n_ent=120, n_rel=6, n_triples=1500, n_valid=50,
                   n_test=50, seed=7)
    got, want = _batches(ds, 96, n_e, n_r, True, seed=5 + n_e + n_r)
    got, want = flatten_reference_layout(got), jax_flatten(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == (96 * (1 + n_e + n_r),)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert got["batch_y"].dtype == torch.float32


def test_complement_uniformity(kg):
    """Corrupted tails of one fixed positive are ~uniform over the
    complement of its (h, r) tail set. The bits pick the positive
    (column 0) and force tail corruption (the flip's top bits all 1)."""
    ds, idx, sampler = kg
    rows = idx.train_row_tables(ds.train)
    i = int(np.argmax(rows["hr_cnt"]))
    h0, _, r0 = ds.train[i]
    known = set(ds.train[(ds.train[:, 0] == h0) & (ds.train[:, 2] == r0),
                         1].tolist())
    complement = np.array(sorted(set(range(ds.n_ent)) - known))
    n_draw = 20000
    g = torch.Generator().manual_seed(1)
    bits = torch.stack([torch.full((n_draw,), i, dtype=torch.int64),
                        torch.full((n_draw,), (1 << 32) - 1),
                        sampler.draw_bits((n_draw,), g)], dim=1)
    assert idx.p_corrupt_head[r0] < 1.0
    b = sampler.sample(n_draw, 1, 0, True, bits=bits)
    assert (b.neg_h[:, 0] == int(h0)).all()
    nt = b.neg_t[:, 0].numpy()
    assert set(np.unique(nt)) <= set(complement.tolist())
    freq = np.bincount(nt, minlength=ds.n_ent)[complement]
    expected = n_draw / len(complement)
    assert freq.min() > 0 and freq.max() < 5 * expected
