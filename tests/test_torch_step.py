"""The port's training step against the JAX package's on the same batch
and tables: the losses, the TransR relation-grouped step (JAX through its
Pallas kernels in interpret mode), the generic TransE step, and the dense
NumPy oracle of ``tests/oracle.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.models import strip_padding as jax_strip
from openkeonspark_tpu.sampling.device import DeviceSampler as JaxSampler
from openkeonspark_tpu.train import step as jstep
from openkeonspark_tpu.train.loss import margin_ranking_loss as jax_loss
from openkeonspark_tpu.train.optim import make_optimizer as jax_opt
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.data import build_kg_index as port_kg_index
from openkeonspark_tpu_torch.data import random_kg as port_random_kg
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.sampling import DeviceSampler, SampledBatch
from openkeonspark_tpu_torch.train import step as tstep
from openkeonspark_tpu_torch.train.loss import margin_ranking_loss
from openkeonspark_tpu_torch.train.optim import (WIDE_SCATTER_MIN_WIDTH,
                                                 DenseUpdate, make_optimizer)

from oracle import dense_sgd_step
from torch_parity import port_config

CPU = torch.device("cpu")


@pytest.mark.parametrize("mode", ["mean_neg", "pairwise", "self_adv"])
def test_margin_ranking_loss_matches_jax(mode):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=17).astype(np.float32)
    neg = rng.normal(size=(17, 3)).astype(np.float32)
    want, (gp, gn) = jax.value_and_grad(
        lambda p, n: jax_loss(p, n, 0.7, mode), argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg))
    p_t = torch.from_numpy(pos).requires_grad_()
    n_t = torch.from_numpy(neg).requires_grad_()
    got = margin_ranking_loss(p_t, n_t, 0.7, mode)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(gp), atol=1e-6)
    np.testing.assert_allclose(n_t.grad.numpy(), np.asarray(gn), atol=1e-6)


def _setup(model, cfg, ds_kw, key, B, sample_key):
    """JAX state and batch, and the same tables and batch for the port."""
    ds = random_kg(**ds_kw)
    jmodel = jax_get_model(model)
    state = jstep.init_state(jmodel, cfg, ds.n_ent, ds.n_rel,
                             jax.random.key(key))
    batch = JaxSampler.build(ds, build_kg_index(ds, for_eval=False)).sample(
        jax.random.key(sample_key), B, cfg.negative_ent, cfg.negative_rel,
        cfg.bern)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in state.params.items()},
        get_model(model), port_config(cfg), ds.n_ent, ds.n_rel, CPU)
    tbatch = SampledBatch(**{
        k: None if getattr(batch, k) is None
        else torch.from_numpy(np.asarray(getattr(batch, k)).astype(np.int64))
        for k in ("h", "t", "r", "neg_h", "neg_t", "neg_rel")})
    return ds, state, batch, tparams, tbatch


def _dense(updates, params):
    """Per-table dense gradients from the port's updates."""
    out = {}
    for k, u in updates.items():
        if isinstance(u, DenseUpdate):
            out[k] = u.grad.clone()
            continue
        ids, g = u
        out[k] = torch.zeros_like(params[k]).index_add_(0, ids, g)
    return out


TRANSR = Config(model="transr", ent_size=16, rel_size=8, alpha=0.05,
                margin=1.0, negative_ent=2)
TRANSR_KG = dict(n_ent=90, n_rel=6, n_triples=900, n_valid=30, n_test=30,
                 seed=5)


def test_transr_grouped_step_matches_jax(monkeypatch):
    """The grouped step on the same batch and tables as the JAX package's
    grouped step (its Pallas kernels in interpret mode): loss and post-SGD
    tables."""
    monkeypatch.setenv("OKST_PALLAS_INTERPRET", "1")
    cfg, tcfg = TRANSR, port_config(TRANSR)
    assert jstep.use_grouped_transr(cfg) and tstep.use_grouped_transr(tcfg)
    ds, state, batch, tparams, tbatch = _setup("transr", cfg, TRANSR_KG, 2,
                                               128, 9)
    loss_j, upd_j = jstep.loss_and_row_grads_transr_grouped(
        jax_get_model("transr"), cfg, state.params, batch)
    want, _ = jax_opt(cfg).apply(state.params, state.opt_state, upd_j,
                                 state.step)
    loss_t, upd_t = tstep.loss_and_row_grads_transr_grouped(
        get_model("transr"), tcfg, tparams, tbatch)
    assert isinstance(upd_t["transfer_matrix"], DenseUpdate)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    make_optimizer(tcfg).apply(tparams, {}, upd_t, 0)
    for k in want:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("loss_mode", ["mean_neg", "self_adv"])
def test_transr_grouped_step_matches_generic_step(loss_mode):
    """The port's grouped step against its own generic step (gathered
    per-row matrices): same loss, same dense gradients of every table,
    same post-SGD tables."""
    _, _, _, tparams, tbatch = _setup(
        "transr", TRANSR.replace(loss_mode=loss_mode), TRANSR_KG, 3, 96, 4)
    cfg = port_config(TRANSR.replace(loss_mode=loss_mode))
    model = get_model("transr")
    loss_g, upd_g = tstep.loss_and_row_grads_transr_grouped(
        model, cfg, tparams, tbatch)
    off = cfg.replace(grouped_transr=False)
    assert not tstep.use_grouped_transr(off)
    loss_s, upd_s = tstep.loss_and_row_grads(model, off, tparams, tbatch)
    np.testing.assert_allclose(float(loss_g), float(loss_s), rtol=1e-5)
    dg, ds_ = _dense(upd_g, tparams), _dense(upd_s, tparams)
    for k in tparams:
        np.testing.assert_allclose(dg[k].numpy(), ds_[k].numpy(), atol=1e-5,
                                   err_msg=k)
    pg = {k: v.clone() for k, v in tparams.items()}
    ps = {k: v.clone() for k, v in tparams.items()}
    make_optimizer(cfg).apply(pg, {}, upd_g, 0)
    make_optimizer(cfg).apply(ps, {}, upd_s, 0)
    for k in tparams:
        np.testing.assert_allclose(pg[k].numpy(), ps[k].numpy(), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("loss_mode", ["mean_neg", "self_adv"])
def test_transr_generic_step_matches_jax(loss_mode):
    """TransR with relation negatives and ``grouped_transr=False`` takes
    the generic step (gathered ``[d_e·d_r]`` matrices, ``transfer_matrix``
    rows scattered through B5's plain version) in both packages: the same
    u32 bits give the same batch (checked), the loss agrees to rtol 1e-5
    and every post-SGD table to atol 1e-5."""
    _transr_relneg_step_matches_jax(loss_mode, grouped=False)


@pytest.mark.parametrize("loss_mode", ["mean_neg", "self_adv"])
def test_transr_grouped_relneg_step_matches_jax(loss_mode):
    """TransR with relation negatives and fp32 tables takes the port's
    relation-grouped route (two relation-sorted streams through the
    grouped projection's plain versions, a dense ``transfer_matrix``
    gradient), the JAX package's generic step: the same batch, loss and
    post-SGD tables as in the generic case."""
    _transr_relneg_step_matches_jax(loss_mode, grouped=True)


def _transr_relneg_step_matches_jax(loss_mode, grouped):
    cfg = TRANSR.replace(negative_rel=1, loss_mode=loss_mode, ent_size=64,
                         rel_size=64, grouped_transr=grouped)
    tcfg = port_config(cfg)
    assert not jstep.use_grouped_transr(cfg)
    assert not tstep.use_grouped_transr(tcfg)
    assert cfg.d_ent * cfg.d_rel >= WIDE_SCATTER_MIN_WIDTH
    ds = random_kg(**TRANSR_KG)
    idx = build_kg_index(ds, for_eval=False)
    state = jstep.init_state(jax_get_model("transr"), cfg, ds.n_ent,
                             ds.n_rel, jax.random.key(6))
    jfn = jstep.build_train_step(jax_get_model("transr"), cfg,
                                 JaxSampler.build(ds, idx), 64)
    tfn = tstep.build_train_step(get_model("transr"), tcfg, 64)
    assert tfn.bits_shape == tuple(jfn.bits_shape)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in state.params.items()},
        get_model("transr"), tcfg, ds.n_ent, ds.n_rel, CPU)
    bits = np.random.default_rng(8).integers(0, 1 << 32, size=tfn.bits_shape,
                                             dtype=np.uint64)
    jsampler, tsampler = JaxSampler.build(ds, idx), DeviceSampler.build(
        ds, idx, CPU)
    jb = jsampler.sample(jax.random.key(0), 64, 2, 1, cfg.bern,
                         bits=jnp.asarray(bits.astype(np.uint32)))
    tb = tsampler.sample(64, 2, 1, cfg.bern,
                         bits=torch.from_numpy(bits.astype(np.int64)))
    for k in ("h", "t", "r", "neg_h", "neg_t", "neg_rel"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    assert tstep.use_grouped_transr_relneg(tcfg, tparams) == grouped
    want, loss_j = jfn(state, jsampler, jax.random.key(0),
                       bits=jnp.asarray(bits.astype(np.uint32)))
    got, loss_t = tfn(tstep.TrainState(tparams, {}, 0), tsampler,
                      torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for k, v in want.params.items():
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(v),
                                   atol=1e-5, err_msg=k)


TRANSE = Config(model="transe", hidden_size=8, margin=2.0, alpha=0.05,
                negative_ent=3, negative_rel=1)
TRANSE_KG = dict(n_ent=60, n_rel=5, n_triples=600, n_valid=20, n_test=20,
                 seed=11)


def _flat_ids(batch):
    h, t, r, _ = jstep._batch_ids(batch)
    return np.asarray(h), np.asarray(t), np.asarray(r)


@pytest.mark.parametrize("loss_mode", ["mean_neg", "pairwise", "self_adv"])
def test_transe_step_matches_jax_and_oracle(loss_mode):
    """The generic TransE step (entity and relation negatives) against the
    JAX package's step and the dense NumPy oracle."""
    cfg = TRANSE.replace(loss_mode=loss_mode)
    B = 32
    ds, state, batch, tparams, tbatch = _setup("transe", cfg, TRANSE_KG, 5,
                                               B, 42)
    jmodel = jax_get_model("transe")
    loss_j, upd_j = jstep.loss_and_row_grads(jmodel, cfg, state.params,
                                             batch)
    want, _ = jax_opt(cfg).apply(state.params, state.opt_state, upd_j,
                                 state.step)
    specs = jmodel.tables(cfg, ds.n_ent, ds.n_rel)
    dense0 = {k: jnp.asarray(v)
              for k, v in jax_strip(state.params, specs).items()}
    oracle_loss, oracle = dense_sgd_step("transe", cfg, dense0,
                                         *_flat_ids(batch), B)

    tcfg = port_config(cfg)
    loss_t, upd_t = tstep.loss_and_row_grads(get_model("transe"), tcfg,
                                             tparams, tbatch)
    make_optimizer(tcfg).apply(tparams, {}, upd_t, 0)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(loss_t), oracle_loss, rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(tparams[k][:specs[k].rows].numpy(),
                                   oracle[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_two_steps_keep_parity():
    """Two steps through the port's step function (its own sampler, fed
    numpy bits) stay allclose to two dense oracle steps: updates
    accumulate across steps, duplicate rows included."""
    cfg, tcfg = TRANSE, port_config(TRANSE)
    B = 32
    ds = random_kg(**TRANSE_KG)
    model = get_model("transe")
    state = tstep.init_state(model, tcfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(5), CPU)
    specs = model.tables(tcfg, ds.n_ent, ds.n_rel)
    dense = {k: jnp.asarray(v[:specs[k].rows].numpy())
             for k, v in state.params.items()}
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  CPU)
    step_fn = tstep.build_train_step(model, tcfg, B)
    rng = np.random.default_rng(44)
    for _ in range(2):
        bits = torch.from_numpy(rng.integers(
            0, 1 << 32, size=step_fn.bits_shape, dtype=np.int64))
        b = sampler.sample(B, cfg.negative_ent, cfg.negative_rel, cfg.bern,
                           bits=bits)
        hs = [b.h] + [b.neg_h[:, k] for k in range(3)] + [b.h]
        ts = [b.t] + [b.neg_t[:, k] for k in range(3)] + [b.t]
        rs = [b.r] * 4 + [b.neg_rel[:, 0]]
        _, dense = dense_sgd_step(
            "transe", cfg, {k: jnp.asarray(v) for k, v in dense.items()},
            *(torch.cat(x).numpy() for x in (hs, ts, rs)), B)
        state, _ = step_fn(state, sampler, bits)
    assert state.step == 2
    for k in dense:
        np.testing.assert_allclose(state.params[k][:specs[k].rows].numpy(),
                                   dense[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _bf16_round(x):
    """float32 → the nearest bf16 (ties to even), kept as float32."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _merge_oracle(b, g, nE, nR, rnd):
    """NumPy oracle of ``merged_row_updates`` for TransE's two tables:
    {table: (ids, rows)}, its pairs joined in order, every add in fp32,
    then ``rnd``."""
    h, t, r = b["h"], b["t"], b["r"]
    B = h.shape[0]

    def seg(x, i):
        return x[B * (1 + i):B * (2 + i)]

    zero = np.float32(0.0)
    gh, gt, gr = g["h_e"], g["t_e"], g["r_e"]
    base_h, base_t, ent = gh[:B], gt[:B], []
    for k in range(nE):
        ch = (b["neg_h"][:, k] != h)[:, None]
        base_h = rnd(base_h + np.where(ch, zero, seg(gh, k)))
        base_t = rnd(base_t + np.where(ch, seg(gt, k), zero))
        ent.append((np.where(ch[:, 0], b["neg_h"][:, k], b["neg_t"][:, k]),
                    np.where(ch, seg(gh, k), seg(gt, k))))
    for k in range(nE, nE + nR):
        base_h, base_t = rnd(base_h + seg(gh, k)), rnd(base_t + seg(gt, k))
    ent += [(h, base_h), (t, base_t)]
    if nR == 0:
        rel = [(r, gr)]
    else:
        base = gr[:B]
        for k in range(nE):
            base = rnd(base + seg(gr, k))
        rel = [(b["neg_rel"][:, k], seg(gr, nE + k)) for k in range(nR)]
        rel.append((r, base))
    return {k: tuple(np.concatenate(x) for x in zip(*pairs))
            for k, pairs in (("ent_embeddings", ent),
                             ("rel_embeddings", rel))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nR", [0, 2])
@pytest.mark.parametrize("nE", [0, 1, 25])
def test_merged_row_updates_match_numpy_oracle(nE, nR, dtype):
    """``merged_row_updates`` on the CPU (the entity tables through
    ``ops/merge.py``'s plain version, no launch) against a NumPy oracle:
    one stream a table, the same ids in the same order, rows bit for bit. Its
    batch corrupts heads, tails and neither (``neg_h == h`` and ``neg_t ==
    t``), takes its ids as strided columns, and its positive rows hold
    −0.0, which an add of +0.0 turns to +0.0."""
    from openkeonspark_tpu_torch.ops import merge
    B, d, n_ent = 37, 12, 50
    rng = np.random.default_rng(100 * nE + nR)
    rec = rng.integers(0, n_ent, size=(B, 3))
    h, t = rec[:, 0], rec[:, 1]
    mode = rng.integers(0, 3, size=(B, nE))     # head, tail, neither
    other = rng.integers(0, n_ent, size=(B, nE))
    neg_h = np.where(mode == 0, (h[:, None] + 1 + other) % n_ent, h[:, None])
    neg_t = np.where(mode == 1, (t[:, None] + 1 + other) % n_ent, t[:, None])
    assert nE == 0 or {0, 1, 2} <= set(mode.ravel())
    negs = torch.from_numpy(np.concatenate([neg_h, neg_t], 1))
    rec_t = torch.from_numpy(rec)
    batch = SampledBatch(
        h=rec_t[:, 0], t=rec_t[:, 1], r=rec_t[:, 2],
        neg_h=negs[:, :nE] if nE else None,
        neg_t=negs[:, nE:] if nE else None,
        neg_rel=torch.from_numpy(rng.integers(0, 5, size=(B, nR)))
        if nR else None)
    S = 1 + nE + nR
    g = {k: torch.randn(S * B if (k != "r_e" or nR) else B, d,
                        generator=torch.Generator().manual_seed(i))
         .to(dtype) for i, k in enumerate(("h_e", "t_e", "r_e"))}
    g["h_e"][:B:3] = -0.0
    g["t_e"][1:B:4] = -0.0
    before = dict(merge.LAUNCHES)
    got = tstep.merged_row_updates(get_model("transe").gathers(), batch, g)
    assert merge.LAUNCHES == before
    rnd = _bf16_round if dtype == torch.bfloat16 else (lambda x: x)
    want = _merge_oracle(
        {k: getattr(batch, k).numpy() for k in SampledBatch.FIELDS
         if getattr(batch, k) is not None},
        {k: v.float().numpy() for k, v in g.items()}, nE, nR, rnd)
    assert list(got) == list(want)
    n_rows = {"ent_embeddings": (nE + 2) * B, "rel_embeddings": (1 + nR) * B}
    for table, (wids, wrows) in want.items():
        ids, rows, n = *got[table], n_rows[table]
        assert ids.dtype == torch.int64 and rows.dtype == dtype
        assert ids.shape == (n,) and rows.shape == (n, d)
        np.testing.assert_array_equal(ids.numpy(), wids, err_msg=table)
        np.testing.assert_array_equal(
            rows.float().numpy().view(np.uint32), wrows.view(np.uint32),
            err_msg=table)
    ids, rows = merge.merge_entity_rows(batch.h, batch.t, batch.neg_h,
                                        batch.neg_t, g["h_e"], g["t_e"], nR)
    assert merge.LAUNCHES == before
    wids, wrows = got["ent_embeddings"]
    assert torch.equal(ids, wids) and torch.equal(rows, wrows)


def test_grouped_transr_touched_mask_marks_the_batch_relations():
    """The grouped step's ``transfer_matrix`` mask is True exactly at the
    relations of the batch."""
    _, _, _, tparams, tbatch = _setup("transr", TRANSR, TRANSR_KG, 3, 96, 4)
    _, upd = tstep.loss_and_row_grads_transr_grouped(
        get_model("transr"), port_config(TRANSR), tparams, tbatch)
    rows = tparams["transfer_matrix"].shape[0]
    want = torch.bincount(tbatch.r, minlength=rows) > 0
    assert torch.equal(upd["transfer_matrix"].touched, want)


@pytest.mark.parametrize("model,route", [("transe", "generic"),
                                         ("transr", "grouped_transr"),
                                         ("rotate", "rotate_slots")])
def test_each_route_gives_one_stream_a_sparse_table(model, route):
    """Every training route hands the optimizer one update per table:
    a ``DenseUpdate`` (the grouped step's ``transfer_matrix``) or exactly
    one ``(ids int64 [N], rows [N, d])`` stream, ``d`` the table's width;
    the entity table's is the merge's ``(negE + 2)·B`` rows."""
    B, n_neg = 16, 3
    ds = port_random_kg(n_ent=70, n_rel=6, n_triples=600, n_valid=10,
                        n_test=10, seed=4)
    cfg = port_config(Config(model=model, hidden_size=6, ent_size=6,
                             rel_size=5, margin=2.0, negative_ent=n_neg,
                             batch_size=B))
    mdl = get_model(model)
    state = tstep.init_state(mdl, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(0), CPU)
    sampler = DeviceSampler.build(ds, port_kg_index(ds, for_eval=False), CPU)
    batch = sampler.sample(B, n_neg, 0, True,
                           gen=torch.Generator().manual_seed(1))
    assert tstep.use_grouped_transr(cfg) == (route == "grouped_transr")
    assert tstep.use_rotate_slots(mdl, state.params, batch) == (
        route == "rotate_slots")
    _, upd = tstep.loss_and_row_grads(mdl, cfg, state.params, batch)
    assert sorted(upd) == sorted(state.params)
    dense = {k for k, u in upd.items() if isinstance(u, DenseUpdate)}
    assert dense == ({"transfer_matrix"} if route == "grouped_transr"
                     else set())
    for table in set(upd) - dense:
        u = upd[table]
        assert type(u) is tuple and len(u) == 2, table
        ids, rows = u
        assert ids.dtype == torch.int64 and ids.dim() == 1, table
        assert rows.shape == (ids.shape[0], state.params[table].shape[1])
    assert upd["ent_embeddings"][0].shape == ((n_neg + 2) * B,)
