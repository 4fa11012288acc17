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
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.sampling import DeviceSampler, SampledBatch
from openkeonspark_tpu_torch.train import step as tstep
from openkeonspark_tpu_torch.train.loss import margin_ranking_loss
from openkeonspark_tpu_torch.train.optim import (WIDE_SCATTER_MIN_WIDTH,
                                                 DenseUpdate, make_optimizer)

from oracle import dense_sgd_step

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
        get_model(model), cfg, ds.n_ent, ds.n_rel, CPU)
    tbatch = SampledBatch(**{
        k: None if getattr(batch, k) is None
        else torch.from_numpy(np.asarray(getattr(batch, k)).astype(np.int64))
        for k in ("h", "t", "r", "neg_h", "neg_t", "neg_rel")})
    return ds, state, batch, tparams, tbatch


def _dense(updates, params):
    """Per-table dense gradients from a port update list."""
    out = {}
    for k, u in updates.items():
        if isinstance(u, DenseUpdate):
            out[k] = u.grad.clone()
            continue
        d = torch.zeros_like(params[k])
        for ids, g in u:
            d.index_add_(0, ids, g)
        out[k] = d
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
    cfg = TRANSR
    assert jstep.use_grouped_transr(cfg) and tstep.use_grouped_transr(cfg)
    ds, state, batch, tparams, tbatch = _setup("transr", cfg, TRANSR_KG, 2,
                                               128, 9)
    loss_j, upd_j = jstep.loss_and_row_grads_transr_grouped(
        jax_get_model("transr"), cfg, state.params, batch)
    want, _ = jax_opt(cfg).apply(state.params, state.opt_state, upd_j,
                                 state.step)
    loss_t, upd_t = tstep.loss_and_row_grads_transr_grouped(
        get_model("transr"), cfg, tparams, tbatch)
    assert isinstance(upd_t["transfer_matrix"], DenseUpdate)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    make_optimizer(cfg).apply(tparams, {}, upd_t, 0)
    for k in want:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("loss_mode", ["mean_neg", "self_adv"])
def test_transr_grouped_step_matches_generic_step(loss_mode):
    """The port's grouped step against its own generic step (gathered
    per-row matrices): same loss, same dense gradients of every table,
    same post-SGD tables."""
    cfg = TRANSR.replace(loss_mode=loss_mode)
    _, _, _, tparams, tbatch = _setup("transr", cfg, TRANSR_KG, 3, 96, 4)
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
    """TransR with relation negatives takes the generic step (gathered
    ``[d_e·d_r]`` matrices, ``transfer_matrix`` rows scattered through B5's
    plain version) in both packages: the same u32 bits give the same
    batch (checked), the loss agrees to rtol 1e-5 and every post-SGD table to atol
    1e-5."""
    cfg = TRANSR.replace(negative_rel=1, loss_mode=loss_mode, ent_size=64,
                         rel_size=64)
    assert not jstep.use_grouped_transr(cfg)
    assert not tstep.use_grouped_transr(cfg)
    assert cfg.d_ent * cfg.d_rel >= WIDE_SCATTER_MIN_WIDTH
    ds = random_kg(**TRANSR_KG)
    idx = build_kg_index(ds, for_eval=False)
    state = jstep.init_state(jax_get_model("transr"), cfg, ds.n_ent,
                             ds.n_rel, jax.random.key(6))
    jfn = jstep.build_train_step(jax_get_model("transr"), cfg,
                                 JaxSampler.build(ds, idx), 64)
    tfn = tstep.build_train_step(get_model("transr"), cfg, 64)
    assert tfn.bits_shape == tuple(jfn.bits_shape)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in state.params.items()},
        get_model("transr"), cfg, ds.n_ent, ds.n_rel, CPU)
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

    loss_t, upd_t = tstep.loss_and_row_grads(get_model("transe"), cfg,
                                             tparams, tbatch)
    make_optimizer(cfg).apply(tparams, {}, upd_t, 0)
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
    cfg = TRANSE
    B = 32
    ds = random_kg(**TRANSE_KG)
    model = get_model("transe")
    state = tstep.init_state(model, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(5), CPU)
    specs = model.tables(cfg, ds.n_ent, ds.n_rel)
    dense = {k: jnp.asarray(v[:specs[k].rows].numpy())
             for k, v in state.params.items()}
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  CPU)
    step_fn = tstep.build_train_step(model, cfg, B)
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
