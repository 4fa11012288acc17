"""The port's lazy Adam, Adagrad and Adadelta against the JAX package's
``build_train_step`` on the same u32 bits and tables (TransE, TransD and
TransR on the generic route), their dense-G and sort-aggregation paths
against each other, and the grouped TransR route (``DenseUpdate``) against
the generic route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JaxConfig
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.sampling.device import DeviceSampler as JaxSampler
from openkeonspark_tpu.train import step as jstep
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.sampling import DeviceSampler
from openkeonspark_tpu_torch.train import optim
from openkeonspark_tpu_torch.train import step as tstep

from torch_parity import config_as

CPU = torch.device("cpu")
KG = dict(n_ent=60, n_rel=5, n_triples=600, n_valid=20, n_test=20, seed=11)
B = 32
OPTS = ["adam", "adagrad", "adadelta"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfg(model, opt, **kw):
    """The JAX optimizer tests' configuration (``test_step_parity.py``):
    entity and relation negatives, so TransR takes the generic route, with
    ``transfer_matrix`` rows 4,096 wide, so they take B5's plain version."""
    cfg = Config(model=model, hidden_size=8, margin=2.0, alpha=0.05,
                 opt_method=opt, negative_ent=3, negative_rel=1)
    if model == "transr":
        cfg = cfg.replace(ent_size=64, rel_size=64)
        assert cfg.d_ent * cfg.d_rel == optim.WIDE_SCATTER_MIN_WIDTH
    return cfg.replace(**kw)


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint64)


def _assert_state_close(tstate, jstate, rtol, atol):
    for k, v in jstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v),
                                   rtol=rtol, atol=atol, err_msg=k)
    assert set(tstate.opt_state) == set(jstate.opt_state)
    for s, tables in jstate.opt_state.items():
        for k, v in tables.items():
            np.testing.assert_allclose(tstate.opt_state[s][k].numpy(),
                                       np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=f"{s}/{k}")


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("model", ["transe", "transd", "transr"])
def test_lazy_opt_steps_match_jax(model, opt):
    """One step, then a second (state accumulates, Adam's bias correction
    moves with the global step): params and ``opt_state`` within the JAX
    optimizer tests' tolerance, rtol 1e-4 / atol 1e-6."""
    cfg = _cfg(model, opt)
    ds = random_kg(**KG)
    idx = build_kg_index(ds, for_eval=False)
    jmodel, tmodel = jax_get_model(model), get_model(model)
    jcfg = config_as(JaxConfig, cfg)
    jstate = jstep.init_state(jmodel, jcfg, ds.n_ent, ds.n_rel,
                              jax.random.key(5))
    jsampler = JaxSampler.build(ds, idx)
    jfn = jstep.build_train_step(jmodel, jcfg, jsampler, B)
    assert not tstep.use_grouped_transr(cfg)

    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()}, tmodel, cfg,
        ds.n_ent, ds.n_rel, CPU)
    tstate = tstep.TrainState(tparams, optim.make_optimizer(cfg).init(tparams),
                              0)
    tfn = tstep.build_train_step(tmodel, cfg, B)
    tsampler = DeviceSampler.build(ds, idx, CPU)
    for i in range(2):
        bits = _bits(jfn.bits_shape, 30 + i)
        jstate, jloss = jfn(jstate, jsampler, jax.random.key(0),
                            bits=jnp.asarray(bits.astype(np.uint32)))
        tstate, tloss = tfn(tstate, tsampler,
                            torch.from_numpy(bits.astype(np.int64)))
        assert tstate.step == i + 1
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        _assert_state_close(tstate, jstate, rtol=1e-4, atol=1e-6)


def _two_steps(model, cfg, seed):
    ds = random_kg(**KG)
    state = tstep.init_state(model, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(5), CPU)
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  CPU)
    fn = tstep.build_train_step(model, cfg, B)
    for i in range(2):
        bits = torch.from_numpy(_bits(fn.bits_shape, seed + i).astype(
            np.int64))
        state, _ = fn(state, sampler, bits)
    return state


@pytest.mark.parametrize("opt", OPTS)
def test_dense_g_and_sort_aggregation_agree(opt, monkeypatch):
    """The dense-G path (every table here) and the sort-aggregation path
    (forced with a cap of 0) implement the same lazy update."""
    model = get_model("transr")
    cfg = _cfg("transr", opt)
    dense = _two_steps(model, cfg, 70)
    monkeypatch.setattr(optim._LazyRowOptimizer, "DENSE_MOMENT_MAX_ELEMS",
                        0)
    srt = _two_steps(model, cfg, 70)
    for k, v in dense.params.items():
        np.testing.assert_allclose(srt.params[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for s, tables in dense.opt_state.items():
        for k, v in tables.items():
            np.testing.assert_allclose(srt.opt_state[s][k].numpy(),
                                       v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{s}/{k}")


def test_aggregate_duplicates():
    ids = torch.tensor([4, 1, 4, 7, 1, 4])
    g = torch.arange(12.0).view(6, 2)
    uids, agg = optim.aggregate_duplicates(ids, g, sentinel=9)
    assert uids.tolist() == [1, 4, 7, 9, 9, 9]
    assert agg.tolist() == [[10.0, 12.0], [14.0, 17.0], [6.0, 7.0],
                            [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]


@pytest.mark.parametrize("rows", [optim.SMALL_TABLE_ROWS,
                                  optim.SMALL_TABLE_ROWS + 1])
def test_sgd_adds_a_small_tables_summed_deltas_once(rows, monkeypatch):
    """SGD adds the fp32 sum of a step's deltas to a narrow table once: at
    most ``SMALL_TABLE_ROWS`` rows (the reference's one-hot product) and
    larger, up to ``DENSE_MAX_ELEMS`` elements; past that bound delta by
    delta. Two deltas under half an ulp of 1.0 tell the two apart. An id
    past the table is dropped."""
    one, d = torch.ones(()), torch.tensor(4e-8)
    summed, each = one + (d + d), one + d + d
    assert summed != each
    for bound, want in ((optim.DENSE_MAX_ELEMS, summed),
                        (2 * rows - 1, each)):
        monkeypatch.setattr(optim, "DENSE_MAX_ELEMS", bound)
        t = torch.ones(rows, 2)
        optim.SparseSGD(Config(alpha=1.0)).apply(
            {"t": t}, {}, {"t": (torch.tensor([3, 3, rows]),
                                 torch.full((3, 2), -4e-8))}, 0)
        assert torch.equal(t[3], want.expand(2))
        t[3] = 1.0
        assert torch.equal(t, torch.ones(rows, 2))


def test_grouped_transr_adam_matches_generic_route():
    """Adam on the grouped TransR route (``transfer_matrix`` as a
    ``DenseUpdate``) and on the generic route (a row stream through the
    dense-G path) from the same batch: the same tables and moments."""
    cfg = _cfg("transr", "adam", negative_ent=2, negative_rel=0)
    ds = random_kg(**KG)
    model = get_model("transr")
    state = tstep.init_state(model, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(3), CPU)
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  CPU)
    batch = sampler.sample(B, 2, 0, True,
                           bits=torch.from_numpy(_bits((B, 5), 9).astype(
                               np.int64)))
    opt = optim.make_optimizer(cfg)
    out = {}
    for grouped in (True, False):
        c = cfg.replace(grouped_transr=grouped)
        assert tstep.use_grouped_transr(c) == grouped
        params = {k: v.clone() for k, v in state.params.items()}
        st = opt.init(params)
        loss, upd = tstep.loss_and_row_grads(model, c, params, batch)
        assert isinstance(upd["transfer_matrix"],
                          optim.DenseUpdate) == grouped
        opt.apply(params, st, upd, 0)
        out[grouped] = (float(loss), params, st)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for k in state.params:
        np.testing.assert_allclose(out[True][1][k].numpy(),
                                   out[False][1][k].numpy(), atol=1e-5,
                                   err_msg=k)
        for s in ("m", "v"):
            np.testing.assert_allclose(out[True][2][s][k].numpy(),
                                       out[False][2][s][k].numpy(),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"{s}/{k}")
