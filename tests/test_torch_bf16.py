"""bf16 in the port against the JAX package: ``eval_dtype='bfloat16'`` on
every link-prediction route, tables in ``dtype='bfloat16'`` (init, the four
optimizers, B5's bf16 plain version, checkpoints and the carry-over of the
JAX package's bf16 arrays), and the grouped TransR step's refusal.

Tolerances: the kernel routes rank in fp32 whatever the eval dtype (as the
reference's kernels do), so their bf16 ranks equal the fp32 ranks bit for
bit; the other routes round in other places than XLA (which keeps fp32
inside a fusion), so their ranks are held to the reference's own bound, a
mean rank drift of at most 5% of n_ent (``tests/test_pallas_rank.py:
122-157``), against the JAX package's bf16 ranks and against the fp32
ranks. B5's plain version equals the JAX kernel bit for bit."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JaxConfig
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.ops.pallas_scatter import \
    scatter_add_rows_sorted as jax_scatter
from openkeonspark_tpu.sampling.device import DeviceSampler as JaxSampler
from openkeonspark_tpu.train import step as jstep
from openkeonspark_tpu_torch.ckpt import (CheckpointManager,
                                          export_parameters,
                                          import_parameters,
                                          params_from_numpy)
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.models import get_model, init_tables
from openkeonspark_tpu_torch.ops import scatter
from openkeonspark_tpu_torch.runtime import NotPortedError
from openkeonspark_tpu_torch.sampling import DeviceSampler
from openkeonspark_tpu_torch.train import optim
from openkeonspark_tpu_torch.train import step as tstep

from torch_parity import port_config

lp_mod = importlib.import_module(
    "openkeonspark_tpu_torch.eval.link_prediction")
CPU = torch.device("cpu")
MODELS = ["transe", "transd", "rotate", "transh", "transr", "distmult",
          "complex"]
KERNEL_ROUTES = ("transe", "transd", "rotate")
DRIFT = 0.05     # mean rank drift bound, a share of n_ent (the reference's)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=89, n_rel=5, n_triples=700, n_valid=30, n_test=30,
                   seed=11)
    return ds, build_kg_index(ds, for_eval=True)


def _bf16_tensor(a):
    """An ml_dtypes bf16 array as a bf16 tensor, bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                            ).view(torch.bfloat16)


def _max_drift(a, b):
    return max(np.abs(a[k].astype(np.int64) - b[k].astype(np.int64)).mean()
               for k in a)


@pytest.mark.parametrize("use_pallas_eval", [True, False])
@pytest.mark.parametrize("model", MODELS)
def test_eval_dtype_bf16_on_every_route(kg, model, use_pallas_eval,
                                        monkeypatch):
    """eval_dtype='bfloat16' on the model's route (the JAX package's in
    interpret mode): the kernel routes' ranks equal their fp32 ranks bit
    for bit; the grouped, bilinear and generic routes stay within the mean
    drift bound of the JAX package's bf16 ranks and of the fp32 ranks."""
    for var in ("OKST_EVAL_TRANSH_KERNEL", "OKST_EVAL_FORCE_GENERIC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OKST_PALLAS_INTERPRET", "1")
    ds, idx = kg
    cfg = JaxConfig(model=model, hidden_size=16, ent_size=16, rel_size=8,
                    eval_chunk=16, eval_block=32,
                    use_pallas_eval=use_pallas_eval)
    st = jstep.init_state(jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
                          jax.random.key(6))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    tp = params_from_numpy(jp, get_model(model), port_config(cfg), ds.n_ent,
                           ds.n_rel, CPU)
    bf = cfg.replace(eval_dtype="bfloat16")
    route = lp_mod.eval_route(port_config(bf))
    got = link_prediction(tp, port_config(bf), ds, idx).ranks
    f32 = link_prediction(tp, port_config(cfg), ds, idx).ranks
    if use_pallas_eval and model in KERNEL_ROUTES:
        assert route == "kernel"
        for k in f32:
            np.testing.assert_array_equal(got[k], f32[k], err_msg=k)
        return
    want = jax_link_prediction(jp, bf, ds, idx).ranks
    assert _max_drift(got, want) <= DRIFT * ds.n_ent
    assert _max_drift(got, f32) <= DRIFT * ds.n_ent


def test_init_state_tables_in_bf16():
    """``cfg.dtype='bfloat16'``: every table is bf16, the fp32 draw of the
    same generator rounded once; the pad row is zero; the lazy
    optimizers' slots are fp32."""
    cfg = port_config(JaxConfig(model="transd", hidden_size=8,
                                dtype="bfloat16", opt_method="adam"))
    model = get_model("transd")
    state = tstep.init_state(model, cfg, 30, 4,
                             torch.Generator().manual_seed(2), CPU)
    f32 = init_tables(torch.Generator().manual_seed(2),
                      model.tables(cfg, 30, 4), CPU)
    for k, v in state.params.items():
        assert v.dtype == torch.bfloat16, k
        assert torch.equal(v, f32[k].bfloat16()), k
        assert not v[-1].any()
    for slots in state.opt_state.values():
        assert all(t.dtype == torch.float32 for t in slots.values())


@pytest.mark.parametrize("opt", ["sgd", "adam", "adagrad", "adadelta"])
@pytest.mark.parametrize("model", ["transe", "transh", "transr"])
def test_optimizer_steps_on_bf16_tables_match_jax(model, opt):
    """Three steps on bf16 tables fed the same u32 bits as the JAX
    package's (its step jitted alone: its scanned loop refuses the fp32
    slots its lazy update returns). TransR takes the generic route with
    4,096-wide ``transfer_matrix`` rows, so SGD's update goes through B5's
    bf16 plain version. Margin 100 keeps every hinge active: at the hinge's
    edge a bf16 score flips between the packages (XLA keeps fp32 inside a
    fusion), which is not what this test holds. Tolerance, per table: the
    port's update (after − before) differs from the JAX package's by at
    most 10% of the latter's norm plus one bf16 ulp of the table's largest
    value per element (each package rounds every element once more); the
    loss within 2⁻⁷; the slots within 10% of their norm."""
    ds = random_kg(n_ent=60, n_rel=5, n_triples=600, n_valid=20, n_test=20,
                   seed=11)
    idx = build_kg_index(ds, for_eval=False)
    cfg = JaxConfig(model=model, hidden_size=8, margin=100.0, p_norm=2,
                    alpha=0.05, opt_method=opt, negative_ent=3,
                    negative_rel=1, dtype="bfloat16")
    if model == "transr":
        cfg = cfg.replace(ent_size=64, rel_size=64)
        assert cfg.d_ent * cfg.d_rel == optim.WIDE_SCATTER_MIN_WIDTH
    tcfg = port_config(cfg)
    assert not tstep.use_grouped_transr(tcfg)
    jmodel, tmodel = jax_get_model(model), get_model(model)
    jstate = jstep.init_state(jmodel, cfg, ds.n_ent, ds.n_rel,
                              jax.random.key(5))
    jsampler = JaxSampler.build(ds, idx)
    jbuilt = jstep.build_train_step(jmodel, cfg, jsampler, 32)
    jfn = jax.jit(jbuilt)
    before = {k: np.asarray(v) for k, v in jstate.params.items()}
    tparams = params_from_numpy(before, tmodel, tcfg, ds.n_ent, ds.n_rel,
                                CPU)
    assert all(v.dtype == torch.bfloat16 for v in tparams.values())
    tstate = tstep.TrainState(tparams,
                              optim.make_optimizer(tcfg).init(tparams), 0)
    tfn = tstep.build_train_step(tmodel, tcfg, 32)
    tsampler = DeviceSampler.build(ds, idx, CPU)
    for i in range(3):
        bits = np.random.default_rng(30 + i).integers(
            0, 1 << 32, size=jbuilt.bits_shape, dtype=np.uint64)
        jstate, jloss = jfn(jstate, jsampler, jax.random.key(0),
                            jnp.asarray(bits.astype(np.uint32)))
        tstate, tloss = tfn(tstate, tsampler,
                            torch.from_numpy(bits.astype(np.int64)))
        assert float(tloss) == pytest.approx(float(jloss), rel=2 ** -7)
    for k, v in jstate.params.items():
        b0 = before[k].astype(np.float32)
        want = np.asarray(v).astype(np.float32) - b0
        got = tstate.params[k].float().numpy() - b0
        assert tstate.params[k].dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(b0).max())) - 7)
        assert (np.linalg.norm(got - want) <= 0.1 * np.linalg.norm(want)
                + ulp * np.sqrt(want.size)), k
    for s, tables in jstate.opt_state.items():
        for k, v in tables.items():
            want = np.asarray(v).astype(np.float32)
            got = tstate.opt_state[s][k].numpy()
            assert np.linalg.norm(got - want) <= 0.1 * np.linalg.norm(
                want) + 1e-30, f"{s}/{k}"


@pytest.mark.parametrize("R,W,N,seed", [(20, 256, 300, 0), (7, 130, 50, 1),
                                        (30, 4096, 200, 2), (5, 64, 1, 3)])
def test_b5_plain_bf16_equals_jax_kernel(R, W, N, seed):
    """B5's plain version on a bf16 table (one rounding per add, in
    stable-sorted run order) equals the JAX kernel in interpret mode on the
    same bf16 table bit for bit: duplicates, sentinels (id R), widths no
    multiple of 8, and deltas a few binades below the rows, so the adds
    round."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, W)).astype(ml_dtypes.bfloat16)
    ids = rng.integers(0, R + 1, size=N)
    delta = (rng.normal(size=(N, W)) * 2.0 ** -5).astype(ml_dtypes.bfloat16)
    want = np.asarray(jax_scatter(jnp.asarray(table),
                                  jnp.asarray(ids.astype(np.int32)),
                                  jnp.asarray(delta), interpret=True))
    scatter.reset_launch_counts()
    got = scatter.scatter_add_rows_sorted(
        _bf16_tensor(table), torch.from_numpy(ids), _bf16_tensor(delta))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert not any(scatter.LAUNCHES.values())


def test_params_from_numpy_carries_bf16(tmp_path):
    """The JAX package's bf16 arrays (ml_dtypes) come across as bf16
    tensors bit for bit; a checkpoint saves and restores them as bf16;
    the export is float32, as the reference's is."""
    cfg = JaxConfig(model="transe", hidden_size=8, dtype="bfloat16")
    st = jstep.init_state(jax_get_model("transe"), cfg, 40, 3,
                          jax.random.key(1))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    assert all(a.dtype.name == "bfloat16" for a in jp.values())
    tcfg = port_config(cfg)
    model = get_model("transe")
    tp = params_from_numpy(jp, model, tcfg, 40, 3, CPU)
    for k, a in jp.items():
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=k)
    state = tstep.TrainState(tp, {}, 7)
    CheckpointManager(str(tmp_path / "ck")).save(7, state)
    fresh = tstep.init_state(model, tcfg, 40, 3,
                             torch.Generator().manual_seed(0), CPU)
    back, _ = CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    for k in tp:
        assert back.params[k].dtype == torch.bfloat16
        assert torch.equal(back.params[k], tp[k]), k
    path = str(tmp_path / "embedding.npz")
    export_parameters(tp, model, tcfg, 40, 3, path, fmt="npz")
    for k, v in import_parameters(path).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, jp[k][:-1].astype(np.float32))


def test_grouped_transr_refuses_bf16_tables_as_the_reference_raises(
        monkeypatch):
    """TransR's grouped step with bf16 tables raises in the JAX package (in
    interpret mode); the port refuses the combination, and takes bf16
    tables on the generic route."""
    monkeypatch.setenv("OKST_PALLAS_INTERPRET", "1")
    ds = random_kg(n_ent=40, n_rel=3, n_triples=300, n_valid=10, n_test=10,
                   seed=1)
    idx = build_kg_index(ds, for_eval=False)
    cfg = JaxConfig(model="transr", ent_size=16, rel_size=8,
                    dtype="bfloat16", negative_ent=1)
    assert jstep.use_grouped_transr(cfg)
    jmodel = jax_get_model("transr")
    sampler = JaxSampler.build(ds, idx)
    fn = jstep.build_train_step(jmodel, cfg, sampler, 16)
    state = jstep.init_state(jmodel, cfg, ds.n_ent, ds.n_rel,
                             jax.random.key(0))
    with pytest.raises(TypeError):
        fn(state, sampler, jax.random.key(1))
    with pytest.raises(NotPortedError, match="grouped"):
        tstep.check_train_supported(port_config(cfg))
    tstep.check_train_supported(port_config(cfg.replace(negative_rel=1)))
    tstep.check_train_supported(port_config(cfg.replace(
        grouped_transr=False)))
    with pytest.raises(NotPortedError, match="float16"):
        tstep.check_train_supported(port_config(cfg.replace(
            dtype="float16", negative_rel=1)))
