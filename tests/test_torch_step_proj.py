"""Training TransH, TransD and RotatE in the port: the generic step against
the JAX package's ``build_train_step`` on the same u32 bits and tables,
and ``cli.train`` end to end on the CPU (TransH ranking relation by
relation, as the JAX package does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import planted_kg, random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.sampling.device import DeviceSampler as JaxSampler
from openkeonspark_tpu.train import step as jstep
from openkeonspark_tpu_torch.ckpt import import_parameters, params_from_numpy
from openkeonspark_tpu_torch.cli import train as train_cli
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.sampling import DeviceSampler
from openkeonspark_tpu_torch.train import step as tstep
from openkeonspark_tpu_torch.train.optim import make_optimizer

from torch_parity import model_near_tie_counts, port_config

CPU = torch.device("cpu")
KG = dict(n_ent=70, n_rel=5, n_triples=700, n_valid=20, n_test=20, seed=13)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Training here is many tiny ops; torch's intra-op threads only
    contend with the other test workers for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("model,loss_mode,p", [
    ("transh", "mean_neg", 1), ("transh", "pairwise", 2),
    ("transd", "mean_neg", 1), ("transd", "self_adv", 2),
    ("rotate", "self_adv", 1), ("rotate", "mean_neg", 1)])
def test_step_matches_jax_build_train_step(model, loss_mode, p):
    """One step with entity and relation negatives from the same u32 bits:
    the sampled batch, the loss (rtol 1e-5) and every table after SGD
    (atol 1e-5)."""
    cfg = Config(model=model, hidden_size=8, p_norm=p, margin=2.0,
                 alpha=0.05, negative_ent=2, negative_rel=1,
                 loss_mode=loss_mode)
    B = 32
    ds = random_kg(**KG)
    idx = build_kg_index(ds, for_eval=False)
    jmodel = jax_get_model(model)
    jstate = jstep.init_state(jmodel, cfg, ds.n_ent, ds.n_rel,
                              jax.random.key(3))
    jsampler = JaxSampler.build(ds, idx)
    jfn = jstep.build_train_step(jmodel, cfg, jsampler, B)
    bits = np.random.default_rng(21).integers(
        0, 1 << 32, size=jfn.bits_shape, dtype=np.uint64)
    jnew, jloss = jfn(jstate, jsampler, jax.random.key(0),
                      bits=jnp.asarray(bits.astype(np.uint32)))

    tmodel, tcfg = get_model(model), port_config(cfg)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()}, tmodel, tcfg,
        ds.n_ent, ds.n_rel, CPU)
    tstate = tstep.TrainState(tparams, make_optimizer(tcfg).init(tparams), 0)
    tfn = tstep.build_train_step(tmodel, tcfg, B)
    assert tfn.bits_shape == jfn.bits_shape
    tnew, tloss = tfn(tstate, DeviceSampler.build(ds, idx, CPU),
                      torch.from_numpy(bits.astype(np.int64)))
    assert tnew.step == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k, v in jnew.params.items():
        np.testing.assert_allclose(tnew.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def planted_transh(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_transh")
    ds = planted_kg(n_ent=150, n_rel=5, n_triples=2000, n_valid=80,
                    n_test=80, dim=8, noise=0.0, seed=1, model="transh")
    save_dataset(ds, str(root / "kg"))
    return root, ds


def test_cli_train_transh_matches_jax_ranks(planted_transh, capsys):
    """``cli.train --model transh --device cpu`` trains (the loss falls),
    ranks relation by relation and exports tables on which the JAX
    package ranks the test triples as the port did (but for near-ties)."""
    root, ds = planted_transh
    out = root / "out"
    summary = train_cli.main([
        "--input", str(root / "kg"), "--output", str(out), "--device", "cpu",
        "--model", "transh", "--hidden_size", "16", "--alpha", "0.01",
        "--margin", "2.0", "--nbatches", "10", "--negative_ent", "2",
        "--train_times", "6", "--valid_every", "3", "--log_every", "100",
        "--test_link_prediction", "--test_triple_classification"])
    printed = capsys.readouterr().out
    assert "link-pred (transh grouped)" in printed
    assert "triple classification: {'accuracy':" in printed
    assert summary["steps"] == 60
    assert summary["epoch_loss"][-1] < 0.8 * summary["epoch_loss"][0]

    tables = import_parameters(str(out / "embedding.vec.json"))
    cfg = Config(model="transh", hidden_size=16)
    jp = {k: np.concatenate([v, np.zeros((1, v.shape[1]), np.float32)])
          for k, v in tables.items()}
    idx = build_kg_index(ds, for_eval=True)
    want = jax_link_prediction(jp, cfg, ds, idx)
    tcfg = port_config(cfg)
    got = link_prediction(params_from_numpy(tables, get_model("transh"),
                                            tcfg, ds.n_ent, ds.n_rel, CPU),
                          tcfg, ds, idx)
    ties = model_near_tie_counts("transh", tables, ds.test, 1)
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - want.ranks[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k
    assert got.filt_avg.mrr == pytest.approx(
        summary["link_prediction"]["filtered_mrr"])


@pytest.mark.parametrize("model", ["transd", "rotate"])
def test_cli_train_runs(planted_transh, tmp_path, model):
    root, _ = planted_transh
    summary = train_cli.main([
        "--input", str(root / "kg"), "--output", str(tmp_path / "o"),
        "--device", "cpu", "--model", model, "--hidden_size", "8",
        "--alpha", "0.01", "--margin", "2.0", "--nbatches", "10",
        "--train_times", "3", "--log_every", "100",
        "--test_link_prediction"])
    assert summary["steps"] == 30
    assert summary["epoch_loss"][-1] < summary["epoch_loss"][0]
    assert 0 < summary["link_prediction"]["filtered_mrr"] <= 1
