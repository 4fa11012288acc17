"""The port's training loop, checkpoints and training CLI on the CPU:
the loss falls, early stopping fires, checkpoints round-trip (across pad
layouts), a resumed run equals an uninterrupted one bit for bit, and the
CLI's TransR tables rank test triples as the JAX package ranks them."""

import os

import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import planted_kg, random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu_torch.ckpt import (CheckpointManager,
                                          import_parameters, latest_step)
from openkeonspark_tpu_torch.cli import train as train_cli
from openkeonspark_tpu_torch.models import get_model, strip_padding
from openkeonspark_tpu_torch.runtime import NotPortedError
from openkeonspark_tpu_torch.train.loop import train
from openkeonspark_tpu_torch.train.step import init_state

from torch_parity import transr_near_tie_counts

CPU = torch.device("cpu")
QUIET = dict(echo=lambda *_: None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Training here is many tiny ops; torch's intra-op threads only
    contend with the other test workers for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def transr_cfg(**kw):
    base = dict(model="transr", ent_size=16, rel_size=8, alpha=0.01,
                margin=2.0, negative_ent=2, nbatches=10, train_times=8,
                steps_per_scan=4, log_every=100)
    base.update(kw)
    return Config(**base)


def test_transr_loss_decreases():
    ds = planted_kg(n_ent=120, n_rel=4, n_triples=1500, n_valid=60,
                    n_test=60, dim=8, noise=0.0, seed=1, model="transr")
    res = train(transr_cfg(), ds, CPU, **QUIET)
    losses = [h.loss for h in res.history]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert res.state.step == 80
    assert all(h.triples_per_sec > 0 for h in res.history)


def test_early_stopping_fires():
    ds = random_kg(n_ent=80, n_rel=6, n_triples=800, n_valid=60, n_test=40,
                   seed=9)
    calls = []

    def fake_valid(state):
        calls.append(state.step)
        return 0.5            # never improves after the first check

    cfg = transr_cfg(train_times=50, valid_every=1, early_stop_patience=2)
    res = train(cfg, ds, CPU, valid_fn=fake_valid, **QUIET)
    assert res.stopped_early
    assert len(res.history) == 3 and len(calls) == 3
    assert res.best_epoch == 0 and res.best_valid_accuracy == 0.5


def test_checkpoint_roundtrip(tmp_path):
    ds = random_kg(n_ent=60, n_rel=5, n_triples=600, n_valid=20, n_test=20,
                   seed=4)
    cfg = transr_cfg(train_times=2)
    ck = str(tmp_path / "ck")
    res = train(cfg, ds, CPU, checkpoint_dir=ck, **QUIET)
    assert latest_step(ck) == res.state.step == 20
    fresh = init_state(get_model("transr"), cfg, ds.n_ent, ds.n_rel,
                       torch.Generator().manual_seed(99), CPU)
    back, manifest = CheckpointManager(ck).restore(fresh)
    assert back.step == 20 and manifest["final"] is True
    for k, v in res.state.params.items():
        assert torch.equal(back.params[k], v), k


def test_restore_across_padding_layouts(tmp_path):
    """Tables written with another pad layout restore by their logical
    rows; fewer stored rows than the vocabulary is refused; a step
    directory without the port's state file (an orbax one) is refused."""
    cfg = transr_cfg()
    model = get_model("transr")
    st8 = init_state(model, cfg, 61, 5, torch.Generator().manual_seed(1),
                     CPU, pad_to_multiple=8)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, st8)
    tmpl = init_state(model, cfg, 61, 5, torch.Generator().manual_seed(2),
                      CPU)
    logical = {n: s.rows for n, s in model.tables(cfg, 61, 5).items()}
    back, _ = mgr.restore(tmpl, step=3, logical_rows=logical)
    specs = model.tables(cfg, 61, 5)
    a, b = strip_padding(st8.params, specs), strip_padding(back.params, specs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert back.params[k].shape == tmpl.params[k].shape
    assert back.step == 0

    big = init_state(model, cfg, 100, 5, torch.Generator().manual_seed(2),
                     CPU)
    with pytest.raises(ValueError, match="vocabulary mismatch"):
        mgr.restore(big, step=3, logical_rows={
            n: s.rows for n, s in model.tables(cfg, 100, 5).items()})
    os.makedirs(tmp_path / "ck" / "step_9")
    with pytest.raises(ValueError, match="orbax"):
        mgr.restore(tmpl)


@pytest.mark.parametrize("model,opt,negative_rel", [
    pytest.param("transr", "sgd", 0, id="transr"),
    pytest.param("transe", "sgd", 0, id="transe"),
    pytest.param("transr", "adagrad", 0, id="transr-adagrad"),
    pytest.param("transe", "adagrad", 0, id="transe-adagrad"),
    pytest.param("transr", "adagrad", 1, id="transr-generic-adagrad")])
def test_exact_resume_data_order(tmp_path, model, opt, negative_rel):
    """Two epochs straight equal one epoch, a restore from its checkpoint
    and one more epoch, bit for bit, tables and optimizer state: each
    group's random bits derive from the restored global step."""
    ds = random_kg(n_ent=80, n_rel=5, n_triples=800, n_valid=30, n_test=30,
                   seed=3)
    cfg = transr_cfg(model=model, hidden_size=8, nbatches=7,
                     steps_per_scan=3, train_times=2, opt_method=opt,
                     negative_rel=negative_rel)
    full = train(cfg, ds, CPU, **QUIET)
    ck = str(tmp_path / "ck")
    train(cfg.replace(train_times=1), ds, CPU, checkpoint_dir=ck, **QUIET)
    fresh = init_state(get_model(model), cfg, ds.n_ent, ds.n_rel,
                       torch.Generator().manual_seed(7), CPU)
    state, _ = CheckpointManager(ck).restore(fresh)
    assert state.step == 7
    resumed = train(cfg.replace(train_times=1), ds, CPU, state=state,
                    **QUIET)
    assert resumed.state.step == full.state.step == 14
    for k, v in full.state.params.items():
        assert torch.equal(resumed.state.params[k], v), k
    assert set(resumed.state.opt_state) == set(full.state.opt_state)
    for s, tables in full.state.opt_state.items():
        for k, v in tables.items():
            assert torch.equal(resumed.state.opt_state[s][k], v), (s, k)


@pytest.mark.parametrize("opt", ["adam", "adagrad", "adadelta"])
def test_optimizer_state_restores_across_padding_layouts(tmp_path, opt):
    """The lazy optimizers' slots restore by their logical rows across pad
    layouts, exactly; extra pad rows keep the template's initial value."""
    cfg = transr_cfg(opt_method=opt)
    model = get_model("transr")
    logical = {n: s.rows for n, s in model.tables(cfg, 61, 5).items()}
    g = torch.Generator().manual_seed(3)
    for pad_from, pad_to in ((8, 1), (1, 8)):
        src = init_state(model, cfg, 61, 5, torch.Generator().manual_seed(1),
                         CPU, pad_to_multiple=pad_from)
        for tables in src.opt_state.values():
            for k, v in tables.items():
                v[:logical[k]] = torch.rand(logical[k], v.shape[1],
                                            generator=g)
        mgr = CheckpointManager(str(tmp_path / f"ck{pad_from}"))
        mgr.save(4, src)
        tmpl = init_state(model, cfg, 61, 5,
                          torch.Generator().manual_seed(2), CPU,
                          pad_to_multiple=pad_to)
        back, _ = mgr.restore(tmpl, step=4, logical_rows=logical)
        assert set(back.opt_state) == set(tmpl.opt_state) == set(
            {"adam": ("m", "v"), "adagrad": ("accum",),
             "adadelta": ("accum", "accum_update")}[opt])
        for s, tables in back.opt_state.items():
            for k, v in tables.items():
                n = logical[k]
                assert v.shape == tmpl.opt_state[s][k].shape
                assert torch.equal(v[:n], src.opt_state[s][k][:n]), (s, k)
                assert torch.equal(v[n:], tmpl.opt_state[s][k][n:]), (s, k)


@pytest.fixture(scope="module")
def planted_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    ds = planted_kg(n_ent=150, n_rel=5, n_triples=2000, n_valid=80,
                    n_test=80, dim=8, noise=0.0, seed=1, model="transr")
    save_dataset(ds, str(root / "kg"))
    return root, ds


def _argv(root, out, *extra):
    return ["--input", str(root / "kg"), "--output", str(out), "--device",
            "cpu", "--model", "transr", "--ent_size", "16", "--rel_size",
            "8", "--alpha", "0.01", "--margin", "2.0", "--nbatches", "10",
            "--negative_ent", "2", "--log_every", "100", *extra]


def _assert_ranks_match_jax(out, ds, summary, cfg):
    """The export in ``out`` has the model's shapes, and the JAX package
    ranks the test triples on it as the port's closing link prediction
    did, but for near-ties."""
    tables = import_parameters(str(out / "embedding.vec.json"))
    specs = get_model("transr").tables(cfg, ds.n_ent, ds.n_rel)
    assert {k: v.shape for k, v in tables.items()} == {
        k: (s.rows, s.dim) for k, s in specs.items()}
    jp = {k: np.concatenate([v, np.zeros((1, v.shape[1]), np.float32)])
          for k, v in tables.items()}
    idx = build_kg_index(ds, for_eval=True)
    want = jax_link_prediction(jp, cfg, ds, idx)
    from openkeonspark_tpu_torch.ckpt import params_from_numpy
    from openkeonspark_tpu_torch.eval import link_prediction
    got = link_prediction(params_from_numpy(tables, get_model("transr"),
                                            cfg, ds.n_ent, ds.n_rel, CPU),
                          cfg, ds, idx)
    ties = transr_near_tie_counts(tables["ent_embeddings"],
                                  tables["rel_embeddings"],
                                  tables["transfer_matrix"], ds.test, 1)
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - want.ranks[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k
    assert got.filt_avg.mrr == pytest.approx(
        summary["link_prediction"]["filtered_mrr"])


def test_cli_train_end_to_end_matches_jax_ranks(planted_dir, capsys):
    """``cli.train --device cpu`` trains, checkpoints and exports
    ``embedding.vec.json``; the JAX package ranks the test triples on the
    exported tables as the port's closing link prediction did (but for
    near-ties); a second call resumes and trains the remaining epoch."""
    root, ds = planted_dir
    out = root / "out"
    summary = train_cli.main(_argv(
        root, out, "--train_times", "4", "--valid_every", "2",
        "--test_link_prediction", "--test_triple_classification"))
    printed = capsys.readouterr().out
    assert "link-pred (transr grouped)" in printed
    assert "triple classification: {'accuracy':" in printed
    assert summary["steps"] == 40 and latest_step(str(out)) == 40
    assert summary["epoch_loss"][-1] < summary["epoch_loss"][0]
    assert 0 < summary["link_prediction"]["filtered_mrr"] <= 1

    _assert_ranks_match_jax(out, ds, summary, transr_cfg())

    again = train_cli.main(_argv(root, out, "--train_times", "5"))
    assert "resumed from" in capsys.readouterr().out
    assert again["steps"] == 50 and len(again["epoch_loss"]) == 1


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_cli_train_transr_relation_negatives(planted_dir, tmp_path, capsys,
                                             opt):
    """``cli.train --model transr --negative_rel 1`` takes the generic
    step, whose 4,096-wide ``transfer_matrix`` rows are updated through
    B5 (its plain version here; with Adagrad the gradient sum G is): the
    loss falls, the export ranks as in the JAX package but for
    near-ties."""
    root, ds = planted_dir
    out = tmp_path / "out"
    summary = train_cli.main(_argv(
        root, out, "--train_times", "3", "--negative_rel", "1",
        "--opt_method", opt, "--ent_size", "64", "--rel_size", "64",
        "--test_link_prediction"))
    assert "link-pred (transr grouped)" in capsys.readouterr().out
    assert summary["steps"] == 30 and latest_step(str(out)) == 30
    assert np.isfinite(summary["epoch_loss"]).all()
    assert summary["epoch_loss"][-1] < summary["epoch_loss"][0]
    _assert_ranks_match_jax(out, ds, summary,
                            transr_cfg(ent_size=64, rel_size=64))


@pytest.mark.parametrize("extra", [
    ["--model", "complex"],
    ["--exchange_hot_rows", "4", "--exchange_capacity", "stats"],
    ["--sampler", "host"], ["--mesh_model", "2"], ["--batch_number", "1"],
    ["--model", "distmult"], ["--type_constrain"]])
def test_cli_train_refuses_unported_options(planted_dir, tmp_path, extra):
    root, _ = planted_dir
    with pytest.raises(NotPortedError, match="ROADMAP"):
        train_cli.main(_argv(root, tmp_path / "o", "--train_times", "1")
                       + extra)
    assert not (tmp_path / "o").exists()


def test_cli_train_cuda_without_card_raises(planted_dir, tmp_path,
                                            monkeypatch):
    root, _ = planted_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(root, tmp_path / "o", "--train_times", "1")
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        train_cli.main(argv)
