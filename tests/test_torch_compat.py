"""The port's OpenKE-style ``Config`` facade (``openkeonspark_tpu_torch/
compat.py``) through the six flows of ``tests/test_compat.py`` on the CPU,
and its ``test()`` table against the JAX facade's on the same tables."""

import json
import os

import numpy as np
import pytest

from openkeonspark_tpu import compat as jax_compat
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.synth import planted_kg
from openkeonspark_tpu_torch import compat
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.compat import Config, TransE, TransH
from openkeonspark_tpu_torch.models import get_model


def _quiet(*_a, **_k):
    return None


@pytest.fixture(scope="module")
def kg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kg")
    save_dataset(planted_kg(n_ent=120, n_rel=5, n_triples=2000, n_valid=100,
                            n_test=100, dim=8, noise=0.0, seed=2), str(d))
    return str(d)


def test_reference_script_flow(kg_dir, tmp_path):
    con = Config(device="cpu")
    con.set_in_path(kg_dir)
    con.set_out_path(str(tmp_path / "out"))
    con.set_work_threads(2)
    con.set_train_times(8)
    con.set_nbatches(10)
    con.set_alpha(0.1)
    con.set_margin(2.0)
    con.set_bern(1)
    con.set_dimension(16)
    con.set_ent_neg_rate(2)
    con.set_rel_neg_rate(0)
    con.set_opt_method("SGD")
    con.set_test_link_prediction(True)
    con.set_test_triple_classification(True)
    con.init()
    con.set_model(TransE)
    result = con.run(echo=_quiet)
    assert result.history[-1].loss < result.history[0].loss

    lines = []
    out = con.test(echo=lines.append)
    assert "link_prediction" in out and "triple_classification" in out
    assert 0.0 <= out["link_prediction"].filt_avg.mrr <= 1.0
    assert any("hit@10" in str(line) for line in lines)

    h, t, r = map(int, con._ds.test[0])
    tails = con.predict_tail_entity(h, r, k=5)
    assert len(tails) == 5 and all(0 <= i < 120 for i in tails)
    heads = con.predict_head_entity(t, r, k=5)
    assert len(heads) == 5
    rels = con.predict_relation(h, t, k=3)
    assert len(rels) == 3 and all(0 <= i < 5 for i in rels)
    verdict = con.predict_triple(h, t, r)
    assert set(verdict) == {"score", "threshold", "is_true"}

    p = con.get_parameters()
    assert p["ent_embeddings"].shape == (120, 16)
    path = str(tmp_path / "embedding.vec.json")
    con.save_parameters(path)
    with open(path) as f:
        blob = json.load(f)
    np.testing.assert_allclose(np.array(blob["rel_embeddings"]),
                               p["rel_embeddings"], rtol=1e-6)


def test_set_import_files_restores_trained_state(kg_dir, tmp_path):
    """set_import_files → init → set_model evaluates the trained tables,
    bit for bit, and an armed path without a checkpoint raises."""
    out = str(tmp_path / "ckpt")
    con = Config(device="cpu")
    con.set_in_path(kg_dir)
    con.set_out_path(out)
    con.set_train_times(3)
    con.set_nbatches(5)
    con.set_dimension(8)
    con.init()
    con.set_model(TransE)
    con.run(echo=_quiet)
    trained = con.get_parameters()

    con2 = Config(device="cpu")
    con2.set_in_path(kg_dir)
    con2.set_import_files(out)
    con2.set_dimension(8)
    con2.init()
    con2.set_model(TransE)
    restored = con2.get_parameters()
    for k in trained:
        np.testing.assert_array_equal(trained[k], restored[k], err_msg=k)

    con3 = Config(device="cpu")
    con3.set_in_path(kg_dir)
    con3.set_import_files(str(tmp_path / "empty"))
    con3.set_dimension(8)
    con3.init()
    with pytest.raises(FileNotFoundError):
        con3.set_model(TransE)


def test_set_model_accepts_class_marker_and_dims(kg_dir):
    con = Config(device="cpu")
    con.set_in_path(kg_dir)
    con.set_train_times(1)
    con.set_nbatches(5)
    con.set_dimension(8)
    con.init()
    con.set_model(TransH)
    assert con.cfg.model == "transh"

    class TransR:  # the reference passes the model CLASS
        pass
    con2 = Config(device="cpu")
    con2.set_in_path(kg_dir)
    con2.set_ent_dimension(8)
    con2.set_rel_dimension(4)
    con2.set_dimension(8)
    con2.init()
    con2.set_model(TransR)
    assert con2.cfg.model == "transr"
    assert con2.cfg.d_rel == 4
    with pytest.raises(ValueError, match="unknown model"):
        con2.set_model("rotate")       # as the JAX facade: no RotatE


def test_set_opt_method_accepts_reference_names(kg_dir):
    """SGD/Adagrad/Adadelta/Adam in loose capitalization each map to a
    working optimizer."""
    for name in ("SGD", "Adagrad", "Adadelta", "Adam", "adagrad"):
        con = Config(device="cpu")
        con.set_in_path(kg_dir)
        con.set_train_times(1)
        con.set_nbatches(5)
        con.set_dimension(8)
        con.set_opt_method(name)
        con.init()
        con.set_model(TransE)
        assert con.cfg.opt_method == name.lower()


def test_setter_walk_full_reference_surface(kg_dir):
    """Every setter of the JAX facade exists here, lands in the effective
    cfg, and the facade has no setter the JAX facade lacks."""
    con = Config(device="cpu")
    calls = [
        ("set_in_path", (kg_dir,), "in_path", kg_dir),
        ("set_out_path", ("/tmp/x",), "out_path", "/tmp/x"),
        ("set_work_threads", (3,), "work_threads", 3),
        ("set_train_times", (7,), "train_times", 7),
        ("set_nbatches", (9,), "nbatches", 9),
        ("set_alpha", (0.02,), "alpha", 0.02),
        ("set_margin", (4.0,), "margin", 4.0),
        ("set_bern", (0,), "bern", False),
        ("set_dimension", (16,), "hidden_size", 16),
        ("set_ent_dimension", (16,), "ent_size", 16),
        ("set_rel_dimension", (8,), "rel_size", 8),
        ("set_ent_neg_rate", (2,), "negative_ent", 2),
        ("set_rel_neg_rate", (1,), "negative_rel", 1),
        ("set_opt_method", ("Adagrad",), "opt_method", "adagrad"),
        ("set_test_link_prediction", (True,), "test_link_prediction", True),
        ("set_test_triple_classification", (True,),
         "test_triple_classification", True),
        ("set_valid_steps", (5,), "valid_every", 5),
        ("set_early_stopping_patience", (3,), "early_stop_patience", 3),
        ("set_seed", (11,), "seed", 11),
        ("set_p_norm", (2,), "p_norm", 2),
        ("set_log_on", (0,), "log_every", 0),
    ]
    for name, args, field, want in calls:
        getattr(con, name)(*args)
        assert getattr(con.cfg, field) == want, (name, field)
    con.set_import_files("/tmp/none")
    con.set_export_files("/tmp/x", 2)
    con.set_export_steps(3)
    assert con._export_steps == 3
    surface = {n for n in dir(jax_compat.Config) if not n.startswith("_")}
    assert {n for n in dir(Config) if not n.startswith("_")} == surface
    assert not hasattr(compat, "RotatE")


def test_export_steps_periodic_export(kg_dir, tmp_path, monkeypatch):
    """set_export_files(path, steps) exports vec.json every ``steps``
    epochs during run()."""
    out = str(tmp_path / "exp")
    con = Config(device="cpu")
    con.set_in_path(kg_dir)
    con.set_train_times(4)
    con.set_nbatches(5)
    con.set_dimension(8)
    con.set_log_on(0)
    con.set_export_files(out, 2)
    con.init()
    con.set_model(TransE)
    seen = []
    import openkeonspark_tpu_torch.ckpt.checkpoint as ck
    orig = ck.export_parameters

    def spy(*a, **k):
        seen.append(a[5])
        return orig(*a, **k)

    monkeypatch.setattr(ck, "export_parameters", spy)
    con.run(echo=_quiet)
    assert len(seen) == 2, seen       # epochs 2 and 4 (1-based)
    p = os.path.join(out, "embedding.vec.json")
    assert os.path.exists(p)
    with open(p) as f:
        assert "ent_embeddings" in json.load(f)


def test_test_table_equals_jax_facade(kg_dir):
    """Both facades on the same tables (the JAX facade's fresh init carried
    over): ``test()`` prints the same link-prediction table."""
    jcon = jax_compat.Config()
    jcon.set_in_path(kg_dir)
    jcon.set_dimension(12)
    jcon.set_test_link_prediction(True)
    jcon.init()
    jcon.set_model(TransE)
    want = []
    jcon.test(echo=want.append)

    con = Config(device="cpu")
    con.set_in_path(kg_dir)
    con.set_dimension(12)
    con.set_test_link_prediction(True)
    con.init()
    con.set_model(TransE)
    con._state.params.update(params_from_numpy(
        {k: np.asarray(v) for k, v in jcon._state.params.items()},
        get_model("transe"), con.cfg, con._ds.n_ent, con._ds.n_rel,
        con.device))
    got = []
    con.test(echo=got.append)
    assert got == want
