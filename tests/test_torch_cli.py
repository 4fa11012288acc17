"""The port's evaluate CLI: same printout as the JAX package on a JAX
export, no silent device fallback, refusals of unported options, and no
jax import."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ckpt import export_parameters as jax_export
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import planted_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.cli import evaluate
from openkeonspark_tpu_torch.runtime import NotPortedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A planted KG on disk and a JAX export of seeded tables beside it."""
    root = tmp_path_factory.mktemp("cli")
    ds = planted_kg(n_ent=120, n_rel=5, n_triples=1500, n_valid=60,
                    n_test=60, dim=8, noise=0.0, seed=1)
    save_dataset(ds, str(root / "kg"))
    cfg = Config(model="transe", hidden_size=12, eval_chunk=32)
    st = init_state(jax_get_model("transe"), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(2))
    jax_export(st.params, jax_get_model("transe"), cfg, ds.n_ent, ds.n_rel,
               str(root / "ckpt" / "embedding.vec.json"))
    return root, ds, cfg, st.params


def _argv(root, *extra):
    return ["--input", str(root / "kg"), "--checkpoint", str(root / "ckpt"),
            "--model", "transe", "--hidden_size", "12", "--eval_chunk", "32",
            *extra]


def test_cli_prints_jax_table(exported, capsys):
    root, ds, cfg, jp = exported
    evaluate.main(_argv(root, "--device", "cpu", "--link_prediction",
                        "--triple_classification", "--predict_tail", "0,0",
                        "--predict_rel", "0,1", "--topk", "5"))
    out = capsys.readouterr().out
    want = jax_link_prediction(jp, cfg, ds,
                               build_kg_index(ds, for_eval=True))
    assert want.format_table() in out
    assert "triple classification: {'accuracy':" in out
    assert "top-5 tails for (0, r=0, ?):" in out
    assert "top-5 relations for (0, ?, 1):" in out


def test_cli_cuda_without_card_raises(exported, monkeypatch):
    root = exported[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        evaluate.main(_argv(root, "--device", "cuda", "--link_prediction"))


@pytest.mark.parametrize("extra", [["--model", "distmult"],
                                   ["--mesh_model", "2"],
                                   ["--type_constrain"],
                                   ["--eval_dtype", "bfloat16"]])
def test_cli_refuses_unported_options(exported, extra):
    root = exported[0]
    with pytest.raises(NotPortedError, match="ROADMAP"):
        evaluate.main(_argv(root, "--device", "cpu", "--link_prediction")
                      + extra)


@pytest.fixture(scope="module")
def exported_transr(tmp_path_factory):
    """A planted KG on disk and a JAX export of seeded TransR tables."""
    root = tmp_path_factory.mktemp("cli_transr")
    ds = planted_kg(n_ent=100, n_rel=4, n_triples=1200, n_valid=50,
                    n_test=50, dim=8, noise=0.0, seed=2, model="transr")
    save_dataset(ds, str(root / "kg"))
    cfg = Config(model="transr", ent_size=12, rel_size=6, eval_chunk=32)
    st = init_state(jax_get_model("transr"), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(3))
    jax_export(st.params, jax_get_model("transr"), cfg, ds.n_ent, ds.n_rel,
               str(root / "ckpt" / "embedding.vec.json"))
    return root, ds, cfg, st.params


def _transr_argv(root, *extra):
    return ["--input", str(root / "kg"), "--checkpoint", str(root / "ckpt"),
            "--model", "transr", "--ent_size", "12", "--rel_size", "6",
            "--eval_chunk", "32", "--device", "cpu", *extra]


def test_cli_transr_prints_jax_table(exported_transr, capsys):
    """TransR link prediction (relation by relation through the count
    kernel's plain version) prints the JAX package's table on the same
    tables."""
    root, ds, cfg, jp = exported_transr
    evaluate.main(_transr_argv(root, "--link_prediction",
                               "--triple_classification"))
    out = capsys.readouterr().out
    want = jax_link_prediction(jp, cfg, ds,
                               build_kg_index(ds, for_eval=True))
    assert want.format_table() in out
    assert "triple classification: {'accuracy':" in out


@pytest.mark.parametrize("query", [["--predict_tail", "0,0"],
                                   ["--predict_head", "1,0"],
                                   ["--predict_rel", "0,1"]])
def test_cli_transr_refuses_predict(exported_transr, query):
    root = exported_transr[0]
    with pytest.raises(NotPortedError, match="ROADMAP"):
        evaluate.main(_transr_argv(root, *query))


def test_port_imports_no_jax():
    """A fresh interpreter that imports every module of the port loads no
    jax (the JAX package's numpy-only modules it reuses included)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import openkeonspark_tpu_torch.cli.evaluate, "
        "openkeonspark_tpu_torch.cli.train, "
        "openkeonspark_tpu_torch.eval, openkeonspark_tpu_torch.ops.rank, "
        "openkeonspark_tpu_torch.ops.grouped, "
        "openkeonspark_tpu_torch.ops.build, openkeonspark_tpu_torch.data, "
        "openkeonspark_tpu_torch.config, openkeonspark_tpu_torch.ckpt, "
        "openkeonspark_tpu_torch.models.transr, "
        "openkeonspark_tpu_torch.sampling.device, "
        "openkeonspark_tpu_torch.train.loss, "
        "openkeonspark_tpu_torch.train.optim, "
        "openkeonspark_tpu_torch.train.step, "
        "openkeonspark_tpu_torch.train.loop\n"
        "added = set(sys.modules) - before\n"
        "bad = sorted(m for m in added if m.split('.')[0] in "
        "('jax', 'jaxlib'))\n"
        "assert 'jax' not in sys.modules and not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
