"""The port's evaluate CLI: same printout as the JAX package on a JAX
export, no silent device fallback, refusals of unported options, and no
jax import."""

import contextlib
import io
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
from openkeonspark_tpu.eval import predict_head_entity as jax_predict_head
from openkeonspark_tpu.eval import predict_relation as jax_predict_rel
from openkeonspark_tpu.eval import predict_tail_entity as jax_predict_tail
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.cli import evaluate

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


@pytest.mark.parametrize("extra", [["--num_processes", "2"],
                                   ["--mesh_model", "2"]])
def test_cli_refuses_unported_options(exported, extra):
    """Grid evaluation is ported (``tests/test_torch_parallel_eval.py``),
    but it needs a process group: more than one process without
    ``--coordinator``, and a grid without a process group, are
    refused."""
    root = exported[0]
    with pytest.raises((ValueError, RuntimeError),
                       match="coordinator|process group"):
        evaluate.main(_argv(root, "--device", "cpu", "--link_prediction")
                      + extra)


def test_cli_eval_dtype_bf16_prints_jax_table(exported, capsys,
                                             monkeypatch):
    """``--eval_dtype bfloat16`` on TransE's kernel route (B1's plain
    version here) prints the JAX package's bf16 table (its kernel route, in
    interpret mode), which is its fp32 table: both kernel routes rank in
    fp32 whatever the flag says."""
    root, ds, cfg, jp = exported
    evaluate.main(_argv(root, "--device", "cpu", "--link_prediction",
                        "--eval_dtype", "bfloat16"))
    out = capsys.readouterr().out
    idx = build_kg_index(ds, for_eval=True)
    monkeypatch.setenv("OKST_PALLAS_INTERPRET", "1")
    want = jax_link_prediction(jp, cfg.replace(eval_dtype="bfloat16"), ds,
                               idx).format_table()
    assert want in out
    assert want == jax_link_prediction(jp, cfg, ds, idx).format_table()


def test_cli_type_constrain_prints_jax_table(exported, tmp_path, capsys):
    """``--type_constrain`` prints the unconstrained table, then
    ``type-constrained:`` and the JAX package's constrained table on the
    same tables; without ``type_constrain.txt`` it says so."""
    from openkeonspark_tpu.data.type_constrain import (
        build_type_constraints, save_type_constraints)
    from openkeonspark_tpu.eval import type_constrained_link_prediction
    root, ds, cfg, jp = exported
    save_dataset(ds, str(tmp_path / "kg"))
    tc = build_type_constraints(ds)
    save_type_constraints(tc, str(tmp_path / "kg" / "type_constrain.txt"))
    argv = ["--input", str(tmp_path / "kg")] + _argv(root)[2:] + [
        "--device", "cpu", "--link_prediction", "--type_constrain"]
    evaluate.main(argv)
    out = capsys.readouterr().out
    idx = build_kg_index(ds, for_eval=True)
    want = type_constrained_link_prediction(jp, cfg, ds, idx, tc)
    assert jax_link_prediction(jp, cfg, ds, idx).format_table() in out
    assert "type-constrained:\n" + want.format_table() in out
    evaluate.main(_argv(root, "--device", "cpu", "--link_prediction",
                        "--type_constrain"))
    out = capsys.readouterr().out
    assert "type_constrain.txt not found in dataset dir" in out
    assert "type-constrained:" not in out


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
    """TransR's ``--predict_*`` queries are ported, in fp32 and with
    ``--eval_dtype bfloat16`` (the query and the candidate scores in
    bf16): each prints the JAX package's top-k ids at the same eval
    dtype."""
    root, ds, cfg, jp = exported_transr
    a, b = map(int, query[1].split(","))
    k = 4 if query[0] == "--predict_rel" else 5
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(eval_dtype=dtype)
        ref = {"--predict_tail": lambda: jax_predict_tail(
                   jp, c, ds.n_ent, ds.n_rel, a, b, k=5),
               "--predict_head": lambda: jax_predict_head(
                   jp, c, ds.n_ent, ds.n_rel, a, b, k=5),
               "--predict_rel": lambda: jax_predict_rel(
                   jp, c, ds.n_ent, ds.n_rel, a, b, k=4)}[query[0]]
        with contextlib.redirect_stdout(io.StringIO()) as out:
            evaluate.main(_transr_argv(root, *query, "--topk", str(k),
                                       "--eval_dtype", dtype))
        ids = [int(line.split()[0]) for line in out.getvalue().splitlines()
               if line.startswith("  ")]
        assert ids == ref()[0].tolist(), dtype


def test_port_imports_no_jax():
    """In a fresh interpreter whose import system refuses ``jax``,
    ``jaxlib`` and the JAX package ``openkeonspark_tpu`` (the exact
    top-level name: ``openkeonspark_tpu_torch`` stays importable), every
    module of the port, ``chip_smoke`` (its ``main`` is guarded) and the
    multi-process tests' rank module ``tests/torch_dist_worker.py`` load."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'openkeonspark_tpu')\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'blocked import of {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "import openkeonspark_tpu_torch as pkg\n"
        "names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name, path in (('chip_smoke', 'chip_smoke.py'),\n"
        "                   ('torch_dist_worker',\n"
        "                    'tests/torch_dist_worker.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "for name in BLOCKED:\n"
        "    try:\n"
        "        importlib.import_module(name)\n"
        "    except ImportError:\n"
        "        pass\n"
        "    else:\n"
        "        raise AssertionError(f'{name} was not blocked')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "assert len(names) > 30, names\n"
        "assert {'openkeonspark_tpu_torch.models.distmult',\n"
        "        'openkeonspark_tpu_torch.models.complexe',\n"
        "        'openkeonspark_tpu_torch.compat',\n"
        "        'openkeonspark_tpu_torch.eval.type_constrained',\n"
        "        'openkeonspark_tpu_torch.data.type_constrain',\n"
        "        'openkeonspark_tpu_torch.sampling.host',\n"
        "        'openkeonspark_tpu_torch.parallel.mesh',\n"
        "        'openkeonspark_tpu_torch.parallel.sharded',\n"
        "        'openkeonspark_tpu_torch.parallel.exchange',\n"
        "        'openkeonspark_tpu_torch.parallel.eval',\n"
        "        'openkeonspark_tpu_torch.cli.launch',\n"
        "        'openkeonspark_tpu_torch.tools.bench_all',\n"
        "        'openkeonspark_tpu_torch.tools.acceptance',\n"
        "        'openkeonspark_tpu_torch.tools.eval_profile'} <= set(names)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
