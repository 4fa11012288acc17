"""The port's file tools and its sampler's and memory ledger's numbers
against the JAX package's tools: ``split_incremental`` and
``gen_type_constrain`` write byte-identical folders and files to the JAX
tools (run as scripts), ``acceptance.make_stand_ins`` the same stand-ins as
the JAX function, ``hbm_budget.budget`` the JAX formula exactly at the JAX
tool's constants; ``DeviceSampler.store_bytes`` counts the store's
tensors, and a store larger than a memory budget trains through the host
sampler (the port's version of ``tests/test_host_sampler.py:157``)."""

import filecmp
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import (build_kg_index, planted_kg,
                                          random_kg, save_dataset)
from openkeonspark_tpu_torch.sampling.device import DeviceSampler
from openkeonspark_tpu_torch.tools import (acceptance, gen_type_constrain,
                                           hbm_budget, split_incremental)
from openkeonspark_tpu_torch.train.loop import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _jax_tool(name):
    """A JAX tool module loaded from its file (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, *argv):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{name}.py"), *argv],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _same_tree(a, b):
    """Every file under ``a`` and ``b`` exists on both sides with the
    same bytes."""
    files = lambda d: sorted(  # noqa: E731
        os.path.relpath(os.path.join(r, f), d)
        for r, _, fs in os.walk(d) for f in fs)
    assert files(a) == files(b) and files(a)
    for f in files(a):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


@pytest.fixture(scope="module")
def kg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kg")
    save_dataset(random_kg(n_ent=120, n_rel=7, n_triples=1500, n_valid=60,
                           n_test=70, seed=3), str(d))
    return d


@pytest.mark.parametrize("n_batches,seed", [(3, 0), (2, 5)])
def test_split_incremental_matches_jax_tool(kg_dir, tmp_path, n_batches,
                                            seed):
    argv = ["--input", str(kg_dir), "--num_batches", str(n_batches),
            "--seed", str(seed)]
    want = _run_jax_tool("split_incremental", *argv, "--output",
                         str(tmp_path / "jax"))
    got = split_incremental.main(argv + ["--output", str(tmp_path / "port")])
    assert len(got) == n_batches
    _same_tree(tmp_path / "jax", tmp_path / "port")
    assert want.count("batch ") == n_batches


@pytest.mark.parametrize("splits", ["all", "train"])
def test_gen_type_constrain_matches_jax_tool(kg_dir, tmp_path, splits):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    for d in (jax_dir, port_dir):
        for f in os.listdir(kg_dir):
            os.makedirs(d, exist_ok=True)
            with open(kg_dir / f, "rb") as src, open(d / f, "wb") as dst:
                dst.write(src.read())
    _run_jax_tool("gen_type_constrain", "--input", str(jax_dir),
                  "--splits", splits)
    out = gen_type_constrain.main(["--input", str(port_dir), "--splits",
                                   splits])
    assert out == os.path.join(str(port_dir), "type_constrain.txt")
    _same_tree(jax_dir, port_dir)


@pytest.mark.parametrize("quick", [True, False])
def test_make_stand_ins_matches_jax(tmp_path, quick):
    _jax_tool("acceptance").make_stand_ins(str(tmp_path / "jax"), quick)
    acceptance.make_stand_ins(str(tmp_path / "port"), quick)
    _same_tree(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("opt", ["sgd", "adam", "adagrad"])
@pytest.mark.parametrize("config", [2, 5])
def test_hbm_budget_equals_jax_formula(opt, config):
    """At the JAX tool's constants (16 GB, 76 B a triple) the port's
    ``budget`` gives the JAX row exactly, for every grid of its ``main``
    (hot rows on the 3-axis grids, as there)."""
    jt = _jax_tool("hbm_budget")
    spec = jt.CONFIG5 if config == 5 else jt.CONFIG2
    assert spec == (hbm_budget.CONFIG5 if config == 5
                    else hbm_budget.CONFIG2)
    assert jt.OPT_SLOTS == hbm_budget.OPT_SLOTS
    for mesh in [(1, 1), (2, 2), (2, 2, 2), (4, 2, 2)]:
        hot = 4096 if len(mesh) == 3 else 0
        want = jt.budget(spec, mesh, opt=opt, hot_rows=hot)
        got = hbm_budget.budget(spec, mesh, opt=opt, hot_rows=hot,
                                store_b_per_triple=jt.STORE_B_PER_TRIPLE,
                                hbm_bytes=jt.HBM_BYTES)
        assert got == want, mesh


def test_hbm_budget_cpu_measures_the_ports_store(capsys):
    """On the CPU: no device memory, so no ``hbm_frac`` / ``fits``; the
    store's bytes a triple are the port's (int64 records and windows: 96
    B a triple and the Bernoulli table), not the TPU's 76."""
    out = hbm_budget.main(["--config", "2", "--device", "cpu"])
    assert out["device"] == "cpu" and out["hbm_bytes"] is None
    assert 96.0 <= out["store_B_per_triple"] < 96.5
    assert len(out["rows"]) == 4
    for r in out["rows"]:
        assert "hbm_frac" not in r and "fits" not in r
    assert "no card" in capsys.readouterr().out


def test_store_bytes_counts_the_store_tensors():
    ds = random_kg(n_ent=150, n_rel=9, n_triples=3000, n_valid=0,
                   n_test=0, seed=2)
    idx = build_kg_index(ds, for_eval=False)
    s = DeviceSampler.build(ds, idx, CPU)
    tensors = (s.trip, s.ent_adj, s.rel_adj, s.p_corrupt_head)
    assert s.store_bytes() == sum(t.numel() * t.element_size()
                                  for t in tensors)
    # the layout: nine int64 fields a triple, one int64 window entry per
    # (h, r), (t, r) and (h, t) group member, one float32 per relation
    assert s.store_bytes() == (72 * ds.n_train + 8 * (
        len(idx.hr.adj) + len(idx.tr.adj) + len(idx.ht.adj))
        + 4 * ds.n_rel)


def test_host_pipeline_niche_store_exceeding_hbm_budget():
    """A KG whose device-sampler store exceeds a configured memory budget
    (the host sampler's purpose) trains end to end through the host
    pipeline: the loss falls and stays finite (as the JAX package's
    ``tests/test_host_sampler.py:157-192``)."""
    ds = planted_kg(n_ent=800, n_rel=8, n_triples=30000, n_valid=200,
                    n_test=200, dim=8, noise=0.0, seed=4)
    idx = build_kg_index(ds, for_eval=False)
    dev_store = DeviceSampler.build(ds, idx, CPU).store_bytes()
    hbm_budget_bytes = 1 << 20
    assert dev_store > hbm_budget_bytes, (dev_store, hbm_budget_bytes)
    assert dev_store < 120 * ds.n_train
    cfg = Config(model="transe", hidden_size=16, alpha=0.1, margin=2.0,
                 train_times=8, nbatches=20, negative_ent=2,
                 sampler="host", work_threads=2, valid_every=0, seed=3)
    res = train(cfg, ds, CPU, index=idx, echo=lambda *a, **k: None)
    losses = [ep.loss for ep in res.history]
    assert losses[-1] < 0.5 * losses[0], losses
    assert np.isfinite(losses).all()
