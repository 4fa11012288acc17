"""The port's host sampler (``sampling/host.py``) and the host path's step
(``train/step.py::build_host_scan_steps``) against the JAX package's: the
same native sampler source gives bit-identical batches for the same
dataset, seed, bern and partition, in the flat layout, the structured
one and a stacked ``group_sizes`` item; the host path's group of steps
matches the JAX one's (loss rtol 1e-5, tables atol 1e-5, as
``tests/test_torch_step.py:107-111``) for TransE and for TransR on both
routes (B4's and B5's plain versions here). The port builds its own
library from ``native/sampler.cpp`` and never loads the tracked one; a run
resumed from a checkpoint replays the data of an uninterrupted one."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config as JConfig
from openkeonspark_tpu.data.index import build_kg_index as jax_index
from openkeonspark_tpu.data.synth import random_kg as jax_random_kg
from openkeonspark_tpu.models import get_model as jax_model
from openkeonspark_tpu.sampling.device import SampledBatch as JBatch
from openkeonspark_tpu.sampling.host import (HostPipeline as JPipeline,
                                             HostSampler as JHostSampler)
from openkeonspark_tpu.train import step as jstep
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.cli import train as train_cli
from openkeonspark_tpu_torch.data import (build_kg_index, planted_kg,
                                          random_kg, save_dataset)
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.ops.build import BUILD_ROOT
from openkeonspark_tpu_torch.sampling import host
from openkeonspark_tpu_torch.sampling.host import HostPipeline, HostSampler
from openkeonspark_tpu_torch.train import step as tstep

from torch_parity import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KG = dict(n_ent=150, n_rel=7, n_triples=2000, n_valid=50, n_test=50, seed=13)
FIELDS = ("h", "t", "r", "neg_h", "neg_t", "neg_rel")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def samplers():
    jds = jax_random_kg(**KG)
    tds = random_kg(**KG)
    return (JHostSampler(jds, jax_index(jds, for_eval=False), n_threads=4),
            HostSampler(tds, build_kg_index(tds, for_eval=False),
                        n_threads=4))


@pytest.mark.parametrize("seed,negs,bern,partition", [
    (1, (3, 2), True, None), (7, (2, 1), False, None),
    (3, (1, 0), True, (100, 50)), (11, (0, 2), True, (0, 1))])
def test_batches_bit_identical_to_jax(samplers, seed, negs, bern, partition):
    js, ts = samplers
    want = js.sample_flat(seed, 256, *negs, bern, partition=partition)
    got = ts.sample_flat(seed, 256, *negs, bern, partition=partition)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_s = js.sample(seed, 256, *negs, bern, partition=partition)
    got_s = ts.sample(seed, 256, *negs, bern, partition=partition)
    for f in FIELDS:
        a, b = getattr(want_s, f), getattr(got_s, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_group_items_bit_identical_to_jax(samplers):
    """``group_sizes`` stacks consecutive batches of the seed chain into one
    ``[S, …]`` item, cycling through the sizes, as the JAX pipeline does."""
    js, ts = samplers
    kw = dict(batch_size=64, negative_ent=2, negative_rel=1, bern=True,
              seed=5, group_sizes=[3, 2])
    jp, tp = JPipeline(js, **kw), HostPipeline(ts, **kw)
    try:
        for size in (3, 2, 3):
            want, got = jp.next(), tp.next()
            assert got.h.shape == (size, 64) and got.h.dtype == torch.int64
            for f in FIELDS:
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                    err_msg=f)
    finally:
        jp.close()
        tp.close()


def test_pipeline_replays_the_seed_chain(samplers):
    """Item k of a pipeline seeded ``s`` holds batches ``s + k·S …``: a
    pipeline restarted at seed ``cfg.seed + step`` continues the stream."""
    _, ts = samplers
    tp = HostPipeline(ts, 32, 1, 0, True, seed=40, group_sizes=[2])
    try:
        for k in range(2):
            item = tp.next()
            for s in range(2):
                want = ts.sample(40 + 2 * k + s, 32, 1, 0, True)
                np.testing.assert_array_equal(item.neg_t[s].numpy(),
                                              want.neg_t)
    finally:
        tp.close()


def test_library_built_from_source_never_the_tracked_one(samplers):
    """The port's library lies in the build tree under a hash of the
    source, and a process that samples through the port maps no
    ``native/libokst_sampler.so``."""
    path = os.path.realpath(host.library()._name)
    assert path.startswith(os.path.realpath(str(BUILD_ROOT)) + os.sep)
    assert os.path.basename(os.path.dirname(path)).startswith("sampler-")
    code = ("from openkeonspark_tpu_torch.data import random_kg, "
            "build_kg_index\n"
            "from openkeonspark_tpu_torch.sampling.host import HostSampler\n"
            "ds = random_kg(n_ent=50, n_rel=3, n_triples=300, n_valid=5, "
            "n_test=5)\n"
            "HostSampler(ds, build_kg_index(ds)).sample_flat(1, 8, 1, 0, "
            "True)\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'libokst_sampler.so' in maps\n"
            "assert 'native/libokst_sampler.so' not in maps, maps\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


TRANSR = dict(model="transr", ent_size=16, rel_size=8, alpha=0.05,
              margin=1.0)


@pytest.mark.parametrize("kw", [
    dict(model="transe", hidden_size=16, alpha=0.05, negative_ent=2,
         negative_rel=1),
    dict(TRANSR, negative_ent=2),                   # grouped route, B4
    dict(TRANSR, negative_ent=1, negative_rel=1,    # generic route, B5
         grouped_transr=False),
    # the port's grouped route with relation negatives (B4, two streams);
    # the JAX package's generic step
    dict(TRANSR, negative_ent=1, negative_rel=1)],
    ids=["transe", "transr-grouped", "transr-generic", "transr-relneg"])
def test_host_scan_steps_match_jax(samplers, monkeypatch, kw):
    """One stacked group of 3 batches through both packages' host-path
    steps, from the same tables."""
    monkeypatch.setenv("OKST_PALLAS_INTERPRET", "1")
    js, _ = samplers
    cfg = JConfig(**kw)
    tcfg = port_config(cfg)
    assert jstep.use_grouped_transr(cfg) == tstep.use_grouped_transr(tcfg)
    ds = jax_random_kg(**KG)
    model = jax_model(cfg.model)
    state = jstep.init_state(model, cfg, ds.n_ent, ds.n_rel,
                             jax.random.key(3))
    singles = [js.sample(9 + s, 64, cfg.negative_ent, cfg.negative_rel,
                         cfg.bern) for s in range(3)]
    group = JBatch(**{f: None if getattr(singles[0], f) is None
                      else np.stack([getattr(b, f) for b in singles])
                      for f in FIELDS})
    tgroup = tstep.SampledBatch(**{
        f: None if getattr(group, f) is None
        else torch.from_numpy(getattr(group, f)).long() for f in FIELDS})
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in state.params.items()},
        get_model(cfg.model), tcfg, ds.n_ent, ds.n_rel, CPU)
    tstate = tstep.TrainState(tparams, {}, 0)
    jout, jloss = jstep.build_host_scan_steps(model, cfg)(
        state, jax.tree_util.tree_map(jax.numpy.asarray, group))
    tout, tloss = tstep.build_host_scan_steps(get_model(cfg.model), tcfg)(
        tstate, tgroup)
    assert tout.step == 3
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in tparams:
        np.testing.assert_allclose(tout.params[k].numpy(),
                                   np.asarray(jout.params[k]), atol=1e-5,
                                   err_msg=k)


def _argv(data, out, *extra):
    return ["--input", str(data), "--output", str(out), "--device", "cpu",
            "--model", "transe", "--hidden_size", "16", "--alpha", "0.05",
            "--margin", "2.0", "--nbatches", "5", "--negative_ent", "2",
            "--steps_per_scan", "2", "--sampler", "host",
            "--export_format", "npz", *extra]


def test_host_sampler_training_resumes_exactly(tmp_path):
    """``cli.train --sampler host``: the loss falls, and a run stopped after
    two epochs and resumed for two more ends on the tables of a four-epoch
    run, bit for bit (the worker's seed chain starts at ``cfg.seed`` plus
    the restored step; groups of 2, 2 and 1 steps)."""
    data = tmp_path / "kg"
    save_dataset(planted_kg(n_ent=120, n_rel=5, n_triples=1500, n_valid=40,
                            n_test=40, dim=8, noise=0.0, seed=1), str(data))
    full = train_cli.main(_argv(data, tmp_path / "a", "--train_times", "4"))
    assert full["epoch_loss"][-1] < full["epoch_loss"][0]
    train_cli.main(_argv(data, tmp_path / "b", "--train_times", "2"))
    resumed = train_cli.main(_argv(data, tmp_path / "b", "--train_times",
                                   "4"))
    assert resumed["steps"] == full["steps"] == 20
    with np.load(tmp_path / "a" / "embedding.npz") as a, \
            np.load(tmp_path / "b" / "embedding.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
