"""Drift guards between the JAX package and the port's own copies of its
numpy modules: ``Config``, the CLI's argument parser, the synthetic KG
generators, the group indexes and the dataset files. The port imports
nothing of the JAX package, so these copies must stay equal by test."""

import argparse
import dataclasses
import inspect

import numpy as np
import pytest

from openkeonspark_tpu import config as jax_config
from openkeonspark_tpu.cli import args as jax_args
from openkeonspark_tpu.data import dataset as jax_dataset
from openkeonspark_tpu.data import index as jax_index
from openkeonspark_tpu.data import synth as jax_synth
from openkeonspark_tpu.data import type_constrain as jax_tc
from openkeonspark_tpu_torch import config as port_config_mod
from openkeonspark_tpu_torch.cli import args as port_args
from openkeonspark_tpu_torch.data import dataset as port_dataset
from openkeonspark_tpu_torch.data import index as port_index
from openkeonspark_tpu_torch.data import synth as port_synth
from openkeonspark_tpu_torch.data import type_constrain as port_tc

from torch_parity import port_config

JaxConfig, PortConfig = jax_config.Config, port_config_mod.Config


def _fields(cls):
    return [(f.name, f.default, f.default_factory, str(f.type))
            for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_equal():
    assert _fields(PortConfig) == _fields(JaxConfig)
    assert PortConfig.__dataclass_params__.frozen
    assert PortConfig() == port_config(JaxConfig())
    assert not hasattr(PortConfig, "eval_chunk_size")   # asks jax


@pytest.mark.parametrize("kw", [
    {}, {"model": "transr", "ent_size": 200, "rel_size": 100},
    {"negative_ent": 3, "negative_rel": 2, "nbatches": 7},
    {"batch_size": 33, "steps_per_scan": 0},
    {"hidden_size": 16, "steps_per_scan": 9}])
def test_config_helpers_equal(kw):
    j, p = JaxConfig(**kw), PortConfig(**kw)
    assert (p.d_ent, p.d_rel, p.neg_total) == (j.d_ent, j.d_rel, j.neg_total)
    for total in (1, 99, 272115):
        assert p.resolve_batch_size(total) == j.resolve_batch_size(total)
    for batch in (1, 400, 5000):
        assert p.scan_group_size(batch) == j.scan_group_size(batch)
    assert dataclasses.asdict(p.replace(alpha=0.5)) == dataclasses.asdict(
        j.replace(alpha=0.5))


@pytest.mark.parametrize("bad", [
    {"model": "nope"}, {"opt_method": "rmsprop"}, {"p_norm": 3},
    {"loss_mode": "x"}, {"sampler": "x"}, {"sharded_step": "x"},
    {"exchange_microbatches": 0}, {"exchange_wire_dtype": "int8"},
    {"exchange_hot_rows": 2}, {"chips_per_host": 0}])
def test_config_validation_equal(bad):
    with pytest.raises(ValueError) as want:
        JaxConfig(**bad)
    with pytest.raises(ValueError) as got:
        PortConfig(**bad)
    assert str(got.value) == str(want.value)


def _options(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default,
                   tuple(a.choices) if a.choices else None,
                   getattr(a.type, "__name__", a.type), a.required,
                   type(a).__name__)
                  for a in parser._actions
                  if not isinstance(a, argparse._HelpAction))


def test_parser_options_and_defaults_equal():
    assert (_options(port_args.build_parser("x"))
            == _options(jax_args.build_parser("x")))


@pytest.mark.parametrize("argv", [
    ["--input", "kg"],
    ["--input", "kg", "--model", "transr", "--ent_size", "200",
     "--rel_size", "100", "--alpha", "0.003", "--bern", "0",
     "--negative_rel", "1", "--opt_method", "adagrad"],
    ["--input", "kg", "--mesh_data", "2", "--mesh_model", "4",
     "--exchange_hot_rows", "8", "--exchange_capacity", "stats",
     "--eval_chunk", "64", "--seed", "3"]])
def test_config_from_args_equal(argv):
    got = port_args.config_from_args(port_args.build_parser("x").parse_args(
        argv))
    want = jax_args.config_from_args(jax_args.build_parser("x").parse_args(
        argv))
    assert isinstance(got, PortConfig)
    assert got == port_config(want)


def _assert_datasets_equal(a, b):
    assert (a.n_ent, a.n_rel) == (b.n_ent, b.n_rel)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(a, split), getattr(b, split),
                                      err_msg=split)
        assert getattr(a, split).dtype == getattr(b, split).dtype


@pytest.mark.parametrize("name,kw", [
    ("random_kg", dict(n_ent=300, n_rel=9, n_triples=4000, n_valid=100,
                       n_test=120, seed=3)),
    ("planted_kg", dict(n_ent=200, n_rel=6, n_triples=3000, n_valid=80,
                        n_test=90, dim=8, seed=1)),
    ("planted_kg", dict(n_ent=150, n_rel=5, n_triples=2000, n_valid=60,
                        n_test=60, dim=8, noise=0.0, seed=2, model="transr")),
    ("planted_kg", dict(n_ent=150, n_rel=5, n_triples=2000, n_valid=60,
                        n_test=60, dim=8, seed=4, model="transh")),
    ("fb15k237_like", dict(seed=0)),
    ("fb15k_like", dict(seed=1)),
    ("wn18rr_like", dict(seed=0))])
def test_synth_equal(name, kw):
    _assert_datasets_equal(getattr(port_synth, name)(**kw),
                           getattr(jax_synth, name)(**kw))


def _assert_group_equal(a, b, what):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f.name}")
            assert x.dtype == y.dtype, f"{what}.{f.name}"
        else:
            assert x == y, f"{what}.{f.name}"


@pytest.mark.parametrize("for_eval", [False, True])
def test_build_kg_index_equal(for_eval):
    ds = port_synth.random_kg(n_ent=250, n_rel=8, n_triples=3000,
                              n_valid=80, n_test=90, seed=7)
    got = port_index.build_kg_index(ds, for_eval=for_eval)
    want = jax_index.build_kg_index(ds, for_eval=for_eval)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, jax_index.GroupIndex):
            _assert_group_equal(x, y, f.name)
        elif isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    np.testing.assert_array_equal(got.p_corrupt_head, want.p_corrupt_head)
    for with_rel in (False, True):
        a = got.train_row_tables(ds.train, with_rel=with_rel)
        b = want.train_row_tables(ds.train, with_rel=with_rel)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_files_equal(tmp_path):
    """Each package's ``save_dataset`` writes the same files, and each
    ``load_dataset`` reads back the same arrays and names."""
    ds = port_synth.random_kg(n_ent=60, n_rel=4, n_triples=500, n_valid=20,
                              n_test=25, seed=5)
    port_dataset.save_dataset(ds, str(tmp_path / "port"))
    jax_dataset.save_dataset(ds, str(tmp_path / "jax"))
    for f in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f
    for names in (False, True):
        got = port_dataset.load_dataset(str(tmp_path / "jax"),
                                        load_names=names)
        want = jax_dataset.load_dataset(str(tmp_path / "port"),
                                        load_names=names)
        _assert_datasets_equal(got, want)
        _assert_datasets_equal(got, ds)
        assert (got.ent_names, got.rel_names) == (want.ent_names,
                                                  want.rel_names)
        np.testing.assert_array_equal(got.all_triples(), want.all_triples())


def test_type_constrain_equal(tmp_path):
    """The port's ``data/type_constrain.py`` is the reference's: the same
    source for every function and class, the same constraints from a KG
    (all splits and train only), the same ``type_constrain.txt`` bytes,
    each package reading the other's file back, and the same masks."""
    names = ("TypeConstraints", "build_type_constraints",
             "save_type_constraints", "load_type_constraints", "maybe_load")
    for name in names:
        assert (inspect.getsource(getattr(port_tc, name))
                == inspect.getsource(getattr(jax_tc, name))), name
    ds = port_synth.random_kg(n_ent=50, n_rel=5, n_triples=400, n_valid=20,
                              n_test=20, seed=3)
    for splits in ("all", "train"):
        got = port_tc.build_type_constraints(ds, splits)
        want = jax_tc.build_type_constraints(ds, splits)
        assert got.n_rel == want.n_rel
        for rel in range(ds.n_rel):
            np.testing.assert_array_equal(got.heads[rel], want.heads[rel])
            np.testing.assert_array_equal(got.tails[rel], want.tails[rel])
    port_tc.save_type_constraints(got, str(tmp_path / "port.txt"))
    jax_tc.save_type_constraints(want, str(tmp_path / "jax.txt"))
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())
    back = port_tc.load_type_constraints(str(tmp_path / "jax.txt"))
    jback = jax_tc.load_type_constraints(str(tmp_path / "port.txt"))
    np.testing.assert_array_equal(back.head_mask(ds.n_ent),
                                  jback.head_mask(ds.n_ent))
    np.testing.assert_array_equal(back.tail_mask(ds.n_ent),
                                  want.tail_mask(ds.n_ent))
    (tmp_path / "port.txt").rename(tmp_path / "type_constrain.txt")
    assert port_tc.maybe_load(str(tmp_path)) is not None
    assert port_tc.maybe_load(str(tmp_path / "nope")) is None
