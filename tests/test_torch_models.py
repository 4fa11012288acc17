"""The port's model tables, TransE scorer and checkpoint files against the
JAX package."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ckpt import export_parameters as jax_export
from openkeonspark_tpu.ckpt import import_parameters as jax_import
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.ckpt import (export_parameters,
                                          import_parameters, load_params,
                                          params_from_numpy, read_parameters,
                                          save_params)
from openkeonspark_tpu_torch.models import (TransE, get_model, init_tables,
                                            padded_rows)
from openkeonspark_tpu_torch.runtime import NotPortedError

CPU = torch.device("cpu")
N_ENT, N_REL = 53, 6


def _jax_params(cfg, pad_to_multiple=1, seed=4):
    st = init_state(jax_get_model("transe"), cfg, N_ENT, N_REL,
                    jax.random.key(seed), pad_to_multiple=pad_to_multiple)
    return {k: np.asarray(v) for k, v in st.params.items()}


@pytest.mark.parametrize("p", [1, 2])
def test_transe_score_triples_matches_jax(p):
    cfg = Config(model="transe", hidden_size=24, p_norm=p)
    jp = _jax_params(cfg)
    tp = params_from_numpy(jp, TransE, cfg, N_ENT, N_REL, CPU)
    rng = np.random.default_rng(1)
    h, t = rng.integers(0, N_ENT, 200), rng.integers(0, N_ENT, 200)
    r = rng.integers(0, N_REL, 200)
    want = jax_get_model("transe").score_triples(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(h),
        jnp.asarray(t), jnp.asarray(r), cfg)
    model = TransE(cfg, N_ENT, N_REL, tp)
    got = model.score_triples(torch.from_numpy(h), torch.from_numpy(t),
                              torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_init_contract():
    cfg = Config(model="transe", hidden_size=16)
    specs = TransE.tables(cfg, N_ENT, N_REL)
    a = init_tables(torch.Generator().manual_seed(3), specs, CPU)
    b = init_tables(torch.Generator().manual_seed(3), specs, CPU)
    c = init_tables(torch.Generator().manual_seed(4), specs,
                    CPU, pad_to_multiple=8)
    for name, spec in specs.items():
        assert a[name].shape == (padded_rows(spec.rows), spec.dim)
        assert a[name].dtype == torch.float32
        assert torch.equal(a[name][spec.rows:], torch.zeros(1, spec.dim))
        limit = math.sqrt(6.0 / (spec.rows + spec.dim))
        body = a[name][:spec.rows]
        assert body.abs().max() <= limit and body.abs().max() > 0.9 * limit
        assert torch.equal(a[name], b[name])            # seeded
        assert c[name].shape[0] % 8 == 0
        assert not c[name][spec.rows:].any()


def test_params_from_numpy_round_trip_from_jax_init():
    """Padded JAX tables (8-row grid padding) carry across with exactly one
    zero pad row and identical values."""
    cfg = Config(model="transe", hidden_size=16)
    jp = _jax_params(cfg, pad_to_multiple=8)
    assert jp["ent_embeddings"].shape[0] == 56
    tp = params_from_numpy(jp, TransE, cfg, N_ENT, N_REL, CPU)
    for name, rows in (("ent_embeddings", N_ENT), ("rel_embeddings", N_REL)):
        assert tp[name].shape == (rows + 1, 16)
        np.testing.assert_array_equal(tp[name][:rows].numpy(),
                                      jp[name][:rows])
        assert not tp[name][rows].any()
    # and back from the stripped layout
    back = params_from_numpy({k: v[:-1].numpy() for k, v in tp.items()},
                             TransE, cfg, N_ENT, N_REL, CPU)
    for k in tp:
        assert torch.equal(back[k], tp[k])


def test_vocab_mismatch_refused():
    cfg = Config(model="transe", hidden_size=16)
    jp = _jax_params(cfg)
    with pytest.raises(ValueError, match="vocabulary"):
        params_from_numpy(jp, TransE, cfg, N_ENT + 5, N_REL, CPU)
    grown = dict(jp, ent_embeddings=np.ones((N_ENT + 4, 16), np.float32))
    with pytest.raises(ValueError, match="vocabulary"):
        params_from_numpy(grown, TransE, cfg, N_ENT, N_REL, CPU)
    with pytest.raises(ValueError, match="width"):
        params_from_numpy(jp, TransE, cfg.replace(hidden_size=8), N_ENT,
                          N_REL, CPU)


@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_exports_interchange_with_jax(tmp_path, fmt):
    cfg = Config(model="transe", hidden_size=16)
    jp = _jax_params(cfg, pad_to_multiple=8)
    tp = params_from_numpy(jp, TransE, cfg, N_ENT, N_REL, CPU)
    name = "embedding.vec.json" if fmt == "json" else "embedding.npz"
    port_path = str(tmp_path / "port" / name)
    jax_path = str(tmp_path / "jax" / name)
    export_parameters(tp, TransE, cfg, N_ENT, N_REL, port_path, fmt=fmt)
    jax_export({k: jnp.asarray(v) for k, v in jp.items()},
               jax_get_model("transe"), cfg, N_ENT, N_REL, jax_path, fmt=fmt)
    via_jax, via_port = jax_import(port_path), import_parameters(jax_path)
    for k, spec in TransE.tables(cfg, N_ENT, N_REL).items():
        np.testing.assert_array_equal(via_jax[k], jp[k][:spec.rows])
        np.testing.assert_array_equal(via_port[k], jp[k][:spec.rows])
    if fmt == "json":
        with open(port_path, "rb") as a, open(jax_path, "rb") as b:
            assert a.read() == b.read()


def test_state_dict_checkpoint_and_directory_lookup(tmp_path):
    cfg = Config(model="transe", hidden_size=16)
    tp = params_from_numpy(_jax_params(cfg), TransE, cfg, N_ENT, N_REL, CPU)
    save_params(tp, str(tmp_path / "params.pt"))
    loaded = load_params(str(tmp_path / "params.pt"))
    tables, path = read_parameters(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "params.pt")
    for k in tp:
        np.testing.assert_array_equal(loaded[k], tp[k].numpy())
        np.testing.assert_array_equal(tables[k], tp[k].numpy())
    os.makedirs(tmp_path / "orbax" / "step_10")
    with pytest.raises(FileNotFoundError, match="orbax"):
        read_parameters(str(tmp_path / "orbax"))


def test_unported_model_refused():
    assert get_model("transe") is TransE
    with pytest.raises(NotPortedError, match="ROADMAP"):
        get_model("distmult")
