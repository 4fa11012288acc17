"""The port's TransH, TransD and RotatE models against the JAX package:
table layouts, triple scores, and parameters carried across as numpy and
through both export formats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ckpt import export_parameters as jax_export
from openkeonspark_tpu.config import Config as JaxConfig
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.ckpt import (export_parameters,
                                          import_parameters,
                                          params_from_numpy)
from openkeonspark_tpu_torch.models import (RotatE, TransD, TransH,
                                            get_model, init_tables)
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.models.base import pnorm

from torch_parity import config_as

CPU = torch.device("cpu")
N_ENT, N_REL = 53, 6
MODELS = {"transh": TransH, "transd": TransD, "rotate": RotatE}


def _jax_params(name, cfg, pad_to_multiple=1, seed=4):
    st = init_state(jax_get_model(name), config_as(JaxConfig, cfg), N_ENT,
                    N_REL, jax.random.key(seed),
                    pad_to_multiple=pad_to_multiple)
    return {k: np.asarray(v) for k, v in st.params.items()}


def test_registry_and_tables():
    cfg = Config(hidden_size=10)
    for name, cls in MODELS.items():
        assert get_model(name) is cls
        want = jax_get_model(name).tables(config_as(JaxConfig, cfg), N_ENT,
                                          N_REL)
        got = cls.tables(cfg, N_ENT, N_REL)
        assert {k: (s.rows, s.dim, s.kind) for k, s in got.items()} == {
            k: (s.rows, s.dim, s.kind) for k, s in want.items()}, name
    specs = RotatE.tables(cfg, N_ENT, N_REL)
    assert specs["ent_embeddings"].dim == 20
    assert specs["rel_embeddings"].dim == 10      # phases, d wide


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("name", ["transh", "transd", "rotate"])
def test_score_triples_matches_jax(name, p):
    cfg = Config(model=name, hidden_size=24, p_norm=p)
    jp = _jax_params(name, cfg)
    if name == "transh":
        # unit-normalisation must matter: normals far from unit length
        jp["normal_vectors"] = jp["normal_vectors"] * 7.0
    tp = params_from_numpy(jp, MODELS[name], cfg, N_ENT, N_REL, CPU)
    rng = np.random.default_rng(1)
    h, t = rng.integers(0, N_ENT, 200), rng.integers(0, N_ENT, 200)
    r = rng.integers(0, N_REL, 200)
    want = jax_get_model(name).score_triples(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(h),
        jnp.asarray(t), jnp.asarray(r), config_as(JaxConfig, cfg))
    got = MODELS[name](cfg, N_ENT, N_REL, tp).score_triples(
        torch.from_numpy(h), torch.from_numpy(t), torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_scores_follow_the_model_definitions():
    """Each score against its definition written out: TransH projects on
    the unit normal's hyperplane, TransD maps e ↦ e + (e·e_p)r_p, RotatE
    sums the complex moduli of rot(h, θ) − t."""
    g = torch.Generator().manual_seed(0)
    cfg = Config(hidden_size=6, p_norm=2)
    h, t, r = torch.tensor([0, 3]), torch.tensor([2, 1]), torch.tensor([1, 0])
    for name, cls in MODELS.items():
        P = init_tables(g, cls.tables(cfg, 4, 2), CPU)
        got = cls(cfg.replace(model=name), 4, 2, P).score_triples(h, t, r)
        E, Rr = P["ent_embeddings"], P["rel_embeddings"]
        if name == "transh":
            w = P["normal_vectors"][r]
            w = w / w.norm(dim=-1, keepdim=True)
            proj = lambda e: e - (e * w).sum(-1, keepdim=True) * w  # noqa
            want = pnorm(proj(E[h]) + Rr[r] - proj(E[t]), 2)
        elif name == "transd":
            rp = P["rel_transfer"][r]
            mp = lambda i: E[i] + (E[i] * P["ent_transfer"][i]).sum(  # noqa
                -1, keepdim=True) * rp
            want = pnorm(mp(h) + Rr[r] - mp(t), 2)
        else:
            hc = torch.complex(E[h][:, :6], E[h][:, 6:])
            tc = torch.complex(E[t][:, :6], E[t][:, 6:])
            want = (hc * torch.exp(1j * Rr[r]) - tc).abs().sum(-1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["transh", "transd", "rotate"])
def test_params_carry_across_from_jax(name):
    """Padded JAX tables (8-row grid padding) carry across with one zero
    pad row and identical values, and back from the stripped layout."""
    cfg = Config(model=name, hidden_size=16)
    jp = _jax_params(name, cfg, pad_to_multiple=8)
    tp = params_from_numpy(jp, MODELS[name], cfg, N_ENT, N_REL, CPU)
    specs = MODELS[name].tables(cfg, N_ENT, N_REL)
    assert set(tp) == set(specs)
    for k, spec in specs.items():
        assert tp[k].shape == (spec.rows + 1, spec.dim)
        np.testing.assert_array_equal(tp[k][:spec.rows].numpy(),
                                      jp[k][:spec.rows])
        assert not tp[k][spec.rows].any()
    back = params_from_numpy({k: v[:-1].numpy() for k, v in tp.items()},
                             MODELS[name], cfg, N_ENT, N_REL, CPU)
    for k in tp:
        assert torch.equal(back[k], tp[k])
    with pytest.raises(ValueError, match="width"):
        params_from_numpy(jp, MODELS[name], cfg.replace(hidden_size=8),
                          N_ENT, N_REL, CPU)


@pytest.mark.parametrize("fmt", ["json", "npz"])
@pytest.mark.parametrize("name", ["transh", "transd", "rotate"])
def test_exports_interchange_with_jax(tmp_path, name, fmt):
    cfg = Config(model=name, hidden_size=8)
    jp = _jax_params(name, cfg)
    tp = params_from_numpy(jp, MODELS[name], cfg, N_ENT, N_REL, CPU)
    fname = "embedding.vec.json" if fmt == "json" else "embedding.npz"
    port_path = str(tmp_path / "port" / fname)
    jax_path = str(tmp_path / "jax" / fname)
    export_parameters(tp, MODELS[name], cfg, N_ENT, N_REL, port_path,
                      fmt=fmt)
    jax_export({k: jnp.asarray(v) for k, v in jp.items()},
               jax_get_model(name), config_as(JaxConfig, cfg), N_ENT, N_REL,
               jax_path, fmt=fmt)
    via_port = import_parameters(jax_path)
    for k, spec in MODELS[name].tables(cfg, N_ENT, N_REL).items():
        np.testing.assert_array_equal(via_port[k], jp[k][:spec.rows])
    if fmt == "json":
        with open(port_path, "rb") as a, open(jax_path, "rb") as b:
            assert a.read() == b.read()
