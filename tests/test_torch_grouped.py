"""The grouped projection (kernel B4) of the port, through its plain
versions, against the JAX package's Pallas kernel in interpret mode and
its gather/einsum reference: run offsets, forward, gradients, and exactly
zero gradients for absent relations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ops.pallas_grouped import (grouped_project as
                                                  jax_grouped_project)
from openkeonspark_tpu.ops.pallas_grouped import (grouped_project_ref as
                                                  jax_grouped_project_ref)
from openkeonspark_tpu.ops.pallas_grouped import pad_inputs
from openkeonspark_tpu_torch.ops import grouped


def _inputs(n_rel, de, dr, n_rows, seed):
    rng = np.random.default_rng(seed)
    rel = np.sort(rng.integers(0, n_rel, n_rows))
    x = rng.normal(size=(n_rows, de)).astype(np.float32)
    m3 = rng.normal(size=(n_rel, de, dr)).astype(np.float32)
    return rel, x, m3


@pytest.mark.parametrize("rel", [[2, 2, 2, 5, 6, 6, 6, 6], [0], [3, 3],
                                 [0, 1, 1, 4, 4, 4, 9]])
def test_run_offsets_match_numpy(rel):
    rel = np.asarray(rel)
    n_rows = 10
    got = grouped.run_offsets(torch.from_numpy(rel), n_rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(rel, np.arange(n_rows + 1), "left"))


@pytest.mark.parametrize("n_rel,n_rows", [(5, 300), (1, 64), (40, 1000)])
def test_grouped_project_matches_jax(n_rel, n_rows):
    rel, x, m3 = _inputs(n_rel, 16, 128, n_rows, seed=3)
    xp, relp = pad_inputs(jnp.asarray(x), jnp.asarray(rel.astype(np.int32)))
    pallas = np.asarray(jax_grouped_project(jnp.asarray(m3), xp, relp,
                                            True)[:n_rows])
    ref = np.asarray(jax_grouped_project_ref(
        jnp.asarray(m3), jnp.asarray(x), jnp.asarray(rel.astype(np.int32))))
    rel_t = torch.from_numpy(rel)
    got = grouped.grouped_project(torch.from_numpy(m3), torch.from_numpy(x),
                                  rel_t, grouped.run_offsets(rel_t, n_rel))
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_grouped_project_vjp_matches_jax():
    """Gradients of Σ sin(y) against the JAX package's custom VJP (the
    Pallas backward kernel in interpret mode) and its reference."""
    n_rel, de, dr, n_rows = 9, 24, 128, 500
    rel, x, m3 = _inputs(n_rel, de, dr, n_rows, seed=7)
    rel_j = jnp.asarray(rel.astype(np.int32))

    def f(m3_, x_):
        xp, relp = pad_inputs(x_, rel_j)
        return jnp.sum(jnp.sin(jax_grouped_project(m3_, xp, relp,
                                                   True)[:n_rows]))

    def f_ref(m3_, x_):
        return jnp.sum(jnp.sin(jax_grouped_project_ref(m3_, x_, rel_j)))

    dm_j, dx_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(m3), jnp.asarray(x))
    dm_r, dx_r = jax.grad(f_ref, argnums=(0, 1))(jnp.asarray(m3),
                                                 jnp.asarray(x))

    m3_t = torch.from_numpy(m3).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    rel_t = torch.from_numpy(rel)
    y = grouped.grouped_project(m3_t, x_t, rel_t,
                                grouped.run_offsets(rel_t, n_rel))
    torch.sin(y).sum().backward()
    for got, want in ((m3_t.grad, dm_j), (x_t.grad, dx_j),
                      (m3_t.grad, dm_r), (x_t.grad, dx_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_absent_relations_get_exactly_zero_dm():
    n_rel, de, dr = 12, 8, 5
    rel, x, m3 = _inputs(n_rel, de, dr, 200, seed=11)
    rel = np.where(np.isin(rel, [0, 3, 11]), 4, rel)
    rel.sort()
    g = np.random.default_rng(2).normal(size=(200, dr)).astype(np.float32)
    rel_t = torch.from_numpy(rel)
    dx, dm = grouped.grouped_project_bwd_ref(
        torch.from_numpy(m3), torch.from_numpy(x), rel_t,
        torch.from_numpy(g))
    absent = ~np.isin(np.arange(n_rel), rel)
    assert absent.sum() >= 3
    assert (dm.numpy()[absent] == 0).all()
    assert (dm.numpy()[~absent] != 0).any(axis=(1, 2)).all()
    # and the dense dM is the per-row outer products summed per relation
    want = np.zeros_like(m3)
    np.add.at(want, rel, np.einsum("ne,nr->ner", x, g))
    np.testing.assert_allclose(dm.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        dx.numpy(), np.einsum("nr,ner->ne", g, m3[rel]), atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    rel, x, m3 = _inputs(3, 4, 2, 10, seed=1)
    rel_t = torch.from_numpy(rel)
    off = grouped.run_offsets(rel_t, 3)
    with pytest.raises(ValueError, match="CUDA"):
        grouped.grouped_project_fwd(torch.from_numpy(m3),
                                    torch.from_numpy(x), off)
    with pytest.raises(ValueError, match="CUDA"):
        grouped.grouped_project_bwd(torch.from_numpy(m3),
                                    torch.from_numpy(x),
                                    torch.zeros(10, 2), off)
    assert grouped.LAUNCHES == {"grouped_project_fwd": 0,
                                "grouped_project_bwd": 0}
