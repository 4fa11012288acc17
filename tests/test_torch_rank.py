"""The port's TransE rank count (ops/rank.py) against the JAX package's
Pallas kernel in interpret mode, its tie-exact candidate scorer and a numpy
brute force. The CUDA kernel is held to its plain version on the card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ops import pallas_rank as pk
from openkeonspark_tpu_torch.ops import rank

from torch_parity import (MAX_NEAR_TIE_SHARE, near_tie_queries,
                          residual_scores64)


def _inputs(seed=0, E=300, D=20, C=17):
    """The shapes of test_count_kernel_matches_numpy_interpret."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(E, D)).astype(np.float32)
    q = rng.normal(size=(C, D)).astype(np.float32)
    gold = rng.uniform(5, 15, size=C).astype(np.float32)
    gold_ids = rng.integers(0, E, C).astype(np.int32)
    return table, q, gold, gold_ids


def _port_count(q, table, gold, gold_ids, sign, p, n_ent):
    return rank.count_better_transe(
        torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(gold),
        torch.from_numpy(gold_ids), sign, p, n_ent).numpy()


def _jax_count(q, table, gold, gold_ids, sign, p, n_ent):
    tt = pk.prepare_table(jnp.asarray(table), block=128)
    return np.asarray(pk.count_better_transe(
        jnp.asarray(q), tt, jnp.asarray(gold), jnp.asarray(gold_ids),
        sign=sign, p=p, n_ent=n_ent, block=128, interpret=True))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_count_matches_jax_interpret_and_numpy(sign, p):
    table, q, gold, gold_ids = _inputs()
    E, C = table.shape[0], len(q)
    got = _port_count(q, table, gold, gold_ids, sign, p, E)
    assert got.dtype == np.int32
    want_jax = _jax_count(q, table, gold, gold_ids, sign, p, E)
    s = residual_scores64(q, table, sign, p)
    s[np.arange(C), gold_ids] = np.inf          # gold masked in the count
    want_np = (s < gold[:, None]).sum(1)
    tie = near_tie_queries(s, gold.astype(np.float64))
    assert tie.mean() < MAX_NEAR_TIE_SHARE
    np.testing.assert_array_equal(got[~tie], want_jax[~tie])
    np.testing.assert_array_equal(got[~tie], want_np[~tie])


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("replace", ["tail", "head"])
def test_ranks_match_jax_without_near_ties(replace, p):
    """Gold = the true entity's own score, each package through its own
    tie-exact scorer: the counts agree wherever no candidate lies within
    float rounding of gold. Many queries over few candidates, so that the
    near-tie share is measured, not guessed."""
    rng = np.random.default_rng(5)
    E, D, C, nR = 120, 16, 200, 11
    ent = rng.normal(size=(E, D)).astype(np.float32)
    rel = rng.normal(size=(nR, D)).astype(np.float32)
    h, t = rng.integers(0, E, C), rng.integers(0, E, C)
    r = rng.integers(0, nR, C)
    gold_ids = (t if replace == "tail" else h).astype(np.int32)

    tp = {"ent_embeddings": torch.from_numpy(ent),
          "rel_embeddings": torch.from_numpy(rel)}
    q, sign = rank.transe_queries(tp, torch.from_numpy(h), torch.from_numpy(t),
                                  torch.from_numpy(r), replace)
    gids = torch.from_numpy(gold_ids)
    gold = rank.transe_candidate_scores(q, tp["ent_embeddings"], gids, sign, p)
    got = rank.count_better_transe(q, tp["ent_embeddings"], gold, gids, sign,
                                   p, E).numpy()

    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    jq, jsign = pk.transe_queries(jp, jnp.asarray(h), jnp.asarray(t),
                                  jnp.asarray(r), replace)
    assert jsign == sign
    np.testing.assert_array_equal(np.asarray(jq), q.numpy())
    jgold = pk.transe_candidate_scores(jq, jp, jnp.asarray(gold_ids), sign, p)
    want = _jax_count(q.numpy(), ent, np.asarray(jgold), gold_ids, sign, p, E)

    s = residual_scores64(q.numpy(), ent, sign, p)
    tie = near_tie_queries(s, s[np.arange(C), gold_ids], gold_ids)
    assert tie.mean() < MAX_NEAR_TIE_SHARE
    np.testing.assert_array_equal(got[~tie], want[~tie])


def test_count_edges_padding_queries_and_pad_rows():
    """gold_ids = −1 queries count 0; rows ≥ n_ent are never candidates; a
    gold id at the last entity is excluded like any other."""
    table, q, gold, gold_ids = _inputs(seed=1, E=300, D=20, C=17)
    n_ent = 290
    table[n_ent:] = 0.0                       # pad rows score ‖q‖, often < gold
    gold_ids[0] = n_ent - 1
    gold_ids[-3:] = -1
    for sign in (-1.0, 1.0):
        for p in (1, 2):
            got = _port_count(q, table, gold, gold_ids, sign, p, n_ent)
            s = residual_scores64(q, table[:n_ent], sign, p)
            live = gold_ids >= 0
            s[np.nonzero(live)[0], gold_ids[live]] = np.inf
            want = (s < gold[:, None]).sum(1)
            want[~live] = 0
            tie = near_tie_queries(s, gold.astype(np.float64))
            np.testing.assert_array_equal(got[~tie], want[~tie])
            assert (got[~live] == 0).all()


@pytest.mark.parametrize("p", [1, 2])
def test_candidate_scores_match_jax(p):
    rng = np.random.default_rng(3)
    E, D, C, K = 100, 24, 9, 5
    ent = rng.normal(size=(E, D)).astype(np.float32)
    rel = rng.normal(size=(11, D)).astype(np.float32)
    h, t = rng.integers(0, E, C), rng.integers(0, E, C)
    r = rng.integers(0, 11, C)
    ids2 = rng.integers(0, E, (C, K)).astype(np.int32)
    tp = {"ent_embeddings": torch.from_numpy(ent),
          "rel_embeddings": torch.from_numpy(rel)}
    jp = {"ent_embeddings": jnp.asarray(ent), "rel_embeddings": jnp.asarray(rel)}
    for replace in ("tail", "head"):
        q, sign = rank.transe_queries(tp, torch.from_numpy(h),
                                      torch.from_numpy(t),
                                      torch.from_numpy(r), replace)
        jq, _ = pk.transe_queries(jp, jnp.asarray(h), jnp.asarray(t),
                                  jnp.asarray(r), replace)
        for ids in (t.astype(np.int32), ids2):
            got = rank.transe_candidate_scores(q, tp["ent_embeddings"],
                                               torch.from_numpy(ids), sign, p)
            want = pk.transe_candidate_scores(jq, jp, jnp.asarray(ids), sign, p)
            assert got.shape == ids.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)


def test_wrapper_refuses_bad_inputs():
    table, q, gold, gold_ids = _inputs()
    args = [torch.from_numpy(x) for x in (q, table, gold, gold_ids)]
    with pytest.raises(TypeError):
        rank.count_better_transe(args[0].double(), *args[1:], -1.0, 1, 300)
    with pytest.raises(TypeError):
        rank.count_better_transe(*args[:3], args[3].long(), -1.0, 1, 300)
    with pytest.raises(ValueError):
        rank.count_better_transe(args[0].t().contiguous().t(), *args[1:],
                                 -1.0, 1, 300)
    with pytest.raises(ValueError):
        rank.count_better_transe(*args, 0.5, 1, 300)
    with pytest.raises(ValueError):
        rank.count_better_transe(*args, -1.0, 3, 300)
    with pytest.raises(ValueError):
        rank.count_better_transe(*args, -1.0, 1, 301)

