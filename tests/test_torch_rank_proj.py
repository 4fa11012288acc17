"""The port's TransH, TransD and RotatE rank counts and id scorers
(ops/rank.py, kernels B6, B2 and B3) against the JAX package's Pallas
kernels in interpret mode, its kernel-mirrored scorers and a float64 numpy
brute force. The CUDA kernels are held to these plain versions on the card
by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ops import pallas_rank as pk
from openkeonspark_tpu_torch.ops import rank

from torch_parity import (MAX_NEAR_TIE_SHARE, near_tie_queries,
                          rotate_scores64, transd_scores64, transh_scores64)

BLOCK = 128
T = torch.from_numpy


def _count_inputs(seed, E, D, C, lo, hi):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(E, D)).astype(np.float32)
    q = rng.normal(size=(C, D)).astype(np.float32)
    v = rng.normal(size=(C, D)).astype(np.float32)
    gold = rng.uniform(lo, hi, size=C).astype(np.float32)
    gold_ids = rng.integers(0, E, C).astype(np.int32)
    return rng, table, q, v, gold, gold_ids


def _unit(v):
    return v / np.sqrt((v * v).sum(-1, keepdims=True))


def _check_counts(got, want_jax, s64, gold, gold_ids, tie_free=False):
    """Counts equal the JAX kernel's and the float64 brute force's on every
    query without a near-tie; near-tie queries stay rare (``tie_free``:
    the seeded inputs have none)."""
    C = len(gold)
    s = s64.copy()
    s[np.arange(C), gold_ids] = np.inf            # gold masked in the count
    want_np = (s < gold[:, None]).sum(1)
    tie = near_tie_queries(s, gold.astype(np.float64))
    assert tie.mean() < MAX_NEAR_TIE_SHARE
    assert not (tie_free and tie.any())
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[~tie], np.asarray(want_jax)[~tie])
    np.testing.assert_array_equal(got[~tie], want_np[~tie])


# gold ranges (p = 1, p = 2) in the lower tail of the scores at each width;
# at D = 1 the unit normal is +-1, every projected candidate is 0 and every
# score is |q| or q^2, so a query counts every candidate or none
_TRANSH_GOLD = {24: ((13, 21), (20, 36)), 33: ((24, 32), (35, 55)),
                1: ((0.2, 1.5), (0.05, 2.0))}
# the seed's shape, then the edge shapes of the card tests (C = 1 and 17,
# D = 1 and 33: one query, a query tile that is not full, one lane, a width
# that is no multiple of 4); the edge inputs are seeded tie-free, so every
# query is compared
_TRANSH_CASES = [
    pytest.param(sign, p, 128, 24, id=f"{sign}-{p}")
    for p in (1, 2) for sign in (-1.0, 1.0)] + [
    pytest.param(sign, p, C, D, id=f"{sign}-{p}-C{C}-D{D}")
    for C in (1, 17) for D in (1, 33) for p in (1, 2)
    for sign in (-1.0, 1.0)]


@pytest.mark.parametrize("sign,p,C,D", _TRANSH_CASES)
def test_transh_count_matches_jax_interpret_and_numpy(sign, p, C, D):
    """B6 on the table of test_transh_kernel_direct_matches_generic; gold
    in the lower tail of the scores, so counts are small but not 0."""
    _, table, q, w, gold, gold_ids = _count_inputs(
        9, 200, D, C, *_TRANSH_GOLD[D][p - 1])
    w = _unit(w)
    E = table.shape[0]
    got = rank.count_better_transh(T(q), T(w), T(table), T(gold),
                                   T(gold_ids), sign, p, E).numpy()
    want = pk.count_better_transh(
        jnp.asarray(q), jnp.asarray(w), pk.prepare_table(jnp.asarray(table),
                                                         block=BLOCK),
        jnp.asarray(gold), jnp.asarray(gold_ids), sign=sign, p=p, n_ent=E,
        block=BLOCK, interpret=True)
    _check_counts(got, want, transh_scores64(q, w, table, sign, p), gold,
                  gold_ids, tie_free=(C, D) != (128, 24))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_transd_count_matches_jax_interpret_and_numpy(sign, p):
    """B2, the cdot operand shared by both packages."""
    rng, table, q, rp, gold, gold_ids = _count_inputs(
        0, 300, 20, 125, *((15, 23) if p == 1 else (25, 45)))
    ep = (0.2 * rng.normal(size=table.shape)).astype(np.float32)
    cdot = (table * ep).sum(-1).astype(np.float32)
    E = table.shape[0]
    got = rank.count_better_transd(T(q), T(rp), T(table), T(cdot), T(gold),
                                   T(gold_ids), sign, p, E).numpy()
    Ep = -(-E // BLOCK) * BLOCK
    cdot_t = jnp.broadcast_to(jnp.asarray(np.pad(cdot, (0, Ep - E)))[None],
                              (8, Ep))
    want = pk.count_better_transd(
        jnp.asarray(q), jnp.asarray(rp),
        pk.prepare_table(jnp.asarray(table), block=BLOCK), cdot_t,
        jnp.asarray(gold), jnp.asarray(gold_ids), sign=sign, p=p, n_ent=E,
        block=BLOCK, interpret=True)
    _check_counts(got, want, transd_scores64(q, rp, table, cdot, sign, p),
                  gold, gold_ids)


@pytest.mark.parametrize("d", [20, 16])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_rotate_count_matches_jax_interpret_and_numpy(sign, d):
    """B3 on the table of test_rotate_kernel_matches_numpy_interpret; the
    JAX kernel's lanes are padded to a multiple of 8 (d = 20 → 24), which
    adds 4e-6 to each of its scores and so to the gold it is given."""
    _, table, q, _, gold, gold_ids = _count_inputs(5, 260, 2 * d, 125,
                                                   1.2 * d, 1.5 * d)
    E = table.shape[0]
    got = rank.count_better_rotate(T(q), T(table), T(gold), T(gold_ids),
                                   sign, E).numpy()
    dp = -(-d // 8) * 8
    qpad = np.concatenate([np.pad(q[:, :d], ((0, 0), (0, dp - d))),
                           np.pad(q[:, d:], ((0, 0), (0, dp - d)))], 1)
    offset = np.float32((dp - d) * 1e-6)
    want = pk.count_better_rotate(
        jnp.asarray(qpad), pk.rotate_prepare_table(jnp.asarray(table),
                                                   block=BLOCK),
        jnp.asarray(gold + offset), jnp.asarray(gold_ids), sign=sign,
        n_ent=E, block=BLOCK, interpret=True)
    _check_counts(got, want, rotate_scores64(q, table, sign), gold, gold_ids)


def _params(seed, E, nR, D, model):
    rng = np.random.default_rng(seed)
    P = {"ent_embeddings": rng.normal(size=(E, D)),
         "rel_embeddings": rng.normal(size=(nR, D))}
    if model == "transh":
        P["normal_vectors"] = rng.normal(size=(nR, D))
    elif model == "transd":
        P["ent_transfer"] = 0.2 * rng.normal(size=(E, D))
        P["rel_transfer"] = rng.normal(size=(nR, D))
    elif model == "rotate":
        P["ent_embeddings"] = rng.normal(size=(E, 2 * D))
        P["rel_embeddings"] = rng.uniform(-np.pi, np.pi, size=(nR, D))
    P = {k: v.astype(np.float32) for k, v in P.items()}
    ids = [rng.integers(0, n, 9) for n in (E, E, nR)]
    return P, ids, rng.integers(0, E, (9, 5)).astype(np.int32)


def _norm(model, p):
    return () if model == "rotate" else (p,)


def _jax_scores(model, jp, h, t, r, replace, ids, p):
    if model == "transh":
        q, w, sign = pk.transh_queries(jp, h, t, r, replace)
        return q, pk.transh_candidate_scores(q, w, jp, ids, sign, p)
    if model == "transd":
        q, rp, sign = pk.transd_queries(jp, h, t, r, replace)
        cdot_t = pk.transd_prepare_cdot(jp, block=BLOCK)
        return q, pk.transd_candidate_scores(q, rp, jp, cdot_t, ids, sign, p)
    q, sign = pk.rotate_queries(jp, h, t, r, replace)
    return q, pk.rotate_candidate_scores(
        q, pk.rotate_pad_table(jp["ent_embeddings"]), ids, sign)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("model", ["transh", "transd", "rotate"])
def test_queries_and_id_scores_match_jax(model, p):
    """Queries equal the JAX package's query functions and the id scores its
    kernel-mirrored scorers, within fp32 reordering (RotatE at d = 16, a
    multiple of 8, so the JAX lanes carry no padding)."""
    P, (h, t, r), ids2 = _params(3, 100, 11, 16, model)
    tp = {k: T(v) for k, v in P.items()}
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    cdot = rank.transd_cdot(tp) if model == "transd" else None
    for replace in ("tail", "head"):
        for ids in (t.astype(np.int32), ids2):
            ops, sign = rank.model_queries(model, tp, cdot, T(h), T(t),
                                           T(r), replace)
            q = ops[0]
            got = rank.KERNELS[model][1](*ops, T(ids), sign,
                                         *_norm(model, p))
            jq, want = _jax_scores(model, jp, jnp.asarray(h), jnp.asarray(t),
                                   jnp.asarray(r), replace,
                                   jnp.asarray(ids), p)
            np.testing.assert_allclose(q.numpy(), np.asarray(jq),
                                       rtol=1e-5, atol=1e-6)
            assert got.shape == ids.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, err_msg=replace)


def test_rotate_head_query_is_the_inverse_rotation():
    """The head sweep q + e with q = −rot(t, −θ) scores each candidate h
    as the model does, ‖rot(h, θ) − t‖ (a wrong sign would still give
    plausible ranks on random tables)."""
    from openkeonspark_tpu_torch.models.rotate import (modulus_sum,
                                                       rotate_residual)
    P, (h, t, r), _ = _params(4, 50, 7, 8, "rotate")
    tp = {k: T(v) for k, v in P.items()}
    q, sign = rank.rotate_queries(tp, T(h), T(t), T(r), "head")
    cand = T(np.arange(50, dtype=np.int32))[None].repeat(9, 1)
    got = rank.rotate_candidate_scores(q, tp["ent_embeddings"], cand, sign)
    E, R = tp["ent_embeddings"], tp["rel_embeddings"]
    want = modulus_sum(*rotate_residual(E[None, :, :], R[T(r)][:, None, :],
                                        E[T(t)][:, None, :]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["transh", "transd", "rotate"])
def test_counts_equal_brute_force_of_own_scores(model):
    """Each count is the number of table rows whose id score lies below
    gold, the gold id, pad rows and padding queries (gold id −1) left
    out: count and id scorer are tie-exact against each other."""
    P, (h, t, r), _ = _params(6, 90, 5, 12, model)
    n_ent = 84                                  # rows past it are padding
    tp = {k: T(v) for k, v in P.items()}
    cdot = rank.transd_cdot(tp) if model == "transd" else None
    allids = T(np.arange(90, dtype=np.int32))[None].repeat(9, 1)
    count, scores = rank.KERNELS[model][:2]
    for p in (1, 2):
        for replace, gold_ids in (("tail", t), ("head", h)):
            gids = T(np.minimum(gold_ids, n_ent - 1).astype(np.int32))
            gids[-2:] = -1
            ops, sign = rank.model_queries(model, tp, cdot, T(h), T(t), T(r),
                                           replace)
            sc = scores(*ops, allids, sign, *_norm(model, p))
            gold = sc[torch.arange(9), gids.long()]
            got = count(*ops, gold, gids, sign, *_norm(model, p), n_ent)
            below = sc[:, :n_ent] < gold[:, None]
            below[torch.arange(9), gids.long()] = False
            want = below.sum(1, dtype=torch.int32)
            want[-2:] = 0
            assert torch.equal(got, want), (model, p, replace)


def test_wrappers_refuse_bad_inputs():
    P, _, _ = _params(7, 40, 3, 8, "transd")
    E = T(P["ent_embeddings"])
    q, v = torch.zeros(4, 8), torch.zeros(4, 8)
    gold, gids = torch.zeros(4), torch.zeros(4, dtype=torch.int32)
    cdot = torch.zeros(41)
    with pytest.raises(ValueError, match="cdot"):
        rank.count_better_transd(q, v, E, cdot, gold, gids, 1.0, 1, 40)
    with pytest.raises(ValueError, match="rp"):
        rank.count_better_transd(q, v[:3], E, cdot[:40], gold, gids, 1.0, 1,
                                 40)
    with pytest.raises(TypeError, match="w"):
        rank.count_better_transh(q, v.double(), E, gold, gids, 1.0, 1, 40)
    with pytest.raises(ValueError, match="p must be"):
        rank.transh_candidate_scores(q, v, E, gids, 1.0, 3)
    with pytest.raises(ValueError, match="2d wide"):
        rank.count_better_rotate(torch.zeros(4, 7), torch.zeros(40, 7), gold,
                                 gids, 1.0, 40)
    with pytest.raises(ValueError, match="n_ent"):
        rank.count_better_rotate(q, E, gold, gids, -1.0, 41)
