"""TransR's relation-grouped step with relation negatives
(``train/step.py::loss_and_row_grads_transr_grouped``, the grouped
projection's plain versions on the CPU) against the generic step
(``grouped_transr=False``: one gathered ``M_r`` a slot row) on the same
batch and tables: the loss, the tables after each optimizer and its
slots; a relation scored only as a relation negative under lazy Adagrad;
and which route each configuration takes."""

import pytest
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.models import TransR
from openkeonspark_tpu_torch.sampling import DeviceSampler, SampledBatch
from openkeonspark_tpu_torch.train import step as tstep
from openkeonspark_tpu_torch.train.optim import DenseUpdate, make_optimizer

CPU = torch.device("cpu")


def _cfg(**kw):
    base = dict(model="transr", ent_size=16, rel_size=8, alpha=0.05,
                margin=1.0, negative_ent=2)
    return Config(**dict(base, **kw))


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=90, n_rel=6, n_triples=900, n_valid=30, n_test=30,
                   seed=5)
    return ds, DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                   CPU)


def _both_routes(cfg, ds, batch):
    """Loss, tables and optimizer state after one step of each route from
    the same tables: (grouped, generic)."""
    state = tstep.init_state(TransR, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(2), CPU)
    out = []
    for c in (cfg, cfg.replace(grouped_transr=False)):
        params = {k: v.clone() for k, v in state.params.items()}
        opt = make_optimizer(c)
        slots = opt.init(params)
        loss, upd = tstep.loss_and_row_grads(TransR, c, params, batch)
        assert isinstance(upd["transfer_matrix"], DenseUpdate) == (
            c.grouped_transr)
        opt.apply(params, slots, upd, 0)
        out.append((float(loss), params, slots))
    return out


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("n_rel_neg", [1, 2])
def test_relneg_grouped_step_matches_generic(kg, n_rel_neg, opt):
    """The grouped route with relation negatives gives the generic route's
    loss and post-optimizer tables and slots (float reassociation only)."""
    ds, sampler = kg
    cfg = _cfg(negative_rel=n_rel_neg, opt_method=opt)
    assert tstep.use_grouped_transr_relneg(cfg, {
        k: torch.zeros(1) for k in ("ent_embeddings", "rel_embeddings",
                                    "transfer_matrix")})
    batch = sampler.sample(128, cfg.negative_ent, n_rel_neg, cfg.bern,
                           gen=torch.Generator().manual_seed(9))
    (lg, pg, sg), (ls, ps, ss) = _both_routes(cfg, ds, batch)
    assert lg == pytest.approx(ls, rel=1e-5)
    for k in pg:
        torch.testing.assert_close(pg[k], ps[k], rtol=1e-5, atol=1e-5,
                                   msg=k)
    assert set(sg) == set(ss)
    for s in sg:
        for k in sg[s]:
            torch.testing.assert_close(sg[s][k], ss[s][k], rtol=1e-5,
                                       atol=1e-5, msg=f"{s} {k}")


def test_relation_scored_only_as_negative_updates_its_matrix(kg):
    """Lazy Adagrad touches every relation the step scored: a relation
    that appears only as a relation negative gets its ``transfer_matrix``
    row and accumulator updated, as on the generic route, and a relation
    never scored keeps both."""
    ds, _ = kg
    cfg = _cfg(negative_ent=1, negative_rel=1, opt_method="adagrad")
    g = torch.Generator().manual_seed(4)
    B = 40
    h, t = (torch.randint(0, ds.n_ent, (B,), generator=g) for _ in "ht")
    r = torch.randint(0, 2, (B,), generator=g)             # relations 0, 1
    batch = SampledBatch(
        h=h, t=t, r=r, neg_h=torch.randint(0, ds.n_ent, (B, 1), generator=g),
        neg_t=t[:, None].clone(),
        neg_rel=torch.where(torch.arange(B) % 3 == 0, 5, 1 - r)[:, None])
    state = tstep.init_state(TransR, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(2), CPU)
    (_, pg, sg), (_, ps, ss) = _both_routes(cfg, ds, batch)
    m0 = state.params["transfer_matrix"]
    a0 = state.opt_state["accum"]["transfer_matrix"]
    for p, s in ((pg, sg), (ps, ss)):
        m, acc = p["transfer_matrix"], s["accum"]["transfer_matrix"]
        for rho in (0, 1, 5):
            assert not torch.equal(m[rho], m0[rho]), rho
            assert not torch.equal(acc[rho], a0[rho]), rho
        for rho in (2, 3, 4):
            assert torch.equal(m[rho], m0[rho]), rho
            assert torch.equal(acc[rho], a0[rho]), rho
    torch.testing.assert_close(pg["transfer_matrix"], ps["transfer_matrix"],
                               rtol=1e-5, atol=1e-5)


def _tables(dtype):
    return {k: torch.zeros(2, 2, dtype=dtype)
            for k in ("ent_embeddings", "rel_embeddings", "transfer_matrix")}


@pytest.mark.parametrize("kw,dtype,grouped", [
    (dict(negative_rel=1), torch.float32, True),
    (dict(negative_rel=2), torch.float32, True),
    (dict(negative_rel=1), torch.bfloat16, False),
    (dict(negative_rel=1, grouped_transr=False), torch.float32, False),
    (dict(negative_rel=0), torch.float32, False),
    (dict(model="transe", negative_rel=1), torch.float32, False)])
def test_relneg_route_predicate(kw, dtype, grouped):
    """fp32 TransR with relation negatives takes the grouped route; bf16
    tables, ``grouped_transr=False`` and other models keep the generic
    step; entity negatives alone are :func:`use_grouped_transr`'s, which
    relation negatives still leave false (the JAX package's predicate)."""
    cfg = _cfg(**kw)
    assert tstep.use_grouped_transr_relneg(cfg, _tables(dtype)) == grouped
    assert tstep.use_grouped_transr(cfg) == (
        cfg.model == "transr" and cfg.negative_rel == 0)


@pytest.mark.parametrize("dtype,grouped", [("float32", True),
                                           ("bfloat16", False)])
def test_relneg_step_takes_the_route(kg, dtype, grouped):
    """``loss_and_row_grads`` sends an fp32 step with relation negatives
    to the grouped route (a dense ``transfer_matrix`` gradient) and a bf16
    one to the generic step (rows of ``M_r``, one a scored slot)."""
    ds, sampler = kg
    cfg = _cfg(negative_rel=1, dtype=dtype)
    state = tstep.init_state(TransR, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(2), CPU)
    batch = sampler.sample(32, cfg.negative_ent, 1, cfg.bern,
                           gen=torch.Generator().manual_seed(3))
    _, upd = tstep.loss_and_row_grads(TransR, cfg, state.params, batch)
    m = upd["transfer_matrix"]
    assert isinstance(m, DenseUpdate) == grouped
    if not grouped:
        assert m[0].shape == (32 * 2,)      # the positives' r, neg_rel
    ids, rows = upd["rel_embeddings"]
    assert ids.shape == (32 * 2,) and rows.shape == (32 * 2, cfg.d_rel)
