"""DistMult and ComplEx in the port against the JAX package: the scores,
one training step on the same u32 bits (and the dense NumPy oracle of
``tests/oracle.py``), link prediction through the bilinear route (JAX on
its generic path and a float64 brute force, up to near-ties), triple
classification, and the top-k ``predict_*`` queries of these two models
and TransR."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ckpt import export_parameters as jax_export
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.eval import predict_head_entity as jax_predict_head
from openkeonspark_tpu.eval import predict_relation as jax_predict_rel
from openkeonspark_tpu.eval import predict_tail_entity as jax_predict_tail
from openkeonspark_tpu.eval.classification import \
    fit_thresholds as jax_fit_thresholds
from openkeonspark_tpu.eval.classification import \
    triple_classification as jax_tc
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.models import strip_padding as jax_strip
from openkeonspark_tpu.sampling.device import DeviceSampler as JaxSampler
from openkeonspark_tpu.train import step as jstep
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.cli import evaluate
from openkeonspark_tpu_torch.eval import (link_prediction,
                                          predict_head_entity,
                                          predict_relation,
                                          predict_tail_entity,
                                          triple_classification)
from openkeonspark_tpu_torch.eval.classification import fit_thresholds
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.ops import rank
from openkeonspark_tpu_torch.sampling import DeviceSampler
from openkeonspark_tpu_torch.train import step as tstep
from openkeonspark_tpu_torch.train.optim import make_optimizer

from oracle import dense_sgd_step
from torch_parity import (MAX_NEAR_TIE_SHARE, model_near_tie_counts,
                          model_scores64, port_config)

# the module (the package's ``link_prediction`` is the function)
lp_mod = importlib.import_module(
    "openkeonspark_tpu_torch.eval.link_prediction")
CPU = torch.device("cpu")
BILINEAR = ("distmult", "complex")
STEP_KG = dict(n_ent=70, n_rel=5, n_triples=700, n_valid=20, n_test=20,
               seed=13)
# link prediction, classification and top-k: the split of
# test_torch_link_prediction_proj.py
KG = dict(n_ent=97, n_rel=6, n_triples=1200, n_valid=30, n_test=100, seed=5)


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(**KG)
    return ds, build_kg_index(ds, for_eval=True)


def _cfg(model, **kw):
    size = ({"ent_size": 16, "rel_size": 8} if model == "transr"
            else {"hidden_size": 8 if model == "complex" else 16})
    return Config(model=model, use_pallas_eval=False, eval_chunk=16,
                  eval_block=32, **size, **kw)


def _setup(kg, model, key=4, **kw):
    """JAX tables of ``model`` and the same tables in the port."""
    ds, idx = kg
    cfg = _cfg(model, **kw)
    st = jstep.init_state(jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
                          jax.random.key(key))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    tcfg = port_config(cfg)
    tp = params_from_numpy(jp, get_model(model), tcfg, ds.n_ent, ds.n_rel,
                           CPU)
    return ds, idx, cfg, st.params, tp, tcfg


def _ties(ds, tp, model, triples=None):
    tables = {k: v[:ds.n_ent if k.startswith("ent") else ds.n_rel].numpy()
              for k, v in tp.items()}
    return model_near_tie_counts(model, tables,
                                 ds.test if triples is None else triples, 1)


def _assert_within_ties(got, want, ties):
    """Exact where no candidate is a near-tie; elsewhere off by at most
    the near-tie count; near-tie queries rare."""
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k
    share = np.concatenate([ties["head"], ties["tail"]]) > 0
    assert share.mean() < MAX_NEAR_TIE_SHARE


@pytest.mark.parametrize("model", BILINEAR)
def test_score_matches_jax(kg, model):
    """The models' triple scores (rtol 1e-5) and the float64 definition."""
    ds, _, cfg, jp, tp, tcfg = _setup(kg, model)
    rng = np.random.default_rng(3)
    h, t = rng.integers(0, ds.n_ent, (2, 200))
    r = rng.integers(0, ds.n_rel, 200)
    want = np.asarray(jax_get_model(model).score_triples(
        jp, jnp.asarray(h), jnp.asarray(t), jnp.asarray(r), cfg))
    got = get_model(model)(tcfg, ds.n_ent, ds.n_rel, tp).score_triples(
        *(torch.from_numpy(a) for a in (h, t, r))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    tables = {k: v.numpy() for k, v in tp.items()}
    np.testing.assert_allclose(got, model_scores64(model, tables, h, t, r, 1),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("loss_mode", ["mean_neg", "pairwise", "self_adv"])
@pytest.mark.parametrize("model", BILINEAR)
def test_step_matches_jax_and_oracle(model, loss_mode):
    """One generic step with entity and relation negatives from the same
    u32 bits: the loss (rtol 1e-5) and every table after SGD (atol 1e-5)
    against the JAX package's ``build_train_step``, and against the dense
    oracle on the batch the JAX sampler draws from those bits (loss rtol
    1e-5; tables rtol 1e-5, atol 1e-6)."""
    cfg = Config(model=model, hidden_size=8, margin=2.0, alpha=0.05,
                 negative_ent=2, negative_rel=1, loss_mode=loss_mode)
    B = 32
    ds = random_kg(**STEP_KG)
    idx = build_kg_index(ds, for_eval=False)
    jmodel = jax_get_model(model)
    jstate = jstep.init_state(jmodel, cfg, ds.n_ent, ds.n_rel,
                              jax.random.key(3))
    jsampler = JaxSampler.build(ds, idx)
    jfn = jstep.build_train_step(jmodel, cfg, jsampler, B)
    bits = np.random.default_rng(21).integers(
        0, 1 << 32, size=jfn.bits_shape, dtype=np.uint64)
    jbits = jnp.asarray(bits.astype(np.uint32))
    jnew, jloss = jfn(jstate, jsampler, jax.random.key(0), bits=jbits)

    batch = jsampler.sample(jax.random.key(0), B, cfg.negative_ent,
                            cfg.negative_rel, cfg.bern, bits=jbits)
    h, t, r, _ = jstep._batch_ids(batch)
    specs = jmodel.tables(cfg, ds.n_ent, ds.n_rel)
    dense0 = {k: jnp.asarray(v)
              for k, v in jax_strip(jstate.params, specs).items()}
    oracle_loss, oracle = dense_sgd_step(model, cfg, dense0, np.asarray(h),
                                         np.asarray(t), np.asarray(r), B)

    tmodel, tcfg = get_model(model), port_config(cfg)
    tparams = params_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()}, tmodel, tcfg,
        ds.n_ent, ds.n_rel, CPU)
    tstate = tstep.TrainState(tparams, make_optimizer(tcfg).init(tparams), 0)
    tfn = tstep.build_train_step(tmodel, tcfg, B)
    assert tfn.bits_shape == jfn.bits_shape
    tnew, tloss = tfn(tstate, DeviceSampler.build(ds, idx, CPU),
                      torch.from_numpy(bits.astype(np.int64)))
    assert tnew.step == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), oracle_loss, rtol=1e-5)
    for k, v in jnew.params.items():
        np.testing.assert_allclose(tnew.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(tnew.params[k][:specs[k].rows].numpy(),
                                   oracle[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _brute_raw(ds, tp, model):
    """float64 raw ranks {direction: [N]}: candidates < n_ent scoring
    strictly better than the gold."""
    tables = {k: v.numpy() for k, v in tp.items()}
    h, t, r = ds.test[:, 0], ds.test[:, 1], ds.test[:, 2]
    ids, rows = np.arange(ds.n_ent)[None, :], np.arange(len(ds.test))
    out = {}
    for d, hh, tt, gold_ids in (("tail", h[:, None], ids, t),
                                ("head", ids, t[:, None], h)):
        s = model_scores64(model, tables, hh, tt, r[:, None], 1)
        out[f"raw_{d}"] = (s < s[rows, gold_ids][:, None]).sum(1)
    return out


@pytest.mark.parametrize("model", BILINEAR)
def test_ranks_match_jax_and_brute_force(kg, model):
    """The bilinear route's ranks against the JAX package's generic path
    (raw and filtered) and a float64 brute force (raw), up to the counted
    near-ties; filtered ranks lie in [0, raw]. No kernel is launched."""
    ds, idx, cfg, jp, tp, tcfg = _setup(kg, model)
    rank.reset_launch_counts()
    got = link_prediction(tp, tcfg, ds, idx)
    assert not any(rank.LAUNCHES.values())
    want = jax_link_prediction(jp, cfg, ds, idx)
    ties = _ties(ds, tp, model)
    _assert_within_ties(got.ranks, want.ranks, ties)
    _assert_within_ties({k: got.ranks[k] for k in ("raw_head", "raw_tail")},
                        _brute_raw(ds, tp, model), ties)
    for d in ("head", "tail"):
        raw, filt = got.ranks[f"raw_{d}"], got.ranks[f"filt_{d}"]
        assert ((0 <= filt) & (filt <= raw) & (raw < ds.n_ent)).all()
    if all((got.ranks[k] == want.ranks[k]).all() for k in want.ranks):
        assert got.format_table() == want.format_table()


@pytest.mark.parametrize("model", BILINEAR)
def test_ranks_do_not_depend_on_chunks_or_blocks(kg, model, monkeypatch):
    """Ragged and one-query chunks, and score blocks of 10 and 33 rows
    (the sweep cut by ``BILINEAR_SWEEP_ELEMS``), rank as one block does,
    up to the near-ties another product shape may round differently."""
    ds, idx, _, _, tp, tcfg = _setup(kg, model)
    want = link_prediction(tp, tcfg, ds, idx).ranks
    ties = _ties(ds, tp, model)
    for chunk, elems in ((7, None), (1, None), (16, 16 * 10), (16, 16 * 33),
                         (5, 5 * 10)):
        if elems is not None:
            monkeypatch.setattr(lp_mod, "BILINEAR_SWEEP_ELEMS", elems)
        got = link_prediction(tp, tcfg.replace(eval_chunk=chunk), ds,
                              idx).ranks
        monkeypatch.undo()
        _assert_within_ties(got, want, ties)


@pytest.mark.parametrize("model", BILINEAR)
def test_pad_rows_never_count(kg, model):
    """Tables whose every real candidate scores above 0 (a negative dot
    product): the zero pad rows, which score 0, would beat every gold.
    With one pad row and with eight, and in blocks that split the pad rows
    from the rest, raw ranks stay below n_ent and equal the float64 brute
    force over the real entities."""
    ds, idx, _, _, tp, tcfg = _setup(kg, model)
    n = ds.n_ent
    ent = tp["ent_embeddings"].abs() + 0.05
    ent[n:] = 0.0
    rel = -(tp["rel_embeddings"].abs() + 0.05)
    if model == "complex":
        d = rel.shape[1] // 2
        ent[:, d:] = 0.0     # real rows: Re⟨h, r, t̄⟩ = Σ hr·rr·tr < 0
    params = {"ent_embeddings": ent, "rel_embeddings": rel}
    want = _brute_raw(ds, params, model)
    ties = _ties(ds, params, model)
    padded = {k: torch.cat([v, torch.zeros(7, v.shape[1])])
              for k, v in params.items()}
    for p in (params, padded):
        for elems in (None, tcfg.eval_chunk * (n - 3)):
            with pytest.MonkeyPatch.context() as mp:
                if elems is not None:
                    mp.setattr(lp_mod, "BILINEAR_SWEEP_ELEMS", elems)
                got = link_prediction(p, tcfg, ds, idx).ranks
            assert (got["raw_tail"] < n).all() and (got["raw_head"] < n).all()
            _assert_within_ties({k: got[k] for k in want}, want, ties)


def test_bilinear_id_scores_outside_the_table_are_nan():
    """The route's id scorer gathers from the sweep's scores: an id outside
    [0, rows) is NaN (never read), a real id its entry of −(q @ Eᵀ), in
    one block and in several."""
    g = torch.Generator().manual_seed(0)
    q, table = torch.randn(4, 6, generator=g), torch.randn(11, 6, generator=g)
    S = -(q @ table.T)
    ids = torch.tensor([[0, 10, -1, 11], [3, 18, 5, 5], [10, 0, 7, 2],
                        [11, -1, 1, 4]])
    for elems in (1 << 24, 4 * 3):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lp_mod, "BILINEAR_SWEEP_ELEMS", elems)
            _, scores = lp_mod._bilinear_scorers(q, table, 10)
            got = scores(ids)
        real = (ids >= 0) & (ids < 11)
        assert torch.isnan(got[~real]).all()
        want = S.gather(1, ids.clamp(0, 10))
        torch.testing.assert_close(got[real], want[real], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("model", BILINEAR)
def test_triple_classification_matches_jax(kg, model):
    """Thresholds (rtol 1e-5) and accuracy equal the JAX package's."""
    ds, idx, cfg, jp, tp, tcfg = _setup(kg, model)
    thr, acc = fit_thresholds(tp, tcfg, ds, idx)
    jthr, jacc = jax_fit_thresholds(jp, cfg, ds, idx)
    assert acc == jacc
    np.testing.assert_array_equal(thr.has_rel, jthr.has_rel)
    np.testing.assert_allclose(thr.per_rel, jthr.per_rel, rtol=1e-5,
                               atol=1e-7)
    assert thr.fallback == pytest.approx(jthr.fallback, rel=1e-5, abs=1e-7)
    got, want = triple_classification(tp, tcfg, ds, idx), jax_tc(jp, cfg, ds,
                                                                  idx)
    assert got["accuracy"] == want["accuracy"]
    assert got["valid_accuracy"] == want["valid_accuracy"]


@pytest.mark.parametrize("model", ("transr",) + BILINEAR)
def test_predict_matches_jax(kg, model):
    """Top-k heads, tails and relations: the JAX package's ids, scores
    within rtol 1e-5."""
    ds, _, cfg, jp, tp, tcfg = _setup(kg, model)
    for a, r in ((0, 0), (17, 3), (96, 5)):
        for ours, ref in ((predict_tail_entity, jax_predict_tail),
                          (predict_head_entity, jax_predict_head)):
            ids, scores = ours(tp, tcfg, ds.n_ent, ds.n_rel, a, r, k=10)
            jids, jscores = ref(jp, cfg, ds.n_ent, ds.n_rel, a, r, k=10)
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_allclose(scores, jscores, rtol=1e-5,
                                       atol=1e-7)
        ids, scores = predict_relation(tp, tcfg, ds.n_ent, ds.n_rel, a, 3,
                                       k=4)
        jids, jscores = jax_predict_rel(jp, cfg, ds.n_ent, ds.n_rel, a, 3,
                                        k=4)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-7)


def test_transr_predict_does_not_depend_on_the_block(kg):
    """TransR's candidate blocks (``eval_block``) split the projection
    E @ M_ρ: one block, ragged blocks and one-row blocks give the same
    top-k ids and scores (rtol 1e-6)."""
    ds, _, _, _, tp, tcfg = _setup(kg, "transr")
    want = predict_tail_entity(tp, tcfg.replace(eval_block=128), ds.n_ent,
                               ds.n_rel, 5, 2, k=20)
    for block in (32, 7, 1):
        got = predict_tail_entity(tp, tcfg.replace(eval_block=block),
                                  ds.n_ent, ds.n_rel, 5, 2, k=20)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


@pytest.mark.parametrize("model", BILINEAR)
def test_cli_evaluate_prints_jax_table(kg, tmp_path, model, capsys):
    """``cli.evaluate --device cpu`` on a JAX export: the JAX package's
    link-prediction table (where the ranks agree exactly), a
    classification dict and the top-k tails."""
    ds, idx, cfg, jp, tp, tcfg = _setup(kg, model)
    save_dataset(ds, str(tmp_path / "kg"))
    jax_export(jp, jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
               str(tmp_path / "ckpt" / "embedding.vec.json"))
    evaluate.main(["--input", str(tmp_path / "kg"), "--checkpoint",
                   str(tmp_path / "ckpt"), "--model", model,
                   "--hidden_size", str(cfg.hidden_size), "--eval_chunk",
                   "16", "--device", "cpu", "--link_prediction",
                   "--triple_classification", "--predict_tail", "3,1",
                   "--topk", "5"])
    out = capsys.readouterr().out
    want = jax_link_prediction(jp, cfg, ds, idx)
    got = link_prediction(tp, tcfg, ds, idx)
    assert got.format_table() in out
    if all((got.ranks[k] == want.ranks[k]).all() for k in want.ranks):
        assert want.format_table() in out
    assert "triple classification: {'accuracy':" in out
    tails = out.split("top-5 tails for (3, r=1, ?):")[1].split()[::2]
    assert [int(x) for x in tails] == \
        jax_predict_tail(jp, cfg, ds.n_ent, ds.n_rel, 3, 1, k=5)[0].tolist()
