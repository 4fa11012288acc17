"""RotatE's slot route (``train/step.py::loss_and_row_grads_rotate``,
``ops/rotate_train.py``) on the CPU: which steps take it, and that its
plain version, which the CPU runs, gives the generic step's loss and
updates bit for bit. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.ops import rotate_train
from openkeonspark_tpu_torch.runtime import torch_dtype
from openkeonspark_tpu_torch.sampling import DeviceSampler
from openkeonspark_tpu_torch.train import step as tstep

CPU = torch.device("cpu")
B = 24


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=70, n_rel=6, n_triples=600, n_valid=10, n_test=10,
                   seed=4)
    return ds, DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                   CPU)


def _setup(kg, model="rotate", negative_ent=5, negative_rel=0,
           dtype="float32", loss_mode="self_adv", seed=0):
    ds, sampler = kg
    cfg = Config(model=model, hidden_size=6, ent_size=6, rel_size=5,
                 margin=2.0, loss_mode=loss_mode, negative_ent=negative_ent,
                 negative_rel=negative_rel, batch_size=B, dtype=dtype,
                 grouped_transr=False)
    mdl = get_model(model)
    state = tstep.init_state(mdl, cfg, ds.n_ent, ds.n_rel,
                             torch.Generator().manual_seed(seed), CPU)
    batch = sampler.sample(B, negative_ent, negative_rel, False,
                           gen=torch.Generator().manual_seed(seed + 1))
    return cfg, mdl, state.params, batch


@pytest.mark.parametrize("case,taken", [
    (dict(), True),
    (dict(negative_ent=0), True),
    (dict(dtype="bfloat16"), False),
    (dict(negative_rel=1), False),
    (dict(negative_ent=0, negative_rel=2), False),
    (dict(model="transe"), False),
    (dict(model="transh"), False),
    (dict(model="transd"), False),
    (dict(model="transr"), False),
    (dict(model="distmult"), False),
    (dict(model="complex"), False),
], ids=lambda x: str(x))
def test_rotate_route_only_for_fp32_rotate_without_relation_negatives(
        kg, case, taken):
    cfg, mdl, params, batch = _setup(kg, **case)
    assert params["ent_embeddings"].dtype == torch_dtype(cfg.dtype)
    assert tstep.use_rotate_slots(mdl, params, batch) is taken


def test_loss_and_row_grads_dispatches_to_the_rotate_route(kg, monkeypatch):
    """``loss_and_row_grads`` hands RotatE's step to its route, and the
    generic step to every other case."""
    calls = []
    real = tstep.loss_and_row_grads_rotate

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tstep, "loss_and_row_grads_rotate", spy)
    for case, n in ((dict(), 1), (dict(dtype="bfloat16"), 1),
                    (dict(negative_rel=1), 1), (dict(model="transe"), 1)):
        cfg, mdl, params, batch = _setup(kg, **case)
        tstep.loss_and_row_grads(mdl, cfg, params, batch)
        assert len(calls) == n, case


def _generic(cfg, mdl, params, batch):
    """The generic step's loss and updates (``loss_and_row_grads``
    without the RotatE route)."""
    slots, n_neg = tstep.gather_slots_structured(mdl, params, batch)
    loss, g = tstep.slot_loss_and_grads(mdl, cfg, slots, B, n_neg)
    return loss, tstep.merged_row_updates(mdl.gathers(), batch, g)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("negative_ent", [0, 1, 5, 40])
@pytest.mark.parametrize("loss_mode", ["self_adv", "pairwise", "mean_neg"])
def test_rotate_route_equals_the_generic_step_bit_for_bit(kg, loss_mode,
                                                          negative_ent):
    """The route's plain version (gathers, ``models/rotate.py`` under
    autograd with the scores as a leaf, ``merge_entity_rows_ref``) gives
    the generic step's loss, update streams and phase gradient bit for
    bit."""
    cfg, mdl, params, batch = _setup(kg, negative_ent=negative_ent,
                                     loss_mode=loss_mode)
    rotate_train.reset_launch_counts()
    loss, upd = tstep.loss_and_row_grads_rotate(cfg, params, batch)
    want_loss, want = _generic(cfg, mdl, params, batch)
    assert rotate_train.LAUNCHES == {"rotate_slot_scores": 0,
                                     "rotate_slot_grads": 0}
    if loss_mode == "mean_neg" and negative_ent == 0:
        assert torch.isnan(loss) and torch.isnan(want_loss)   # empty mean
    else:
        assert torch.equal(_bits(loss), _bits(want_loss))
    assert list(upd) == list(want) == ["ent_embeddings", "rel_embeddings"]
    assert upd["ent_embeddings"][0].shape == ((negative_ent + 2) * B,)
    assert upd["rel_embeddings"][0].shape == (B,)
    for table, (wids, wrows) in want.items():
        ids, rows = upd[table]
        assert torch.equal(ids, wids), table
        assert rows.shape == wrows.shape, table
        assert torch.equal(_bits(rows), _bits(wrows)), table


def test_rotate_route_steps_like_the_generic_step(kg, monkeypatch):
    """Three Adam steps through ``build_train_step`` leave the same tables
    and moments bit for bit with the route as without it."""
    ds, sampler = kg
    cfg = Config(model="rotate", hidden_size=6, margin=2.0, alpha=0.02,
                 opt_method="adam", loss_mode="self_adv", negative_ent=16,
                 bern=False, batch_size=B)
    mdl = get_model("rotate")
    out = []
    for route in (True, False):
        if not route:
            monkeypatch.setattr(tstep, "use_rotate_slots",
                                lambda *a: False)
        state = tstep.init_state(mdl, cfg, ds.n_ent, ds.n_rel,
                                 torch.Generator().manual_seed(3), CPU)
        step = tstep.build_train_step(mdl, cfg, B)
        bits = sampler.draw_bits((3,) + step.bits_shape,
                                 torch.Generator().manual_seed(4))
        losses = []
        for k in range(3):
            state, loss = step(state, sampler, bits[k])
            losses.append(loss)
        out.append([*losses, *state.params.values(),
                    *(t for slot in state.opt_state.values()
                      for t in slot.values())])
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert torch.equal(_bits(a), _bits(b))


def test_prepare_refuses_what_the_kernels_do_not_take(kg):
    cfg, mdl, params, batch = _setup(kg)
    E, th = params["ent_embeddings"], params["rel_embeddings"]
    ids = (batch.h, batch.t, batch.r, batch.neg_h, batch.neg_t)
    s = rotate_train.prepare(E, th, *ids)
    assert s.neg_h.shape == (B, 5) and s.rows is None      # CPU: no buffers
    with pytest.raises(ValueError):
        rotate_train.prepare(E.bfloat16(), th.bfloat16(), *ids)
    with pytest.raises(ValueError):
        rotate_train.prepare(E[:, :-2], th, *ids)          # not 2d wide
    with pytest.raises(ValueError):
        rotate_train.prepare(E, th, batch.h.int(), *ids[1:])
    with pytest.raises(ValueError):
        rotate_train.prepare(E, th, *ids[:3], batch.neg_h[:, :2],
                             batch.neg_t)
    s = rotate_train.prepare(E, th, *ids[:3], None, None)
    assert s.neg_h.shape == s.neg_t.shape == (B, 0)
