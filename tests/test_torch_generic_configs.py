"""The port's generic training step against the plain reference
(``tests/plain_generic.py``) on seeded random tables at a small size on
the CPU: RotatE under the self-adversarial loss and lazy Adam (the
``rotate_d1000_fb15k237`` configuration's path), and TransR with relation
negatives under SGD, on the generic route (``grouped_transr=False``) and
on the relation-grouped route that fp32 tables take.
Both sides start from the same tables and take the same u32 draws; each
step's batch, loss, tables and, under Adam, both moments are compared.
The references import nothing of JAX or of either package, and the
``okst.train.loss`` and ``okst.train.optim`` spans open once a step under
a profiler and change nothing without one."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openkeonspark_tpu_torch import obs
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.sampling import DeviceSampler
from openkeonspark_tpu_torch.train import step as tstep

import plain_generic as plain

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
STEPS = 3
CONFIGS = {
    # RotatE as rotate_d1000_fb15k237 trains it, at 6 complex lanes
    "rotate_adv_adam": dict(
        model="rotate", hidden_size=6, margin=2.0, alpha=0.02,
        opt_method="adam", loss_mode="self_adv", negative_ent=16,
        negative_rel=0, bern=False, batch_size=24),
    # TransR with relation negatives: the generic route, per-row M_r
    "transr_relneg_sgd": dict(
        model="transr", hidden_size=6, ent_size=6, rel_size=5, margin=1.5,
        alpha=0.02, opt_method="sgd", loss_mode="pairwise", negative_ent=3,
        negative_rel=2, bern=True, batch_size=20, grouped_transr=False),
    # the same on the grouped route (the transr_d200_fb15k237
    # configuration's path with relation negatives): two relation-sorted
    # streams through the grouped projection, a dense M gradient
    "transr_relneg_grouped_sgd": dict(
        model="transr", hidden_size=6, ent_size=6, rel_size=5, margin=1.5,
        alpha=0.02, opt_method="sgd", loss_mode="pairwise", negative_ent=3,
        negative_rel=2, bern=True, batch_size=20),
}


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=70, n_rel=6, n_triples=600, n_valid=10, n_test=10,
                   seed=4)
    return ds, build_kg_index(ds, for_eval=False)


def _port(name, ds, index, seed=3):
    """The port's state, sampler and step; the draws of ``STEPS`` steps."""
    kw = CONFIGS[name]
    cfg = Config(**kw, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    state = tstep.init_state(get_model(cfg.model), cfg, ds.n_ent, ds.n_rel,
                             gen, CPU)
    assert set(state.opt_state) == ({"m", "v"} if cfg.opt_method == "adam"
                                    else set())
    assert not tstep.use_grouped_transr(cfg)
    sampler = DeviceSampler.build(ds, index, CPU)
    step = tstep.build_train_step(get_model(cfg.model), cfg, cfg.batch_size)
    bits = sampler.draw_bits((STEPS,) + step.bits_shape,
                             torch.Generator().manual_seed(seed + 1))
    return cfg, state, sampler, step, bits


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_steps_agree_with_the_plain_reference(kg, name):
    ds, index = kg
    cfg, state, sampler, step, bits = _port(name, ds, index)
    p0 = {k: v.clone() for k, v in state.params.items()}
    conf = dict(CONFIGS[name], adam_beta1=cfg.adam_beta1,
                adam_beta2=cfg.adam_beta2, adam_eps=cfg.adam_eps)
    want = plain.follow(conf, plain.PlainSampler(ds.train, ds.n_ent,
                                                 ds.n_rel),
                        p0, [b.numpy() for b in bits])
    for k in range(STEPS):
        b = sampler.sample(cfg.batch_size, cfg.negative_ent,
                           cfg.negative_rel, cfg.bern, bits=bits[k])
        for f, ref in want["batch"][k].items():
            got = getattr(b, f)
            got = np.zeros((cfg.batch_size, 0)) if got is None else got.numpy()
            np.testing.assert_array_equal(got, ref, err_msg=f)
        state, loss = step(state, sampler, bits[k])
        assert float(loss) == pytest.approx(want["loss"][k], rel=2e-6)
        for t, ref in want["tables"][k].items():
            # the change from the start, against its own size
            got, d_ref = state.params[t] - p0[t], ref - p0[t]
            assert float((got - d_ref).norm()) <= 2e-5 * float(d_ref.norm()), t
        for slot in state.opt_state:
            for t, ref in want[slot][k].items():
                got = state.opt_state[slot][t]
                assert float((got - ref).norm()) <= 2e-5 * float(ref.norm()), \
                    (slot, t)
    assert state.step == STEPS


def test_adam_first_moment_is_the_scaled_first_gradient(kg):
    """m₁ = (1 − β₁)·g at touched rows and 0 elsewhere, so the benchmark
    reads the port's first gradient from its optimizer state."""
    ds, index = kg
    cfg, state, sampler, step, bits = _port("rotate_adv_adam", ds, index)
    p0 = {k: v.clone() for k, v in state.params.items()}
    conf = dict(CONFIGS["rotate_adv_adam"], adam_beta1=cfg.adam_beta1,
                adam_beta2=cfg.adam_beta2, adam_eps=cfg.adam_eps)
    sp = plain.PlainSampler(ds.train, ds.n_ent, ds.n_rel)
    batch = sp.batch(bits[0].numpy(), cfg.negative_ent, 0, cfg.bern)
    leaves = {k: v.clone().requires_grad_() for k, v in p0.items()}
    loss = plain.loss_of(conf, plain.distances(
        conf, leaves, *plain.triples(batch, CPU)))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    state, _ = step(state, sampler, bits[0])
    for (k, _), g in zip(leaves.items(), grads):
        m1 = state.opt_state["m"][k] / (1.0 - cfg.adam_beta1)
        assert float((m1 - g).norm()) <= 2e-5 * float(g.norm()), k
        on = plain.touched(conf, p0, batch)[k][:, 0]
        assert torch.all(state.opt_state["m"][k][~on] == 0), k


@pytest.mark.parametrize("path", [
    ROOT / "tests" / "plain_generic.py",
    ROOT / "kgbench" / "reference" / "generic.py"], ids=lambda p: p.name)
def test_reference_imports_nothing_of_jax_or_either_package(path):
    blocked = ("jax", "jaxlib", "flax", "openkeonspark_tpu",
               "openkeonspark_tpu_torch")
    code = (
        "import importlib.util, sys\n"
        f"BLOCKED = {blocked!r}\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked import of ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"spec = importlib.util.spec_from_file_location('ref', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert not {m.split('.')[0] for m in sys.modules} & set(BLOCKED)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def _group(name, ds, index):
    cfg, state, sampler, step, _ = _port(name, ds, index)
    runner = tstep.build_group_runner(step, STEPS)
    state, loss = runner(state, sampler, torch.Generator().manual_seed(9))
    return [loss, *state.params.values(),
            *(t for slot in state.opt_state.values() for t in slot.values())]


def _parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("okst."):
        p = p.cpu_parent
    return p.name if p is not None else None


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_optim_spans_open_once_a_step(kg, name, monkeypatch):
    """Every stage span opens once a step (the update twice: the update
    streams, then the optimizer) inside the step's span, on RotatE's slot
    route as on the generic step; the loss inside the score, the optimizer
    inside the second update."""
    ds, index = kg
    routes = []
    real = tstep.loss_and_row_grads_rotate

    def spy(*a, **k):
        routes.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tstep, "loss_and_row_grads_rotate", spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _group(name, ds, index)
    assert len(routes) == (STEPS if CONFIGS[name]["model"] == "rotate"
                           else 0)
    evs = [e for e in prof.events() if e.name.startswith("okst.")]
    for span, parent in (("okst.train.loss", "okst.train.score"),
                         ("okst.train.optim", "okst.train.update")):
        got = [e for e in evs if e.name == span]
        assert len(got) == STEPS, span
        assert {_parent(e) for e in got} == {parent}, span
    for span, per_step in (("okst.train.sampling", 1),
                           ("okst.train.gather", 1), ("okst.train.score", 1),
                           ("okst.train.grad", 1), ("okst.train.update", 2)):
        got = [e for e in evs if e.name == span]
        assert len(got) == per_step * STEPS, span
        assert {_parent(e) for e in got} == {"okst.train.step"}, span
    steps = [e for e in evs if e.name == "okst.train.step"]
    assert len(steps) == STEPS


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_optim_spans_cost_nothing_when_off(kg, name, monkeypatch):
    ds, index = kg
    with profile(activities=[ProfilerActivity.CPU]):
        on = _group(name, ds, index)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.span("okst.train.loss") is obs.span("okst.train.optim")
    off = _group(name, ds, index)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
