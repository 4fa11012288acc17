"""Per-stage step-time breakdown of a bench_all config.

Counterpart of ``tools/step_breakdown.py`` (``:47-251``). Times
cumulative prefixes of the training step — sampling → +gather → +score →
+grad → full step — each as S steps from one draw of random bits (as the
group runner draws them), plus the isolated hot ops of TransR (the wide
``transfer_matrix`` scatter through ``train/optim.py::scatter_add_rows``,
kernel B5 on a card; the M_r gather; the projection einsum). Differences
between consecutive prefixes attribute the step time; the isolated ops
cross-check the attribution. Where the JAX tool scanned the S steps inside
one program, the port runs them eagerly, so each stage's time includes
the host's launches. The full step's device time comes from
``torch.profiler`` (one group of S steps, profiled after every timing).

For TransR the full step is the relation-grouped step (kernels B4 fwd and
bwd; with relation negatives and fp32 tables a second pair for their
stream); the grad prefix takes it too (``loss_and_row_grads``, as in the JAX
package), while the gather and score prefixes decompose the generic
step's per-row matrices. RotatE with fp32 tables likewise takes its slot
route (``ops/rotate_train.py``, which gathers no slot) in the grad prefix
and the full step, while its gather and score prefixes decompose the
generic step.

Usage: python -m openkeonspark_tpu_torch.tools.step_breakdown
           [--config 4] [--steps 50] [--device cuda]
Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json

import torch

from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.sampling.device import DeviceSampler
from openkeonspark_tpu_torch.tools import (add_device_flag, device_ms,
                                           launch_counts, launched_since,
                                           open_device, timed_best)
from openkeonspark_tpu_torch.tools.bench_all import (CONFIGS, config_of,
                                                     sampler_of)
from openkeonspark_tpu_torch.train.optim import DenseUpdate, scatter_add_rows
from openkeonspark_tpu_torch.train.step import (build_group_runner,
                                                build_train_step,
                                                gather_slots_structured,
                                                init_state,
                                                loss_and_row_grads,
                                                use_grouped_transr,
                                                use_grouped_transr_relneg)

STAGES = ("sampling", "gather", "score", "grad")


def attribute(cumulative: dict) -> dict:
    """Per-stage times from the cumulative prefixes: each stage the
    difference from the one before, ``update`` the full step less the
    grad prefix; they sum to the full step."""
    prev, out = 0.0, {}
    for name in STAGES:
        out[name] = cumulative[name] - prev
        prev = cumulative[name]
    out["update"] = cumulative["full"] - prev
    return out


def stage_fns(model, cfg, B):
    """name → ``stage(params, batch) -> scalar`` of each prefix."""

    def gather(params, b):
        return gather_slots_structured(model, params, b)[0]

    def st_sample(params, b):
        acc = b.h.sum() + b.t.sum() + b.r.sum()
        if b.neg_h is not None:
            acc = acc + b.neg_h.sum() + b.neg_t.sum()
        return acc.float()

    def st_gather(params, b):
        return sum(v.sum(dtype=torch.float32) for v in gather(params, b)
                   .values())

    def st_score(params, b):
        shaped = {k: v.view(v.shape[0] // B, B, v.shape[-1])
                  for k, v in gather(params, b).items()}
        return model.score(shaped, cfg).sum(dtype=torch.float32)

    def st_grad(params, b):
        loss, updates = loss_and_row_grads(model, cfg, params, b)
        acc = loss.float()
        for u in updates.values():
            g = u.grad if isinstance(u, DenseUpdate) else u[1]
            acc = acc + g.sum(dtype=torch.float32)
        return acc

    return dict(zip(STAGES, (st_sample, st_gather, st_score, st_grad)))


def isolated_transr_ops(params, cfg, B, S, n_rel, dev, emit):
    """The wide scatter (B5 on a card: S launches a call), the M_r gather
    and the projection einsum at the step's shapes, S times a call."""
    de, dr = cfg.d_ent, cfg.d_rel
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ids = torch.randint(0, n_rel, (B,), generator=g, device=dev)
    delta = torch.randn(B, de * dr, generator=g, device=dev)
    table = params["transfer_matrix"].clone()
    wide_bytes = B * de * dr * 4

    def iso_scatter():
        for _ in range(S):
            scatter_add_rows(table, ids, delta)
        return table

    t = timed_best(iso_scatter, dev)
    before = launch_counts()
    iso_scatter()
    launches = launched_since(before).get("scatter_add_rows_sorted", 0)
    emit({"op": "wide_scatter_B_rows", "ms": round(t / S * 1e3, 3),
          "gb_per_s": round(wide_bytes / (t / S) / 1e9, 1),
          "b5_launches_per_call": launches, "steps_per_call": S})
    del table

    tm = params["transfer_matrix"]

    def iso_gather():
        acc = torch.zeros((), device=dev)
        for _ in range(S):
            acc += tm[ids].sum(dtype=torch.float32)
        return acc

    t = timed_best(iso_gather, dev)
    emit({"op": "m_r_gather_B_rows", "ms": round(t / S * 1e3, 3),
          "gb_per_s": round(wide_bytes / (t / S) / 1e9, 1)})

    h_e = torch.randn(2, B, de, generator=g, device=dev)
    m = delta.view(B, de, dr)

    def iso_einsum():
        acc = torch.zeros((), device=dev)
        for _ in range(S):
            acc += torch.einsum("sbe,ber->sbr", h_e, m).sum()
        return acc

    t = timed_best(iso_einsum, dev)
    emit({"op": "proj_einsum_2seg", "ms": round(t / S * 1e3, 3)})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    spec = CONFIGS[args.config]
    lines = []

    def emit(rec):
        rec["device"] = label
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    cfg = config_of(spec)
    B = spec["n_train"] // spec["nbatches"]
    S = args.steps
    model = get_model(cfg.model)
    sampler = sampler_of(spec, dev)
    state = init_state(model, cfg, sampler.n_ent, sampler.n_rel,
                       torch.Generator().manual_seed(7), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bits = sampler.draw_bits(
        (S, B, DeviceSampler.bits_cols(cfg.negative_ent, cfg.negative_rel)),
        gen)

    def prefix(stage):
        def run():
            acc = torch.zeros((), device=dev)
            with torch.no_grad():
                for s in range(S):
                    b = sampler.sample(B, cfg.negative_ent,
                                       cfg.negative_rel, cfg.bern,
                                       bits=bits[s])
                    acc += stage(state.params, b)
            return acc
        return run

    results = {}
    for name, fn in stage_fns(model, cfg, B).items():
        t = timed_best(prefix(fn), dev)
        results[name] = t / S
        emit({"stage": name, "ms": round(t / S * 1e3, 3)})

    run = build_group_runner(build_train_step(model, cfg, B), S)
    gens = iter(range(10, 100))

    def full():
        g = torch.Generator(device=dev)
        g.manual_seed(next(gens))
        st, loss = run(state, sampler, g)
        return float(loss)

    t = timed_best(full, dev)
    results["full"] = t / S
    attributed = attribute(results)

    out = {
        "config": args.config, "model": spec["model"], "batch": B,
        "steps_per_call": S,
        "ms_per_step_cumulative": {k: round(v * 1e3, 3)
                                   for k, v in results.items()},
        "ms_per_step_attributed": {k: round(v * 1e3, 3)
                                   for k, v in attributed.items()},
        "triples_per_sec": round(B / results["full"], 1),
    }
    if use_grouped_transr(cfg) or use_grouped_transr_relneg(cfg,
                                                            state.params):
        out["note"] = ("full step and grad prefix take the relation-"
                       "grouped step; the gather and score prefixes "
                       "decompose the GENERIC step, so their attribution "
                       "does not apply to it")

    if spec["model"] == "transr":
        isolated_transr_ops(state.params, cfg, B, S, spec["n_rel"], dev,
                            emit)
    # profiled last: a process launches more slowly once traced
    dms = device_ms(full, dev)
    out["full_device_ms_per_step"] = (None if dms is None
                                      else round(dms / S, 3))
    emit(out)
    return lines


if __name__ == "__main__":
    main()
