"""Training throughput (positive triples/s) of every bench_all config on
one device.

Counterpart of ``tools/bench_all.py`` (``CONFIGS`` ``:35-52``,
``bench_config`` ``:55-107``): configs 1–8 on ``random_kg(seed=7)``, batch
= train / nbatches, the port's ``DeviceSampler`` and
``train/step.py::build_train_step`` run through ``build_group_runner`` at
depth ``max(--steps, cfg.scan_group_size(batch))``. Two warm calls (the
kernel build and first allocations fall outside the timed calls), then
the median of ``--repeats`` timed calls with its relative spread. The JAX
tool fused a group into one program; the port runs its steps eagerly.

1. TransE d=64, FB15K-237 subset (3k ents / 40k triples), 1 neg
2. TransE d=200, FB15K-237 shape (14.5k ents / 237 rels / 272k triples)
3. TransH d=200, WN18RR shape (41k ents / 11 rels / 87k triples)
4. TransR d_e=200 d_r=100, FB15K shape (15k ents / 1345 rels / 483k
   triples); the relation-grouped step (kernels B4 fwd and bwd each step)
5. TransE d=256, DBpedia scale (2M ents / 600 rels / 10M triples)
6. DistMult d=200, FB15K-237 shape
7. ComplEx d=100 (2·100 table lanes), FB15K-237 shape
8. RotatE d=100 (2·100 entity lanes, phase relations), FB15K-237 shape

Usage: python -m openkeonspark_tpu_torch.tools.bench_all
           [--configs 1,2,3,4,5] [--steps 200] [--repeats 5] [--device cuda]
Prints one JSON line per config; on a card it also carries the peak
device memory of the config (``torch.cuda.max_memory_allocated``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.sampling.device import DeviceSampler
from openkeonspark_tpu_torch.tools import add_device_flag, clock, open_device
from openkeonspark_tpu_torch.train.step import (build_group_runner,
                                                build_train_step, init_state)

CONFIGS = {
    1: dict(model="transe", d=64, n_ent=3000, n_rel=100, n_train=40000,
            nbatches=100),
    2: dict(model="transe", d=200, n_ent=14541, n_rel=237, n_train=272115,
            nbatches=100),
    3: dict(model="transh", d=200, n_ent=40943, n_rel=11, n_train=86835,
            nbatches=100),
    4: dict(model="transr", d=200, d_rel=100, n_ent=14951, n_rel=1345,
            n_train=483142, nbatches=100),
    5: dict(model="transe", d=256, n_ent=2_000_000, n_rel=600,
            n_train=10_000_000, nbatches=1000),
    6: dict(model="distmult", d=200, n_ent=14541, n_rel=237,
            n_train=272115, nbatches=100),
    7: dict(model="complex", d=100, n_ent=14541, n_rel=237,
            n_train=272115, nbatches=100),
    8: dict(model="rotate", d=100, n_ent=14541, n_rel=237,
            n_train=272115, nbatches=100),
}


def config_of(spec: dict) -> Config:
    """The training configuration of a bench_all config (also
    ``step_breakdown``'s)."""
    cfg = Config(model=spec["model"], hidden_size=spec["d"], alpha=0.01,
                 margin=1.0, negative_ent=1, negative_rel=0, bern=True,
                 nbatches=spec["nbatches"])
    if spec["model"] == "transr":
        cfg = cfg.replace(ent_size=spec["d"], rel_size=spec["d_rel"])
    return cfg


def dataset_of(spec: dict):
    return random_kg(n_ent=spec["n_ent"], n_rel=spec["n_rel"],
                     n_triples=spec["n_train"], n_valid=100, n_test=100,
                     seed=7)


def sampler_of(spec: dict, dev: torch.device) -> DeviceSampler:
    """The config's KG as a device sampler (``random_kg(seed=7)``)."""
    ds = dataset_of(spec)
    return DeviceSampler.build(ds, build_kg_index(ds, for_eval=False), dev)


def bench_config(i: int, spec: dict, steps: int, dev: torch.device,
                 repeats: int = 5, samplers: Optional[dict] = None) -> dict:
    """One config's line: ``steps_per_call`` steps a timed call (of
    ``2 + repeats`` calls in all), triples/s median and spread;
    ``setup_s``, the host seconds to make the KG, its index and sampler
    and the tables; on a card the config's peak device memory.
    ``samplers`` keeps the last KG's sampler for the next config of the
    same shape (configs 6, 7 and 8 share config 2's), and drops it before
    another KG is made."""
    kg = (spec["n_ent"], spec["n_rel"], spec["n_train"])
    samplers = {} if samplers is None else samplers
    if kg not in samplers:
        samplers.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if kg not in samplers:
        samplers[kg] = sampler_of(spec, dev)
    sampler = samplers[kg]
    cfg = config_of(spec)
    batch = spec["n_train"] // spec["nbatches"]
    model = get_model(cfg.model)
    state = init_state(model, cfg, sampler.n_ent, sampler.n_rel,
                       torch.Generator().manual_seed(7), dev)
    setup_s = clock(dev) - t0
    # the fusion depth training uses (small batches group deeper)
    steps = max(steps, cfg.scan_group_size(batch))
    run = build_group_runner(build_train_step(model, cfg, batch), steps)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    for seed in (1, 999):        # two warm calls
        state, loss = run(state, sampler, gen(seed))
        float(loss)
    rates = []
    for r in range(repeats):
        t0 = clock(dev)
        state, loss = run(state, sampler, gen(1000 + r))
        float(loss)
        rates.append(steps * batch / (clock(dev) - t0))
    med = float(statistics.median(rates))
    out = {"config": i, "model": spec["model"], "d": spec["d"],
           "n_ent": spec["n_ent"], "n_train": spec["n_train"],
           "batch": batch, "triples_per_sec": round(med, 1),
           "spread": round((max(rates) - min(rates)) / med, 3),
           "steps_per_call": steps, "calls": 2 + repeats,
           "final_loss": float(loss), "setup_s": round(setup_s, 2)}
    if dev.type == "cuda":
        out["peak_device_MB"] = round(
            torch.cuda.max_memory_allocated(dev) / 1e6, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=5)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    out, samplers = [], {}
    for i in [int(x) for x in args.configs.split(",")]:
        rec = bench_config(i, CONFIGS[i], args.steps, dev, args.repeats,
                           samplers)
        rec["device"] = label
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
