"""The exchange step's microbatch curve: for each ``exchange_microbatches``
setting, the collectives a step issues, its per-device wire bytes and its
milliseconds a step on the grid.

Counterpart of ``tools/overlap_report.py``, with its flags and JSON keys
(TransE d=128, 4 entity negatives, global batch 2048 on ``random_kg(4096,
64, 40000, seed 0)``, the ``--mesh`` grid, default (2, 4)). The grid's
ranks are processes joined by gloo (``tools/ranks.py``) on ``--device``:
on one card they share it. Per setting they count one step under
``parallel.comm.CollectiveCounter`` (``collectives``: the collectives
issued outside the exact fallbacks, the JAX tool's count of the step
body's collective ops; ``wire_bytes_per_device``), then time the best of
three runs of ``--steps`` steps (``cpu_mesh_ms_per_step``, the JAX key,
here the grid's milliseconds a step on ``--device``, host clock after
``torch.cuda.synchronize()``, gloo's transfers included).

``dependent_pairs`` and ``independent_pairs`` are ``null``. The JAX tool
counts them on the def-use graph of the compiled step's HLO: pairs of
collectives with no data path between them, which XLA's latency-hiding
scheduler may overlap. The port's step is eager: each collective is
issued in program order and the overflow counts are read on the host
between collectives, so there is no program graph to read and no
scheduler to free; no figure stands in for them.

Usage: python -m openkeonspark_tpu_torch.tools.overlap_report
           [--mesh 2,4] [--mbs 1,2,4,8] [--steps 20] [--device cuda]
Prints one JSON line per setting.
"""

from __future__ import annotations

import argparse
import json

import torch

from openkeonspark_tpu_torch.tools import add_device_flag, clock, open_device
from openkeonspark_tpu_torch.tools.ranks import run_ranks

BATCH = 2048


def mb_curve(args, dev: torch.device) -> list:
    """On every rank: one counted step and the timed steps of each
    microbatch setting; rank 0's records."""
    from openkeonspark_tpu_torch.config import Config
    from openkeonspark_tpu_torch.data import build_kg_index, random_kg
    from openkeonspark_tpu_torch.models import get_model
    from openkeonspark_tpu_torch.parallel import (Sharding,
                                                  build_train_step_for,
                                                  degree_stats, make_mesh,
                                                  shard_state,
                                                  sync_hot_cache)
    from openkeonspark_tpu_torch.parallel.comm import CollectiveCounter
    from openkeonspark_tpu_torch.sampling import DeviceSampler
    from openkeonspark_tpu_torch.train.loop import group_generator
    from openkeonspark_tpu_torch.train.step import init_state
    ds = random_kg(n_ent=4096, n_rel=64, n_triples=40000, n_valid=100,
                   n_test=100, seed=0)
    model = get_model("transe")
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  dev)
    degrees = degree_stats(ds)
    grid = make_mesh(tuple(args["mesh"]), dev)
    sharding = Sharding(grid, True)
    out = []
    for mb in args["mbs"]:
        cfg = Config(model="transe", hidden_size=128, negative_ent=4,
                     exchange_microbatches=mb,
                     exchange_hot_rows=args["hot_rows"],
                     exchange_capacity=args["capacity"])
        state = sync_hot_cache(shard_state(init_state(
            model, cfg, ds.n_ent, ds.n_rel, torch.Generator().manual_seed(0),
            dev, pad_to_multiple=grid.size), grid, True), model, degrees,
            sharding)
        step = build_train_step_for(model, cfg, grid, BATCH, ds.n_train,
                                    None, degrees)

        def run(state, first):
            for s in range(first, first + args["steps"]):
                bits = sampler.draw_bits(step.bits_shape, group_generator(
                    cfg, s, dev, grid.d_idx, grid.data))
                state, loss = step(state, sampler, bits)
            float(loss)
            return state

        bits = sampler.draw_bits(step.bits_shape, group_generator(
            cfg, 0, dev, grid.d_idx, grid.data))
        with CollectiveCounter() as counter:
            state, loss = step(state, sampler, bits)
        float(loss)
        best = float("inf")
        for r in range(3):
            t0 = clock(dev)
            state = run(state, 1 + r * args["steps"])
            best = min(best, (clock(dev) - t0) / args["steps"])
        out.append({"microbatches": mb, "mesh": list(args["mesh"]),
                    "collectives": counter.count, "dependent_pairs": None,
                    "independent_pairs": None,
                    "wire_bytes_per_device": counter.bytes["wire"],
                    "cpu_mesh_ms_per_step": round(best * 1e3, 2)})
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="2,4",
                    help="2 ints = flat exchange; 3 = hierarchical "
                         "(host,data,model), e.g. 2,2,2")
    ap.add_argument("--mbs", default="1,2,4,8")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--hot-rows", type=int, default=0)
    ap.add_argument("--capacity", default="uniform",
                    choices=["uniform", "stats"])
    add_device_flag(ap)
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)
    dev, label = open_device(a.device)
    mesh = [int(x) for x in a.mesh.split(",")]
    world = 1
    for x in mesh:
        world *= x
    args = {"mesh": mesh, "mbs": [int(x) for x in a.mbs.split(",")],
            "steps": a.steps, "hot_rows": a.hot_rows,
            "capacity": a.capacity}
    recs = (mb_curve(args, dev) if world == 1 else run_ranks(
        "openkeonspark_tpu_torch.tools.overlap_report:mb_curve", world,
        args, str(dev))[0])
    for rec in recs:
        rec["device"] = label
        print(json.dumps(rec), flush=True)
    return recs


if __name__ == "__main__":
    main()
