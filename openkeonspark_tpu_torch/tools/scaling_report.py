"""Analytic multi-device scaling report: each mesh's collective bytes,
counted on the real step, priced on H100 links.

Counterpart of ``tools/scaling_report.py``, with its flags, meshes
(``MESHES``) and JSON keys. For each mesh the port's step
(``parallel.build_train_step_for``: psum, exchange, or the hierarchical
step for a 3-tuple) runs one step of config #2's width (TransE d=200,
per-rank batch 2721, 14,541 entities; weak scaling, the global batch
2721 × ranks) on that many rank processes (``tools/ranks.py``, gloo;
``--devices`` caps the ranks, 16 unlocks the 16-rank meshes), under
``parallel.comm.CollectiveCounter`` with hosts of ``--chips-per-host``
ranks. The bytes depend on the shapes only, so gloo ranks on the CPU
count what cards would send. The model (``comm.predict_scaling``):

    step(mesh) = max(compute, comm) + (1 − overlap)·min(compute, comm)
    comm       = max(t_nvlink, t_net)   [pipelined; --link-model serial
                                         sums]
    t_nvlink   = wire_ici bytes/dev / NVLINK_BW  (225 GB/s: half the
                 H100 SXM5's 450 GB/s a direction)
    t_net      = wire_dcn bytes/dev / NET_BW     (24.8 GB/s: half the
                 payload rate of one 400 Gb/s NIC a GPU)
    compute    = the single-device step time, overlap 0 (eager steps)

Every efficiency is a prediction from those sourced constants
(``parallel/comm.py``); no link was measured. ``--step-ms`` gives the
single-device step time; without it the tool measures it on
``--device`` through ``bench_all``'s timing of config #2 at this width
(the median of five timed calls of 50 steps, its group depth's floor,
after two warm calls, the host clock read after
``torch.cuda.synchronize()``, on a KG of 100 batches), and prints it
beside the card's name and power limit.

Usage:
    python -m openkeonspark_tpu_torch.tools.scaling_report [--step-ms X]
        [--batch 2721] [--d 200] [--step exchange|psum]
        [--chips-per-host 8] [--meshes 2x2,2x2x2] [--device cuda]
Prints a markdown table, the sensitivity table, then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.parallel.comm import (BW_BRACKETS,
                                                   OVERLAP_BRACKETS,
                                                   predict_scaling)
from openkeonspark_tpu_torch.tools import add_device_flag, open_device
from openkeonspark_tpu_torch.tools.ranks import run_ranks

# 2-tuples = flat grids (data, model); 3-tuples = hierarchical (host,
# data, model); the JAX tool's list (tools/scaling_report.py:55-56)
MESHES = [(1, 1), (2, 1), (2, 2), (4, 2), (2, 4), (2, 2, 2), (2, 1, 4),
          (4, 2, 2), (8, 2), (2, 2, 4)]
# the single-device step's timing: bench_all's defaults, five timed calls
# of 50 steps (config #2's group depth at B = 2,721, its 50-step floor)
STEP_TIME_STEPS, STEP_TIME_REPEATS = 50, 5


def config_of(args) -> Config:
    return Config(model="transe", hidden_size=args["d"], negative_ent=1,
                  sharded_step=args["step"],
                  exchange_wire_dtype=args["wire_dtype"],
                  exchange_ici_wire_dtype=args["ici_dtype"],
                  exchange_hot_rows=args["hot_rows"],
                  exchange_capacity=args["capacity"])


def dataset_of(args):
    from openkeonspark_tpu_torch.data import random_kg
    # collective shapes depend on batch, d and mesh; 'stats' capacities
    # also on the degree tables, so config #5 runs pass --n-triples
    return random_kg(n_ent=args["n_ent"], n_rel=237,
                     n_triples=args["n_triples"], n_valid=100, n_test=100,
                     seed=7)


def mesh_bytes(args, dev: torch.device) -> dict:
    """On every rank of a world: one step of each of ``args['meshes']``
    (all of the world's size) under the counter; {mesh: its dict}."""
    from openkeonspark_tpu_torch.data import build_kg_index
    from openkeonspark_tpu_torch.models import get_model
    from openkeonspark_tpu_torch.parallel import (Sharding,
                                                  build_train_step_for,
                                                  degree_stats, make_mesh,
                                                  plan_sharded_step,
                                                  shard_state,
                                                  sync_hot_cache)
    from openkeonspark_tpu_torch.parallel.comm import CollectiveCounter
    from openkeonspark_tpu_torch.sampling import DeviceSampler
    from openkeonspark_tpu_torch.train.loop import group_generator
    from openkeonspark_tpu_torch.train.step import init_state
    ds = dataset_of(args)
    cfg = config_of(args)
    model = get_model(cfg.model)
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  dev)
    degrees = degree_stats(ds)
    out = {}
    for shape in map(tuple, args["meshes"]):
        grid = make_mesh(shape, dev)
        batch = args["batch"] * grid.size   # weak scaling
        flat = plan_sharded_step(cfg, batch, grid) != "psum"
        state = shard_state(init_state(
            model, cfg, ds.n_ent, ds.n_rel, torch.Generator().manual_seed(0),
            dev, pad_to_multiple=grid.size), grid, flat)
        state = sync_hot_cache(state, model, degrees, Sharding(grid, flat))
        step = build_train_step_for(model, cfg, grid, batch, ds.n_train,
                                    None, degrees)
        bits = sampler.draw_bits(step.bits_shape, group_generator(
            cfg, 0, dev, grid.d_idx, grid.data))
        with CollectiveCounter(args["chips_per_host"]) as counter:
            step(state, sampler, bits)
        out[str(list(shape))] = dict(counter.bytes,
                                     collectives=counter.count)
    return out


def count_meshes(args, meshes, device: str) -> dict:
    """{mesh: counter dict} of every mesh, a world of ranks per mesh size
    (one after another; a (1, 1) mesh in this process)."""
    by_world = {}
    for shape in meshes:
        n = 1
        for s in shape:
            n *= s
        by_world.setdefault(n, []).append(list(shape))
    out = {}
    for n, group in sorted(by_world.items()):
        job = dict(args, meshes=group)
        got = (mesh_bytes(job, torch.device(device)) if n == 1 else
               run_ranks("openkeonspark_tpu_torch.tools.scaling_report:"
                         "mesh_bytes", n, job, device)[0])
        out.update({tuple(json.loads(k)): v for k, v in got.items()})
    return out


def single_device_step_ms(args, dev: torch.device,
                          steps: int = STEP_TIME_STEPS,
                          repeats: int = STEP_TIME_REPEATS) -> float:
    """Median ms a step of the configuration's single-device step, from
    ``bench_all``'s own timing of config #2 (``bench_config``) at this
    width, on a KG of 100 batches (config #2's shape at the defaults)."""
    from openkeonspark_tpu_torch.tools.bench_all import bench_config
    spec = dict(model="transe", d=args["d"], n_ent=args["n_ent"], n_rel=237,
                n_train=args["batch"] * 100, nbatches=100)
    rec = bench_config(2, spec, steps, dev, repeats)
    return rec["batch"] / rec["triples_per_sec"] * 1e3


def parse_meshes(text: str):
    return [tuple(int(x) for x in m.split("x")) for m in text.split(",")]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step-ms", type=float, default=None,
                    help="single-device step time; measured on --device "
                         "when not given")
    ap.add_argument("--batch", type=int, default=2721)
    ap.add_argument("--d", type=int, default=200)
    ap.add_argument("--n-ent", type=int, default=14541)
    ap.add_argument("--step", default="exchange",
                    choices=["exchange", "psum"])
    ap.add_argument("--chips-per-host", type=int, default=8,
                    help="GPUs a node joins over NVLink (link "
                         "classification)")
    ap.add_argument("--link-model", default="pipelined",
                    choices=["pipelined", "serial"])
    ap.add_argument("--ici-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="hier stage-1 (inside a host) update wire dtype")
    ap.add_argument("--wire-dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "float8_e4m3fn"],
                    help="exchange wire dtype (a2a payloads)")
    ap.add_argument("--devices", type=int, default=8,
                    help="the most ranks a mesh may take (16 unlocks the "
                         "16-rank meshes)")
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="replicate the top-K highest-degree entity rows "
                         "(parallel/hot.py); requires --capacity stats")
    ap.add_argument("--n-triples", type=int, default=20000,
                    help="synthetic store size (matters in stats mode)")
    ap.add_argument("--meshes", default="",
                    help="comma list of mesh shapes, e.g. '2x2,2x2x2' "
                         "(empty = the standard list)")
    ap.add_argument("--capacity", default="uniform",
                    choices=["uniform", "stats"])
    add_device_flag(ap)
    return ap


def job_args(a: argparse.Namespace) -> dict:
    """The ranks' arguments of parsed flags."""
    return {"d": a.d, "step": a.step, "wire_dtype": a.wire_dtype,
            "ici_dtype": a.ici_dtype, "hot_rows": a.hot_rows,
            "capacity": a.capacity, "n_ent": a.n_ent,
            "n_triples": a.n_triples, "batch": a.batch,
            "chips_per_host": a.chips_per_host}


def meshes_of(a: argparse.Namespace):
    """The meshes the flags ask for, within ``--devices`` ranks (the
    hierarchical ones only for the exchange step)."""
    meshes = parse_meshes(a.meshes) if a.meshes else MESHES
    return [s for s in meshes if int(torch.tensor(s).prod()) <= a.devices
            and not (len(s) == 3 and a.step != "exchange")]


def main(argv=None):
    a = build_parser().parse_args(argv)
    dev, label = open_device(a.device)
    args = job_args(a)
    cfg = config_of(args)
    payload_by_mesh = count_meshes(args, meshes_of(a), str(dev))

    if a.step_ms is None:
        step_ms = single_device_step_ms(args, dev)
        source = f"measured on {label}"
    else:
        step_ms, source = a.step_ms, "given (--step-ms)"
    print(f"single-device step: {step_ms:.4f} ms, {source}")

    def predict(shapes, **kw):
        kw.setdefault("link_model", a.link_model)
        return predict_scaling(step_ms / 1e3,
                               {s: payload_by_mesh[s] for s in shapes},
                               gpus_per_host=a.chips_per_host, **kw)

    table = predict(payload_by_mesh)
    print("| mesh | devices | payload MB/dev | wire MB/dev "
          "| NVLink MB/dev | network MB/dev | comm ms | pred step ms "
          "| scaling eff (predicted) |")
    print("|---|---|---|---|---|---|---|---|---|")
    for shape, row in sorted(table.items(),
                             key=lambda kv: (kv[1]["devices"], len(kv[0]))):
        pl = payload_by_mesh[shape]
        name = str(shape) + (" hier" if len(shape) == 3 else "")
        print(f"| {name} | {row['devices']} | {pl['total']/1e6:.2f} | "
              f"{row['wire_bytes_per_device']/1e6:.2f} | "
              f"{pl.get('wire_ici', 0)/1e6:.2f} | "
              f"{pl.get('wire_dcn', 0)/1e6:.2f} | "
              f"{row['comm_s']*1e3:.3f} | {row['predicted_step_s']*1e3:.3f} "
              f"| {row['scaling_efficiency']:.1%} |")

    print("\nSensitivity (predicted scaling efficiency; bandwidth "
          "×0.5/×1/×2, overlap 0%/90%/100%; final column = serialized "
          "NVLink + network at nominal bandwidth, overlap 0%):")
    print("| mesh | " + " | ".join(
        f"bw×{b:g}, ov={o:.0%}" for b in BW_BRACKETS
        for o in OVERLAP_BRACKETS) + " | serial links |")
    print("|---|" + "---|" * (len(BW_BRACKETS) * len(OVERLAP_BRACKETS) + 1))
    sens = {}
    for shape in sorted(payload_by_mesh, key=lambda s: (len(s), list(s))):
        cells = [predict([shape], bw_scale=b, overlap=o)[shape][
            "scaling_efficiency"] for b in BW_BRACKETS
            for o in OVERLAP_BRACKETS]
        serial = predict([shape], link_model="serial")[shape][
            "scaling_efficiency"]
        sens[str(shape)] = cells + [serial]
        print(f"| {shape} | " + " | ".join(f"{c:.0%}" for c in cells)
              + f" | {serial:.0%} |")

    out = {"step": a.step, "step_ms": step_ms,
           "chips_per_host": a.chips_per_host,
           "link_model": a.link_model,
           "wire_dtype": cfg.exchange_wire_dtype,
           "dedup": cfg.exchange_dedup,
           "hot_rows": cfg.exchange_hot_rows,
           "capacity": cfg.exchange_capacity,
           "meshes": {str(k): {**v, "payload_bytes":
                               payload_by_mesh[k]["total"],
                               "wire_ici": payload_by_mesh[k].get(
                                   "wire_ici"),
                               "wire_dcn": payload_by_mesh[k].get(
                                   "wire_dcn"),
                               "payload": payload_by_mesh[k]}
                      for k, v in table.items()},
           "sensitivity": sens,
           "device": label,
           "step_ms_source": source,
           "efficiency": "predicted from the sourced link constants of "
                         "parallel/comm.py; only the single-device step "
                         "was timed, no link was measured"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
