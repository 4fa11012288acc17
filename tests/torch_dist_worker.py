"""One rank of the port's multi-process tests (not collected by pytest).

    python tests/torch_dist_worker.py <job.json> <rank> <world size>

Joins a gloo process group at the job's ``init_file`` (a ``file://``
rendezvous, so parallel test runs never share a port), runs the job's
tasks in order on the job's device (every rank runs every task: their
collectives must match) and, on rank 0, writes each task's result to
``<out_dir>/<task name>.npz``. Imports no jax: the ranks run the port
alone, on the CPU here and on a card where there is one.

Tasks (``kind``):

- ``steps``: ``steps`` training steps of the psum or exchange step on a
  (data, model) grid, or of the hierarchical step (``hier``) on a (host,
  data, model) grid, from the tables in ``params`` (an ``.npz`` of padded
  tables, with zeroed ``#hot`` companions for hot rows, which the task
  fills with ``sync_hot_cache``); the batches of data row ``d`` either
  come from ``batches`` (``s{step}_d{d}_{field}`` arrays, the JAX
  package's draws) or are drawn by the port's sampler from
  ``train.loop.group_generator``. Writes the full stripped tables
  (``p_<table>``) and optimizer slots (``s_<slot>_<table>``), the global
  losses, the fallback counts, the microbatches the step ran, every
  rank's companions after the sync (``sync_<key>``) and after the run
  (``hot_<key>``, ranks stacked), the degree-table capacities
  (``caps_<table>``), the ids the hierarchical step's buckets dropped
  per stage over all ranks (``overflow``: gather 1, 2, update 1, 2)
  and, with ``count_bytes`` (the ranks of a host), the steps' collective
  bytes as ``parallel.comm.CollectiveCounter`` counts them, summed over
  the steps (``comm_<key>`` for each byte key of its dict,
  ``comm_fallback`` the fallbacks' total, ``comm_count`` the collectives
  issued, ``comm_a2a_wire_ici`` and ``comm_a2a_wire_dcn`` the wire split
  of the ``all_to_all``s alone; ``comm_chips_per_host`` once).
- ``wire_sum``: ``parallel.hier.wire_sum`` of a seeded buffer per rank at
  the bf16 wire; writes rank 0's result.
- ``host_train``: ``train.loop.train`` with the host sampler on a grid
  (the psum or exchange step) from the tables in ``params``: every rank
  samples the global batch and its data row steps on its slice. Writes
  the full stripped tables and the epoch losses.
- ``link_prediction``: sharded (type-constrained with ``tc``) link
  prediction on a grid; writes the four rank arrays.
- ``classification``: ``triple_classification`` through the sharded
  triple scorer (rows over 'model', or over the grid with ``flat``);
  writes its metrics.
- ``a2a``: an ``all_to_all`` of a payload in ``dtype`` through
  ``parallel.mesh.all_to_all``; writes what rank 0 received and sent.
"""

import json
import os
import sys
from contextlib import nullcontext
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from openkeonspark_tpu_torch.config import Config  # noqa: E402
from openkeonspark_tpu_torch.data import (build_kg_index,  # noqa: E402
                                          build_type_constraints, random_kg)
from openkeonspark_tpu_torch.models import get_model  # noqa: E402
from openkeonspark_tpu_torch.models.base import strip_padding  # noqa: E402
from openkeonspark_tpu_torch.parallel import (  # noqa: E402
    Sharding, build_exchange_train_step, build_hier_train_step,
    build_sharded_train_step, build_train_step_for, degree_stats, make_mesh,
    shard_state, sync_hot_cache, unshard_state)
from openkeonspark_tpu_torch.parallel import hier  # noqa: E402
from openkeonspark_tpu_torch.parallel.comm import (  # noqa: E402
    CollectiveCounter, bytes_of)
from openkeonspark_tpu_torch.parallel.mesh import (  # noqa: E402
    HOT_SUFFIX, all_gather, all_reduce)
from openkeonspark_tpu_torch.sampling import (DeviceSampler,  # noqa: E402
                                              SampledBatch)
from openkeonspark_tpu_torch.train.loop import group_generator  # noqa: E402
from openkeonspark_tpu_torch.train.optim import make_optimizer  # noqa: E402
from openkeonspark_tpu_torch.train.step import TrainState  # noqa: E402

FIELDS = ("h", "t", "r", "neg_h", "neg_t", "neg_rel")


def _setup(task, device):
    cfg = Config(**task["cfg"])
    ds = random_kg(**task["kg"])
    model = get_model(cfg.model)
    with np.load(task["params"]) as z:
        params = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    return cfg, ds, model, params


def _companions(state, grid, prefix):
    """Every rank's ``#hot`` companions and their slots, ranks stacked
    ([ranks, K, d])."""
    out = {}
    trees = {"": state.params, **{f"{s}_": t
                                  for s, t in state.opt_state.items()}}
    for tag, tree in trees.items():
        for k, v in tree.items():
            if k.endswith(HOT_SUFFIX):
                out[f"{prefix}{tag}{k[:-len(HOT_SUFFIX)]}"] = all_gather(
                    v, grid, "grid").view(grid.size, *v.shape).cpu().numpy()
    return out


STEPS = {"psum": build_sharded_train_step,
         "exchange": build_exchange_train_step,
         "hier": build_hier_train_step}


def run_steps(task, device):
    cfg, ds, model, params = _setup(task, device)
    grid = make_mesh(tuple(task["grid"]), device)
    flat = task["step"] != "psum"
    degrees = degree_stats(ds)
    step_fn = STEPS[task["step"]](model, cfg, grid, task["batch"],
                                  ds.n_train, None,
                                  *([degrees] if flat else []))
    sharding = Sharding(grid, flat)
    state = shard_state(TrainState(params, make_optimizer(cfg).init(params),
                                   0), grid, flat)
    state = sync_hot_cache(state, model, degrees, sharding)
    out = _companions(state, grid, "sync_")
    batches = np.load(task["batches"]) if task.get("batches") else None
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                  device)
    counted = {}
    losses = []
    for i in range(task["steps"]):
        counter = CollectiveCounter(task.get("count_bytes") or 0)
        with counter if task.get("count_bytes") else nullcontext():
            if batches is not None:
                key = f"s{i}_d{grid.d_idx}_"
                batch = SampledBatch(**{
                    f: (torch.from_numpy(batches[key + f]).long().to(device)
                        if key + f in batches.files else None)
                    for f in FIELDS})
                state, loss = step_fn.batch_step(state, batch)
            else:
                gen = group_generator(cfg, state.step, device, grid.d_idx,
                                      grid.data)
                bits = sampler.draw_bits(step_fn.bits_shape, gen)
                state, loss = step_fn(state, sampler, bits)
        if counter.bytes is not None:
            a2a = bytes_of([e for e in counter.events
                            if e[0] == "all-to-all"], counter.chips_per_host)
            got = dict(counter.bytes, fallback=counter.bytes["fallback"][
                "total"], count=counter.count, a2a_wire_ici=a2a["wire_ici"],
                a2a_wire_dcn=a2a["wire_dcn"])
            got.pop("chips_per_host")
            counted = {k: counted.get(k, 0) + v for k, v in got.items()}
            counted["chips_per_host"] = counter.chips_per_host
        losses.append(float(loss))
    out.update(_stripped(unshard_state(state, sharding), model, cfg, ds))
    out.update(_companions(state, grid, "hot_"))
    out["loss"] = np.asarray(losses)
    stats = getattr(step_fn, "fallbacks", {})
    out["fallbacks"] = np.asarray([stats.get("gather", 0),
                                   stats.get("update", 0)])
    out["microbatches"] = np.asarray(getattr(step_fn, "microbatches", 0))
    if hasattr(step_fn, "overflow"):   # ids dropped per stage, all ranks
        out["overflow"] = all_reduce(torch.stack(
            [step_fn.overflow[k] for k in sorted(step_fn.overflow)]), grid,
            "grid").cpu().numpy()
    plan = getattr(step_fn, "plan", None)
    caps = (plan.caps if plan is not None
            else (getattr(step_fn, "stats_caps", None) or (0, {}))[1])
    for t, c in caps.items():
        out[f"caps_{t}"] = np.asarray([c[k] for k in sorted(c)])
    if plan is not None:
        out["lp"] = np.asarray(sorted(plan.lp_by_table.items())[0][1]
                               if plan.lp_by_table else 0)
    out.update({f"comm_{k}": np.asarray(v) for k, v in counted.items()})
    return out


def _stripped(full, model, cfg, ds):
    """The full state's tables (``p_<table>``) and optimizer slots
    (``s_<slot>_<table>``) without their padding rows."""
    specs = model.tables(cfg, ds.n_ent, ds.n_rel)
    out = {f"p_{k}": v for k, v in strip_padding(full.params, specs).items()}
    for slot, tables in full.opt_state.items():
        out.update({f"s_{slot}_{k}": v for k, v in
                    strip_padding(tables, specs).items()})
    return out


def run_host_train(task, device):
    from openkeonspark_tpu_torch.train.loop import train
    cfg, ds, model, params = _setup(task, device)
    grid = make_mesh(tuple(task["grid"]), device)
    sharding = Sharding(grid, task["step"] == "exchange")
    state = shard_state(TrainState(params, make_optimizer(cfg).init(params),
                                   0), grid, sharding.flat)
    res = train(cfg, ds, device, state=state, echo=lambda _: None,
                step_builder=lambda m, c, b, n: build_train_step_for(
                    m, c, grid, b, n),
                sharding=sharding)
    out = _stripped(unshard_state(res.state, sharding), model, cfg, ds)
    out["loss"] = np.asarray([e.loss for e in res.history])
    return out


def _sharded_params(task, device):
    """The task's tables, each rank keeping its rows: over 'model', or
    over the whole grid with ``flat``."""
    cfg, ds, model, params = _setup(task, device)
    grid = make_mesh(tuple(task["grid"]), device)
    sharding = Sharding(grid, bool(task.get("flat")))
    return cfg, ds, sharding, sharding.shard(params)


def run_link_prediction(task, device):
    from openkeonspark_tpu_torch.parallel.eval import (
        sharded_link_prediction, sharded_type_constrained_link_prediction)
    cfg, ds, sharding, params = _sharded_params(task, device)
    index = build_kg_index(ds, for_eval=True)
    triples = ds.test[:task["n_test"]]
    if task.get("tc"):
        res = sharded_type_constrained_link_prediction(
            params, cfg, ds, index, build_type_constraints(ds), sharding,
            triples=triples)
    else:
        res = sharded_link_prediction(params, cfg, ds, index, sharding,
                                      triples=triples)
    return res.ranks


def run_classification(task, device):
    from openkeonspark_tpu_torch.eval import triple_classification
    from openkeonspark_tpu_torch.parallel.eval import ShardedTripleScorer
    cfg, ds, sharding, params = _sharded_params(task, device)
    index = build_kg_index(ds, for_eval=True)
    out = triple_classification(params, cfg, ds, index,
                                score_fn=ShardedTripleScorer(cfg, sharding))
    return {k: np.asarray(v) for k, v in out.items()}


def run_a2a(task, device):
    from openkeonspark_tpu_torch.parallel.mesh import all_to_all
    grid = make_mesh(tuple(task["grid"]), device)
    g = torch.Generator().manual_seed(grid.rank)
    x = (torch.randn(grid.size * 4, 3, generator=g) * 4).to(
        getattr(torch, task["dtype"])).to(device)
    got = all_to_all(x, grid)
    bits = lambda t: t.cpu().view(torch.uint8).numpy()  # noqa: E731
    return {"sent": bits(x), "got": bits(got)}


def launch(tmp_path, worlds, device: str = "cpu", timeout: float = 240.0):
    """Run each world's tasks (``{world size: [task, …]}``) on that many
    rank processes of this script, every world at once
    (``tools.ranks.run_processes``), and return {task name: its npz as a
    dict}. Raises with the rank's output if any rank fails or outlives
    ``timeout`` seconds (every rank is killed then)."""
    import tempfile
    from openkeonspark_tpu_torch.tools.ranks import run_processes
    cmds, names, works = [], [], []
    for world, tasks in worlds.items():
        work = tempfile.mkdtemp(dir=str(tmp_path))
        works.append((work, tasks))
        job = os.path.join(work, "job.json")
        with open(job, "w") as f:
            json.dump({"init_file": os.path.join(work, "pg"),
                       "out_dir": work, "device": device, "tasks": tasks,
                       "timeout": timeout}, f)
        cmds += [[sys.executable, os.path.abspath(__file__), job, str(r),
                  str(world)] for r in range(world)]
        names += [f"rank {r} of world {world}" for r in range(world)]
    run_processes(cmds, str(tmp_path), timeout, names=names, cwd=REPO)
    res = {}
    for work, tasks in works:
        for t in tasks:
            with np.load(os.path.join(work, t["name"] + ".npz")) as z:
                res[t["name"]] = {k: z[k] for k in z.files}
    return res


def wire_sum_input(rank: int) -> torch.Tensor:
    """Rank ``rank``'s buffer of the ``wire_sum`` task: magnitudes in
    [0.5, 2), so an fp32 sum of four bf16 values is exact."""
    g = torch.Generator().manual_seed(100 + rank)
    sign = torch.randint(0, 2, (64, 9), generator=g) * 2 - 1
    return sign * (0.5 + 1.5 * torch.rand(64, 9, generator=g))


def run_wire_sum(task, device):
    grid = make_mesh(tuple(task["grid"]), device)
    got = hier.wire_sum(wire_sum_input(grid.rank).to(device), grid,
                        torch.bfloat16)
    return {"got": got.cpu().numpy()}


TASKS = {"steps": run_steps, "host_train": run_host_train,
         "link_prediction": run_link_prediction,
         "classification": run_classification, "a2a": run_a2a,
         "wire_sum": run_wire_sum}


def main():
    job_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(job_path) as f:
        job = json.load(f)
    device = torch.device(job.get("device", "cpu"))
    torch.set_num_threads(1)   # the ranks share the host's cores
    dist.init_process_group("gloo", init_method="file://" + job["init_file"],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=job.get("timeout",
                                                              120)))
    try:
        for task in job["tasks"]:
            out = TASKS[task["kind"]](task, device)
            if rank == 0:
                np.savez(os.path.join(job["out_dir"], task["name"] + ".npz"),
                         **out)
    finally:
        dist.destroy_process_group()
    # as tools/ranks.py: leave without the exit-time destructors, in which
    # a gloo rank may abort after its work is done
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
