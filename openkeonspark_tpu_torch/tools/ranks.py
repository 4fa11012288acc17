"""The port's one launcher of rank processes.

:func:`run_processes` starts commands at once, each with its output to a
log, and kills every one once one fails or at the deadline, raising with
the failed one's output. ``tools/acceptance.py`` runs ``cli.launch``
ranks through it, ``tests/torch_dist_worker.py`` its test ranks.

:func:`run_ranks` starts ``world`` processes of

    python -m openkeonspark_tpu_torch.tools.ranks <job.json> <rank>

which join one gloo process group (a ``file://`` rendezvous in a private
directory, so runs never share a port), call the job's function
``fn(args, device)`` on every rank (their collectives must match) and
write its return value; ``run_ranks`` returns every rank's. The tools
that run a step on a grid (``scaling_report``, ``overlap_report``) and
``chip_smoke.py``'s grid phases use it. Gloo runs on the CPU and over
CUDA tensors alike, so ranks may share one card, which NCCL refuses; the
collectives' bytes depend on the shapes only, so they are the same on
either backend."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

RANKS_TIMEOUT = 900.0      # seconds a world's ranks may take
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rank_env() -> dict:
    """The environment of a rank process: this checkout first on the
    import path, one OpenMP thread (the ranks share the host's cores)."""
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, (ROOT, os.environ.get("PYTHONPATH")))))


def run_processes(cmds: Sequence[Sequence[str]], work: str, timeout: float,
                  names: Optional[Sequence[str]] = None,
                  cwd: Optional[str] = None) -> List[str]:
    """Run every command of ``cmds`` at once in :func:`rank_env`, the
    output of command i to ``work/proc{i}.log``; returns their outputs.
    Once one exits non-zero, or at ``timeout`` seconds, every one still
    running is killed, and one that failed is raised with the tail of its
    output (``names[i]`` names it, else ``process i``): one that exited on
    its own before one that was killed."""
    env = rank_env()
    logs = [os.path.join(work, f"proc{i}.log") for i in range(len(cmds))]
    procs, killed = [], set()
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    list(cmd), env=env, cwd=cwd, stdout=out,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.add(i)
            p.wait()
    texts = []
    for log in logs:
        with open(log) as f:
            texts.append(f.read())
    bad = sorted((i in killed, i) for i, p in enumerate(procs)
                 if p.returncode != 0)
    if bad:
        i = bad[0][1]
        name = names[i] if names else f"process {i}"
        raise RuntimeError(f"{name} of {len(cmds)} exited "
                           f"{procs[i].returncode}"
                           f"{' (killed)' if i in killed else ''}:\n"
                           f"{texts[i][-4000:]}")
    return texts


def run_ranks(fn: str, world: int, args: dict, device: str,
              timeout: float = RANKS_TIMEOUT) -> list:
    """Every rank's return value of ``fn`` (``"module:function"``, a
    module importable from this checkout) run on ``world`` rank processes
    on ``device``, rank 0's first."""
    with tempfile.TemporaryDirectory(prefix="okst_ranks_") as work:
        job = os.path.join(work, "job.json")
        with open(job, "w") as f:
            json.dump({"fn": fn, "args": args, "device": device,
                       "world": world, "init": os.path.join(work, "pg"),
                       "result": os.path.join(work, "result{}.json"),
                       "timeout": timeout}, f)
        run_processes([[sys.executable, "-m",
                        "openkeonspark_tpu_torch.tools.ranks", job, str(r)]
                       for r in range(world)], work, timeout,
                      names=[f"{fn} rank {r}" for r in range(world)])
        out = []
        for r in range(world):
            with open(os.path.join(work, f"result{r}.json")) as f:
                out.append(json.load(f))
        return out


def main():
    job_path, rank = sys.argv[1], int(sys.argv[2])
    with open(job_path) as f:
        job = json.load(f)
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    torch.set_num_threads(1)   # the ranks share the host's cores
    dist.init_process_group("gloo", init_method="file://" + job["init"],
                            rank=rank, world_size=job["world"],
                            timeout=timedelta(seconds=job["timeout"]))
    try:
        module, name = job["fn"].split(":")
        out = getattr(importlib.import_module(module), name)(job["args"],
                                                             device)
    finally:
        dist.destroy_process_group()
    with open(job["result"].format(rank), "w") as f:
        json.dump(out, f)
    # A gloo rank may abort in the interpreter's exit-time destructors
    # ("terminate called without an active exception", a few runs in a
    # hundred on a loaded host) after its work is done: leave without them.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
