"""Multi-process launcher of the port: one copy per rank, the same flags
plus each rank's ``--process_id``.

Counterpart of ``openkeonspark_tpu/cli/launch.py``. Each process calls
``torch.distributed.init_process_group`` at ``--coordinator host:port``
with ``--num_processes`` ranks: NCCL with ``--device cuda``, where rank
``p`` drives card ``p % torch.cuda.device_count()``, gloo with
``--device cpu``. The ranks form the (data, model) grid (``--mesh_data
-1``: every rank left after ``--mesh_model``) and train through
``cli.train.run``; only rank 0 echoes. A re-launch resumes from the latest
checkpoint in ``--output``, as a single-device run does.

    # one process per card of one host (NCCL)
    for p in 0 1 2 3; do
      python -m openkeonspark_tpu_torch.cli.launch --coordinator \\
          localhost:29500 --num_processes 4 --process_id $p \\
          --mesh_data -1 --mesh_model 2 --device cuda \\
          --input data/FB15K --output out --model transe ... &
    done; wait
    # the same on the CPU (gloo): --device cpu
"""

from __future__ import annotations

import sys
from datetime import timedelta

import torch
import torch.distributed as dist

from openkeonspark_tpu_torch.cli.args import build_parser, config_from_args
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.runtime import resolve_device

# how long a rank waits for the others, at start and in any collective
TIMEOUT = timedelta(minutes=10)


def rank_device(cfg: Config, device: torch.device) -> torch.device:
    """The device of rank ``cfg.process_id``: its card on a card."""
    if device.type == "cuda":
        return torch.device("cuda",
                            cfg.process_id % torch.cuda.device_count())
    return device


def init_distributed(cfg: Config, device: torch.device) -> None:
    """Form the process group of ``cfg.num_processes`` ranks at
    ``cfg.coordinator``: NCCL for a card, gloo for the CPU."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{cfg.coordinator}",
                            world_size=cfg.num_processes,
                            rank=cfg.process_id, timeout=TIMEOUT)


def join_process_group(cfg: Config, device: torch.device) -> None:
    """Form the process group when ``cfg.coordinator`` names one and none
    is formed yet; more than one process without either is refused."""
    if dist.is_initialized():
        return
    if cfg.coordinator:
        init_distributed(cfg, device)
    elif cfg.num_processes > 1:
        raise ValueError(f"--num_processes {cfg.num_processes} needs "
                         "--coordinator host:port")


def main(argv=None) -> dict:
    p = build_parser(__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device of every rank (cuda or cpu)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    device = rank_device(cfg, resolve_device(args.device))
    if not cfg.coordinator and cfg.num_processes == 1:
        cfg = cfg.replace(coordinator="localhost:0")
    # a world of one still forms its group, and one all_reduce checks
    # the backend on the rank's device
    join_process_group(cfg, device)
    try:
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe)
        if int(probe.item()) != dist.get_world_size():
            raise RuntimeError(f"{dist.get_backend()} all_reduce gave "
                               f"{probe.item()}")
        d, m = cfg.mesh_shape
        if d == -1:
            d = max(1, dist.get_world_size() // max(m, 1))
        cfg = cfg.replace(mesh_shape=(d, m), coordinator="")
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"{cfg.num_processes} process(es), "
                  f"{dist.get_backend()} on {device.type}, mesh=({d},{m})",
                  flush=True)
        from openkeonspark_tpu_torch.cli.train import run
        summary = run(cfg, device, args.export_format,
                      echo=print if rank0 else (lambda *_: None))
        # no rank tears the group down while a peer still uses it
        dist.barrier()
        return summary
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
