"""What every traffic module shares: the run's settings, seeds derived
from ``--seed``, the seeded tables, and the port's configuration and
dataset built from a configuration file and a KG."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from kgbench.kg import KG

# tags of the seeds a run derives from --seed
KG_SEED, TABLE_SEED, QUERY_SEED, PROGRAM_SEED, GROUP_SEED = 1, 2, 3, 4, 5


@dataclass
class Run:
    """One run of one cell: its files' contents, ``--seed``, the device,
    and, for the calibration and the tests only, a ``control`` switch and
    the faults to plant (names from the traffic module's ``FAULTS``)."""
    workload: dict
    config: dict
    mix: dict
    seed: int
    device: torch.device
    control: bool = False
    faults: tuple = ()

    def sub_seed(self, tag: int) -> int:
        """A 63-bit seed for one purpose, the same for the same ``--seed``
        (any whole number, also one beyond 64 bits)."""
        words = np.random.SeedSequence(
            [self.seed % (1 << 64), tag]).generate_state(2, np.uint32)
        return (int(words[0]) << 31) ^ int(words[1])

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_tables(spec: Dict[str, tuple], seed: int, dev: torch.device
                ) -> Dict[str, torch.Tensor]:
    """Xavier-uniform tables ``[rows + 1, width]`` in float32, the last row
    the zero pad row the port's layout keeps, drawn on ``dev`` from one
    generator seeded with ``seed``, one call a table in sorted name
    order: the same tables for the same seed, whenever drawn."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name in sorted(spec):
        rows, width = spec[name]
        lim = math.sqrt(6.0 / (rows + width))
        t = torch.empty(rows + 1, width, device=dev)
        t.uniform_(-lim, lim, generator=gen)
        t[rows:].zero_()
        out[name] = t
    return out


def program_config(config: dict, seed: int):
    """The port's ``Config`` of a configuration file: every key the
    dataclass has, and the run's seed."""
    from openkeonspark_tpu_torch.config import Config
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in config.items() if k in names}
    return Config(**kw, seed=seed)


def program_dataset(kg: KG):
    from openkeonspark_tpu_torch.data.dataset import Dataset
    return Dataset(n_ent=kg.n_ent, n_rel=kg.n_rel, train=kg.train,
                   valid=kg.valid, test=kg.test)
