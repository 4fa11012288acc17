"""What the generic-step training traffic modules share
(:mod:`.train_adv`, :mod:`.train_relneg`): :mod:`.train`'s step groups back
to back, for configurations that train through the port's generic step
with any optimizer, relation negatives included, held to
:mod:`kgbench.reference.generic`.

Set-up, window and traced slice are :class:`.train.Traffic`'s: the seeded
tables, the optimizer's ``init``, ``DeviceSampler.build``,
``build_train_step(get_model(model), …)`` and ``build_group_runner`` at
the port's own group size, :data:`.train.CHECKED_STEPS` checked steps on
draws the benchmark makes, then one group. The draws are ``[S, B, 1 +
2·negE + negR]``. Besides each checked step's batch (relation negatives
included) and loss and the tables after steps 1 and 3, set-up keeps the
optimizer's first moment after step 1 where the optimizer has one.

``compare`` runs the reference over the same draws (the checked steps',
and the first group's from a generator seeded as the group's was) and
hands both sides to ``checks``: :mod:`.train`'s for SGD, or the
traffic module's own."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kgbench.common import (KG_SEED, PROGRAM_SEED, TABLE_SEED, make_tables,
                            program_config, program_dataset, sync)
from kgbench.kg import kg_of
from kgbench.reference import generic as ref
from kgbench.traffic import train

CHECKED_STEPS = train.CHECKED_STEPS


def host(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in d.items()}


class GenericTraffic(train.Traffic):

    def prepare(self) -> None:
        from openkeonspark_tpu_torch.data.index import build_kg_index
        from openkeonspark_tpu_torch.models.base import get_model
        from openkeonspark_tpu_torch.sampling.device import DeviceSampler
        from openkeonspark_tpu_torch.train.optim import make_optimizer
        from openkeonspark_tpu_torch.train.step import (TrainState,
                                                        build_group_runner,
                                                        build_train_step)
        run, c = self.run, self.run.config
        self.kg = kg_of(c, run.sub_seed(KG_SEED))
        ds = program_dataset(self.kg)
        self.sampler = DeviceSampler.build(
            ds, build_kg_index(ds, for_eval=False), self.dev)
        cfg = program_config(c, run.sub_seed(PROGRAM_SEED) % (1 << 31))
        self.spec = ref.tables_spec(c, self.kg.n_ent, self.kg.n_rel)
        params = make_tables(self.spec, run.sub_seed(TABLE_SEED), self.dev)
        control = run.workload.get("control", {})
        if run.control and control.get("side") == "program":
            cfg = cfg.replace(dtype=control["dtype"])
            params = {k: v.to(getattr(torch, control["dtype"]))
                      for k, v in params.items()}
        self.cfg = cfg
        self.B = cfg.resolve_batch_size(ds.n_train)
        self.S = cfg.scan_group_size(self.B)
        self.state = TrainState(params, make_optimizer(cfg).init(params), 0)
        step = build_train_step(get_model(cfg.model), cfg, self.B)
        self.runner = build_group_runner(step, self.S)

        bits = ref.draw_bits(self.generator(-1), CHECKED_STEPS, self.B, c,
                             self.dev)
        self.seen = {"loss": [], "batch": []}
        for k in range(CHECKED_STEPS):
            b = self.sampler.sample(self.B, cfg.negative_ent,
                                    cfg.negative_rel, cfg.bern, bits=bits[k])
            self.seen["batch"].append(tuple(
                np.zeros((self.B, 0), np.int64) if getattr(b, f) is None
                else getattr(b, f).cpu().numpy() for f in ref.FIELDS))
            self.state, loss = step(self.state, self.sampler, bits[k])
            self.seen["loss"].append(float(loss))
            if k == 0 and "m" in self.state.opt_state:
                self.seen["m1"] = host(self.state.opt_state["m"])
            if k in (0, CHECKED_STEPS - 1):
                self.seen[f"p{k + 1}"] = host(self.state.params)
        del bits
        self.unit()
        self.seen["group_loss"] = float(self.loss)
        sync(self.dev)

    def compare(self) -> Dict[str, float]:
        c = self.run.config
        sampler = ref.Sampler(self.kg.train, self.kg.n_ent, self.kg.n_rel)
        p0 = make_tables(self.spec, self.run.sub_seed(TABLE_SEED), self.dev)
        draws = [ref.draw_bits(self.generator(-1), CHECKED_STEPS, self.B, c,
                               self.dev),
                 ref.draw_bits(self.generator(0), self.S, self.B, c,
                               self.dev)]
        self.want = ref.follow(c, sampler, p0, draws)
        side_p0 = p0
        if self.run.control:   # the program's own lower precision
            dt = getattr(torch, self.run.workload["control"]["dtype"])
            side_p0 = {k: v.to(dt).float() for k, v in p0.items()}
        want = {"loss": self.want["step_loss"][:CHECKED_STEPS],
                "batch": self.want["batch"][:CHECKED_STEPS],
                "grad": self.want["grad"], "g1": self.want["g1"],
                "pN": self.want["tables"][0],
                "group_loss": self.want["loss"][1]}
        return self.checks(want, self.seen, p0, side_p0)

    def checks(self, want: dict, side: dict, p0, side_p0) -> dict:
        """SGD's compared numbers (:func:`.train.checks`); an optimizer
        whose step is not ``α·g`` brings its own."""
        return train.checks(want, side, p0, side_p0, self.run.config["alpha"])
