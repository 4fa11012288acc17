"""Training traffic: the port's step groups back to back, as
``train/loop.py::train`` runs them for its epochs.

Set-up builds one training state (the seeded tables, SGD's state), the
``DeviceSampler`` over the KG's train split, the step function
``build_train_step(...)`` and the group runner ``build_group_runner(step,
cfg.scan_group_size(batch))`` over it. It drives that state through
:data:`CHECKED_STEPS` calls of the step function, on u32 draws that the
benchmark makes, and then through one group of the runner. The window
runs further groups on the same state and runner, the device synchronised
after each. Every group gets a generator of its own, seeded from
``--seed`` and the group's number by the benchmark.

The comparison takes only what those public calls give: each checked
step's loss and the tables after steps 1 and 3, the batch the sampler
selects from each step's draws (``DeviceSampler.sample(..., bits=)``),
and the group's mean loss. The reference (:mod:`kgbench.reference.train`)
follows the same steps from the same initial tables: the checked steps on
the benchmark's draws, the group on the draws it takes itself from a
generator seeded as the group's was. Compared: the batches, id for id;
each step's loss; the first gradient as SGD applied it, ``(p0 − p1)/α``;
the change of the tables after three steps, ``p3 − p0``, each by the
worst table; and the group's loss. A group of 50 steps is compared by its
loss alone: L1 signs that rounding flips make the two sides' tables part
further with every step, and after 50 of them no table's norm separates
a sound run from the lower precision."""

from __future__ import annotations

import statistics
from contextlib import ExitStack
from typing import Dict
from unittest import mock

import numpy as np
import torch

from kgbench.common import (GROUP_SEED, KG_SEED, PROGRAM_SEED, TABLE_SEED,
                            Run, make_tables, program_config,
                            program_dataset, sync)
from kgbench.kg import kg_of
from kgbench.reference import train as ref
from kgbench.reference.sampler import TrainSampler

CHECKED_STEPS = 3
FIELDS = ("h", "t", "r", "neg_h", "neg_t")


class Traffic:
    unit_name = "steps"

    def __init__(self, run: Run):
        self.run = run
        self.dev = run.device
        self.groups = 0

    def generator(self, group: int) -> torch.Generator:
        """The generator of the run's ``group``-th step group; group −1
        makes the draws of the checked steps."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed((self.run.sub_seed(GROUP_SEED) + group + 1)
                        % (1 << 63))
        return gen

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
        control = self.run.workload.get("control", {})
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

        host = lambda d: {k: v.detach().to("cpu", torch.float32, copy=True)  # noqa: E731
                          for k, v in d.items()}
        self.bits = ref.draw_bits(self.generator(-1), CHECKED_STEPS, self.B,
                                  c["negative_ent"], self.dev)
        self.seen = {"loss": [], "batch": []}
        for k in range(CHECKED_STEPS):
            b = self.sampler.sample(self.B, cfg.negative_ent, 0, cfg.bern,
                                    bits=self.bits[k])
            self.seen["batch"].append(tuple(getattr(b, f).cpu().numpy()
                                            for f in FIELDS))
            self.state, loss = step(self.state, self.sampler, self.bits[k])
            self.seen["loss"].append(float(loss))
            if k in (0, CHECKED_STEPS - 1):
                self.seen[f"p{k + 1}"] = host(self.state.params)
        self.unit()
        self.seen["group_loss"] = float(self.loss)
        sync(self.dev)

    def unit(self) -> None:
        gen = self.generator(self.groups)
        self.groups += 1
        self.state, self.loss = self.runner(self.state, self.sampler, gen)

    def e2e(self, seconds: float, units: int) -> Dict[str, float]:
        return {"train_triples_per_s": units * self.S * self.B / seconds}

    def counts(self, units: int) -> Dict[str, int]:
        return {"steps": units * self.S}

    def shapes(self) -> dict:
        """The cell's shapes, and the distinct rows a step of the checked
        steps and group touched (from the reference's batches), for the
        metrics' byte counts."""
        rows = self.want["rows"]
        c = self.run.config
        return {"model": c["model"], "batch": self.B,
                "negative_ent": c["negative_ent"],
                "widths": {k: w for k, (_, w) in self.spec.items()},
                "rel_rows": self.kg.n_rel + 1,
                "ent_size": c.get("ent_size", c.get("hidden_size")),
                "rel_size": c.get("rel_size", c.get("hidden_size")),
                "distinct_ent_rows": statistics.mean(e for e, _ in rows),
                "distinct_rel_rows": statistics.mean(r for _, r in rows)}

    def free(self) -> None:
        self.last_loss = float(self.loss)
        del self.state, self.sampler, self.runner, self.loss

    def compare(self) -> Dict[str, float]:
        c = self.run.config
        sampler = TrainSampler(self.kg.train, self.kg.n_ent, self.kg.n_rel)
        p0 = make_tables(self.spec, self.run.sub_seed(TABLE_SEED), self.dev)

        def draws():
            return [ref.draw_bits(self.generator(-1), CHECKED_STEPS, self.B,
                                  c["negative_ent"], self.dev),
                    ref.draw_bits(self.generator(0), self.S, self.B,
                                  c["negative_ent"], self.dev)]
        self.want = ref.follow(c, sampler, p0, draws())
        control = self.run.workload.get("control", {})
        side_p0 = p0
        if self.run.control and control.get("side") == "reference":
            low = ref.follow(c, sampler, p0, draws(), control["mode"])
            side = {"loss": low["step_loss"][:CHECKED_STEPS],
                    "batch": low["batch"][:CHECKED_STEPS], "p1": low["p1"],
                    "p3": low["tables"][0], "group_loss": low["loss"][1]}
        else:
            side = self.seen
            if self.run.control:   # the program's own lower precision
                dt = getattr(torch, control["dtype"])
                side_p0 = {k: v.to(dt).float() for k, v in p0.items()}
        want = {"loss": self.want["step_loss"][:CHECKED_STEPS],
                "batch": self.want["batch"][:CHECKED_STEPS],
                "grad": self.want["grad"], "pN": self.want["tables"][0],
                "group_loss": self.want["loss"][1]}
        return checks(want, side, p0, side_p0, c["alpha"])


def checks(want: dict, side: dict, p0: Dict[str, torch.Tensor],
           side_p0: Dict[str, torch.Tensor], alpha: float) -> dict:
    """The compared numbers of a training cell: ``batch_mismatch`` (ids
    that differ from the reference's batches), ``loss_gap`` (the worst
    checked step's |loss − reference| over |reference|), ``grad_gap`` and
    ``change_gap`` (the worst table's gap between the two sides' norms,
    over the larger of the reference's norm of that table and of the
    median table) and ``group_loss_gap`` (the group's mean loss, as
    ``loss_gap``). ``p0`` are the tables both sides start from,
    ``side_p0`` the compared side's own (a lower-precision side rounds
    them). Tables whose reference gradient is under a thousandth of the
    median table's are left out of both."""
    mismatch = 0
    for got, ref_b in zip(side["batch"], want["batch"]):
        for a, b in zip(got, ref_b):
            a, b = np.asarray(a), np.asarray(b)
            mismatch += (int((a != b).sum()) if a.shape == b.shape
                         else max(a.size, b.size))
    mismatch += abs(len(side["batch"]) - len(want["batch"])) * len(FIELDS)

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    loss_gap = (max(rel(a, b) for a, b in zip(side["loss"], want["loss"]))
                if len(side["loss"]) == len(want["loss"]) else float("inf"))

    g_ref = want["grad"]
    g_med = statistics.median(g_ref.values())
    counted = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    cpu = lambda d: {k: v.detach().double().cpu() for k, v in d.items()}  # noqa: E731
    p0r, p0s = cpu(p0), cpu(side_p0)
    p1, p3, ref_n = cpu(side["p1"]), cpu(side["p3"]), cpu(want["pN"])
    g_side = {k: float((p0s[k] - p1[k]).norm()) / alpha for k in counted}
    ch_side = {k: float((p3[k] - p0s[k]).norm()) for k in counted}
    ch_ref = {k: float((ref_n[k] - p0r[k]).norm()) for k in g_ref}
    ch_med = statistics.median(ch_ref.values())

    def worst(got, ref_norms, med):
        return max(abs(got[k] - ref_norms[k]) / max(ref_norms[k], med, 1e-30)
                   for k in counted)

    return {"batch_mismatch": float(mismatch), "loss_gap": loss_gap,
            "grad_gap": worst(g_side, g_ref, g_med),
            "change_gap": worst(ch_side, ch_ref, ch_med),
            "group_loss_gap": rel(side["group_loss"], want["group_loss"]),
            # the readings behind them, for the calibration's record
            "norms": {"grad": [g_side, g_ref], "change": [ch_side, ch_ref],
                      "loss": [list(side["loss"]), list(want["loss"])],
                      "group_loss": [side["group_loss"],
                                     want["group_loss"]]}}


# ---------------------------------------------------------------------------
# faults planted under the timed path (the tests and the calibration only)


def _unchanged(run: Run, stack: ExitStack) -> None:
    """The optimizer leaves the state as it was."""
    from openkeonspark_tpu_torch.train import optim
    stack.enter_context(mock.patch.object(
        optim.SparseSGD, "apply",
        lambda self, params, state, updates, step, plain=False:
        (params, state)))


def _half_batch(run: Run, stack: ExitStack) -> None:
    """The loss takes half of the batch, scaled to the whole."""
    from openkeonspark_tpu_torch.train import step
    orig = step.margin_ranking_loss

    def half(pos, neg, margin, mode="mean_neg"):
        n = pos.shape[0] // 2
        return 2.0 * orig(pos[:n], neg[:n], margin, mode)
    stack.enter_context(mock.patch.object(step, "margin_ranking_loss", half))


def _token(run: Run, stack: ExitStack) -> None:
    """One negative's tail id is altered where the sampler makes it."""
    from openkeonspark_tpu_torch.sampling.device import DeviceSampler
    orig = DeviceSampler.sample

    def altered(self, *a, **kw):
        b = orig(self, *a, **kw)
        b.neg_t[0, 0] = (b.neg_t[0, 0] + 1) % self.n_ent
        return b
    stack.enter_context(mock.patch.object(DeviceSampler, "sample", altered))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "token": _token}
