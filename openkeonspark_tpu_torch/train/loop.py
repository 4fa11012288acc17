"""Training loop: epochs × batches with validation-accuracy early
stopping, checkpoints, and a triples/s meter.

Counterpart of ``openkeonspark_tpu/train/loop.py:36-256`` for the device
sampler. Steps run in groups (``cfg.scan_group_size``), each group from
one draw of random bits made by a generator seeded from ``cfg.seed + 17``
and the global step at which the group starts. A run resumed from a
checkpoint therefore replays the data order of an uninterrupted one (the
contract of the JAX package's step-derived keys, ``loop.py:165-171``).

The meter reports positive triples consumed per second over a clock read
after ``torch.cuda.synchronize()`` (on a card), so it times the device
work and not its enqueueing. Not ported: the host sampler, ``trace_dir``
and ``exchange_hot_rows`` (refused by ``check_train_supported``)."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import Dataset
from openkeonspark_tpu.data.index import KGIndex, build_kg_index
from openkeonspark_tpu_torch.models.base import get_model
from openkeonspark_tpu_torch.sampling.device import DeviceSampler
from openkeonspark_tpu_torch.train.step import (TrainState,
                                                build_group_runner,
                                                build_train_step,
                                                check_train_supported,
                                                init_state)


@dataclass
class EpochStats:
    epoch: int
    loss: float
    seconds: float
    triples_per_sec: float
    valid_accuracy: Optional[float] = None


@dataclass
class TrainResult:
    state: TrainState
    history: List[EpochStats] = field(default_factory=list)
    stopped_early: bool = False
    best_valid_accuracy: Optional[float] = None
    best_epoch: Optional[int] = None

    @property
    def final_loss(self) -> float:
        return self.history[-1].loss if self.history else float("nan")


class _Logger:
    """Echoes one line per record and appends it to ``cfg.log_path`` as a
    JSON line when set."""

    def __init__(self, cfg: Config, echo: Callable[[str], None] = print):
        self.echo = echo
        self.f = None
        if cfg.log_path:
            os.makedirs(os.path.dirname(os.path.abspath(cfg.log_path)) or ".",
                        exist_ok=True)
            self.f = open(cfg.log_path, "a")

    def __call__(self, record: Dict):
        if self.f is not None:
            self.f.write(json.dumps(record) + "\n")
            self.f.flush()
        self.echo(" ".join(f"{k}={v:.6g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in record.items()))

    def close(self):
        if self.f is not None:
            self.f.close()


def group_generator(cfg: Config, step: int,
                    device: torch.device) -> torch.Generator:
    """The generator of the step group that starts at global ``step``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((cfg.seed + 17) << 32) + step)
    return gen


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train(cfg: Config, ds: Dataset, device: torch.device,
          index: Optional[KGIndex] = None,
          state: Optional[TrainState] = None,
          checkpoint_dir: Optional[str] = None,
          valid_fn: Optional[Callable] = None,
          epoch_callback: Optional[Callable] = None,
          echo: Callable[[str], None] = print) -> TrainResult:
    """Run the training schedule on ``device``.

    - ``state``: resume / warm-start state (default: a fresh one from
      ``cfg.seed``); its tables are updated in place.
    - ``valid_fn(state) -> float``: early-stop metric, higher is better
      (default: triple-classification accuracy on the valid split).
    - ``checkpoint_dir``: ``step_N`` checkpoints on improvement and at the
      end.
    - ``epoch_callback(epoch, state)``: called after every epoch."""
    check_train_supported(cfg)
    model = get_model(cfg.model)
    if index is None:
        index = build_kg_index(ds, for_eval=False)
    batch_size = cfg.resolve_batch_size(ds.n_train)
    if state is None:
        state = init_state(model, cfg, ds.n_ent, ds.n_rel,
                           torch.Generator().manual_seed(cfg.seed), device)

    sampler = DeviceSampler.build(ds, index, device)
    step_fn = build_train_step(model, cfg, batch_size)
    sps = max(1, min(cfg.scan_group_size(batch_size), cfg.nbatches))
    n_full, rem = divmod(cfg.nbatches, sps)
    groups = [(build_group_runner(step_fn, sps), sps)] * n_full
    if rem:
        groups.append((build_group_runner(step_fn, rem), rem))

    if cfg.valid_every and valid_fn is None and ds.valid is not None \
            and len(ds.valid):
        eval_index = index if index.hr_all is not None else \
            build_kg_index(ds, for_eval=True)

        def valid_fn(st):
            from openkeonspark_tpu_torch.eval.classification import \
                fit_thresholds
            _, acc = fit_thresholds(st.params, cfg, ds, eval_index,
                                    seed=cfg.seed + 1)
            return acc

    ckpt = None
    if checkpoint_dir:
        from openkeonspark_tpu_torch.ckpt import CheckpointManager
        ckpt = CheckpointManager(checkpoint_dir)

    log = _Logger(cfg, echo)
    result = TrainResult(state=state)
    best_acc, best_epoch, bad_checks = -np.inf, None, 0
    try:
        for epoch in range(cfg.train_times):
            t0 = _clock(device)
            losses, weights = [], []
            for run, size in groups:
                gen = group_generator(cfg, state.step, device)
                state, loss = run(state, sampler, gen)
                losses.append(loss)
                weights.append(size)
            # group means weighted to the epoch mean over nbatches steps
            mean_loss = float(np.average(
                torch.stack(losses).cpu().numpy(), weights=weights))
            dt = _clock(device) - t0
            tps = cfg.nbatches * batch_size / dt
            stats = EpochStats(epoch=epoch, loss=mean_loss, seconds=dt,
                               triples_per_sec=tps)

            if cfg.valid_every and valid_fn is not None \
                    and (epoch + 1) % cfg.valid_every == 0:
                acc = float(valid_fn(state))
                stats.valid_accuracy = acc
                if acc > best_acc + cfg.early_stop_min_delta:
                    best_acc, best_epoch, bad_checks = acc, epoch, 0
                    if ckpt is not None:
                        ckpt.save(state.step, state,
                                  extra={"valid_accuracy": acc,
                                         "epoch": epoch})
                else:
                    bad_checks += 1

            result.history.append(stats)
            if epoch_callback is not None:
                epoch_callback(epoch, state)
            if cfg.log_every and (epoch + 1) % cfg.log_every == 0:
                rec = {"epoch": epoch, "loss": mean_loss,
                       "triples_per_sec": round(tps, 1),
                       "seconds": round(dt, 3)}
                if stats.valid_accuracy is not None:
                    rec["valid_accuracy"] = stats.valid_accuracy
                log(rec)

            if cfg.valid_every and bad_checks >= cfg.early_stop_patience:
                result.stopped_early = True
                log({"event": "early_stop", "epoch": epoch,
                     "best_valid_accuracy": best_acc,
                     "best_epoch": best_epoch})
                break

        result.state = state
        result.best_valid_accuracy = None if best_epoch is None else best_acc
        result.best_epoch = best_epoch
        if ckpt is not None:
            ckpt.save(state.step, state,
                      extra={"final": True, "loss": result.final_loss})
    finally:
        log.close()
    return result
