"""Training loop: epochs × batches with validation-accuracy early
stopping, checkpoints, and a triples/s meter.

Counterpart of ``openkeonspark_tpu/train/loop.py:36-256``. Steps run in
groups (``cfg.scan_group_size``), each group from
one draw of random bits made by a generator seeded from ``cfg.seed + 17``
and the global step at which the group starts. A run resumed from a
checkpoint therefore replays the data order of an uninterrupted one (the
contract of the JAX package's step-derived keys, ``loop.py:165-171``).

The meter reports positive triples consumed per second over a clock read
after ``torch.cuda.synchronize()`` (on a card), so it times the device
work and not its enqueueing. ``cfg.trace_dir`` records the second epoch
(epoch 1; the first carries the warm-up) with ``torch.profiler``, CPU and
CUDA activities on a card, the CPU alone on the CPU, and writes it as a
Chrome trace, ``epoch1.pt.trace.json``, into ``trace_dir``: the analog of
the JAX package's ``jax.profiler`` trace (``loop.py:175-206``), with the
step's stage spans (``obs.py``: ``okst.train.*``, and
``okst.train.host_wait`` around the host sampler's wait). Every
checkpoint's manifest records the vocabulary sizes (``n_ent``,
``n_rel``), so an incremental warm start can read them from any step.
The host sampler's groups come from ``sampling/host.py::HostPipeline``
(``loop.py:112-131, 182-186``), a grid's steps from ``parallel/``. With
``cfg.exchange_hot_rows`` the replicated ``#hot`` companions are refilled
from the tables (``parallel/hot.py::sync_hot_cache``, a collective on a
grid) after init, warm start or restore, before the first step
(``loop.py:134-139``)."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data.dataset import Dataset
from openkeonspark_tpu_torch.data.index import KGIndex, build_kg_index
from openkeonspark_tpu_torch.models.base import get_model
from openkeonspark_tpu_torch.obs import span
from openkeonspark_tpu_torch.sampling.device import DeviceSampler
from openkeonspark_tpu_torch.train.step import (TrainState,
                                                build_group_runner,
                                                build_host_scan_steps,
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


def group_generator(cfg: Config, step: int, device: torch.device,
                    data_row: int = 0, data_rows: int = 1
                    ) -> torch.Generator:
    """The generator of the step group that starts at global ``step``. On
    a grid with more than one data row, row ``data_row`` folds its index
    into the seed (the JAX package's ``fold_in(key, d)``), so rows draw
    distinct bits and the ranks of one row the same; one data row draws
    what one device draws."""
    seed = ((cfg.seed + 17) << 32) + step
    if data_rows > 1:
        seed = (seed * 0x9E3779B97F4A7C15 + data_row + 1) % (1 << 63)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


TRACE_NAME = "epoch1.pt.trace.json"


def _start_trace(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def train(cfg: Config, ds: Dataset, device: torch.device,
          index: Optional[KGIndex] = None,
          state: Optional[TrainState] = None,
          checkpoint_dir: Optional[str] = None,
          valid_fn: Optional[Callable] = None,
          epoch_callback: Optional[Callable] = None,
          echo: Callable[[str], None] = print,
          step_builder: Optional[Callable] = None,
          sharding=None) -> TrainResult:
    """Run the training schedule on ``device``.

    - ``state``: resume / warm-start state (default: a fresh one from
      ``cfg.seed``); its tables are updated in place.
    - ``valid_fn(state) -> float``: early-stop metric, higher is better
      (default: triple-classification accuracy on the valid split,
      through ``parallel.eval.ShardedTripleScorer`` on a grid).
    - ``checkpoint_dir``: ``step_N`` checkpoints on improvement and at the
      end.
    - ``epoch_callback(epoch, state)``: called after every epoch.
    - ``step_builder(model, cfg, batch_size, n_train) -> step_fn`` and
      ``sharding`` (``parallel.mesh.Sharding``, the state's row layout):
      the grid's step (``parallel.exchange.build_train_step_for``). Every
      rank calls ``train`` alike; only rank 0 writes the log, the trace
      and the checkpoints (which it gathers from every rank).

    ``cfg.sampler == 'host'`` feeds the steps from the native host sampler
    (``sampling/host.py``): stacked groups of batches, the worker seeded
    ``cfg.seed + step`` at the state's step, so a resumed run replays the
    data order; on a grid each data row takes its slice of every batch."""
    check_train_supported(cfg)
    model = get_model(cfg.model)
    if index is None:
        index = build_kg_index(ds, for_eval=False)
    batch_size = cfg.resolve_batch_size(ds.n_train)
    if state is None:
        state = init_state(model, cfg, ds.n_ent, ds.n_rel,
                           torch.Generator().manual_seed(cfg.seed), device)
    if cfg.exchange_hot_rows:
        from openkeonspark_tpu_torch.parallel.hot import (degree_stats,
                                                          sync_hot_cache)
        state = sync_hot_cache(state, model, degree_stats(ds), sharding)
    grid = sharding.grid if sharding is not None else None
    lead = grid is None or grid.rank == 0
    data_row, data_rows = (grid.d_idx, grid.data) if grid else (0, 1)

    step_fn = (step_builder(model, cfg, batch_size, ds.n_train)
               if step_builder is not None else None)
    sps = max(1, min(cfg.scan_group_size(batch_size), cfg.nbatches))
    n_full, rem = divmod(cfg.nbatches, sps)
    sizes = [sps] * n_full + ([rem] if rem else [])
    pipe = None
    if cfg.sampler == "host":
        from openkeonspark_tpu_torch.sampling.host import (HostPipeline,
                                                           HostSampler)
        batch_step = None
        if step_fn is not None:
            b_local = step_fn.bits_shape[0]
            lo = data_row * b_local
            batch_step = lambda st, b: step_fn.batch_step(  # noqa: E731
                st, b.map(lambda x: x[lo:lo + b_local]))
        host_run = build_host_scan_steps(model, cfg, batch_step)
        pipe = HostPipeline(HostSampler(ds, index,
                                        n_threads=cfg.work_threads),
                            batch_size, cfg.negative_ent, cfg.negative_rel,
                            cfg.bern, seed=cfg.seed + state.step,
                            group_sizes=sizes, device=device)

        def next_group():
            with span("okst.train.host_wait"):
                return pipe.next()

        groups = [(lambda st, _s, _g: host_run(st, next_group()), size)
                  for size in sizes]
        sampler = None
    else:
        sampler = DeviceSampler.build(ds, index, device)
        step_fn = step_fn or build_train_step(model, cfg, batch_size)
        runners = {size: build_group_runner(step_fn, size)
                   for size in set(sizes)}
        groups = [(runners[size], size) for size in sizes]

    if cfg.valid_every and valid_fn is None and ds.valid is not None \
            and len(ds.valid):
        eval_index = index if index.hr_all is not None else \
            build_kg_index(ds, for_eval=True)
        score_fn = None
        if sharding is not None:
            from openkeonspark_tpu_torch.parallel.eval import \
                ShardedTripleScorer
            score_fn = ShardedTripleScorer(cfg, sharding)

        def valid_fn(st):
            from openkeonspark_tpu_torch.eval.classification import \
                fit_thresholds
            _, acc = fit_thresholds(st.params, cfg, ds, eval_index,
                                    seed=cfg.seed + 1, score_fn=score_fn)
            return acc

    ckpt = None
    if checkpoint_dir:
        from openkeonspark_tpu_torch.ckpt import CheckpointManager
        ckpt = CheckpointManager(checkpoint_dir, sharding=sharding)

    log = _Logger(cfg if lead else cfg.replace(log_path=""), echo)
    result = TrainResult(state=state)
    best_acc, best_epoch, bad_checks = -np.inf, None, 0
    vocab = {"n_ent": ds.n_ent, "n_rel": ds.n_rel}
    prof = None
    try:
        for epoch in range(cfg.train_times):
            if cfg.trace_dir and epoch == 1 and lead:
                prof = _start_trace(device)
            t0 = _clock(device)
            losses, weights = [], []
            for run, size in groups:
                gen = group_generator(cfg, state.step, device, data_row,
                                      data_rows)
                state, loss = run(state, sampler, gen)
                losses.append(loss)
                weights.append(size)
            # group means weighted to the epoch mean over nbatches steps
            mean_loss = float(np.average(
                torch.stack(losses).cpu().numpy(), weights=weights))
            dt = _clock(device) - t0      # synchronizes a card
            if prof is not None:
                prof.stop()
                os.makedirs(cfg.trace_dir, exist_ok=True)
                path = os.path.join(cfg.trace_dir, TRACE_NAME)
                prof.export_chrome_trace(path)
                prof = None
                log({"event": "trace_written", "dir": cfg.trace_dir,
                     "file": path})
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
                                         "epoch": epoch, **vocab})
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
                      extra={"final": True, "loss": result.final_loss,
                             **vocab})
    finally:
        if prof is not None:
            prof.stop()
        if pipe is not None:
            pipe.close()
        log.close()
    return result
