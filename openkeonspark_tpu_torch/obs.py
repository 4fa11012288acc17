"""Stage spans of the port's hot paths, recorded only while a profiler
records.

:func:`span` returns ``torch.profiler.record_function(name)`` while a
``torch.profiler`` profile is recording (``--trace_dir``'s epoch trace, the
tools' profiles, a benchmark's traced slice), and one shared null context
otherwise. The profiler's trace is the only store: a span lands there as a
``user_annotation`` range on the same clock as the device's kernels, and
nothing is kept in memory. Off, a span costs one check of the profiler's
state; no span opens inside a per-negative, per-block or per-kernel loop,
so that cost stays a fixed, small number per unit of work.

Spans (every name starts with ``okst.``):

Training (``train/step.py``, ``train/loop.py``)

- ``okst.train.group``: one group of S steps, in ``build_group_runner``
  and ``build_host_scan_steps``: the bits draw, the steps, the mean loss.
- ``okst.train.step``: one step, once a step: ``build_train_step``'s step
  and each step of ``build_host_scan_steps``.
- ``okst.train.sampling``: the device sampler's ``sample`` in
  ``build_train_step``'s step (absent on the host-sampler path).
- ``okst.train.gather``: the slot rows' gathers (``loss_and_row_grads``:
  ``gather_slots_structured``; the grouped TransR step: the relation sort,
  the entity and relation gathers, ``run_offsets``).
- ``okst.train.score``: the forward, scores and the margin loss
  (``slot_loss_and_grads``; the grouped TransR step: B4 forward).
- ``okst.train.grad``: ``torch.autograd.grad`` (grouped TransR: B4
  backward).
- ``okst.train.update``: twice a step, ``merged_row_updates`` (and the
  grouped step's dense ``transfer_matrix`` update) in the loss functions,
  then the optimizer's ``apply`` in ``build_batch_step``'s step.
- ``okst.train.host_wait``: the wait for the host sampler's next stacked
  group (``train.loop.train``, ``--sampler host``).

Link prediction (``eval/link_prediction.py``)

- ``okst.eval.evaluation``: one ``link_prediction`` call.
- ``okst.eval.prepare``: the known windows (host lookups, the group
  arrays copied to the device), the finite guard (a host sync), the fp32
  copies of the tables and the route's own tables.
- ``okst.eval.chunk``: one chunk of test triples, both directions: the
  known-id windows, the queries, the counts, the id scores and the filter
  compare (chunk by chunk, and relation by relation).
- ``okst.eval.fetch``: one group's ranks concatenated and copied to the
  host, with the wait for the device's queue.

Top-k (``eval/predict.py``)

- ``okst.topk.query``: one top-k entity query.
- ``okst.topk.build``: the id tensors and the query.
- ``okst.topk.score``: every candidate block scored, and their ``cat``.
- ``okst.topk.select``: the sort and the k best.
- ``okst.topk.fetch``: the ids and scores copied to the host."""

from __future__ import annotations

import contextlib

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a range of the running
    profiler's trace, or does nothing when no profiler records."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF
