"""Host milliseconds a training step inside ``okst.train.gather``: the slot
rows' gathers (``gather_slots_structured``; the grouped TransR step: the
relation sort, the entity and relation gathers, ``run_offsets``); the
spans' time in the traced slice over its ``okst.train.step`` spans
(``kgbench/spans.py``). Moves ``train_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.train.gather", "okst.train.step")
