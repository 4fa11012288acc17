"""Host milliseconds a training step inside ``okst.train.update``: both
``okst.train.update`` spans of a step: ``merged_row_updates`` (and the
grouped step's dense ``transfer_matrix`` update), then the optimizer's
``apply``; the spans' time in the traced slice over its
``okst.train.step`` spans (``kgbench/spans.py``). Moves
``train_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.train.update", "okst.train.step")
