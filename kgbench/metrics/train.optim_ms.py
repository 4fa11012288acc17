"""Host milliseconds a training step inside ``okst.train.optim``: the
optimizer's ``apply`` (SGD's adds; lazy Adam's gradient sums, touched
mask and moment update), inside the step's second ``okst.train.update``
span, so ``train.update_ms`` keeps it; the spans' time in the traced
slice over its ``okst.train.step`` spans (``kgbench/spans.py``). Moves
``train_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.train.optim", "okst.train.step")
