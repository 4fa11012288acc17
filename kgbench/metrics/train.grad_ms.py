"""Host milliseconds a training step inside ``okst.train.grad``:
``torch.autograd.grad`` (the grouped TransR step: B4 backward); the
spans' time in the traced slice over its ``okst.train.step`` spans
(``kgbench/spans.py``). Moves ``train_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.train.grad", "okst.train.step")
