"""Host milliseconds a training step inside ``okst.train.sampling``: the
device sampler's ``sample`` (``sampling/device.py``: the positives'
records, the Bernoulli flips, the complement search of the corrupted
entities); the spans' time in the traced slice over its
``okst.train.step`` spans (``kgbench/spans.py``). Moves
``train_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.train.sampling", "okst.train.step")
