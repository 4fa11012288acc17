"""Host syncs a training step: blocking runtime calls
(``kgbench/spans.py``) that start inside an ``okst.train.group`` span of
the traced slice, over its ``okst.train.step`` spans. The group runner
reads no value back, so it promises 0; a sync inside a group stalls the
host until the device's queue drains. Moves ``train_triples_per_s``."""

from kgbench.spans import syncs_per


def read(ctx):
    return syncs_per(ctx.slice, "okst.train.group", "okst.train.step")
