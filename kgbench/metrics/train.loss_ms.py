"""Host milliseconds a training step inside ``okst.train.loss``: the loss
of the step's scores (the hinge, or the self-adversarial softmax and
log-sigmoids) inside ``okst.train.score``, on both routes; the spans'
time in the traced slice over its ``okst.train.step`` spans
(``kgbench/spans.py``). Moves ``train_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.train.loss", "okst.train.step")
