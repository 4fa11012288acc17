"""Host milliseconds an evaluation inside ``okst.eval.fetch``: each group's
ranks concatenated and copied to the host, with the wait for the
device's queue to drain; the spans' time in the traced slice over its
``okst.eval.evaluation`` spans (``kgbench/spans.py``). Moves
``eval_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.eval.fetch", "okst.eval.evaluation")
