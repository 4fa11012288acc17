"""Host syncs an evaluation: blocking runtime calls (``kgbench/spans.py``)
that start inside an ``okst.eval.evaluation`` span of the traced slice,
over those spans: the finite guard's read, the host copies of the ranks
and any other read back. Moves ``eval_triples_per_s``."""

from kgbench.spans import syncs_per


def read(ctx):
    return syncs_per(ctx.slice, "okst.eval.evaluation",
                     "okst.eval.evaluation")
