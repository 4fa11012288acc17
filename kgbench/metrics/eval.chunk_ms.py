"""Host milliseconds a chunk of link prediction, both directions, inside
``okst.eval.chunk``: the known-id windows, the queries, B1's counts, the
id scores and the filter compare; the mean of the traced slice's
``okst.eval.chunk`` spans (``kgbench/spans.py``). Moves
``eval_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.eval.chunk", "okst.eval.chunk")
