"""Host syncs a top-k query: blocking runtime calls (``kgbench/spans.py``)
that start inside an ``okst.topk.query`` span of the traced slice, over
those spans. Moves ``topk_p95_ms``."""

from kgbench.spans import syncs_per


def read(ctx):
    return syncs_per(ctx.slice, "okst.topk.query", "okst.topk.query")
