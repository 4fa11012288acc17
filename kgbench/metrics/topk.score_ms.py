"""Host milliseconds a top-k query inside ``okst.topk.score``: every block
of candidates scored and their ``cat``; the spans' time in the traced
slice over its ``okst.topk.query`` spans (``kgbench/spans.py``). Moves
``topk_p95_ms``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.topk.score", "okst.topk.query")
