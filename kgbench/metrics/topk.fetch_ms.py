"""Host milliseconds a top-k query inside ``okst.topk.fetch``: the ids and
scores copied to the host, with the wait for the device's queue to
drain; the spans' time in the traced slice over its ``okst.topk.query``
spans (``kgbench/spans.py``). Moves ``topk_p95_ms``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.topk.fetch", "okst.topk.query")
