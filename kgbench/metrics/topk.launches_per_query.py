"""Device events (kernels, copies, fills) per top-k query: those in the
traced slice over its queries. Moves ``topk_p95_ms``."""


def read(ctx):
    if not ctx.slice.device:
        return None
    return ctx.slice.launches() / ctx.slice.counts["queries"]
