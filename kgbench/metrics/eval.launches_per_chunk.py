"""Device events (kernels, copies, fills) per chunk of link prediction:
those in the traced slice over its chunks, two directions of
``ceil(n_test / eval_chunk)`` chunks an evaluation (160 at 20,466 test
triples and chunks of 256). A larger chunk or fused per-chunk operations
cut it; it moves ``eval_triples_per_s``."""


def read(ctx):
    if not ctx.slice.device:
        return None
    return ctx.slice.launches() / ctx.slice.counts["chunks"]
