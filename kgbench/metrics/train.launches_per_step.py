"""Device events (kernels, copies, fills) a training step issues: those
in the traced slice over its steps. CUDA graphs or fused step operations
cut it; it moves ``train_triples_per_s``."""


def read(ctx):
    if not ctx.slice.device:
        return None
    return ctx.slice.launches() / ctx.slice.counts["steps"]
