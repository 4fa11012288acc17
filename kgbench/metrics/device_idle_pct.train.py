"""The share of the traced slice in which the device ran nothing, in %:
the slice's window less the union of its kernels', copies' and fills'
intervals. Moves the train cells' end-to-end metric."""


def read(ctx):
    return ctx.slice.idle_pct()
