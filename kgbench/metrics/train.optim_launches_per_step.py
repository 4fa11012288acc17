"""Launch calls a training step makes inside ``okst.train.optim``: the
host runtime calls that put a kernel, a copy or a fill on the device's
queue (:data:`LAUNCHES`) and start inside an ``okst.train.optim`` span of
the traced slice, over its ``okst.train.step`` spans. The optimizer's
share of ``train.launches_per_step``: fused or fewer optimizer ops cut
it. Silent without device events or without either span. Moves
``train_triples_per_s``."""

import bisect

from kgbench.spans import spans
from kgbench.trace import merged

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def read(ctx):
    sl = ctx.slice
    inside = merged(spans(sl, "okst.train.optim"))
    steps = spans(sl, "okst.train.step")
    if not sl.device or not inside or not steps:
        return None
    starts = [s for s, _ in inside]
    n = 0
    for name, s, _ in sl.host:
        if name in LAUNCHES:
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s <= inside[i][1]
    return n / len(steps)
