"""B4's share of its roofline, in %: the relation-grouped projection's
forward and backward kernels (``ops/csrc/grouped_project.cu``:
``fwd_kernel``, ``bwd_kernel``), their least time at the step's shapes
(``kgbench/bounds.py``: the larger of B4's bytes over 3.35 TB/s and its
FMAs over 33.5 T fp32 instructions a second, PERF.md §6's convention)
for each step of the traced slice, over the profiled device time of the
two kernels there. It names the bound that sets the larger of the two
least times: bytes for 200 x 100 projections of 19,252 rows, fp32 issue
for 200 x 200 ones of 141,492 rows. Silent when neither kernel ran. Moves
``train_triples_per_s``."""

import re

from kgbench.bounds import b4_bwd, b4_fwd

KERNEL = re.compile(r"(?<![A-Za-z0-9])(fwd|bwd)_kernel\b")


def read(ctx):
    sh = ctx.shapes
    busy = ctx.slice.device_time(lambda n: bool(KERNEL.search(n))
                                 and "flash" not in n)
    if sh["model"] != "transr" or busy <= 0:
        return None
    n = 2 * (1 + sh["negative_ent"]) * sh["batch"]
    present = sh["distinct_rel_rows"]
    de, dr = sh["ent_size"], sh["rel_size"]
    fwd, by_f = b4_fwd(n, present, de, dr)
    bwd, by_b = b4_bwd(n, present, sh["rel_rows"], de, dr)
    return (100.0 * (fwd + bwd) * ctx.slice.counts["steps"] / busy,
            by_f if fwd >= bwd else by_b)
