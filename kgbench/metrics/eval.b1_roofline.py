"""B1's share of its roofline, in %: the TransE rank count
(``ops/csrc/rank_count.cu`` on ``rank_tiled.cuh``'s ``count_kernel``),
its least time over an evaluation (``kgbench/bounds.py``: two fp32
instructions per query, candidate and lane over 33.5 T/s, PERF.md §6)
for each evaluation of the traced slice, over the profiled device time of
the count kernel there. Bound by fp32 issue. Silent when the kernel did
not run. Moves ``eval_triples_per_s``."""

from kgbench.bounds import evaluation_bound


def is_count(name):
    return "count_kernel" in name and "TransE" in name


def read(ctx):
    busy = ctx.slice.device_time(is_count)
    if ctx.shapes["model"] != "transe" or busy <= 0:
        return None
    t, bound = evaluation_bound(ctx.shapes)
    return 100.0 * t * ctx.slice.counts["evaluations"] / busy, bound
