"""The whole evaluation's share of the chip's peak, in %: the least time
an evaluation's rank counts could take on one H100 (both directions of
every test triple against every entity, two fp32 instructions a lane over
33.5 T/s: 2 × 20,466 × 14,541 × 200 × 2 instructions, about 7.1 ms,
``kgbench/bounds.py``), over the measured time an evaluation in the
untraced window. Bound by fp32 issue. Moves ``eval_triples_per_s``."""

from kgbench.bounds import evaluation_bound


def read(ctx):
    sh = ctx.shapes
    if sh["model"] != "transe" or not ctx.window.get("evaluations"):
        return None
    t, bound = evaluation_bound(sh)
    per_eval = ctx.window_s / ctx.window["evaluations"]
    return 100.0 * t / per_eval, bound
