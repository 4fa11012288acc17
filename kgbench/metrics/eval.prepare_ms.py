"""Host milliseconds an evaluation inside ``okst.eval.prepare``: the known
windows (host lookups, the group arrays copied to the device), the
finite guard (a host sync) and the fp32 copies of the tables; the spans'
time in the traced slice over its ``okst.eval.evaluation`` spans
(``kgbench/spans.py``). Moves ``eval_triples_per_s``."""

from kgbench.spans import ms_per


def read(ctx):
    return ms_per(ctx.slice, "okst.eval.prepare", "okst.eval.evaluation")
