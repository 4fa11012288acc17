"""The whole training step's share of the chip's peak, in %: the least
time the step's work could take on one H100 (the larger of its model
FLOPs over 67 TFLOP/s fp32 and its bytes over 3.35 TB/s,
``kgbench/bounds.py``), over the measured time a step in the untraced
window (the window's seconds over its steps). It names the bound that
sets it; the cells' steps are bound by bytes. It bounds what any change
to the step can gain, also after a later change takes a kernel off the
path. Moves ``train_triples_per_s``.

The work is counted from the cell's shapes and the distinct rows its
recorded steps touched (each input read once, each output written once):

- bytes: every distinct entity and relation row the step touches, read
  and written back once (TransR's ``M_r`` rows among them), the batch's
  ids and the step's u32 draws;
- FLOPs, per scored triple (a positive and each negative): TransE four
  per lane forward (add, subtract, |.|, accumulate) and four back;
  TransR the two projections ``x·M_r`` forward (2·d_e·d_r each) and their
  two products back (dx and dM), four per relation lane each way; SGD two
  per element of every touched row."""

from kgbench.bounds import least_flops


def step_work(sh):
    """(FLOPs, bytes) of one step."""
    B, neg = sh["batch"], sh["negative_ent"]
    scored = B * (1 + neg)
    w = sh["widths"]
    ent_w = w["ent_embeddings"]
    rel_w = sum(v for k, v in w.items() if k != "ent_embeddings")
    touched = sh["distinct_ent_rows"] * ent_w + sh["distinct_rel_rows"] * rel_w
    ids = B * (3 + neg) * 4 + B * (1 + 2 * neg) * 4
    if sh["model"] == "transe":
        flops = scored * 8 * ent_w
    elif sh["model"] == "transr":
        de, dr = sh["ent_size"], sh["rel_size"]
        flops = scored * (3 * 2 * (2 * de * dr) + 8 * dr)
    else:
        return None
    return flops + 2 * touched, 8 * touched + ids


def read(ctx):
    work = step_work(ctx.shapes)
    if work is None or not ctx.window.get("steps"):
        return None
    t, bound = least_flops(work[1], work[0])
    step_s = ctx.window_s / ctx.window["steps"]
    return 100.0 * t / step_s, bound
