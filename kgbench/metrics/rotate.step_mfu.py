"""The RotatE training step's share of the chip's peak, in %: the least
time the step's work could take on one H100 (the larger of its model
FLOPs over 67 TFLOP/s fp32 and its bytes over 3.35 TB/s,
``kgbench/bounds.py``), over the measured time a step in the untraced
window (the window's seconds over its steps). It names the bound that
sets it; at 1,000 complex lanes under Adam that is bytes. Counted as
``train.step_mfu`` counts its models, from the cell's shapes and the
distinct rows its recorded steps touched (each input read once, each
output written once):

- bytes: every distinct entity and relation row the step touches, its
  parameters and Adam's two moments read and written back once (24 B an
  element), the batch's ids and the step's u32 draws;
- FLOPs: 40 a complex lane of every scored triple (a positive and each
  negative), forward and back: the rotation (four products, two sums),
  the residual (two), the modulus (two squares, two sums, the root) and
  its sum, about 14 forward and twice that back; Adam's 12 an element of
  every touched row (m: 3, v: 4, the step: root, sum, quotient and
  product, the add).

Silent for any other model. Moves ``train_triples_per_s``."""

from kgbench.bounds import least_flops

LANE_FLOPS = 40
ADAM_FLOPS = 12
ADAM_BYTES = 24


def step_work(sh):
    """(FLOPs, bytes) of one RotatE step under Adam."""
    B, neg = sh["batch"], sh["negative_ent"]
    w = sh["widths"]
    lanes = w["rel_embeddings"]
    touched = (sh["distinct_ent_rows"] * w["ent_embeddings"]
               + sh["distinct_rel_rows"] * w["rel_embeddings"])
    ids = B * (3 + neg) * 4 + B * (1 + 2 * neg) * 4
    flops = B * (1 + neg) * lanes * LANE_FLOPS + ADAM_FLOPS * touched
    return flops, ADAM_BYTES * touched + ids


def read(ctx):
    sh = ctx.shapes
    if sh.get("model") != "rotate" or not ctx.window.get("steps"):
        return None
    flops, nbytes = step_work(sh)
    t, bound = least_flops(nbytes, flops)
    step_s = ctx.window_s / ctx.window["steps"]
    return 100.0 * t / step_s, bound
