"""The plain reference that decides ``correct``: NumPy and plain PyTorch,
written from the models' published definitions and the OpenKE sampling
rules, importing nothing of the port or of the JAX package and taking
nothing the port made (no tables, indexes or sampler store). The harness
hands the same inputs to both sides: the KG, the seeded initial tables
and, in training, the u32 random draws of the checked steps, which the
benchmark makes; a step group's draws the reference takes itself from a
generator seeded as the group's was.

- :mod:`.sampler`: the batch a step's draws select (uniform positives,
  the Bernoulli head/tail choice, a corrupted entity drawn uniformly from
  those that form no train triple with the kept side);
- :mod:`.train`: steps and step groups of TransE or TransR under SGD,
  with each step's and group's loss, the first gradient and the tables
  after them;
- :mod:`.ranks`: link prediction's raw and filtered ranks, as the band of
  counts that fp32 rounding allows;
- :mod:`.topk`: the exact scores a top-k answer is judged by.

Everything is float64 or float32 with TF32 off, unless a precision
``mode`` asks for the lower precision that serves as the control."""
