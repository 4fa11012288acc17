"""Training traffic with relation negatives: :mod:`.train`'s step groups
on a configuration with ``negative_rel`` > 0, which leaves TransR's
grouped route for the port's generic step (a ``[d_e·d_r]`` matrix
gathered for every scored row, kernel B5 scattering the
``transfer_matrix`` rows every step). The draws are ``[S, B, 1 + 2·negE +
negR]``, the last column the relation negative's (:mod:`.generic`).

Compared as :mod:`.train` compares SGD's training (:func:`.train.checks`):
the batches id for id (relation negatives included), each checked step's
loss, the first gradient as SGD applied it, the change of the tables after
three steps, each by the worst table's norm, and the group's loss."""

from __future__ import annotations

from kgbench.traffic import train
from kgbench.traffic.generic import GenericTraffic as Traffic  # noqa: F401

FAULTS = train.FAULTS
