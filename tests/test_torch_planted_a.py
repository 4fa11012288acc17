"""Planted recovery of the port's TransE, TransR and DistMult, each
trained on the CPU to at least 0.6 of its per-direction filtered Hits@10
ceiling (``tests/torch_planted.py``). The other models are in
``test_torch_planted_b.py``, so that two test workers share them."""

import pytest
import torch

from torch_planted import assert_recovers


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Training here is many tiny ops; torch's intra-op threads only
    contend with the other test workers for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("model", ["transe", "transr", "distmult"])
def test_planted_recovery(model):
    assert_recovers(model)
