"""Kernel B5's plain version (the sorted-run wide-row scatter-add) against
the JAX package's Pallas kernel in interpret mode and the sorted-order
NumPy oracle of ``tests/test_pallas_scatter.py``, bit for bit; and the
width routing of ``train/optim.scatter_add_rows``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ops.pallas_scatter import \
    scatter_add_rows_sorted as jax_scatter
from openkeonspark_tpu_torch.ops import scatter
from openkeonspark_tpu_torch.train import optim

from test_pallas_scatter import oracle


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _random_case(R, W, N, seed):
    """The JAX tests' inputs: ids in [0, R] (R is the discard sentinel)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, W)).astype(np.float32)
    ids = rng.integers(0, R + 1, size=N)
    delta = rng.normal(size=(N, W)).astype(np.float32)
    return table, ids, delta


def _hub_case(R, W, N, seed):
    """One hot row taking most of the stream (a long run) plus singles and
    sentinels."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, W)).astype(np.float32)
    ids = np.full(N, 2)
    ids[::10] = rng.integers(0, R + 1, size=len(ids[::10]))
    delta = rng.normal(size=(N, W)).astype(np.float32)
    return table, ids, delta


def _all_sentinel():
    return (np.ones((9, 128), np.float32), np.full(17, 9),
            np.full((17, 128), 5.0, np.float32))


CASES = {
    "37x256 N=200": lambda: _random_case(37, 256, 200, 37 + 200),
    "11x128 N=5": lambda: _random_case(11, 128, 5, 11 + 5),
    "64x384 N=1": lambda: _random_case(64, 384, 1, 64 + 1),
    "16x200 N=64": lambda: _random_case(16, 200, 64, 16 + 64),
    "all sentinel": _all_sentinel,
    "heavy duplicates": lambda: _hub_case(8, 128, 100, 3),
    "wide 6x4096 hub": lambda: _hub_case(6, 4096, 40, 5),
    "wide 4x4097": lambda: _random_case(4, 4097, 12, 7),
}


def _port(table, ids, delta):
    t = torch.from_numpy(table.copy())
    out = scatter.scatter_add_rows_sorted(t, torch.from_numpy(ids),
                                          torch.from_numpy(delta))
    assert out is t                                  # in place
    return t.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_jax_kernel_and_oracle(case):
    """Bit for bit: duplicates added one at a time from the table's value
    in stable-sorted order, sentinel ids dropped."""
    table, ids, delta = CASES[case]()
    got = _port(table, ids, delta)
    want = jax_scatter(jnp.asarray(table), jnp.asarray(ids, jnp.int32),
                       jnp.asarray(delta), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, oracle(table, ids, delta))


def test_plain_order_is_sorted_run_order():
    """The order of additions is visible in fp32: 1 + 1e8 − 1e8 is 0 in
    that order and 1 in another."""
    table = torch.tensor([[1.0] * 4, [0.0] * 4])
    ids = torch.tensor([0, 1, 0])
    delta = torch.tensor([[1e8] * 4, [3.0] * 4, [-1e8] * 4])
    scatter.scatter_add_rows_sorted(table, ids, delta)
    assert table.tolist() == [[0.0] * 4, [3.0] * 4]


def test_edge_shapes_and_no_launch_on_cpu():
    scatter.reset_launch_counts()
    table = torch.randn(5, 4096)
    before = table.clone()
    scatter.scatter_add_rows_sorted(table, torch.zeros(0, dtype=torch.long),
                                    torch.zeros(0, 4096))
    assert torch.equal(table, before)
    scatter.scatter_add_rows_sorted(table, torch.tensor([3]),
                                    torch.ones(1, 4096))
    assert torch.equal(table[3], before[3] + 1)
    assert torch.equal(table[[0, 1, 2, 4]], before[[0, 1, 2, 4]])
    assert scatter.LAUNCHES == {"scatter_add_rows_sorted": 0,
                                "scatter_add_rows_sorted_bf16": 0}


def test_wrapper_checks():
    table = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="int64"):
        scatter.scatter_add_rows_sorted(
            table, torch.tensor([1], dtype=torch.int32), torch.ones(1, 8))
    with pytest.raises(ValueError, match="contiguous"):
        scatter.scatter_add_rows_sorted(table, torch.tensor([1, 2]),
                                        torch.ones(8, 2).T)
    with pytest.raises(ValueError, match="shape"):
        scatter.scatter_add_rows_sorted(table, torch.tensor([1]),
                                        torch.ones(1, 7))
    with pytest.raises(TypeError, match="bfloat16"):
        scatter.scatter_add_rows_sorted(table.bfloat16(), torch.tensor([1]),
                                        torch.ones(1, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        scatter.scatter_add_rows_sorted(table.double(), torch.tensor([1]),
                                        torch.ones(1, 8).double())


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of B5's plain version."""
    calls = []
    ref = scatter.scatter_add_rows_sorted_ref

    def counted(*a):
        calls.append(a[0].shape)
        return ref(*a)

    monkeypatch.setattr(scatter, "scatter_add_rows_sorted_ref", counted)
    monkeypatch.setattr(optim, "scatter_add_rows_sorted_ref", counted)
    monkeypatch.delenv("OKST_NO_WIDE_SCATTER", raising=False)
    return calls


def _masked_add(table, ids, delta):
    out = table.clone()
    valid = ids < table.shape[0]
    out.index_add_(0, ids[valid], delta[valid])
    return out


@pytest.mark.parametrize("width,wide", [(8, False), (4095, False),
                                        (4096, True), (4500, True)])
@pytest.mark.parametrize("plain", [False, True])
def test_optim_routes_by_width(plain_calls, width, wide, plain):
    """Rows ≥ 4096 wide take B5 (its plain version on the CPU, or with
    ``plain``), narrower rows the masked ``index_add_``; both drop
    sentinel ids and sum duplicates."""
    g = torch.Generator().manual_seed(width)
    table = torch.randn(6, width, generator=g)
    ids = torch.tensor([1, 6, 3, 1, 0, 6, 1])
    delta = torch.randn(7, width, generator=g)
    want = _masked_add(table, ids, delta)
    assert optim.use_wide_kernel(table) == wide
    optim.scatter_add_rows(table, ids, delta, plain=plain)
    assert len(plain_calls) == (1 if wide else 0)
    torch.testing.assert_close(table, want, rtol=1e-6, atol=1e-6)


def test_optim_honours_no_wide_scatter(plain_calls, monkeypatch):
    """``OKST_NO_WIDE_SCATTER=1`` sends wide rows to the masked scatter."""
    monkeypatch.setenv("OKST_NO_WIDE_SCATTER", "1")
    table = torch.zeros(3, 4096)
    assert not optim.use_wide_kernel(table)
    optim.scatter_add_rows(table, torch.tensor([0, 3, 0]),
                           torch.ones(3, 4096))
    assert plain_calls == []
    assert torch.equal(table[0], torch.full((4096,), 2.0))
    assert not table[1:].any()
