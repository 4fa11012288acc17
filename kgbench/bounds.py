"""The yardstick's peaks and least-time arithmetic.

A frozen copy of the bound convention of ``PERF.md`` §6 and of
``chip_smoke.py`` (``bound``, ``count_bound``, the B4 bounds of its
"B4 timings" phase) at commit 3ffe0770, so that a later change to the
port cannot change what a roofline share is measured against.

Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit): 3.35 TB/s of device memory and 67 TFLOP/s of fp32 outside
the tensor cores, an FMA counted as two, so 33.5 T fp32 instructions a
second, one per lane and clock. A call's least time is the larger of its
bytes over the memory peak (each input read once, each output written
once) and its instructions over the issue peak; which of the two is
larger names the bound."""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP32_INSTR_PER_S = FP32_FLOP_PER_S / 2

# rounded fp32 operations per (query, candidate, lane) of B1 at p = 1: the
# residual's add, then |.| and the running add (PERF.md §6, RANK_OPS)
B1_OPS_PER_TERM = 2


def least(nbytes: float, instr: float = 0.0) -> Tuple[float, str]:
    """(seconds, bound) of a call that moves ``nbytes`` and issues
    ``instr`` fp32 instructions: the larger of the two times, and
    ``"bytes"`` or ``"operations"`` for the one that sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = instr / FP32_INSTR_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def least_flops(nbytes: float, flops: float) -> Tuple[float, str]:
    """(seconds, bound) of work counted in model FLOPs (an FMA as two)
    against 67 TFLOP/s, and bytes against 3.35 TB/s."""
    return least(nbytes, flops / 2)


def b1_count(C: int, n_ent: int, D: int) -> Tuple[float, str]:
    """B1's rank count of ``C`` queries over ``n_ent`` candidates of width
    ``D`` (``chip_smoke.py::count_bound`` for TransE at p = 1): bytes are
    the rows swept, the queries, and per query its gold, gold id and
    count; instructions two per (query, candidate, lane)."""
    nbytes = n_ent * D * 4 + C * D * 4 + C * 12
    return least(nbytes, C * n_ent * D * B1_OPS_PER_TERM)


def evaluation_bound(sh: dict) -> Tuple[float, str]:
    """(seconds, bound) of B1 over one evaluation: both directions, the
    ``n_test`` test triples cut into chunks of ``chunk`` queries over
    ``n_ent`` candidates of ``width``."""
    full, last = divmod(sh["n_test"], sh["chunk"])
    sizes = [sh["chunk"]] * full + ([last] if last else [])
    parts = [b1_count(C, sh["n_ent"], sh["width"]) for C in sizes]
    return 2 * sum(p[0] for p in parts), parts[0][1]


def b4_fwd(n: int, present: float, d_e: int, d_r: int) -> Tuple[float, str]:
    """B4's forward over ``n`` rows sorted by relation, ``present``
    relations among them: M of the relations present, the rows in and
    out; one FMA per (row, d_e, d_r)."""
    m_bytes = d_e * d_r * 4
    return least(present * m_bytes + n * (d_e + d_r) * 4, n * d_e * d_r)


def b4_bwd(n: int, present: float, rows: int, d_e: int, d_r: int
           ) -> Tuple[float, str]:
    """B4's backward: M of the relations present read, dM written dense
    over all ``rows``, x and g in, dx out; two FMAs per (row, d_e, d_r)."""
    m_bytes = d_e * d_r * 4
    return least((present + rows) * m_bytes + n * (d_e + d_r) * 4
                 + n * d_e * 4, 2 * n * d_e * d_r)
