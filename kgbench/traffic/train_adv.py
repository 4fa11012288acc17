"""Training traffic under lazy Adam: :mod:`.train`'s step groups on a
configuration that trains through the port's generic step with
``opt_method`` ``adam`` (RotatE's self-adversarial run), held to
:mod:`kgbench.reference.generic`.

Adam needs checks of its own: its first step is ≈ lr·sign(g), so the
norm of an update says almost nothing of the gradient. Compared:

- ``batch_mismatch``: ids of the 3 checked steps' batches unlike the
  reference's;
- ``loss_gap``: the worst checked step's |loss − ref| / |ref|;
- ``grad_gap``: the first gradient, read from Adam's first moment after
  step 1 (m₁ = (1 − β₁)·g at the touched rows, 0 elsewhere: the port's
  ``opt_state``), against the reference's autograd gradient, element by
  element: the worst table's ‖g − g_ref‖ / ‖g_ref‖;
- ``change_gap``: the change of the tables after three steps, element by
  element, the worst table's ‖Δ − Δ_ref‖ / ‖Δ_ref‖;
- ``group_loss_gap``: the first group's mean loss, as ``loss_gap``."""

from __future__ import annotations

from contextlib import ExitStack
from unittest import mock

from kgbench.common import Run
from kgbench.traffic import train
from kgbench.traffic.generic import GenericTraffic


class Traffic(GenericTraffic):

    def checks(self, want, side, p0, side_p0) -> dict:
        return checks(want, side, p0, side_p0, self.cfg.adam_beta1,
                      self.cfg.alpha)


def checks(want: dict, side: dict, p0, side_p0, beta1: float,
           alpha: float) -> dict:
    """The compared numbers of an Adam cell (the module's docstring):
    the batches, the checked steps' and the group's losses as
    :func:`.train.checks` compares them, the first gradient and the
    change element by element. ``p0`` are the tables both sides start
    from, ``side_p0`` the compared side's own (a lower-precision side
    rounds them)."""
    def gap(got, ref_t):
        return float((got.double() - ref_t.double()).norm()) / max(
            float(ref_t.double().norm()), 1e-30)

    out = train.checks(want, side, p0, side_p0, alpha)
    grad = {k: gap(side["m1"][k].cpu() / (1.0 - beta1), g)
            for k, g in want["g1"].items()}
    change = {k: gap(side["p3"][k].cpu() - side_p0[k].cpu(),
                     want["pN"][k] - p0[k].cpu())
              for k in want["pN"]}
    out.update(grad_gap=max(grad.values()), change_gap=max(change.values()))
    # the readings behind them, for the calibration's record
    out["norms"].update(grad=grad, change=change)
    return out


def _unchanged(run: Run, stack: ExitStack) -> None:
    """Adam leaves the tables and its moments as they were."""
    from openkeonspark_tpu_torch.train import optim
    stack.enter_context(mock.patch.object(
        optim.SparseAdam, "apply",
        lambda self, params, state, updates, step, plain=False:
        (params, state)))


FAULTS = {"unchanged": _unchanged, "half_batch": train._half_batch,
          "token": train._token}
