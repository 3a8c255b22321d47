"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to its limit (the traffic file's
``limits``; ``PERF.md`` gives the readings each was set from).

Generation: ``frames_rmse``, the worst frame's root-mean-square difference
in uint8 levels between the program's frames and the reference's.

Training, over the first steps the set-up drives:

* ``loss_rel``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as the optimizer takes it, by the worst
  leaf: | |g_program| - |g_reference| | over the larger of the reference's
  norm of that leaf and the median leaf's;
* ``change_gap``: the same for each leaf's change over the steps, leaves
  whose reference gradient is under a thousandth of the median leaf's left
  out (their change is round-off).
"""

from __future__ import annotations

import numpy as np

ZERO_GRAD = 1e-3


def frames_rmse(program: np.ndarray, reference: np.ndarray) -> float:
    if program.shape != reference.shape:
        return float("inf")
    d = program.astype(np.float64) - reference.astype(np.float64)
    return float(np.sqrt((d * d).reshape(d.shape[0], -1).mean(1)).max())


def leaf_gap(program, reference, keep=None) -> float:
    """max over leaves of | |p| - |r| | / max(|r|, median |r|)."""
    p, r = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if keep is not None:
        p, r = p[keep], r[keep]
    if p.shape != r.shape or not np.isfinite(p).all():
        return float("inf")
    return float((np.abs(p - r) / np.maximum(r, np.median(r))).max())


def train_numbers(program: dict, reference: dict) -> dict:
    """``program``/``reference``: ``losses`` (a step each), ``grad_norms``
    and ``change_norms`` (a leaf each, in one order)."""
    pl, rl = np.asarray(program["losses"]), np.asarray(reference["losses"])
    loss_rel = (float(np.max(np.abs(pl - rl) / np.abs(rl)))
                if pl.shape == rl.shape and np.isfinite(pl).all() else float("inf"))
    g = np.asarray(reference["grad_norms"], np.float64)
    keep = g >= ZERO_GRAD * np.median(g)
    return dict(loss_rel=loss_rel,
                grad_gap=leaf_gap(program["grad_norms"], g),
                change_gap=leaf_gap(program["change_norms"], reference["change_norms"], keep))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and within its limit."""
    shown = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
