"""The numbers that decide ``correct``, each a gap between the program and
the reference, and each held to its limit from the traffic file.

A leaf's gap is ``|norm_program - norm_reference|`` over the larger of the
reference's norm of that leaf and the median leaf's, so a leaf whose norm
is all but zero cannot dominate.  Leaves whose first gradient is under a
thousandth of the median leaf's in the reference move under AdamW by
round-off alone and are left out of the change (``moving``).
"""

from __future__ import annotations

import statistics


def loss_gap(program: list, reference: list) -> float:
    """The worst step's relative gap of the loss."""
    return max(abs(p - r) / max(abs(r), 1e-12)
               for p, r in zip(program, reference))


def moving(ref_grads: dict) -> set:
    med = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v >= 1e-3 * med}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    names = [k for k in reference if keep is None or k in keep]
    if set(program) != set(reference):
        return float("inf")
    med = statistics.median(reference[k] for k in names)
    return max(abs(program[k] - reference[k]) / max(reference[k], med)
               for k in names)


def leaf_mean_gap(program: dict, reference: dict) -> float:
    """The mean over all leaves of the relative gap ``leaf_gap`` takes the
    worst of: steady from seed to seed where one small leaf's rounding
    noise sets the worst."""
    med = statistics.median(reference.values())
    if set(program) != set(reference):
        return float("inf")
    return statistics.fmean(abs(program[k] - reference[k])
                            / max(reference[k], med) for k in reference)


def widest_gap(program: dict, reference: dict) -> float:
    """The largest |program - reference| over the tensors of both dicts,
    on the rows both hold."""
    worst = 0.0
    for k, r in reference.items():
        p = program[k]
        n = min(p.shape[0], r.shape[0])
        worst = max(worst, float((p[:n].float() - r[:n].float()).abs().max()))
    return worst


def judge(checks: list, limits: dict) -> tuple:
    """-> (correct, [(name, value, limit)]): correct when every number is
    finite and at most its limit."""
    rows = [(name, value, limits[name]) for name, value in checks]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
