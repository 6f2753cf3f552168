"""How ``correct`` is decided: the numbers that hold a solve of the system
under test against the reference's solve of the same problem from the same
start, and their limits.

Each number is a gap, 0 where the two agree:

- ``obj0``, ``gnorm0``: the objective and ||J'r|| at the start, relative
  (the linearization);
- ``obj1``: the objective after the first iteration, relative (the reduced
  camera system, PCG's matvecs, the back-substitution and the trial
  objective of one step);
- ``obj_final``: the final objective, relative;
- ``answer``: the reported objective against the reference's objective at
  the returned cameras and points, relative (the answer as returned);
- ``iters``: iterations, absolute; ``cg``: CG steps of the whole solve,
  relative; ``status``: 1 where the stop differs.

A cell's file names the numbers it compares and their limits; every
number is computed and printed, and those without a limit are shown as
readings only.
"""

from __future__ import annotations

NUMBERS = ("obj0", "gnorm0", "obj1", "obj_final", "answer", "iters", "cg",
           "status")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else
                                               float("inf"))


def summary(res) -> dict:
    """The parts of a solve's result that are compared, as plain numbers
    (a result of the system or of the reference)."""
    it = int(res.iterations)
    return {"objective": float(res.objective), "iterations": it,
            "status": int(res.status), "naccepts": int(res.naccepts),
            "hist_obj": [float(v) for v in list(res.hist_obj)[:it]],
            "hist_gnorm": [float(v) for v in list(res.hist_gnorm)[:it]],
            "cg": int(sum(int(v) for v in list(res.hist_cg)[:it]))}


def numbers(sut: dict, ref: dict, answer_obj: float) -> dict:
    """The gaps of one solve's :func:`summary` ``sut`` against the
    reference's ``ref``; ``answer_obj``: the reference's objective at the
    state ``sut`` returned."""
    def after_first(s):
        return s["hist_obj"][1] if len(s["hist_obj"]) > 1 else s["objective"]

    def first(s, key):
        return s[key][0] if s[key] else float("nan")

    return {
        "obj0": _rel(first(sut, "hist_obj"), first(ref, "hist_obj")),
        "gnorm0": _rel(first(sut, "hist_gnorm"), first(ref, "hist_gnorm")),
        "obj1": _rel(after_first(sut), after_first(ref)),
        "obj_final": _rel(sut["objective"], ref["objective"]),
        "answer": _rel(sut["objective"], answer_obj),
        "iters": float(abs(sut["iterations"] - ref["iterations"])),
        "cg": _rel(sut["cg"], max(ref["cg"], 1)),
        "status": float(sut["status"] != ref["status"]),
    }


def last_step(s: dict) -> float:
    """The relative objective change of a solve's last iteration: what
    ``obj_final`` reads for a solve that stops one iteration earlier."""
    return _rel(s["hist_obj"][-1], s["objective"]) if s["hist_obj"] else 0.0


def worst(readings: list) -> dict:
    """Each number's largest reading over the compared solves (a NaN is
    the worst)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if v != v or k not in out or out[k] < v:
                out[k] = float("inf") if v != v else v
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(every compared number within its limit, {name: {value, limit}})``
    for the numbers of ``limits``; a number absent from ``values`` fails."""
    checks = {k: {"value": values.get(k, float("inf")), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
