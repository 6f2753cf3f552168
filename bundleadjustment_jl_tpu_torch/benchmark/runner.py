"""Benchmark campaign runner (PyTorch port of
`bundleadjustment_jl_tpu/benchmark/runner.py`): every solver on every
problem, one stats row a run, Markdown and LaTeX tables, stats as JSON
lines, and Dolan-Moré performance profiles over time or evaluation counts
with the reference's "solved" statuses.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np

SOLVED_STATUSES = ("first_order", "small_residual", "small_step",
                   "small_obj_change")

COLUMNS = ("problem", "solver", "status", "objective", "rmse_px",
           "iterations", "elapsed_s", "compile_s", "neval_residual",
           "neval_jac", "dual_feas", "nvar", "nequ")


def _error_line(e: Exception) -> str:
    """One line for a failed run: ``repr(e)``, or past 300 characters its
    first line that names an error, cut to 300."""
    msg = repr(e)
    if len(msg) > 300:
        key = next((ln for ln in msg.splitlines()
                    if "out of memory" in ln.lower()
                    or "error:" in ln.lower()), "")
        msg = (key or msg)[:300]
    return msg


def run_campaign(solvers: Dict[str, Callable],
                 problems: Iterable[Tuple[str, object]],
                 logger: Callable[[str], None] = print) -> List[dict]:
    """Run each solver on each problem -> a stats row a run. ``solvers``
    maps a name to ``fn(problem)`` returning a result with ``status``
    (a name, or the one-shot driver's code), ``objective``,
    ``iterations`` and ``dual_feas`` (``elapsed_time``, ``neval_*`` and
    ``compile_time`` where it has them). A run that raises gives a row
    with status ``capability`` (a ``MemoryError``, a size gate) or
    ``exception`` and its error in one line."""
    from bundleadjustment_jl_tpu_torch.solver.lm_jit import STATUS_NAMES
    rows: List[dict] = []
    for pname, problem in problems:
        for sname, solve in solvers.items():
            logger(f"[bmark] {sname} on {pname} "
                   f"(nvar={problem.nvar}, nequ={problem.nequ})")
            t0 = time.perf_counter()
            try:
                res = solve(problem)
                elapsed = time.perf_counter() - t0
                status = getattr(res, "status", "unknown")
                if not isinstance(status, str):
                    status = STATUS_NAMES[int(status)]
                obj = float(getattr(res, "objective"))
                row = {
                    "problem": pname, "solver": sname, "status": status,
                    "objective": obj,
                    "rmse_px": (2.0 * obj / max(problem.nequ, 1)) ** 0.5,
                    "iterations": int(getattr(res, "iterations")),
                    "elapsed_s": float(getattr(res, "elapsed_time",
                                               elapsed)),
                    "compile_s": float(getattr(res, "compile_time", 0.0)),
                    "neval_residual": int(getattr(res, "neval_residual",
                                                  -1)),
                    "neval_jac": int(getattr(res, "neval_jac", -1)),
                    "dual_feas": float(getattr(res, "dual_feas")),
                    "nvar": problem.nvar, "nequ": problem.nequ,
                }
            except Exception as e:  # a failed run is a row, as in the JAX runner
                row = {"problem": pname, "solver": sname,
                       "status": ("capability" if isinstance(e, MemoryError)
                                  else "exception"),
                       "objective": float("inf"), "rmse_px": float("inf"),
                       "iterations": 0,
                       "elapsed_s": time.perf_counter() - t0,
                       "neval_residual": -1, "neval_jac": -1,
                       "dual_feas": float("inf"),
                       "nvar": problem.nvar, "nequ": problem.nequ,
                       "error": _error_line(e)}
            rows.append(row)
            logger(f"[bmark]   -> {row['status']} obj={row['objective']:.6g} "
                   f"iters={row['iterations']} t={row['elapsed_s']:.2f}s")
    return rows


def _cell(v) -> str:
    return f"{v:.6g}" if isinstance(v, float) else str(v)


def markdown_table(rows: List[dict], columns=COLUMNS) -> str:
    """The rows as a Markdown table."""
    head = "| " + " | ".join(columns) + " |"
    sep = "|" + "|".join("---" for _ in columns) + "|"
    body = ["| " + " | ".join(_cell(r.get(c, "")) for c in columns) + " |"
            for r in rows]
    return "\n".join([head, sep] + body)


def latex_table(rows: List[dict], columns=COLUMNS) -> str:
    """The rows as a LaTeX tabular."""
    lines = [r"\begin{tabular}{" + "l" * len(columns) + "}",
             " & ".join(c.replace("_", r"\_") for c in columns) + r" \\",
             r"\hline"]
    for r in rows:
        lines.append(" & ".join(_cell(r.get(c, "")).replace("_", r"\_")
                                for c in columns) + r" \\")
    lines.append(r"\end{tabular}")
    return "\n".join(lines)


def save_stats(rows: List[dict], path: str) -> None:
    """Write the rows as JSON lines."""
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def load_stats(path: str) -> List[dict]:
    """Read rows written by :func:`save_stats`."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def performance_profile(rows: List[dict], cost: str = "elapsed_s",
                        out_path: str | None = None):
    """Dolan-Moré performance profiles of the solvers over ``cost`` (time,
    or residual or Jacobian evaluations) -> ``(taus, {solver: fraction of
    problems solved within tau of the best})``, or None for no rows. With
    ``out_path`` it also draws them there with matplotlib, imported only
    then."""
    solvers = sorted({r["solver"] for r in rows})
    problems = sorted({r["problem"] for r in rows})
    costs = np.full((len(problems), len(solvers)), np.inf)
    for r in rows:
        i = problems.index(r["problem"])
        j = solvers.index(r["solver"])
        if r["status"] in SOLVED_STATUSES and np.isfinite(r.get(cost,
                                                               np.inf)):
            costs[i, j] = max(float(r[cost]), 1e-12)
    if costs.size == 0:
        return None
    best = costs.min(axis=1, keepdims=True)
    ratios = np.where(np.isfinite(best), costs / best, np.inf)
    finite = ratios[np.isfinite(ratios)]
    tau_max = float(finite.max()) * 1.05 if finite.size else 2.0
    taus = np.linspace(1.0, max(tau_max, 1.01), 256)
    profile = {s: np.array([(ratios[:, j] <= t).mean() for t in taus])
               for j, s in enumerate(solvers)}
    if out_path is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 4))
        for s in solvers:
            ax.step(taus, profile[s], where="post", label=s)
        ax.set_xlabel(f"within factor tau of best ({cost})")
        ax.set_ylabel("fraction of problems solved")
        ax.set_ylim(0, 1.02)
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_path)
        plt.close(fig)
    return taus, profile
