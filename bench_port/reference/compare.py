"""The numbers that decide `correct` for a training cell: the program's
first steps against the reference's.

- loss_gap: the first step's |loss - reference| / |reference|; the later
  steps' gaps, which swing between runs of one seed (PERF.md, section
  2), are printed beside it in its `where`.
- grad_gap: step 1's gradient, the worst leaf of |norm - reference norm|
  over the larger of the reference's norm of that leaf and of the median
  leaf (some gradients are all but zero).
- change_gap: the parameters' change over the steps, each leaf's gap
  taken as grad_gap takes it, over the leaves whose reference gradient
  is at least a thousandth of the median leaf's (the others move under
  Adam by round-off alone); the median of those leaves' gaps, since the
  worst leaf's swings between runs of one seed (PERF.md, section 2).
  Its `where` names the worst leaf and its gap beside it.
- distill_gap, where the recipe distills the avatar's nets: the
  reference's distillation loss of the program's distilled nets against
  that of its own, |program - own| / own.
"""
from __future__ import annotations

import statistics

# a leaf whose reference gradient is under this share of the median
# leaf's is nought to rounding and left out of change_gap
NOUGHT = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """{leaf: the relative gap of its norms} over the kept leaves, each
    over the larger of the reference's norm of it and of the median
    kept leaf."""
    names = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in names)
    out = {}
    for k in names:
        den = max(ref[k], med)
        out[k] = abs(prog.get(k, 0.0) - ref[k]) / den if den > 0 else 0.0
    return out


def worst_leaf(prog: dict, ref: dict, keep) -> tuple[float, str]:
    """(the worst relative gap of the kept leaves' norms, its leaf)."""
    got = leaf_gaps(prog, ref, keep)
    where = max(got, key=got.get)
    return got[where], where


def median_leaf(prog: dict, ref: dict, keep) -> tuple[float, str]:
    """(the median relative gap of the kept leaves' norms, the worst
    leaf and its gap)."""
    got = leaf_gaps(prog, ref, keep)
    worst = max(got, key=got.get)
    return (statistics.median(got.values()),
            f"median of {len(got)} leaves; worst {worst} {got[worst]!r}")


def gaps(prog: dict, ref: dict) -> dict:
    """{number: (value, where)} for the program's record against the
    reference's, each {'losses', 'grad_norms', 'change_norms'}."""
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"], strict=True)]
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= NOUGHT * med}
    out = {
        "loss_gap": (steps[0], "step 1; the later steps " + ", ".join(
            repr(g) for g in steps[1:])),
        "grad_gap": worst_leaf(prog["grad_norms"], g, lambda k: True),
        "change_gap": median_leaf(prog["change_norms"], ref["change_norms"],
                                  lambda k: k in moved),
    }
    if "distill" in ref:
        d = ref["distill"]
        out["distill_gap"] = (abs(d["program"] - d["own"]) / d["own"],
                              "the distilled nets")
    return out
