"""Instance budgets grown from the binning's slot demand: the one rule the
trainer's automatic budget, the training steps' retry and the
convergence recipes share.

A render reports its slot demand `n_slots` (instances plus the tiles'
alignment padding) and `n_instances` even where it overflowed the
budget, so one retry at the grown budget fits the frame.
"""
from __future__ import annotations


def budget_bucket(needed: int) -> int:
    """A required instance count rounded up to the next budget bucket:
    multiples of 32768 with 1.25x headroom, at least 65536, so that a
    growing population grows the budget O(log) times while wasting far
    less than power-of-two sizes (binning pays for the whole budget)."""
    step = 32768
    return max(1 << 16, -(-(needed * 5 // 4) // step) * step)


def grown_budget(budget: int, n_slots: int, n_instances: int) -> int:
    """The budget after a render of `n_slots` slots, `n_instances` of
    them instances: 1.5x the instances plus the padding, in buckets, and
    never below `budget`. The headroom scales the instances, not the
    padding, which depends on the tile grid only."""
    waste = max(int(n_slots) - int(n_instances), 0)
    return budget_bucket(max(int(n_instances) * 3 // 2 + waste, int(budget)))


def fit_budget(render, budget: int, what: str):
    """`render(budget)`, and where its render overflowed, `render` again at
    grown_budget; a render that overflows after that raises. `render`
    returns the render's dict or a tuple that starts with it. Returns
    (render's output, the budget it fitted)."""
    out = render(budget)
    pkg = out[0] if isinstance(out, tuple) else out
    if not bool(pkg["overflowed"]):
        return out, budget
    new = grown_budget(budget, pkg["n_slots"], pkg["n_instances"])
    print(f"# {what}: instance budget {budget} overflowed (n_slots="
          f"{int(pkg['n_slots'])}) -> {new}", flush=True)
    out = render(new)
    pkg = out[0] if isinstance(out, tuple) else out
    if bool(pkg["overflowed"]):
        raise RuntimeError(f"{what}: instance budget {new} overflowed again "
                           f"(n_slots={int(pkg['n_slots'])})")
    return out, new
