"""The trainer's automatic instance budget, sized from the capacities."""
from __future__ import annotations


def budget_bucket(needed: int) -> int:
    """A required instance count rounded up to the next budget bucket:
    multiples of 32768 with 1.25x headroom, at least 65536, so that a
    growing population grows the budget O(log) times while wasting far
    less than power-of-two sizes (binning pays for the whole budget)."""
    step = 32768
    return max(1 << 16, -(-(needed * 5 // 4) // step) * step)
