"""slot_fill: the instance slots a frame used (`n_slots`) over the
budget it was binned in (`budget`), the program's counters of each of
the traced window's steps, the mean, in %."""
from bench_port.spans import window


def read(rec: dict, cell: dict):
    w = window(rec)
    if w is None:
        return None
    fills = [100.0 * c["n_slots"] / c["budget"] for c in w.counters.values()
             if c.get("budget")]
    return sum(fills) / len(fills) if fills else None
