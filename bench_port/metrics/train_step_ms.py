"""train_step_ms: the window's wall time, from the first step dispatched
to the synchronisation after the last, over the steps it completed
(host clock)."""


def read(rec: dict, cell: dict):
    if rec.get("device_trace") is not None or not rec.get("steps"):
        return None
    return rec["window_s"] / rec["steps"] * 1e3
