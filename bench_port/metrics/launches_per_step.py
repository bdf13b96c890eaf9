"""launches_per_step: device operations (kernels, copies, sets) per step
of the traced window, from the profiler's trace."""


def read(rec: dict, cell: dict):
    dt = rec.get("device_trace")
    if dt is None or not rec.get("steps"):
        return None
    return dt.n_ops / rec["steps"]
