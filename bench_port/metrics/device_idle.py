"""device_idle: the share of the traced window's wall time in which no
operation ran on the device, from the profiler's trace."""


def read(rec: dict, cell: dict):
    dt = rec.get("device_trace")
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
