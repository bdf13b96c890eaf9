"""host_dispatch_ms: the host ms a step inside the program's root spans
(`train.step` and `train.periodic`) less `step.sync_readback`, over the
traced window's steps: the host's time to dispatch a step."""
from bench_port.spans import ROOTS, host_ms


def read(rec: dict, cell: dict):
    inside = host_ms(rec, ROOTS)
    if inside is None:
        return None
    return inside - host_ms(rec, ("step.sync_readback",))
