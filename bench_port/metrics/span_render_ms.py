"""span_render_ms: the device ms of the program's `step.render` span(s),
summed in each step, the mean over the traced window's steps."""
from bench_port.spans import device_ms


def read(rec: dict, cell: dict):
    return device_ms(rec, "step.render")
