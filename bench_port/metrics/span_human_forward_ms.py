"""span_human_forward_ms: the device ms of the program's
`step.human_forward` span, the mean over the traced window's steps."""
from bench_port.spans import device_ms


def read(rec: dict, cell: dict):
    return device_ms(rec, "step.human_forward")
