"""sync_wait_ms: the host ms of the program's `step.sync_readback` spans
(the read-back of the loss and slot counts at sync steps, and the budget
check) over the traced window, divided by the window's steps."""
from bench_port.spans import host_ms


def read(rec: dict, cell: dict):
    return host_ms(rec, ("step.sync_readback",))
