"""binning_ms: the device ms a step of the program's `render.bin` spans,
summed over the step's renders (merged and the human alone), over the
traced window's steps."""
from bench_port.spans import device_ms


def read(rec: dict, cell: dict):
    return device_ms(rec, "render.bin")
