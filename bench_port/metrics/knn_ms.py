"""knn_ms: the device ms a step of the program's `human.knn_targets`
spans (the kNN skinning targets inside the human forward), over the
traced window's steps."""
from bench_port.spans import device_ms


def read(rec: dict, cell: dict):
    return device_ms(rec, "human.knn_targets")
