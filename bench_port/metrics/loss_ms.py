"""loss_ms: the loss stage's device ms, the mean over the staged steps
(CUDA events between the benchmark's calls into the trainer's stage
functions)."""


def read(rec: dict, cell: dict):
    return rec.get("stage_ms", {}).get("loss")
