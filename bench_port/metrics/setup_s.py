"""setup_s: from the start of the process to the first step of the
window: imports, the sequence, the trainer (the init distillation), the
checked steps, the warm-up and, in a checkout's first run, the kernels'
build (host clock)."""


def read(rec: dict, cell: dict):
    return rec["setup_s"]
