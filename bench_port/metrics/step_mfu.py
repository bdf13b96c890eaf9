"""step_mfu: the whole step's least time (work/step.py's count of the
staged steps, their mean) over the traced window's time a step."""
import statistics
import sys


def read(rec: dict, cell: dict):
    dt, least = rec.get("device_trace"), rec.get("step_least")
    if dt is None or not least or not rec.get("steps"):
        return None
    step_s = dt.window_s / rec["steps"]
    mean = statistics.fmean(w["least_s"] for w in least)
    by = sorted({w["bound_by"] for w in least})
    w = least[0]
    print(f"# step_mfu: least {mean * 1e3:.6f} ms a step by {'/'.join(by)} "
          f"(first staged step: {w['tc_flops']:.0f} tensor-core flops, "
          f"{w['fp32_flops']:.0f} float32 flops, {w['bytes']:.0f} bytes) "
          f"over {step_s * 1e3:.6f} ms a traced step", file=sys.stderr)
    return 100.0 * mean / step_s
