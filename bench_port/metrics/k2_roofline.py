"""k2_roofline: K2's least time on the staged steps' renders (work/blend.py's
count: its operations at the float32 peak or its bytes at the memory
rate, the larger) over its device time in their trace."""
import sys

from bench_port.work.peaks import PEAK_BYTES, PEAK_FP32


def read(rec: dict, cell: dict):
    seconds = rec.get("k2_s")
    if not seconds:
        return None
    ops, nbytes = rec["k2_work"]
    least = max(ops / PEAK_FP32, nbytes / PEAK_BYTES)
    by = "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES else "bytes"
    print(f"# k2_roofline: least {least * 1e3:.6f} ms by {by} ({ops:.0f} "
          f"float32 operations, {nbytes:.0f} bytes) over {seconds * 1e3:.6f}"
          f" ms of K2", file=sys.stderr)
    return 100.0 * least / seconds
