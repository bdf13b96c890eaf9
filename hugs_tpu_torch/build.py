"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a
plain C interface, `build/hugs_tpu_torch/<name>-<hash>.so` under the
repository root, keyed on a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, with nvcc's output (ptxas -v) beside it in
`<name>-<hash>.log`; a library that is already there with its log is
reused. There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "hugs_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # nvcc's output (ptxas -v) per source
compiled: set[str] = set()   # the sources this process compiled


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to, keyed on its source, every shared
    header in csrc/ and the flags, so that an edit to a header rebuilds
    every kernel."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that is not built yet (no library, or
    no log beside it), one nvcc process per source, all started together.
    Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if path.exists() and log.exists():
            build_logs[name] = log.read_text()
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            paths[name].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[name])
            compiled.add(name)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def kernel_resources(log, kernel):
    """Registers, static shared memory (bytes) and spill stores of the
    entry function named `kernel` in nvcc's `-Xptxas -v` output."""
    entry, out = None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif entry is not None and kernel in entry:
            if "spill stores" in line:
                spills = int(line.split("bytes spill stores")[0]
                             .split(",")[-1])
                out = dict(out or {}, spill_bytes=spills)
            if "registers" in line:
                regs = int(line.split("Used")[1].split("registers")[0])
                smem = int(line.split("bytes smem")[0].split(",")[-1]) \
                    if "bytes smem" in line else 0
                out = dict(out or {}, registers=regs, smem_bytes=smem)
    if not out or "registers" not in out:
        raise AssertionError(f"no ptxas report for {kernel}")
    return out
