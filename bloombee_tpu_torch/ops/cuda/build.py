"""Build the port's CUDA kernels and count their launches.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes; `csrc/*.cuh` holds
device code that several sources include. No PyTorch headers and no ninja:
a source builds in seconds. Libraries land in `_build/` (listed in
.gitignore), keyed by a hash of the source, the headers and the flags, so
a changed source rebuilds and an unchanged one loads at once. Several
sources build in parallel, one `nvcc` each.

A build failure raises with the compiler's output; nothing falls back.

`LAUNCHES` counts kernel launches by name. Each wrapper adds one
(`count_launch`) exactly where it launches its kernel, so a run can show
that its main path went through the kernels (`reset_launch_counts()`
before, read after).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    # each source's kernel instantiations optimized on every core
    "--split-compile=0",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of `name`; safe from several compute threads (two
    servers in one process each launch from their own)."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        LAUNCHES.clear()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build only where the CUDA toolkit is installed"
        )
    return path


def _output(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # every source may include the shared headers: they key each library
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def sources() -> list[str]:
    """The name of every kernel source, `csrc/<name>.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names) -> dict[str, str]:
    """Compile every named source whose library is missing, all `nvcc`s at
    once; returns each built source's compiler log (ptxas register and
    spill report). Raises RuntimeError naming each source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _output(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_output(name)))
            _libs[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise on a launch error code returned by a library entry point."""
    if err == -1:
        raise ValueError(f"{kernel}: configuration not compiled in")
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {err})")
