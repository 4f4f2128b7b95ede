"""Build the CUDA kernels with ``nvcc`` at first use and load them.

The sources in ``csrc/`` have a plain C interface, so they compile in
seconds into a shared library that ``ctypes`` loads; no PyTorch headers
are involved. The library goes to ``build/kernels/`` at the repository
root (listed in ``.gitignore``), named after a hash of its source and
flags, so an edited source rebuilds and an unchanged one is reused. The
compiler's output is kept beside it (``lib<name>-<hash>.log``), so a
reused build still reports its registers and spills.

Nothing here runs at import time: the first kernel launch calls
:func:`load`, which compiles when needed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# No --use_fast_math: the kernels must match the plain PyTorch versions
# bit for bit (see the note at the top of each source).
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, ``PATH``, or
    ``/usr/local/cuda/bin``. Raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(pathlib.Path(which))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple[pathlib.Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless an identical build exists.

    Returns ``(library path, compiler output, seconds spent compiling)``;
    the compiler output carries ``-Xptxas -v``'s registers and spills per
    kernel. A reused build returns the output saved when it was compiled,
    with 0 seconds.
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return lib, log_path.read_text(), 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    # The log first, then the library: a library on disk always has its log.
    tmp_log = log_path.with_suffix(f".{os.getpid()}.logtmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_path)
    os.replace(tmp, lib)
    return lib, log, seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    lib_path, _, _ = build(name)
    return ctypes.CDLL(str(lib_path))
