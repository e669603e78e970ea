"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<stem>.cu`` is compiled at first use, on the machine with the
card, into ``build/ergo_uvo_tpu_torch/lib<stem>_<hash>.so`` under the
checkout's root, where ``<hash>`` covers the source and the compiler flags, so
an edited source is rebuilt and an unchanged one is loaded as built.  Nothing
is compiled when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ergo_uvo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBRARIES: dict[str, ctypes.CDLL] = {}
# stem -> (seconds spent in nvcc in this process, or 0.0 if the library was
# already built; nvcc's stderr, which holds ptxas's register/spill report).
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels of ergo_uvo_tpu_torch are built on the "
            "machine with the card"
        )
    return found


def load_library(stem: str) -> ctypes.CDLL:
    """Build ``csrc/<stem>.cu`` if needed and return the loaded library."""
    lib = _LIBRARIES.get(stem)
    if lib is not None:
        return lib
    src = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{digest}.so"
    seconds, log = 0.0, ""
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
        log = proc.stderr
    lib = ctypes.CDLL(str(out))
    _LIBRARIES[stem] = lib
    BUILD_INFO[stem] = (seconds, log)
    return lib
