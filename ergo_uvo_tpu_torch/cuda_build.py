"""Build the port's CUDA sources with nvcc, load them with ctypes, and reach them.

Each ``csrc/<stem>.cu`` is compiled at first use, on the machine with the
card, into ``build/ergo_uvo_tpu_torch/lib<stem>_<hash>.so`` under the
checkout's root, where ``<hash>`` covers the source and the compiler flags, so
an edited source is rebuilt and an unchanged one is loaded as built.  Nothing
is compiled when the module is imported.

Every hand-written kernel is reached the same way, through this module
(``cuda_build.bind(...)``, so that one test double stands in for all of
them)::

    if cuda_build.use_kernel(x.device, "who"):   # CUDA: the kernel; CPU: plain
        ...checks, outputs, the empty-input return...
        with cuda_build.on_card(x.device, "who") as stream:
            err = cuda_build.bind(stem, SIGNATURES).entry(..., stream)
        cuda_build.launched(err, "who", "<stem>.launches")
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ergo_uvo_tpu_torch.utils.profiling import count

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ergo_uvo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The C types of the entry points' arguments: a pointer is a device buffer, a
# host array of them or a stream's handle.  An entry point returns its
# ``cudaError`` as an int unless its signature says otherwise.
INT, FLOAT, PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

_LIBRARIES: dict[str, ctypes.CDLL] = {}
_BOUND: set[str] = set()  # stems whose entry points have their types set
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


def bind(stem: str, signatures: dict) -> ctypes.CDLL:
    """:func:`load_library` with each entry point's types set on first use.

    ``signatures`` maps an entry point's name to its argument types, or to
    ``(argument types, result type)`` where it returns no ``cudaError``.
    """
    lib = load_library(stem)
    if stem not in _BOUND:
        for name, sig in signatures.items():
            argtypes, restype = sig if isinstance(sig, tuple) else (sig, INT)
            entry = getattr(lib, name)
            entry.argtypes, entry.restype = argtypes, restype
        _BOUND.add(stem)
    return lib


@contextlib.contextmanager
def on_card(device: torch.device, who: str):
    """Make ``device`` current for a launch and yield its current stream's
    handle.  A device that is not CUDA is refused: the kernel would read host
    pointers."""
    if device.type != "cuda":
        raise ValueError(f"{who}: the kernel takes tensors on a CUDA device, got {device}")
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def launched(err: int, who: str, counter: str) -> None:
    """Raise on an entry point's non-zero ``cudaError``; else count one launch
    under ``counter``."""
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed: cudaError {err}")
    count(counter)


def use_kernel(device: torch.device, who: str) -> bool:
    """The dispatch of every kernel's public function: CUDA tensors take the
    kernel (True), CPU tensors the plain version (False); any other device
    raises."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: no implementation for device {device}")
    return device.type == "cuda"
