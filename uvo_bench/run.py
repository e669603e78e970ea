"""Run one cell of the benchmark of ``ergo_uvo_tpu_torch`` and print its result.

    python3 uvo_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port, on a machine with as many
NVIDIA cards as the cell asks for.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number of the
check beside its limit, which also close standard error.  Without a card,
with too few, or with JAX loaded once the window has closed, the run prints
no result and exits non-zero.  ``--control`` judges the plain reference
computed in TF32 in the program's place (the check's control; the
benchmark's own runs never pass it).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Run as a script, this folder leads sys.path, where its modules would shadow
# top-level names; the checkout's root takes its place.
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]
FORBIDDEN = ("jax", "jaxlib", "flax", "ergo_uvo_tpu")
# Every build and kernel cache at a fixed path inside the checkout; the port's
# nvcc outputs go to build/ergo_uvo_tpu_torch/ by its own rule.
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "uvo_bench" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "uvo_bench" / "triton"}


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    for key, path in CACHES.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"

    import torch

    from uvo_bench.harness import run_cell
    from uvo_bench.spec import load_cell

    cell = load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"uvo_bench: {args.workload} needs {chips} NVIDIA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS,
                      control=args.control)
    loaded = forbidden_modules()
    if loaded:
        print(f"uvo_bench: JAX or the JAX package is loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
