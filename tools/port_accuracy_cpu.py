"""The accuracy phases of chip_smoke.py through the port on the CPU.

    python tools/port_accuracy_cpu.py

``bench.py::section_parity``'s SIFT configs and sequences
(``chip_smoke.accuracy_runs``): mono on seeds 0, 1, 2 (24 frames of 320x240)
and stereo on seeds 0 and 1 (16 pairs).  Prints one JSON line each, with
the rows a seed and the means; the bounds ``chip_smoke.py`` holds the card's
run to were set from these, no looser than 2x the JAX package's figures.
Imports torch and the port only.
"""

import json
import sys
import time
from pathlib import Path

# The repo root in place of this directory, whose profile.py would shadow
# the standard library's module of that name.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    for stereo in (False, True):
        t0 = time.perf_counter()
        rows = chip_smoke.accuracy_runs(torch, torch.device("cpu"), stereo)
        print(json.dumps({
            "phase": "accuracy_stereo_sift" if stereo else "accuracy_sift", "device": "cpu",
            "seconds": time.perf_counter() - t0, "rows": rows,
            "mean_velocity_rmse": float(np.mean([r["velocity_rmse"] for r in rows])),
            "mean_ate_m": float(np.mean([r["ate_m"] for r in rows]))}), flush=True)
