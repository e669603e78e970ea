"""Structured per-frame run records (SURVEY.md §5 metrics/observability).

A copy of ``ergo_uvo_tpu/utils/records.py`` (whose package imports JAX); it
writes the same JSONL lines for the same outputs.  Outputs are numpy arrays
or CPU tensors: the runners read them back from the card before they are
recorded.

The reference's only observability is its ROS topics + console logs
(visual_odometry.h:138-139,157-158).  Here every frame's full diagnostic
record (pose, validity, inlier counts, scale factor, timing) is appended to a
JSONL file host-side — the input to the ATE/RPE evaluator and to dashboards.
"""

from __future__ import annotations

import json
import time
from typing import IO, Any

import numpy as np


def _to_jsonable(v: Any):
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


class RunRecorder:
    """Append per-frame records (dicts or pipeline outputs) to JSONL."""

    def __init__(self, path: str):
        self.path = path
        self._f: IO | None = open(path, "a", buffering=1)
        self._t0 = time.time()

    def record_frame(self, frame_index: int, output, **extra) -> None:
        """`output`: a MonoFrameOutput/StereoFrameOutput or any NamedTuple."""
        rec = {"frame": int(frame_index), "wall_time": time.time() - self._t0}
        if hasattr(output, "_asdict"):
            for k, v in output._asdict().items():
                rec[k] = _to_jsonable(v)
        elif isinstance(output, dict):
            rec.update({k: _to_jsonable(v) for k, v in output.items()})
        rec.update({k: _to_jsonable(v) for k, v in extra.items()})
        assert self._f is not None
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
