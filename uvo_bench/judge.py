"""The numbers that decide ``correct``: the program's outputs on a sample of the
window's frames against the plain reference's outputs on the same frames.

Each number is the worst over the compared frames; a frame that the
program published and whose velocity is not finite reads as infinitely far.
"""

from __future__ import annotations

import math

import numpy as np


def rotation_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle between two rotations from ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2),
    which stays exact near 0 where the trace's arccos does not."""
    s = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)) / (2 * math.sqrt(2))
    return math.degrees(2 * math.asin(min(1.0, float(s))))


FLAGS = ("published", "validity", "used_essential")


def compare(prog: list[dict], ref: list[dict], counts: tuple, speed: float) -> dict:
    """Four numbers over the frame pairs ``prog[k]``, ``ref[k]`` (dicts of a
    frame's output fields, numpy):

    * ``velocity_gap``: the largest |v_program - v_reference| over frames that
      either side published, as a share of the mix's cruise speed;
    * ``rotation_gap_deg``: the largest angle between the two sides' relative
      rotations over frames that both published;
    * ``count_gap``: the largest |difference| of a count field, as a share of
      the reference's count (at least 1);
    * ``flags_differ``: the share of the frames in which a flag of
      :data:`FLAGS` that the output has (published, validity, the estimator
      used) differs.
    """
    v_gap, r_gap, c_gap, flagged = 0.0, 0.0, 0.0, 0
    for p, r in zip(prog, ref):
        flagged += any(bool(p[f]) != bool(r[f]) for f in FLAGS if f in r)
        for f in counts:
            c_gap = max(c_gap, abs(int(p[f]) - int(r[f])) / max(abs(int(r[f])), 1))
        if bool(p["published"]) or bool(r["published"]):
            dv = np.linalg.norm(np.asarray(p["velocity"], np.float64)
                                - np.asarray(r["velocity"], np.float64))
            v_gap = max(v_gap, float(dv) / speed if np.isfinite(dv) else math.inf)
        if bool(p["published"]) and bool(r["published"]):
            if np.all(np.isfinite(p["R"])):
                r_gap = max(r_gap, rotation_angle_deg(np.asarray(p["R"], np.float64),
                                                      np.asarray(r["R"], np.float64)))
            else:
                r_gap = math.inf
    return {"velocity_gap": v_gap, "rotation_gap_deg": r_gap, "count_gap": c_gap,
            "flags_differ": flagged / max(len(ref), 1)}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number that the configuration limits at or under its limit (a
    NaN fails); a configuration without limits is never correct."""
    return bool(limits) and all(numbers[k] <= limits[k] for k in limits)
