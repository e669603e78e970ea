"""The JAX package's mono runs that chip_smoke.py's detector phases are held to.

    JAX_PLATFORMS=cpu python tools/jax_detector_reference.py [--keys N] [SIFT ORB AKAZE]

For each detector: ``bench.py::_section_detector``'s config
(``MonoVOConfig(feature_detector=det, max_keypoints=512, num_hypotheses=512)``)
on ``make_mono_sequence(n_frames=24, height=480, width=640, dt=0.05, seed=1)``
with ``PRNGKey(k)`` for k < N (default 1), ORB through
``run_mono_vo_batched_features`` as ``bench.py`` runs it, under ``jax.jit``
(one compile a detector).  Prints one JSON line a run: the validity share of
frames 1..23 and the velocity RMSE over the valid frames (as
``chip_smoke.py::_velocity_check`` computes it), beside the run's seconds;
then a line of the medians over the keys.  Imports the JAX package only;
about 3 min of compile a detector on a CPU host, then seconds a key.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ergo_uvo_tpu.config import MonoVOConfig
from ergo_uvo_tpu.io import make_mono_sequence
from ergo_uvo_tpu.pipeline import run_mono_vo
from ergo_uvo_tpu.pipeline.mono import run_mono_vo_batched_features


def reference(det: str, key: int, run) -> dict:
    seq = make_mono_sequence(n_frames=24, height=480, width=640, dt=0.05, seed=1)
    cfg = MonoVOConfig(feature_detector=det, max_keypoints=512, num_hypotheses=512)
    t0 = time.time()
    _, outs = run(jnp.asarray(seq.imgs_left), jnp.asarray(seq.timestamps),
                  jnp.asarray(seq.ranges), jnp.asarray(seq.K), cfg, jax.random.PRNGKey(key))
    outs = jax.tree.map(np.asarray, outs)
    val = outs.validity
    gt = seq.velocities_prevcam
    err = outs.velocity[val].astype(np.float64) - gt[val]
    return {"detector": det, "key": key, "seconds": time.time() - t0,
            "valid_share": float(val[1:].mean()),
            "velocity_rmse": float(np.sqrt((err**2).sum(-1).mean())),
            "mean_gt_speed": float(np.linalg.norm(gt[1:], axis=-1).mean()),
            "published": outs.published.astype(int).tolist(), "validity": val.astype(int).tolist(),
            "num_features": outs.num_features.tolist(), "num_matches": outs.num_matches.tolist()}


if __name__ == "__main__":
    args = sys.argv[1:]
    n_keys = 1
    if args[:1] == ["--keys"]:
        n_keys, args = int(args[1]), args[2:]
    for det in args or ["SIFT", "ORB", "AKAZE"]:
        runner = run_mono_vo_batched_features if det == "ORB" else run_mono_vo
        run = jax.jit(runner, static_argnames="cfg")  # one compile for every key
        rows = [reference(det, key, run) for key in range(n_keys)]
        for row in rows:
            print(json.dumps(dict(row, runner=runner.__name__)), flush=True)
        print(json.dumps({"detector": det, "keys": n_keys,
                          "median_valid_share": float(np.median([r["valid_share"] for r in rows])),
                          "median_velocity_rmse": float(np.median([r["velocity_rmse"] for r in rows]))}),
              flush=True)
