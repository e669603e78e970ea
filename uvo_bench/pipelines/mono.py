"""The mono pipeline's runner: the port's ``run_mono_vo_streaming`` under a
configuration, and its check against the plain reference.

The check follows the program frame by frame from the program's own
carried state where the reference cannot rebuild it from the frames: the
relative pose, translation and scale factor that the previous frame left
(the outputs ``R``, ``t``, ``scale_factor`` of frame i - 1), whether the
stream was initialized (from the program's feature counts), and the
generator's position before the frame's chunk, which the reference carries
through the chunk.  The previous frame's features are
the reference's own, from the raw frame.  The start, frames 0 and 1 of the
first pass, runs on the reference's own state from a fresh one.
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.config import MonoVOConfig
from ergo_uvo_tpu_torch.image.preprocess import build_preprocess_plan
from ergo_uvo_tpu_torch.io.sequence import FrameBatch
from ergo_uvo_tpu_torch.pipeline.mono import run_mono_vo_streaming
from uvo_bench.pipelines import common
from uvo_bench.reference import config as ref_config
from uvo_bench.reference.features.frontend import detect_and_describe_cfg as ref_detect
from uvo_bench.reference.pipeline import mono as ref_mono
from uvo_bench.sources import FrameList
from uvo_bench.spec import build_config

load_kernels = common.load_kernels

COUNTS = ("num_features", "num_matches", "num_inliers", "num_3d_points")
WARM_FRAMES = (0, 8, 9, 10, 11, 12)  # 0 -> 8 has parallax enough for the essential matrix


class Runner:
    frame_batch = FrameBatch

    def __init__(self, config: dict, traffic: dict, stream, device: torch.device):
        self.config, self.traffic, self.stream, self.device = config, traffic, stream, device
        self.chunk_size = traffic["chunk_size"]
        self.cfg = build_config(MonoVOConfig, config)
        pre = self.cfg.preprocessing
        h, w = stream.left.shape[1:]
        self.plan = build_preprocess_plan(stream.K, stream.dist, w, h, pre.desired_width,
                                          pre.clahe, pre.clip_limit, device=device)
        self.ref = common.RefFrames(config, stream, device, ref_config.MonoVOConfig)

    def run(self, source, generator, callback, state=None):
        state, _ = run_mono_vo_streaming(source, self.plan, self.plan.new_K, self.cfg, generator,
                                         chunk_size=self.chunk_size, state=state,
                                         chunk_callback=callback,
                                         device=self.device)
        return state

    def warm(self, generator, frames=None):
        """Run the cell's shapes once: frame 0, then 8 (the essential matrix
        and, on the plane, the homography after its gate), then neighbours,
        to a whole chunk."""
        source = FrameList(self.stream, common.warm_indices(WARM_FRAMES, self.chunk_size, frames),
                           FrameBatch)
        self.run(source, generator, source.callback)
        return source.seconds

    # ---- the check
    def _ref_state(self, by_key, rec, initialized):
        """The state before ``rec``'s frame, as the reference rebuilds it."""
        cfg, ref = self.ref.cfg, self.ref
        i = rec["index"]
        if not initialized:
            return ref_mono.mono_vo_init(cfg.max_keypoints, cfg.descriptor_dim,
                                         device=self.device)
        prev = by_key[(rec["pass"], i - 1)]["out"]
        kp, desc = ref_detect(ref.frame(i - 1), cfg)
        put = ref.put
        return ref_mono.MonoVOState(
            prev_xy=kp.xy, prev_desc=desc, prev_mask=kp.mask,
            prev_time=put(self.stream.timestamps[i - 1]),
            R=put(prev["R"]), t=put(prev["t"]), SF=put(prev["scale_factor"]),
            initialized=torch.ones((), dtype=torch.bool, device=self.device),
        )

    def _ref_step(self, state, rec, gen):
        i, s, ref = rec["index"], self.stream, self.ref
        return ref_mono.mono_vo_step(state, ref.frame(i), ref.put(s.timestamps[i]),
                                     ref.put(s.ranges[i]), ref.K, ref.cfg, gen)

    def check(self, window, seed, control):
        by_key = {(r["pass"], r["index"]): r for r in window}
        min_f = self.cfg.min_num_features

        def initialized(rec):
            return any(by_key[(rec["pass"], j)]["out"]["num_features"] >= min_f
                       for j in range(rec["index"]))

        def fresh():
            return ref_mono.mono_vo_init(self.ref.cfg.max_keypoints, self.ref.cfg.descriptor_dim,
                                         device=self.device)

        return common.check(
            window, seed, control, self.config, self.traffic, COUNTS,
            step=self._ref_step, fresh=fresh,
            rebuild=lambda rec: self._ref_state(by_key, rec, initialized(rec)),
            generator=self.ref.generator,
            stratum=lambda rec: essential(rec["out"], self.config),
        )


def essential(out: dict, config: dict) -> bool:
    """Whether a frame's relative pose ran the essential estimator (preferred,
    median parallax >= ``distance``, or it gave the pose)."""
    return bool(out["median_disparity"] >= config["distance"] or out["used_essential"])


def summary(window: list[dict], config: dict) -> dict:
    """The window's work: the frames that ran the essential estimator."""
    return {"essential_frames": sum(1 for r in window
                                    if r["out"] is not None and essential(r["out"], config))}

