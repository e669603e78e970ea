"""The stereo pipeline's runner: the port's ``run_stereo_vo_streaming`` under a
configuration, each eye under its own preprocessing plan, and its check
against the plain reference.

As in mono, the check takes from the program only what the reference cannot
rebuild from the frames: the translation and rotation that the previous
pair left (outputs ``t``, ``R`` of pair i - 1), whether the stream was
initialized (from the program's counts of the earlier pairs), and the
generator's position before the pair's chunk, which the reference carries
through the chunk.  The previous pair's stereo-matched
set is the reference's own; the start, pairs 0 and 1 of the first pass,
runs on the reference's own state from a fresh one.
"""

from __future__ import annotations

import torch

from ergo_uvo_tpu_torch.config import StereoVOConfig
from ergo_uvo_tpu_torch.image.preprocess import build_preprocess_plan
from ergo_uvo_tpu_torch.io.sequence import FrameBatch
from ergo_uvo_tpu_torch.pipeline.stereo import StereoRig, run_stereo_vo_streaming
from uvo_bench.pipelines import common
from uvo_bench.reference import config as ref_config
from uvo_bench.reference.features.frontend import detect_and_describe_cfg as ref_detect
from uvo_bench.reference.features.matcher import match_descriptors as ref_match
from uvo_bench.reference.pipeline import stereo as ref_stereo
from uvo_bench.sources import FrameList
from uvo_bench.spec import build_config

load_kernels = common.load_kernels

COUNTS = ("num_features_l", "num_features_r", "num_stereo_matches", "num_triangular_matches",
          "num_3d_points", "num_pnp_inliers")
WARM_FRAMES = (0, 1, 2)


def _rig(cls, K_left, K_right, baseline, device):
    """The rig of the reference's shipped extrinsics: identity rotation, the
    right camera ``baseline`` along the left camera's +x."""
    return cls(K_left=K_left, K_right=K_right,
               R_right=torch.eye(3, dtype=torch.float32, device=device),
               t_right=torch.tensor([-baseline, 0.0, 0.0], dtype=torch.float32, device=device))


class Runner:
    frame_batch = FrameBatch

    def __init__(self, config: dict, traffic: dict, stream, device: torch.device):
        self.config, self.traffic, self.stream, self.device = config, traffic, stream, device
        self.chunk_size = traffic["chunk_size"]
        self.cfg = build_config(StereoVOConfig, config)
        pre = self.cfg.preprocessing
        h, w = stream.left.shape[1:]
        self.plans = [build_preprocess_plan(stream.K, stream.dist, w, h, pre.desired_width,
                                            pre.clahe, pre.clip_limit, device=device)
                      for _ in range(2)]
        self.rig = _rig(StereoRig, self.plans[0].new_K, self.plans[1].new_K,
                        config["stereo_baseline"], device)
        self.ref = common.RefFrames(config, stream, device, ref_config.StereoVOConfig)
        self.ref_rig = _rig(ref_stereo.StereoRig, self.ref.K, self.ref.K,
                            config["stereo_baseline"], device)

    def run(self, source, generator, callback, state=None):
        state, _ = run_stereo_vo_streaming(source, self.plans[0], self.plans[1], self.rig,
                                           self.cfg, generator, chunk_size=self.chunk_size,
                                           state=state, chunk_callback=callback,
                                           device=self.device)
        return state

    def warm(self, generator, frames=None):
        source = FrameList(self.stream, common.warm_indices(WARM_FRAMES, self.chunk_size, frames),
                           FrameBatch)
        self.run(source, generator, source.callback)
        return source.seconds

    # ---- the check
    def _stereo_ok(self, out) -> bool:
        c = self.cfg
        return bool(out["num_features_l"] >= c.min_num_features
                    and out["num_features_r"] >= c.min_num_features
                    and out["num_stereo_matches"] > c.min_num_features)

    def _ref_state(self, by_key, rec):
        """The state before ``rec``'s pair, as the reference rebuilds it."""
        cfg, ref, i = self.ref.cfg, self.ref, rec["index"]
        initialized = any(self._stereo_ok(by_key[(rec["pass"], j)]["out"]) for j in range(i))
        if not initialized:
            return ref_stereo.stereo_vo_init(cfg.max_keypoints, cfg.descriptor_dim,
                                             device=self.device)
        prev = by_key[(rec["pass"], i - 1)]["out"]
        kl, dl = ref_detect(ref.frame(i - 1), cfg)
        kr, dr = ref_detect(ref.frame(i - 1, right=True), cfg)
        sm = ref_match(dl, kl.mask, dr, kr.mask, cfg.lowe_ratio_test)
        ok = ((kl.count >= cfg.min_num_features) & (kr.count >= cfg.min_num_features)
              & (sm.count > cfg.min_num_features))
        keep = sm.mask & ok
        return ref_stereo.StereoVOState(
            prev_xy_l=torch.where(keep[:, None], kl.xy, 0.0),
            prev_xy_r=torch.where(keep[:, None], kr.xy[sm.idx.long()], 0.0),
            prev_desc_l=torch.where(keep[:, None], dl, 0.0),
            prev_mask=keep,
            prev_time=ref.put(self.stream.timestamps[i - 1]),
            t_prev_curr=ref.put(prev["t"]),
            R_curr_prev=ref.put(prev["R"]),
            initialized=torch.ones((), dtype=torch.bool, device=self.device),
        )

    def _ref_step(self, state, rec, gen):
        i, ref = rec["index"], self.ref
        return ref_stereo.stereo_vo_step(state, ref.frame(i), ref.frame(i, right=True),
                                         ref.put(self.stream.timestamps[i]), self.ref_rig,
                                         ref.cfg, gen)

    def check(self, window, seed, control):
        by_key = {(r["pass"], r["index"]): r for r in window}

        def fresh():
            return ref_stereo.stereo_vo_init(self.ref.cfg.max_keypoints,
                                             self.ref.cfg.descriptor_dim, device=self.device)

        return common.check(window, seed, control, self.config, self.traffic, COUNTS,
                            step=self._ref_step, fresh=fresh,
                            rebuild=lambda rec: self._ref_state(by_key, rec),
                            generator=self.ref.generator)
