"""What the pipelines' runners share: the kernels' build, the reference's view
of the stream, the sample of the window that is checked, and the check's loop."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from uvo_bench import judge
from uvo_bench.reference.image.preprocess import build_preprocess_plan, preprocess_frame
from uvo_bench.spec import build_config

KERNELS = ("top2_distances", "jacobi_eigh")


def load_kernels(device: torch.device) -> dict:
    """Build (first run in a checkout) or load the port's CUDA kernels; the
    seconds spent in nvcc in this process."""
    if device.type != "cuda":
        return {"nvcc_s": 0.0}
    from ergo_uvo_tpu_torch import cuda_build

    for stem in KERNELS:
        cuda_build.load_library(stem)
    return {"nvcc_s": sum(cuda_build.BUILD_INFO[s][0] for s in KERNELS)}


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 (``on``) or in true float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def host(out) -> dict:
    """A step's output tuple as a dict of numpy values."""
    return {k: v.detach().cpu().numpy() for k, v in out._asdict().items()}


class RefFrames:
    """The stream as the plain reference sees it: its own preprocessing plan
    (worked out again from the camera), its config, its generator."""

    def __init__(self, config: dict, stream, device: torch.device, config_cls):
        self.stream, self.device = stream, device
        self.cfg = build_config(config_cls, config)
        pre = self.cfg.preprocessing
        h, w = stream.left.shape[1:]
        self.plan = build_preprocess_plan(stream.K, stream.dist, w, h, pre.desired_width,
                                          pre.clahe, pre.clip_limit, device=device)
        self.K = self.plan.new_K

    def put(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def frame(self, i: int, right: bool = False) -> torch.Tensor:
        raw = (self.stream.right if right else self.stream.left)[i]
        return preprocess_frame(self.plan, self.put(raw).float())

    def generator(self, state) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        return gen


def sample(window: list[dict], seed: int, k: int, stratum=None) -> list[dict]:
    """``k`` finished frames of the window, drawn from the seed, each the
    second or a later frame of its pass (frames 0 and 1 of the first pass are
    the start, checked apart).  ``stratum(rec)`` splits the frames into kinds
    (the estimator a mono frame prefers); each kind gets an equal share of
    ``k``, and what a kind lacks goes to the others."""
    pool = [r for r in window if r["out"] is not None and r["index"] >= 1
            and not (r["pass"] == 0 and r["index"] <= 1)]
    rng = np.random.default_rng([seed, 0xC0FFEE])
    kinds: dict = {}
    for r in pool:
        kinds.setdefault(None if stratum is None else stratum(r), []).append(r)
    groups = [kinds[key] for key in sorted(kinds, key=repr)]
    for g in groups:
        rng.shuffle(g)
    take = [0] * len(groups)
    for _ in range(min(k, len(pool))):
        open_ = [j for j, g in enumerate(groups) if take[j] < len(g)]
        take[min(open_, key=lambda j: take[j])] += 1
    picks = [r for g, n in zip(groups, take) for r in g[:n]]
    return sorted(picks, key=lambda r: (r["pass"], r["index"]))


def check(window, seed, control, config, traffic, counts, step, fresh, rebuild,
          stratum=None) -> dict:
    """The program's outputs on the start and on the sample against the
    reference's (in the control: the reference in TF32 against the reference).

    ``step(state, rec)`` runs the reference's step on ``rec``'s frame;
    ``fresh()`` is a fresh state; ``rebuild(rec)`` the state before ``rec``'s
    frame; ``stratum`` as in :func:`sample`.  Each side builds its states
    under its own precision.
    """
    by_key = {(r["pass"], r["index"]): r for r in window}
    start = [by_key.get((0, 0)), by_key.get((0, 1))]
    if any(r is None or r["out"] is None for r in start):
        raise RuntimeError("the window did not finish the first two frames of its first pass")
    prog, refs = [], []
    sides = (False, True) if control else (False,)
    carried = {on: None for on in sides}
    for rec in start:
        outs = {}
        for on in sides:
            with tf32(on):
                state = fresh() if carried[on] is None else carried[on]
                carried[on], out = step(state, rec)
                outs[on] = host(out)
        prog.append(outs[True] if control else rec["out"])
        refs.append(outs[False])
    for rec in sample(window, seed, config["reference_frames"], stratum):
        outs = {}
        for on in sides:
            with tf32(on):
                outs[on] = host(step(rebuild(rec), rec)[1])
        prog.append(outs[True] if control else rec["out"])
        refs.append(outs[False])
    return judge.compare(prog, refs, counts, traffic["speed"])
