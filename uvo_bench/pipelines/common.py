"""What the pipelines' runners share: the kernels' build, the reference's view
of the stream, the sample of the window that is checked, and the check's loop."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from uvo_bench import judge
from uvo_bench.reference.image.preprocess import build_preprocess_plan, preprocess_frame
from uvo_bench.spec import build_config

KERNELS = ("top2_distances", "jacobi_eigh", "surf_hessian")


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


def warm_indices(frames: tuple, chunk_size: int, take=None) -> list[int]:
    """The warm-up's frames: the first ``take`` of ``frames`` (the estimator
    branches), all of them padded with the frames that follow the last to a
    whole number of chunks, so that warm-up also runs a whole chunk's shapes."""
    idx = list(frames[:take])
    if take is None:
        while len(idx) % chunk_size:
            idx.append(idx[-1] + 1)
    return idx


def _checked(rec: dict) -> bool:
    """Whether the sample compares ``rec``'s frame: the second or a later frame
    of its pass (frames 0 and 1 of the first pass are the start, checked apart)."""
    return rec["index"] >= 1 and not (rec["pass"] == 0 and rec["index"] <= 1)


def sample(window: list[dict], seed: int, k: int, stratum=None, chunk_size: int = 1) -> list:
    """``k`` finished chunks of the window (each the list of its frames' records,
    in order), drawn from the seed; a chunk whose frames the sample would
    compare none of (:func:`_checked`) is not drawn.  ``stratum(rec)`` splits
    the chunks into kinds by their first compared frame (the estimator a mono
    frame prefers); each kind gets an equal share of ``k``, and what a kind
    lacks goes to the others."""
    chunks: dict = {}
    for r in window:
        chunks.setdefault((r["pass"], r["index"] // chunk_size), []).append(r)
    pool = [c for c in chunks.values()
            if all(r["out"] is not None for r in c) and any(_checked(r) for r in c)]
    rng = np.random.default_rng([seed, 0xC0FFEE])
    kinds: dict = {}
    for c in pool:
        first = next(r for r in c if _checked(r))
        kinds.setdefault(None if stratum is None else stratum(first), []).append(c)
    groups = [kinds[key] for key in sorted(kinds, key=repr)]
    for g in groups:
        rng.shuffle(g)
    take = [0] * len(groups)
    for _ in range(min(k, len(pool))):
        open_ = [j for j, g in enumerate(groups) if take[j] < len(g)]
        take[min(open_, key=lambda j: take[j])] += 1
    picks = [c for g, n in zip(groups, take) for c in g[:n]]
    return sorted(picks, key=lambda c: (c[0]["pass"], c[0]["index"]))


def check(window, seed, control, config, traffic, counts, step, fresh, rebuild, generator,
          stratum=None) -> dict:
    """The program's outputs on the start and on the sample against the
    reference's (in the control: the reference in TF32 against the reference).

    ``step(state, rec, gen)`` runs the reference's step on ``rec``'s frame
    with the generator ``gen``; ``fresh()`` is a fresh state; ``rebuild(rec)``
    the state before ``rec``'s frame; ``generator(gen_state)`` a generator at
    a recorded state; ``stratum`` as in :func:`sample`.  The sample is of
    whole chunks of the traffic's ``chunk_size``, ``reference_frames`` frames
    in all; the reference replays a chunk frame by frame from the generator's
    state before the chunk, carrying its generator through the chunk as the
    program does.  Each side builds its states and carries its generator
    under its own precision.
    """
    by_key = {(r["pass"], r["index"]): r for r in window}
    start = [by_key.get((0, 0)), by_key.get((0, 1))]
    if any(r is None or r["out"] is None for r in start):
        raise RuntimeError("the window did not finish the first two frames of its first pass")
    prog, refs = [], []
    sides = (False, True) if control else (False,)

    def replay(frames, run, compared):
        """The reference's outputs ``run(on, rec, gen)`` on ``frames`` in order,
        each side's generator carried from frame to frame."""
        gens = {on: None for on in sides}
        for rec in frames:
            outs = {}
            for on in sides:
                with tf32(on):
                    if rec["gen_state"] is not None:
                        gens[on] = generator(rec["gen_state"])
                    elif gens[on] is None:
                        raise RuntimeError(f"frame {rec['index']} of pass {rec['pass']} starts "
                                           "a replay but has no generator state")
                    outs[on] = host(run(on, rec, gens[on]))
            if compared(rec):
                prog.append(outs[True] if control else rec["out"])
                refs.append(outs[False])

    carried = {on: None for on in sides}

    def start_step(on, rec, gen):
        """The start's step, on the reference's own state from a fresh one."""
        carried[on], out = step(fresh() if carried[on] is None else carried[on], rec, gen)
        return out

    replay(start, start_step, lambda rec: True)
    chunk = traffic["chunk_size"]
    for frames in sample(window, seed, -(-config["reference_frames"] // chunk), stratum, chunk):
        replay(frames, lambda on, rec, gen: step(rebuild(rec), rec, gen)[1], _checked)
    return judge.compare(prog, refs, counts, traffic["speed"])
