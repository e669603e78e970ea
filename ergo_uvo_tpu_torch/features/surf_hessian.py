"""SURF's fast-Hessian on the card: the CUDA kernels behind ``detect_surf``.

``csrc/surf_hessian.cu`` computes what the plain version in
:mod:`ergo_uvo_tpu_torch.features.detector` computes, each stage one launch
for the whole batch and every octave, where the plain version runs ~2,700
elementwise launches an image:

* :func:`padded_integral`: ``pad_integral(integral_image(img), margin)``, the
  blocked scans down the columns, then along the rows into the padded table
  (2 launches);
* :func:`responses`: every octave's det and trace stacks (1 launch);
* :func:`peak_scores`: the 3x3x3 peak test, the threshold and the validity
  masks, each octave's flat masked score in (layer, y, x) order (1 launch);
* :func:`detect`: those, ``torch.sort``'s stable top-K of each octave's flat
  scores, then the sub-pixel refinement and the cross-octave merge, written
  into the fields of ``Keypoints`` (1 launch).

The table, the stacks, the flat scores and so the keypoints' order, masks,
scores and laplacians are the plain version's bits on the card; so are
``xy`` and ``scale``, which go through ``_solve33``, whose ``adj @ b`` is
cuBLAS's product, for as long as the kernel sums it in cuBLAS's order (see
the source's note).  The launches run with the frames' card current; frames
on any other device are refused.  Nothing allocates or syncs on the host's behalf beyond
the outputs: no host sync, no host-to-device copy.

The counter ``surf_hessian.launches`` of
:mod:`ergo_uvo_tpu_torch.utils.profiling` counts kernel launches, 5 a call
of :func:`detect`, so a run can show that its detection went through them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ergo_uvo_tpu_torch import cuda_build
from ergo_uvo_tpu_torch.cuda_build import FLOAT, INT, PTR

MAX_OCTAVES = 8  # the kernels' bound on octaves (strides up to 128)

_SHAPE = [INT] * 6  # batch, h, w, n_octaves, layers, margin
SIGNATURES = {
    "surf_integral_columns": [PTR] * 2 + _SHAPE + [PTR],
    "surf_integral_rows": [PTR] * 2 + _SHAPE + [PTR],
    "surf_responses": [PTR] * 3 + _SHAPE + [PTR],
    "surf_peaks": [PTR] * 2 + _SHAPE + [FLOAT, PTR],
    "surf_refine_merge": [PTR] * 4 + _SHAPE + [INT, FLOAT] + [PTR] * 5 + [PTR],
}


class SurfShape(NamedTuple):
    """The shapes of one call: B frames of h x w, ``layers`` = n_layers + 2
    filter sizes an octave, the padded table's ``margin``."""

    batch: int
    h: int
    w: int
    n_octaves: int
    layers: int
    margin: int

    @property
    def grids(self) -> list[tuple[int, int]]:
        """Each octave's stride-2^o grid: (ceil(h / 2^o), ceil(w / 2^o))."""
        return [(-(-self.h // (1 << o)), -(-self.w // (1 << o))) for o in range(self.n_octaves)]

    def split(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Each octave's (B, layers, h_o, w_o) stack, as views of a flat buffer."""
        out, at = [], 0
        for h_o, w_o in self.grids:
            n = self.batch * self.layers * h_o * w_o
            out.append(flat[at:at + n].view(self.batch, self.layers, h_o, w_o))
            at += n
        return out

    def points(self) -> int:
        return sum(self.batch * self.layers * h_o * w_o for h_o, w_o in self.grids)


def _launch(name: str, *args) -> None:
    """Call the entry point ``name``: one kernel launch, counted."""
    err = getattr(cuda_build.bind("surf_hessian", SIGNATURES), name)(*args)
    cuda_build.launched(err, f"surf_hessian: {name}", "surf_hessian.launches")


def padded_integral(img: torch.Tensor, shape: SurfShape, stream: int) -> torch.Tensor:
    """(B, h + 1 + 2 margin, w + 1 + 2 margin) float32: the padded table."""
    cols = torch.empty_like(img)
    table = torch.empty(shape.batch, shape.h + 1 + 2 * shape.margin, shape.w + 1 + 2 * shape.margin,
                        dtype=torch.float32, device=img.device)
    _launch("surf_integral_columns", img.data_ptr(), cols.data_ptr(), *shape, stream)
    _launch("surf_integral_rows", cols.data_ptr(), table.data_ptr(), *shape, stream)
    return table


def responses(table: torch.Tensor, shape: SurfShape, stream: int):
    """(det, trace), each flat: every octave's (B, layers, h_o, w_o) stack,
    octave after octave (:meth:`SurfShape.split` gives the stacks)."""
    det = torch.empty(shape.points(), dtype=torch.float32, device=table.device)
    trace = torch.empty_like(det)
    _launch("surf_responses", table.data_ptr(), det.data_ptr(), trace.data_ptr(), *shape, stream)
    return det, trace


def peak_scores(det: torch.Tensor, shape: SurfShape, min_hessian: float, stream: int) -> torch.Tensor:
    """Flat masked scores, laid out as ``det``: the det where the point is a
    valid 3x3x3 peak above ``min_hessian``, else -inf."""
    scores = torch.empty_like(det)
    _launch("surf_peaks", det.data_ptr(), scores.data_ptr(), *shape, min_hessian, stream)
    return scores


def detect(
    frames: torch.Tensor,
    max_keypoints: int,
    min_hessian: float,
    n_octaves: int,
    n_layers: int,
    margin: int,
):
    """(xy, scale, score, laplacian, mask) of (B, H, W) float32 frames on the
    card, each (B, max_keypoints[, 2]), as the plain version gives them."""
    if frames.dtype != torch.float32:
        raise TypeError(f"surf_hessian: the kernels take float32 frames, got {frames.dtype}")
    if frames.ndim != 3:
        raise ValueError(f"surf_hessian: expected (B, H, W) frames, got {tuple(frames.shape)}")
    if not 1 <= n_octaves <= MAX_OCTAVES or n_layers < 0:
        raise ValueError(f"surf_hessian: n_octaves must be in 1..{MAX_OCTAVES} and n_layers >= 0, "
                         f"got {n_octaves}, {n_layers}")
    frames = frames.contiguous()
    dev = frames.device
    b, h, w = frames.shape
    k = max_keypoints
    with cuda_build.on_card(dev, "surf_hessian") as stream:
        xy = torch.empty(b, k, 2, dtype=torch.float32, device=dev)
        scale = torch.empty(b, k, dtype=torch.float32, device=dev)
        score = torch.empty_like(scale)
        lap = torch.empty_like(scale)
        mask = torch.empty(b, k, dtype=torch.bool, device=dev)
        if b == 0 or k == 0 or h == 0 or w == 0:
            return xy.zero_(), scale.zero_(), score.zero_(), lap.zero_(), mask.zero_()

        shape = SurfShape(b, h, w, n_octaves, n_layers + 2, margin)
        table = padded_integral(frames, shape, stream)
        det, trace = responses(table, shape, stream)
        flat = peak_scores(det, shape, min_hessian, stream)
        # The plain version's top_k: a stable descending sort of each octave's
        # flat scores, of which the kernel reads the first min(K, n) a frame.
        ranked = [torch.sort(s.reshape(b, -1), dim=-1, descending=True, stable=True)
                  for s in shape.split(flat)]
        values = (PTR * n_octaves)(*(v.data_ptr() for v, _ in ranked))
        indices = (PTR * n_octaves)(*(i.data_ptr() for _, i in ranked))
        _launch("surf_refine_merge", det.data_ptr(), trace.data_ptr(), values, indices, *shape, k,
                min_hessian, xy.data_ptr(), scale.data_ptr(), score.data_ptr(), lap.data_ptr(),
                mask.data_ptr(), stream)
        return xy, scale, score, lap, mask
