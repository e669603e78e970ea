"""The PnP refinement kernel against the plain refinement (``refine_pnp``).

On the CPU ``refine_pnp`` takes the plain chain, ``refine_pnp_reference``,
and ``solve_pnp_ransac`` keeps the bits it had before the kernel: here they
are held to the benchmark's frozen copy of that chain
(``uvo_bench/reference/estimation/pnp.py``), bit for bit.  The wrapper's
launch, its counter and its refusals are tested with the library mocked (a
CPU build of torch cannot launch).  The ``cuda`` tests hold the kernel
(``csrc/pnp_refine.cu``) to the plain chain run on the card, on the inputs
of 66 stereo pairs of 640x480 and on constructed cases.

Tolerances on the card, and why:

* the pose, 1e-5 absolute per entry of R and t: the kernel sums J^T W J and
  J^T W r in a fixed order of its own and solves the 6x6 system by its own
  LU, where the plain chain sums through cuBLAS and solves through cuSOLVER,
  so the two differ by rounding (float32, eps 6e-8) carried through 32
  Gauss-Newton steps that converge;
* the inlier masks may differ only on slots whose squared error under the
  plain chain's pose lies within 1e-3 px^2 of the gate: that rounding moves a
  squared error by ~1e-5 px^2;
* ``success`` and ``better``: equal;
* the kernel against itself: the same bits, launch after launch.

This file imports no JAX, so that it also runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_pnp_kernel.py
"""

import numpy as np
import pytest
import torch
from kernel_fakes import FakeLibrary, mock_card, mock_library

from ergo_uvo_tpu_torch.config import StereoVOConfig, SurfConfig
from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy
from ergo_uvo_tpu_torch.estimation import pnp
from ergo_uvo_tpu_torch.io import make_stereo_sequence
from ergo_uvo_tpu_torch.pipeline import run_stereo_vo
from ergo_uvo_tpu_torch.utils.profiling import COUNTERS
from uvo_bench.reference.estimation import pnp as frozen_pnp

K = np.array([[576.0, 0, 320], [0, 576, 240], [0, 0, 1]], np.float32)
POSE_TOL = 1e-5  # absolute, per entry of R and t
GATE_TOL = 1e-3  # px^2 around the squared-error gate
SCENE_PAIRS = 66  # run_stereo_vo's pairs whose refinement inputs the card tests take


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain chain's hundreds of small eager ops run faster on one
    thread than spread over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rotation(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    W = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * W + (1 - np.cos(angle)) * (W @ W)


def scene(n=512, valid=0.7, outliers=0.2, seed=0, behind=0, noise=0.3, nan_slot=False):
    """Arguments of ``refine_pnp`` (CPU tensors): n slots, a share of them
    masked in, some outliers, ``behind`` masked-in points behind the camera;
    the candidates are the true pose perturbed (the winner) and three others,
    the winner's inliers its 1 px inliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (n, 3))
    R, t = rotation(rng, 0.03), np.array([0.05, -0.02, 0.1])
    pc = X @ R.T + t
    xy = pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2] + rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    xy[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
    mask = rng.uniform(size=n) < valid
    on = np.flatnonzero(mask)
    X[on[:behind]] = -X[on[:behind]]
    if nan_slot and len(on):
        X[on[-1]] = np.nan
    Rs = np.stack([rotation(rng, 0.5) for _ in range(4)])
    ts = rng.normal(0, 0.5, (4, 3))
    best = 2
    Rs[best], ts[best] = rotation(rng, 0.01) @ R, t + rng.normal(0, 0.02, 3)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (Rs, ts)]
    best_t = torch.tensor(best)
    Xt, xyt = (torch.from_numpy(a.astype(np.float32)) for a in (X, xy))
    maskt = torch.from_numpy(mask)
    r2 = pnp._reproj_error_sq(args[0][best], args[1][best], torch.from_numpy(K), Xt, xyt)
    inliers = maskt & (r2 <= 1.0)
    return (*args, best_t, inliers, torch.from_numpy(K), Xt, xyt, maskt)


SCENES = {
    "main": {},
    "n_100": {"n": 100},
    "n_700": {"n": 700},
    "n_1500": {"n": 1500, "seed": 4},
    "five_valid": {"n": 512, "valid": 5 / 512, "outliers": 0.0, "noise": 0.0, "seed": 1},
    "two_valid": {"n": 512, "valid": 2 / 512, "outliers": 0.0, "noise": 0.0, "seed": 2},
    "behind_camera": {"behind": 20, "seed": 3},
    "nan_point": {"nan_slot": True, "seed": 5},
    "all_false": {"valid": 0.0},
}


# ---- on the CPU -----------------------------------------------------------

@pytest.mark.parametrize("name", ["main", "n_100", "five_valid", "behind_camera", "all_false"])
def test_cpu_tensors_keep_the_plain_bits(name):
    """CPU tensors never reach the kernel: ``solve_pnp_ransac`` gives the
    frozen chain's bits, and no launch is counted."""
    Rs, ts, best, inliers, Kt, X, xy, mask = scene(**SCENES[name])
    before = COUNTERS["pnp_refine.launches"]
    got = pnp.solve_pnp_ransac(X, xy, mask, Kt, 1.0, 64, generator=torch.Generator().manual_seed(7))
    want = frozen_pnp.solve_pnp_ransac(X, xy, mask, Kt, 1.0, 64,
                                       generator=torch.Generator().manual_seed(7))
    assert COUNTERS["pnp_refine.launches"] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b), name
    if name == "all_false":
        assert not bool(got.success) and not got.inliers.any()
    elif name in ("main", "n_100", "behind_camera"):
        assert bool(got.success)


def test_refine_pnp_on_the_cpu_is_the_reference():
    args = scene()
    got = pnp.refine_pnp(*args)
    want = pnp.refine_pnp_reference(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got.better) and bool(got.success)


def test_an_all_false_mask_gives_no_success():
    """An all-false mask (a pair whose gates failed) runs the refinement all
    the same and gives ``success`` False, without raising."""
    Rs, ts, best, inliers, Kt, X, xy, mask = scene(valid=0.0)
    out = pnp.refine_pnp(Rs, ts, best, inliers, Kt, X, xy, mask)
    assert not bool(out.success) and not out.inliers.any()
    assert torch.equal(out.R, Rs[best]) and torch.equal(out.t, ts[best])


def test_other_devices_are_refused():
    args = [a.to("meta") for a in scene(n=16)]
    with pytest.raises(ValueError, match="refine_pnp: no implementation for device meta"):
        pnp.refine_pnp(*args)


@pytest.fixture
def fake_library(monkeypatch):
    return mock_card(monkeypatch, FakeLibrary())


@pytest.mark.parametrize("n,refine_iters,polish_rounds", [(512, 8, 3), (100, 6, 1), (0, 8, 3),
                                                          (700, 1, -2)])
def test_one_launch_a_refinement_counted(fake_library, n, refine_iters, polish_rounds):
    """With the launcher mocked: one entry point a refinement, counted once;
    it gets the inputs' buffers, the sizes, the rounds (``2 polish_rounds +
    2``, at least 0) and steps (``refine_iters // 2``), the gate, the Cauchy
    scale and support, and writes the buffers returned, on the current
    stream."""
    Rs, ts, best, inliers, Kt, X, xy, mask = args = scene(n=n)
    before = COUNTERS["pnp_refine.launches"]
    out = pnp._launch(*args, 1.5, 6, refine_iters, polish_rounds)
    assert COUNTERS["pnp_refine.launches"] == before + 1
    [(name, got)] = fake_library.calls
    assert name == "pnp_refine"
    assert list(got[:8]) == [a.data_ptr() for a in (Rs, ts, best, Kt, X, xy, mask, inliers)]
    assert got[8:12] == (n, 4, max(2 * polish_rounds + 2, 0), max(refine_iters // 2, 0))
    assert got[12:15] == pytest.approx((2.25, 1.05, 30.0)) and got[15] == 6
    assert list(got[16:19]) == [out.R.data_ptr(), out.t.data_ptr(), out.inliers.data_ptr()]
    assert list(got[19:21]) == [out.success.data_ptr(), out.better.data_ptr()]
    assert got[21] == 7
    assert [tuple(a.shape) for a in out] == [(3, 3), (3,), (n,), (), ()]
    assert [a.dtype for a in out] == [torch.float32] * 2 + [torch.bool] * 3


def test_a_failed_launch_raises_and_is_not_counted(monkeypatch):
    mock_card(monkeypatch, FakeLibrary(err=1), stream=0)
    before = COUNTERS["pnp_refine.launches"]
    with pytest.raises(RuntimeError, match="pnp_refine: kernel launch failed: cudaError 1"):
        pnp._launch(*scene(n=32), 1.0, 5, 8, 3)
    assert COUNTERS["pnp_refine.launches"] == before


def _bad(field, value):
    names = ["Rs", "ts", "best", "inliers", "K", "X", "xy", "mask"]
    args = list(scene(n=32))
    i = names.index(field)
    args[i] = value(args[i])
    return args


@pytest.mark.parametrize("field,value,error", [
    ("Rs", lambda a: a.double(), TypeError),
    ("K", lambda a: a.double(), TypeError),
    ("X", lambda a: a.half(), TypeError),
    ("best", lambda a: a.int(), TypeError),
    ("mask", lambda a: a.float(), TypeError),
    ("inliers", lambda a: a.to(torch.uint8), TypeError),
    ("X", lambda a: torch.zeros(32, 4), ValueError),
    ("xy", lambda a: a[:31], ValueError),
    ("mask", lambda a: a[:, None], ValueError),
    ("best", lambda a: a[None], ValueError),
    ("ts", lambda a: a[:3], ValueError),
    ("Rs", lambda a: a[:0], ValueError),
    ("K", lambda a: a.to("meta"), ValueError),
    ("inliers", lambda a: a.to("meta"), ValueError),
])
def test_wrapper_refuses_what_the_kernel_cannot_take(fake_library, field, value, error):
    """The checks come before any build or launch; nothing falls back."""
    before = COUNTERS["pnp_refine.launches"]
    with pytest.raises(error, match="pnp_refine"):
        pnp._launch(*_bad(field, value), 1.0, 5, 8, 3)
    assert COUNTERS["pnp_refine.launches"] == before and not fake_library.calls


def test_too_many_slots_are_refused(fake_library):
    n = pnp.MAX_SLOTS + 1
    args = [torch.zeros(4, 3, 3), torch.zeros(4, 3), torch.tensor(0), torch.zeros(n, dtype=torch.bool),
            torch.eye(3), torch.zeros(n, 3), torch.zeros(n, 2), torch.zeros(n, dtype=torch.bool)]
    with pytest.raises(ValueError, match="at most 32768 slots"):
        pnp._launch(*args, 1.0, 5, 8, 3)
    assert not fake_library.calls


def test_tensors_off_the_card_are_refused(monkeypatch):
    """CPU tensors given to the kernel's wrapper raise before anything is
    launched: the kernel would read host pointers."""
    lib = mock_library(monkeypatch, FakeLibrary())
    before = COUNTERS["pnp_refine.launches"]
    with pytest.raises(ValueError, match="pnp_refine: the kernel takes tensors on a CUDA device"):
        pnp._launch(*scene(n=32), 1.0, 5, 8, 3)
    assert COUNTERS["pnp_refine.launches"] == before and not lib.calls


# ---- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_inputs(card):
    """The arguments of every ``refine_pnp`` call of ``run_stereo_vo`` over
    66 pairs of 640x480 (the first with an all-false mask), as the stereo
    step hands them over on the card."""
    seq = make_stereo_sequence(n_frames=SCENE_PAIRS, height=480, width=640, seed=2)
    rig = stereo_rig_from_numpy(dict(K_left=seq.K, K_right=seq.K, R_right=np.eye(3, dtype=np.float32),
                                     t_right=np.asarray([-0.33, 0.0, 0.0], np.float32)), card)
    cfg = StereoVOConfig(surf=SurfConfig(min_hessian=60.0), max_keypoints=512, num_hypotheses=512)
    captured, real = [], pnp.refine_pnp

    def capture(*args):
        captured.append(args)
        return real(*args)

    pnp.refine_pnp = capture
    try:
        run_stereo_vo(seq.imgs_left, seq.imgs_right, seq.timestamps, rig, cfg,
                      torch.Generator(device=card).manual_seed(0), device=card)
    finally:
        pnp.refine_pnp = real
    torch.cuda.synchronize()
    return captured


def same_bits(a, b):
    """Equal bit for bit, any NaN equal to any NaN in the same place."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.view(torch.int32)[~nan],
                                                            b.view(torch.int32)[~nan])


def compare(args, got, want, pose=True):
    """The tolerances of the module doc; returns the largest pose difference."""
    Rs, ts, best, inliers, Kt, X, xy, mask = args[:8]
    assert bool(got.better) == bool(want.better)
    assert bool(got.success) == bool(want.success)
    if not bool(want.better):  # both keep the RANSAC winner and its inliers
        assert same_bits(got.R, want.R) and same_bits(got.t, want.t)
        assert torch.equal(got.inliers, want.inliers)
        return 0.0
    X_safe = torch.where(mask[:, None], X, torch.eye(3, device=X.device)[2])
    xy_safe = torch.where(mask[:, None], xy, 0.0)
    r2 = pnp._reproj_error_sq(want.R, want.t, Kt, X_safe, xy_safe)
    differ = got.inliers != want.inliers
    assert bool(((r2[differ] - 1.0).abs() <= GATE_TOL).all()), r2[differ]
    err = max(float((got.R - want.R).abs().max()), float((got.t - want.t).abs().max()))
    if pose:
        assert err <= POSE_TOL, err
    return err


@pytest.mark.cuda
def test_kernel_matches_the_plain_chain_on_the_stereo_pairs(scene_inputs):
    """Every pair's refinement on the card (64 or more, the first with an
    all-false mask) within the tolerances of the module doc, one launch a
    refinement, no host sync."""
    assert len(scene_inputs) >= 64
    assert not bool(scene_inputs[0][7].any())
    kept = 0
    for args in scene_inputs:
        before = COUNTERS["pnp_refine.launches"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = pnp.refine_pnp(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert COUNTERS["pnp_refine.launches"] == before + 1
        want = pnp.refine_pnp_reference(*args)
        compare(args, got, want)
        kept += bool(want.better) and bool(want.success)
    assert kept >= len(scene_inputs) - 2


@pytest.mark.cuda
def test_repeated_launches_give_the_same_bits(scene_inputs, card):
    cases = [scene_inputs[len(scene_inputs) // 2], [a.to(card) if torch.is_tensor(a) else a
                                                     for a in scene(n=1500, seed=4)]]
    for args in cases:
        first = pnp.refine_pnp(*args)
        for _ in range(3):
            again = pnp.refine_pnp(*args)
            assert all(same_bits(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in SCENES if n != "two_valid"])
def test_kernel_matches_the_plain_chain_on_constructed_cases(card, name):
    """Slot counts below, at and above the block's 512 threads, five valid
    points, points behind the camera, a non-finite point (its 0 * NaN
    poisons the sums: the refinement is thrown away by both), an all-false
    mask."""
    args = [a.to(card) for a in scene(**SCENES[name])]
    got = pnp.refine_pnp(*args)
    want = pnp.refine_pnp_reference(*args)
    compare(args, got, want)
    if name == "nan_point":
        assert not bool(got.better)
    elif name == "all_false":
        assert bool(got.better) and not bool(got.success)
    else:
        assert bool(got.better) and bool(got.success)


@pytest.mark.cuda
def test_two_points_leave_the_pose_to_rounding(card):
    """Two valid points fix two of the pose's six directions; the damping
    1e-6 I decides the others from rounding noise, which differs between the
    kernel's sums and cuBLAS's.  So only the discrete outputs are held equal:
    ``success`` False (2 < 5 inliers), ``better``, and the inliers."""
    args = [a.to(card) for a in scene(**SCENES["two_valid"])]
    got = pnp.refine_pnp(*args)
    want = pnp.refine_pnp_reference(*args)
    assert not bool(got.success) and not bool(want.success)
    compare(args, got, want, pose=False)
    assert torch.isfinite(got.R).all() == torch.isfinite(want.R).all()
