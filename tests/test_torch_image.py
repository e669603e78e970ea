"""Parity of the port's preprocessing with the JAX package (CPU), and with
OpenCV where ``cv2`` imports.

The same images (numpy, from a seed) go through both packages.  Tolerances:
integer stages (CLAHE histograms and look-up tables) exact; float images to
1e-4 gray levels before CLAHE and 1e-3 after it (the tables hold integers up
to 255 and the four weights are float32 products, so one ulp of a weight
moves a pixel by up to 3e-5); a pixel whose remapped value lands within an
ulp of ``x.5`` may round into the next histogram bin, so the share of pixels
that agree is reported and bounded where a whole path is compared.  The
OpenCV checks carry the bands of tests/test_image.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergo_uvo_tpu_torch.features.sampling import resize_bilinear

# The packages' ``__init__`` export the function ``clahe`` under the module's name.
j_clahe_mod = importlib.import_module("ergo_uvo_tpu.image.clahe")
jpre = importlib.import_module("ergo_uvo_tpu.image.preprocess")
jund = importlib.import_module("ergo_uvo_tpu.image.undistort")
t_clahe_mod = importlib.import_module("ergo_uvo_tpu_torch.image.clahe")
tpre = importlib.import_module("ergo_uvo_tpu_torch.image.preprocess")
tund = importlib.import_module("ergo_uvo_tpu_torch.image.undistort")

pytestmark = pytest.mark.fast

K = np.array([[460.0, 0, 320.0], [0, 455.0, 240.0], [0, 0, 1.0]])
DIST = np.array([-0.25, 0.06, 1e-3, -5e-4])
# The distortion of the main path's plan: every displacement is under 24 px,
# so the JAX package takes its shift form.
DIST_MAIN = np.array([-0.05, 0.01, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_image(h=480, w=640, channels=3, seed=7):
    """Smooth low-frequency pattern + texture, resembling seafloor imagery."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (
        110
        + 60 * np.sin(xs / 37.0)
        + 40 * np.cos(ys / 23.0 + xs / 61.0)
        + 10 * rng.standard_normal((h, w)).astype(np.float32)
    )
    base = np.clip(base, 0, 255)
    if channels == 3:
        return np.stack([base, 0.9 * base, 0.8 * base], -1).astype(np.float32)
    return base.astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def plans(K_in, dist, ow, oh, dw, clahe_enabled, clip):
    jp = jpre.build_preprocess_plan(K_in, dist, ow, oh, dw, clahe_enabled, clip)
    tp = tpre.build_preprocess_plan(K_in, dist, ow, oh, dw, clahe_enabled, clip, device="cpu")
    return jp, tp


def test_undistort_copy_equals_original():
    """The numpy copy gives the original's arrays, element for element."""
    for dist in (DIST, DIST_MAIN):
        a = jund.optimal_new_camera(K, dist, 640, 480)
        b = tund.optimal_new_camera(K, dist, 640, 480)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(
            tund.build_undistort_grid(K, dist, b, 640, 480),
            jund.build_undistort_grid(K, dist, a, 640, 480))


def test_plan_equals_jax():
    """Every field of the plan, tensors bit for bit."""
    jp, tp = plans(K, DIST_MAIN, 640, 480, 640, True, 3.0)
    assert jp.max_shift <= jpre.MAX_SHIFT_FOR_DECOMP
    for name in jp._fields:
        a, b = getattr(jp, name), getattr(tp, name)
        if isinstance(b, torch.Tensor):
            assert b.dtype == torch.float32 and b.device.type == "cpu", name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        else:
            assert a == b and type(a) is type(b), name


def test_rgb_to_gray_matches_jax():
    img = synthetic_image(120, 160)
    np.testing.assert_allclose(tpre.rgb_to_gray(t(img)).numpy(),
                               np.asarray(jpre.rgb_to_gray(jnp.asarray(img))), atol=1e-4)


@pytest.mark.parametrize("new_hw", [(120, 160), (100, 150)], ids=["factor2", "noninteger"])
def test_resize_area_matches_jax(new_hw):
    """A 2x box average and a non-integer ratio (antialiased triangle
    weights), single frames and a batch of two: atol 1e-4."""
    imgs = np.stack([synthetic_image(240, 320, 1, seed=s) for s in (1, 2)])
    ref = np.stack([np.asarray(jpre.resize_area(jnp.asarray(im), *new_hw)) for im in imgs])
    np.testing.assert_allclose(tpre.resize_area(t(imgs), *new_hw).numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(tpre.resize_area(t(imgs[0]), *new_hw).numpy(), ref[0], atol=1e-4)


def test_resize_bilinear_plain_matches_jax():
    """``antialias=False`` (the INTER_LINEAR form): atol 1e-4."""
    from ergo_uvo_tpu.features.sampling import resize_bilinear as j_resize

    img = synthetic_image(96, 128, 1)
    np.testing.assert_allclose(resize_bilinear(t(img), 77, 100).numpy(),
                               np.asarray(j_resize(jnp.asarray(img), 77, 100)), atol=1e-4)


def test_remap_matches_both_jax_forms():
    """One gather against the JAX package's two forms, atol 1e-4 each; the
    share of pixels bit-equal to the shift form (the one the main path's
    plan takes) is at least 0.999."""
    img = synthetic_image(240, 320, 1)
    jp, tp = plans(K / 2 + np.diag([0, 0, 0.5]), DIST_MAIN, 320, 240, 320, False, 3.0)
    ours = tpre.remap_bilinear(t(img), tp.grid, tp.disp).numpy()
    shifts = np.asarray(jpre.remap_bilinear_shifts(jnp.asarray(img), jp.disp, jp.max_shift))
    gather = np.asarray(jpre.remap_bilinear(jnp.asarray(img), jp.grid))
    np.testing.assert_allclose(ours, shifts, atol=1e-4)
    np.testing.assert_allclose(ours, gather, atol=1e-4)
    share = float((ours == shifts).mean())
    print(f"remap: {share:.6f} of pixels bit-equal to remap_bilinear_shifts")
    assert share >= 0.999, share
    # without the plan's displacement the grid alone gives the same picture
    np.testing.assert_allclose(tpre.remap_bilinear(t(img), tp.grid).numpy(), gather, atol=1e-4)
    # a batch of frames goes through as its frames do
    both = tpre.remap_bilinear(t(np.stack([img, img[::-1].copy()])), tp.grid, tp.disp).numpy()
    np.testing.assert_array_equal(both[0], ours)


def test_remap_large_warp_matches_jax_gather():
    """A strong distortion (displacements beyond the shift form's range, and
    taps outside the image, which give 0): atol 1e-4 against JAX's gather."""
    img = synthetic_image(480, 640, 1)
    jp, tp = plans(K, DIST, 640, 480, 640, False, 3.0)
    assert jp.max_shift > jpre.MAX_SHIFT_FOR_DECOMP
    np.testing.assert_allclose(tpre.remap_bilinear(t(img), tp.grid, tp.disp).numpy(),
                               np.asarray(jpre.remap_bilinear(jnp.asarray(img), jp.grid)),
                               atol=1e-4)


def jax_histogram_stage(img, clip_limit, grid=(8, 8)):
    """The JAX package's histograms and tables, by its own formulas
    (ergo_uvo_tpu/image/clahe.py:47-84) in numpy integers."""
    h, w = img.shape
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)
    padded = np.asarray(j_clahe_mod._pad_reflect101(jnp.asarray(img), th * gh - h, tw * gw - w))
    ints = np.clip(np.round(padded), 0, 255).astype(np.int64)
    tiles = ints.reshape(gh, th, gw, tw).transpose(0, 2, 1, 3).reshape(gh * gw, th * tw)
    hist = np.stack([np.bincount(row, minlength=256) for row in tiles])
    return padded, hist


@pytest.mark.parametrize("hw,clip", [((480, 640), 3.0), ((250, 330), 8.0)],
                         ids=["even_tiles", "nondivisible"])
def test_clahe_matches_jax(hw, clip):
    """640x480 (tiles 60x80, even: JAX's one-hot path) and 330x250 (the grid
    does not divide it: reflect-101 padding, odd tiles, JAX's gather path).
    Padding and histograms exact; output to atol 1e-3."""
    img = synthetic_image(*hw, 1)
    h, w = hw
    th, tw = -(-h // 8), -(-w // 8)
    padded, hist = jax_histogram_stage(img, clip)
    ours_padded = t_clahe_mod._pad_reflect101(t(img)[None], th * 8 - h, tw * 8 - w)
    np.testing.assert_array_equal(ours_padded[0].numpy(), padded)
    pix = torch.clamp(torch.round(ours_padded), 0, 255).long()
    ours_hist = t_clahe_mod.tile_histograms(pix, 8, 8)
    assert ours_hist.dtype == torch.int64
    np.testing.assert_array_equal(ours_hist[0].numpy(), hist)
    assert int(ours_hist.sum()) == th * tw * 64

    ref = np.asarray(j_clahe_mod.clahe(jnp.asarray(img), clip_limit=clip))
    ours = t_clahe_mod.clahe(t(img), clip_limit=clip).numpy()
    assert ours.shape == hw and ours.min() >= 0 and ours.max() <= 255
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    print(f"clahe {hw}: {float((ours == ref).mean()):.6f} of pixels bit-equal")


def test_clahe_tables_are_opencv_integers():
    """The clip and the stepped residual on a hand-made histogram: clip =
    int(3.0 * 512 / 256) = 6; excess 500 - 6 = 494 = 1 * 256 + 238, so every
    bin gains 1 and bins 0, 1, ..., 237 (step 256 // 238 = 1) gain one more."""
    hist = torch.zeros(256, dtype=torch.int64)
    hist[10] = 500
    hist[200] = 12 - 6  # exactly at the clip: no excess
    hist[201] = 6
    luts = t_clahe_mod.tile_luts(hist[None], 3.0, 512)[0]
    clipped = np.zeros(256, np.int64)
    clipped[[10, 200, 201]] = 6
    clipped += 1
    clipped[:238] += 1
    expect = np.clip(np.round(np.cumsum(clipped).astype(np.float32) * np.float32(255.0 / 512)), 0, 255)
    np.testing.assert_array_equal(luts.numpy(), expect)


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
def test_preprocess_frame_matches_jax(channels):
    """The whole path on a 1280x960 frame (2x area resize, undistort under
    the main path's distortion, CLAHE 3.0): at least 0.999 of the pixels
    within 1e-3 of JAX's and none further than one table step (a pixel at
    x.5 may fall into the next bin); a batch of two equals its frames."""
    img = synthetic_image(960, 1280, channels)
    K2 = K.copy() * 2
    K2[2, 2] = 1.0
    jp, tp = plans(K2, DIST_MAIN, 1280, 960, 640, True, 3.0)
    ref = np.asarray(jpre.preprocess_frame(jp, jnp.asarray(img)))
    ours = tpre.preprocess_frame(tp, t(img))
    assert ours.shape == (480, 640) and ours.dtype == torch.float32
    d = np.abs(ours.numpy() - ref)
    share = float((d <= 1e-3).mean())
    print(f"preprocess_frame ({channels} ch): {share:.6f} within 1e-3, max {d.max():.4f}")
    assert share >= 0.999 and d.max() < 8.0, (share, d.max())
    both = tpre.preprocess_frame(tp, t(np.stack([img, img])))
    assert both.shape == (2, 480, 640)
    np.testing.assert_array_equal(both[0].numpy(), ours.numpy())
    np.testing.assert_array_equal(both[1].numpy(), ours.numpy())


# ---- the OpenCV bands of tests/test_image.py:44-133, on the port.

try:
    import cv2
except ImportError:  # the parity tests above need no OpenCV
    cv2 = None
needs_cv2 = pytest.mark.skipif(cv2 is None, reason="cv2 is not installed")


@needs_cv2
def test_gray_matches_cv2():
    img = synthetic_image()
    ours = tpre.rgb_to_gray(t(img)).numpy()
    ref = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    assert np.abs(ours - ref).mean() < 1.0


@needs_cv2
def test_resize_area_integer_factor_matches_cv2():
    img = synthetic_image(480, 640, channels=1)
    ours = tpre.resize_area(t(img), 240, 320).numpy()
    ref = cv2.resize(img, (320, 240), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(ours, ref, atol=0.51)


@needs_cv2
def test_optimal_new_camera_and_grid_match_cv2():
    ours = tund.optimal_new_camera(K, DIST, 640, 480)
    ref, _ = cv2.getOptimalNewCameraMatrix(K, DIST, (640, 480), 0, (640, 480), False)
    np.testing.assert_allclose(ours, ref, rtol=5e-3, atol=0.5)
    grid = tund.build_undistort_grid(K, DIST, ours, 640, 480)
    mapx, mapy = cv2.initUndistortRectifyMap(K, DIST, None, ours, (640, 480), cv2.CV_32FC1)
    np.testing.assert_allclose(grid[..., 0], mapx, atol=0.05)
    np.testing.assert_allclose(grid[..., 1], mapy, atol=0.05)


@needs_cv2
def test_remap_matches_cv2_undistort():
    img = synthetic_image(480, 640, channels=1)
    new_K = tund.optimal_new_camera(K, DIST, 640, 480)
    grid = tund.build_undistort_grid(K, DIST, new_K, 640, 480)
    ours = tpre.remap_bilinear(t(img), t(grid)).numpy()
    ref = cv2.undistort(img, K, DIST, None, new_K)
    # interior comparison (border fill conventions differ by a pixel)
    d = np.abs(ours - ref)[5:-5, 5:-5]
    assert d.mean() < 0.5
    assert np.percentile(d, 99) < 3.0


@needs_cv2
def test_clahe_matches_cv2():
    img = synthetic_image(480, 640, channels=1)
    ours = t_clahe_mod.clahe(t(img), clip_limit=3.0).numpy()
    ref = cv2.createCLAHE(clipLimit=3.0, tileGridSize=(8, 8)).apply(img.astype(np.uint8))
    d = np.abs(ours - ref.astype(np.float32))
    assert d.mean() < 1.5, d.mean()
    assert (d > 4).mean() < 0.01


@needs_cv2
def test_preprocess_matches_reference_composition():
    """Compose the same steps with OpenCV and compare feature-scale stats;
    with CLAHE on, the histogram must spread (std must not collapse)."""
    img = synthetic_image(960, 1280, channels=3)
    K2 = K.copy() * 2
    K2[2, 2] = 1.0
    plan = tpre.build_preprocess_plan(K2, DIST, 1280, 960, 640, False, 3.0, device="cpu")
    ours = tpre.preprocess_frame(plan, t(img)).numpy()
    resized = cv2.resize(img.astype(np.uint8), (640, 480), interpolation=cv2.INTER_AREA)
    gray = cv2.cvtColor(resized, cv2.COLOR_RGB2GRAY)
    ref = cv2.undistort(gray, plan.K_resized.numpy().astype(np.float64), DIST, None,
                        plan.new_K.numpy().astype(np.float64))
    d = np.abs(ours - ref.astype(np.float32))[5:-5, 5:-5]
    assert d.mean() < 1.5, d.mean()
    on = tpre.build_preprocess_plan(K2, DIST, 1280, 960, 640, True, 3.0, device="cpu")
    o = tpre.preprocess_frame(on, t(img)).numpy()
    assert o.shape == (480, 640) and o.min() >= 0 and o.max() <= 255
    assert o[50:-50, 50:-50].std() > 20
