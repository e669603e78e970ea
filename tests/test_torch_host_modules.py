"""The port's numpy copies of the JAX package's host modules, held equal to the originals.

* ``geometry/geodesy.py``: every function against the original on random
  float64 inputs, to 1e-12, and ``tests/test_geodesy_viz.py``'s contracts;
* ``utils/visualize.py``: ``draw_matches`` canvases byte for byte,
  ``dump_matches`` and ``save_image`` (PNG and the PPM fallback) writing the
  same bytes;
* ``eval/reference_oracle.py``: ``run_mono_oracle`` and ``run_stereo_oracle``
  equal to the originals on a few synthetic frames of 160x128 (skipped
  without cv2).
"""

import sys

import numpy as np
import pytest
import torch

from ergo_uvo_tpu.geometry import geodesy as jgeo
from ergo_uvo_tpu.utils import visualize as jvis
from ergo_uvo_tpu_torch.geometry import geodesy as tgeo
from ergo_uvo_tpu_torch.utils import visualize as tvis


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _origins_and_points(rng, n=64, dim=2):
    """Random origins over the globe (but the poles) and points within ~0.1 deg."""
    o = np.stack([rng.uniform(-80, 80, n), rng.uniform(-180, 180, n)], -1)
    p = o + rng.uniform(-0.1, 0.1, (n, 2))
    if dim == 3:
        o = np.concatenate([o, rng.uniform(0, 500, (n, 1))], -1)
        p = np.concatenate([p, rng.uniform(0, 500, (n, 1))], -1)
    return o, p


@pytest.mark.parametrize("name,dim", [("ll_to_ne", 2), ("ne_to_ll", 2), ("lld_to_ned", 3),
                                      ("ned_to_lld", 3)])
def test_geodesy_matches_original(name, dim):
    rng = np.random.default_rng(len(name) + dim)
    o, p = _origins_and_points(rng, dim=dim)
    if name in ("ne_to_ll", "ned_to_lld"):
        p = rng.uniform(-5e3, 5e3, p.shape)  # metres
    for args in ((o, p), (o[0], p), (o[3], p[3])):  # batched and shared origins
        got, want = getattr(tgeo, name)(*args), getattr(jgeo, name)(*args)
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (tgeo.WGS84_A, tgeo.WGS84_F) == (jgeo.WGS84_A, jgeo.WGS84_F)
    assert set(tgeo.__all__) == set(jgeo.__all__)


def test_geodesy_roundtrip_and_reference_formula():
    """``tests/test_geodesy_viz.py``'s contracts on the port: the round trips
    and the reference's literal ``atan2(1, R)`` form."""
    ll0 = np.array([43.72, 10.39])
    ll = np.array([[43.721, 10.391], [43.719, 10.388], [43.72, 10.39]])
    np.testing.assert_allclose(tgeo.ne_to_ll(ll0, tgeo.ll_to_ne(ll0, ll)), ll, atol=1e-10)
    lld0, lld = np.array([43.7, 10.4, 5.0]), np.array([43.7, 10.4, 17.5])
    ned = tgeo.lld_to_ned(lld0, lld)
    np.testing.assert_allclose(ned, [0.0, 0.0, 12.5], atol=1e-9)
    np.testing.assert_allclose(tgeo.ned_to_lld(lld0, ned), lld, atol=1e-10)
    ll0, ll = np.array([43.5, 10.2]), np.array([43.5123, 10.2456])
    lat0, lat = np.deg2rad(ll0[0]), np.deg2rad(ll[0])
    lon0, lon = np.deg2rad(ll0[1]), np.deg2rad(ll[1])
    a, f = 6378137.0, 1 / 298.257223563
    e2 = 2 * f - f * f
    Rn = a / np.sqrt(1 - e2 * np.sin(lat0) ** 2)
    Rm = Rn * (1 - e2) / (1 - e2 * np.sin(lat0) ** 2)
    ref = [(lat - lat0) / np.arctan2(1, Rm), (lon - lon0) / np.arctan2(1, Rn * np.cos(lat0))]
    np.testing.assert_allclose(tgeo.ll_to_ne(ll0, ll), ref, rtol=1e-9)


def _match_fixture(float_images=False):
    """``tests/test_geodesy_viz.py``'s fixture; float images go through the
    min-max scaling to uint8."""
    rng = np.random.default_rng(1)
    img_a = rng.integers(0, 255, (60, 80), dtype=np.uint8)
    img_b = rng.integers(0, 255, (60, 80), dtype=np.uint8)
    if float_images:
        img_a, img_b = img_a * 0.37 + 3.0, (img_b.astype(np.float32) - 90.0) * 1.7
    kpa = rng.uniform(0, [79, 59], (16, 2))
    kpb = rng.uniform(0, [79, 59], (16, 2))
    mask = np.ones(16, bool)
    mask[10:] = False
    inl = np.zeros(16, bool)
    inl[:5] = True
    return img_a, kpa, img_b, kpb, mask, inl


@pytest.mark.parametrize("case", ["mask_inliers", "mask", "all", "max_draw", "float", "rgb"])
def test_draw_matches_byte_equal(case):
    img_a, kpa, img_b, kpb, mask, inl = _match_fixture(float_images=case == "float")
    kwargs = {"mask_inliers": {"mask": mask, "inliers": inl}, "mask": {"mask": mask},
              "all": {}, "max_draw": {"mask": mask, "inliers": inl, "max_draw": 4},
              "float": {"inliers": inl}, "rgb": {"mask": mask}}[case]
    if case == "rgb":  # a colour frame beside a taller gray one
        img_a = np.stack([img_a, img_a[::-1], img_a[:, ::-1]], -1)
        img_b = np.concatenate([img_b, img_b[:10]])
    got = tvis.draw_matches(img_a, kpa, img_b, kpb, **kwargs)
    want = jvis.draw_matches(img_a, kpa, img_b, kpb, **kwargs)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if case == "mask_inliers":
        assert ((got == [0, 255, 0]).all(-1)).any() and ((got == [255, 64, 64]).all(-1)).any()


@pytest.mark.parametrize("pillow", [True, False])
def test_dump_matches_writes_same_file(tmp_path, monkeypatch, pillow):
    """The PNG through pillow, and the PPM the module falls back to without it."""
    if not pillow:
        monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises ImportError
    img_a, kpa, img_b, kpb, mask, inl = _match_fixture()
    got = tvis.dump_matches(str(tmp_path / "port"), 3, "inliers", img_a, kpa, img_b, kpb, mask,
                            inliers=inl)
    want = jvis.dump_matches(str(tmp_path / "jax"), 3, "inliers", img_a, kpa, img_b, kpb, mask,
                             inliers=inl)
    assert got.endswith(".png" if pillow else ".ppm")
    assert got.rsplit("/", 1)[1] == want.rsplit("/", 1)[1] == (
        "f000003_inliers.png" if pillow else "f000003_inliers.ppm")
    with open(got, "rb") as f, open(want, "rb") as g:
        data = f.read()
        assert data == g.read() and len(data) > 100
    image = np.asarray(img_a, np.float32) / 3.0  # save_image scales a float image
    assert open(tvis.save_image(image, str(tmp_path / "a.png")), "rb").read() == open(
        jvis.save_image(image, str(tmp_path / "b.png")), "rb").read()


def _oracle_mono_inputs():
    from ergo_uvo_tpu.config import MonoVOConfig as JMonoCfg
    from ergo_uvo_tpu_torch.config import MonoVOConfig
    from ergo_uvo_tpu_torch.io import make_mono_sequence

    seq = make_mono_sequence(n_frames=5, height=128, width=160, seed=0)
    kw = dict(feature_detector="SIFT", max_keypoints=512, num_hypotheses=256)
    return seq, MonoVOConfig(**kw), JMonoCfg(**kw)


def _assert_oracle_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "OracleOutput"
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_run_mono_oracle_matches_original():
    pytest.importorskip("cv2")
    from ergo_uvo_tpu.eval.reference_oracle import run_mono_oracle as jrun
    from ergo_uvo_tpu_torch.eval.reference_oracle import run_mono_oracle

    seq, cfg, jcfg = _oracle_mono_inputs()
    got = run_mono_oracle(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, cfg)
    want = jrun(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, jcfg)
    _assert_oracle_equal(got, want)
    assert got.published.sum() >= 2 and got.validity.any()  # the run tracked


def test_run_stereo_oracle_matches_original():
    pytest.importorskip("cv2")
    from ergo_uvo_tpu.config import StereoVOConfig as JStereoCfg
    from ergo_uvo_tpu.eval.reference_oracle import run_stereo_oracle as jrun
    from ergo_uvo_tpu_torch.config import StereoVOConfig
    from ergo_uvo_tpu_torch.eval.reference_oracle import run_stereo_oracle
    from ergo_uvo_tpu_torch.io import make_stereo_sequence

    seq = make_stereo_sequence(n_frames=5, height=128, width=160, seed=0)
    kw = dict(feature_detector="SIFT", max_keypoints=512, num_hypotheses=256)
    R_right, t_right = np.eye(3), np.array([-0.33, 0.0, 0.0])
    args = (seq.imgs_left, seq.imgs_right, seq.timestamps, seq.K, seq.K, R_right, t_right)
    got = run_stereo_oracle(*args, StereoVOConfig(**kw))
    want = jrun(*args, JStereoCfg(**kw))
    _assert_oracle_equal(got, want)
    assert got.published[1:].all() and got.validity.any()  # the run tracked


def test_oracle_refuses_what_cv2_lacks():
    """SURF (the default) raises as in the original, before any frame."""
    pytest.importorskip("cv2")
    from ergo_uvo_tpu_torch.config import MonoVOConfig
    from ergo_uvo_tpu_torch.eval.reference_oracle import run_mono_oracle

    seq, _, _ = _oracle_mono_inputs()
    with pytest.raises(NotImplementedError, match="SURF"):
        run_mono_oracle(seq.imgs_left, seq.timestamps, seq.ranges, seq.K, MonoVOConfig())
