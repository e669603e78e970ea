"""On the CPU, where the port takes the plain versions of its kernels, the
benchmark's plain reference gives the port's outputs bit for bit at a small
size: mono and stereo steps over a few frames of the benchmark's own scene."""

import pytest
import torch

from ergo_uvo_tpu_torch import config as port_config
from ergo_uvo_tpu_torch.image.preprocess import build_preprocess_plan as port_plan
from ergo_uvo_tpu_torch.image.preprocess import preprocess_frame as port_pre
from ergo_uvo_tpu_torch.pipeline import mono as port_mono
from ergo_uvo_tpu_torch.pipeline import stereo as port_stereo
from uvo_bench import scene, spec
from uvo_bench.reference import config as ref_config
from uvo_bench.reference.image.preprocess import build_preprocess_plan as ref_plan
from uvo_bench.reference.image.preprocess import preprocess_frame as ref_pre
from uvo_bench.reference.pipeline import mono as ref_mono
from uvo_bench.reference.pipeline import stereo as ref_stereo

SMALL = {"width": 160, "height": 120}
FRAMES = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(config_name, baseline=None):
    config = spec.load_json(spec.BENCH_DIR / "configs" / f"{config_name}.json")
    config = {**config, "camera": {**config["camera"], **SMALL},
              "preprocessing": {**config["preprocessing"], "desired_width": SMALL["width"]}}
    traffic = {**spec.load_json(spec.BENCH_DIR / "traffic" / "survey_20hz.json"),
               "texture_size": 256}
    stream = scene.make_stream(config["camera"], traffic, baseline, 2**31 + 11, "cpu",
                               frames=FRAMES)
    pre = config["preprocessing"]
    args = (stream.K, stream.dist, SMALL["width"], SMALL["height"], pre["desired_width"],
            pre["clahe"], pre["clip_limit"])
    return config, stream, port_plan(*args, device="cpu"), ref_plan(*args, device="cpu")


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_plain_reference_equals_the_port_on_mono_frames():
    config, stream, pp, rp = _setup("mono_surf_vga")
    pc = spec.build_config(port_config.MonoVOConfig, config)
    rc = spec.build_config(ref_config.MonoVOConfig, config)
    ps = port_mono.mono_vo_init_from(pc, device="cpu")
    rs = ref_mono.mono_vo_init(rc.max_keypoints, rc.descriptor_dim, device="cpu")
    pg, rg = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    published = 0
    for i in range(FRAMES):
        raw = stream.left[i].float()
        assert torch.equal(port_pre(pp, raw), ref_pre(rp, raw))
        args = (stream.timestamps[i], stream.ranges[i])
        ps, po = port_mono.mono_vo_step(ps, port_pre(pp, raw), *args, pp.new_K, pc, pg)
        rs, ro = ref_mono.mono_vo_step(rs, ref_pre(rp, raw), *args, rp.new_K, rc, rg)
        assert _equal(po, ro) and _equal(ps, rs)
        published += int(po.published)
    assert published == FRAMES - 1


def test_plain_reference_equals_the_port_on_stereo_pairs():
    config, stream, pp, rp = _setup("stereo_surf_vga", baseline=0.33)
    pc = spec.build_config(port_config.StereoVOConfig, config)
    rc = spec.build_config(ref_config.StereoVOConfig, config)
    eye, t = torch.eye(3), torch.tensor([-0.33, 0.0, 0.0])
    prig = port_stereo.StereoRig(pp.new_K, pp.new_K, eye, t)
    rrig = ref_stereo.StereoRig(rp.new_K, rp.new_K, eye, t)
    ps = port_stereo.stereo_vo_init_from(pc, device="cpu")
    rs = ref_stereo.stereo_vo_init(rc.max_keypoints, rc.descriptor_dim, device="cpu")
    pg, rg = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for i in range(FRAMES):
        left, right = stream.left[i].float(), stream.right[i].float()
        ps, po = port_stereo.stereo_vo_step(ps, port_pre(pp, left), port_pre(pp, right),
                                            stream.timestamps[i], prig, pc, pg)
        rs, ro = ref_stereo.stereo_vo_step(rs, ref_pre(rp, left), ref_pre(rp, right),
                                           stream.timestamps[i], rrig, rc, rg)
        assert _equal(po, ro) and _equal(ps, rs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 9, 9), (1, 9, 9), (512, 12, 12), (512, 3, 3)])
def test_the_graph_replayed_jacobi_equals_the_plain_one_bit_for_bit(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from uvo_bench.reference.geometry import linalg

    gen = torch.Generator(device="cuda").manual_seed(7)
    for _ in range(2):  # the capture, then a replay on new inputs
        M = torch.randn(shape, generator=gen, device="cuda")
        A = M @ M.transpose(-1, -2)
        got, want = linalg.jacobi_eigh(A), linalg.jacobi_eigh_reference(A)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
