"""The SURF fast-Hessian kernels against the plain version of ``detect_surf``.

On the CPU ``detect_surf`` takes the plain version (held to the JAX package
in tests/test_torch_features.py); here the dispatch, the launch counter (the
library mocked: a CPU build of torch cannot launch) and the wrapper's checks
are tested.  The ``cuda`` tests hold the kernels (``csrc/surf_hessian.cu``)
to the plain version run on the card: the padded integral table, the det
and trace stacks and the flat masked scores bit for bit, then the keypoints
field for field, every field bit for bit, on rendered frames at 640x480 under both
configurations' thresholds, a batch of 2, an odd 479x641 frame and a flat
frame.

This file imports no JAX, so that it also runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_surf_kernel.py
"""

import pytest
import torch
from kernel_fakes import FakeLibrary, mock_card, mock_library

from ergo_uvo_tpu_torch import cuda_build
from ergo_uvo_tpu_torch.features import detector, surf_hessian
from ergo_uvo_tpu_torch.features.integral import integral_image, pad_integral
from ergo_uvo_tpu_torch.io import make_mono_sequence
from ergo_uvo_tpu_torch.utils.profiling import COUNTERS

LAUNCHES_PER_CALL = 5  # two scans, the responses, the peaks, refine + merge


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Hundreds of small eager ops a detection run faster on one thread than
    spread over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_frames(batch=1, height=120, width=160, seed=5):
    return torch.from_numpy(make_mono_sequence(n_frames=batch, height=height, width=width,
                                               seed=seed).imgs_left)


@pytest.mark.parametrize("batch,height,width,min_hessian", [
    (1, 120, 160, 50.0), (1, 120, 160, 1500.0), (2, 120, 160, 50.0), (1, 119, 161, 50.0)])
def test_cpu_frames_take_the_plain_version(batch, height, width, min_hessian):
    """A CPU tensor never reaches the kernels: the plain version's bits and
    no launch counted."""
    frames = small_frames(batch, height, width)
    before = COUNTERS["surf_hessian.launches"]
    got = detector.detect_surf(frames, 128, min_hessian)
    ref = detector.detect_surf_reference(frames, 128, min_hessian)
    assert COUNTERS["surf_hessian.launches"] == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got.count.sum()) > 0 or min_hessian > 1000


@pytest.fixture
def fake_library(monkeypatch):
    return mock_card(monkeypatch, FakeLibrary())


@pytest.mark.parametrize("batch,height,width,n_octaves,n_layers", [
    (1, 120, 160, 4, 3), (2, 119, 161, 4, 3), (1, 64, 80, 2, 2)])
def test_launches_are_counted_one_a_kernel(fake_library, batch, height, width, n_octaves, n_layers):
    """With the launcher mocked: five entry points a call, in order, each
    counted once; every one gets the call's shapes and the current stream;
    the buffers they get are the ones the next stage reads; every launch is
    made with the frames' device current."""
    frames = torch.zeros(batch, height, width)
    before = COUNTERS["surf_hessian.launches"]
    margin = detector.surf_margin(n_octaves, n_layers)
    out = surf_hessian.detect(frames, 64, 50.0, n_octaves, n_layers, margin)
    assert COUNTERS["surf_hessian.launches"] == before + LAUNCHES_PER_CALL
    names = [name for name, _ in fake_library.calls]
    assert names == ["surf_integral_columns", "surf_integral_rows", "surf_responses", "surf_peaks",
                     "surf_refine_merge"]
    assert fake_library.devices == [frames.device] * LAUNCHES_PER_CALL
    shape = (batch, height, width, n_octaves, n_layers + 2, margin)
    cols, rows, resp, peaks, refine = (args for _, args in fake_library.calls)
    assert cols[0] == frames.data_ptr() and cols[1] == rows[0]
    assert resp[0] == rows[1] and peaks[0] == resp[1] == refine[0] and refine[1] == resp[2]
    for args, at in ((cols, 2), (rows, 2), (resp, 3), (peaks, 2), (refine, 4)):
        assert tuple(args[at:at + 6]) == shape and args[-1] == 7
    assert len(refine[2]) == len(refine[3]) == n_octaves
    assert refine[10:12] == (64, 50.0)
    assert [a.data_ptr() for a in out] == list(refine[12:17])
    assert [tuple(a.shape) for a in out] == [(batch, 64, 2), (batch, 64), (batch, 64), (batch, 64),
                                            (batch, 64)]


def test_a_failed_launch_raises_and_is_not_counted(monkeypatch):
    mock_card(monkeypatch, FakeLibrary(err=1), stream=0)
    before = COUNTERS["surf_hessian.launches"]
    with pytest.raises(RuntimeError,
                       match="surf_hessian: surf_integral_columns: kernel launch failed: cudaError 1"):
        surf_hessian.detect(torch.zeros(1, 32, 32), 16, 50.0, 4, 3, detector.surf_margin(4, 3))
    assert COUNTERS["surf_hessian.launches"] == before


@pytest.mark.parametrize("frames,n_octaves,n_layers,error", [
    (torch.zeros(1, 32, 32, dtype=torch.float64), 4, 3, TypeError),
    (torch.zeros(32, 32), 4, 3, ValueError),
    (torch.zeros(1, 32, 32), 9, 3, ValueError),
    (torch.zeros(1, 32, 32), 0, 3, ValueError),
    (torch.zeros(1, 32, 32), 4, -1, ValueError),
])
def test_wrapper_refuses_what_the_kernels_cannot_take(fake_library, frames, n_octaves, n_layers, error):
    """The checks come before any build or launch; nothing falls back."""
    before = COUNTERS["surf_hessian.launches"]
    with pytest.raises(error, match="surf_hessian"):
        surf_hessian.detect(frames, 16, 50.0, n_octaves, n_layers, 200)
    assert COUNTERS["surf_hessian.launches"] == before and not fake_library.calls


@pytest.mark.parametrize("batch,k", [(1, 16), (0, 16)])
def test_frames_off_the_card_are_refused(monkeypatch, batch, k):
    """CPU frames given to the kernels' wrapper raise before anything is
    allocated or launched, empty ones too: the kernels would read host
    pointers."""
    lib = mock_library(monkeypatch, FakeLibrary())
    before = COUNTERS["surf_hessian.launches"]
    with pytest.raises(ValueError, match="surf_hessian: the kernel takes tensors on a CUDA device"):
        surf_hessian.detect(torch.zeros(batch, 32, 32), k, 50.0, 4, 3, detector.surf_margin(4, 3))
    assert COUNTERS["surf_hessian.launches"] == before and not lib.calls


@pytest.mark.parametrize("batch,k", [(0, 16), (2, 0)])
def test_nothing_to_detect_launches_nothing(fake_library, batch, k):
    before = COUNTERS["surf_hessian.launches"]
    out = surf_hessian.detect(torch.zeros(batch, 32, 32), k, 50.0, 4, 3, detector.surf_margin(4, 3))
    assert COUNTERS["surf_hessian.launches"] == before and not fake_library.calls
    assert [tuple(a.shape) for a in out] == [(batch, k, 2)] + [(batch, k)] * 4
    assert all(not a.any() for a in out)


@pytest.mark.parametrize("height,width,n_octaves,n_layers", [
    (120, 160, 4, 3), (119, 161, 4, 3), (37, 53, 4, 3), (64, 80, 2, 2)])
def test_shape_splits_as_the_plain_stacks(height, width, n_octaves, n_layers):
    """The kernels' flat layout, split by ``SurfShape``, gives each octave's
    stack in the plain version's shape and (batch, layer, y, x) order."""
    frames = small_frames(2, max(height, 16), max(width, 16))[:, :height, :width].contiguous()
    margin = detector.surf_margin(n_octaves, n_layers)
    iip = pad_integral(integral_image(frames), margin)
    sizes = detector.filter_sizes(n_octaves, n_layers)
    plain = [detector.hessian_octave(iip, margin, height, width, o, sizes[o])[0]
             for o in range(n_octaves)]
    shape = surf_hessian.SurfShape(2, height, width, n_octaves, n_layers + 2, margin)
    flat = torch.cat([d.reshape(-1) for d in plain])
    assert shape.points() == flat.numel()
    for got, want in zip(shape.split(flat), plain):
        assert torch.equal(got, want)


# ---- on the card ---------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_frames(card):
    """name -> (frames (B, H, W) on the card, min_hessian): rendered frames
    as the mono (50) and stereo (1500) configurations see them, a batch of
    2, an odd size for the ceil grids, a flat frame."""
    vga = torch.from_numpy(make_mono_sequence(n_frames=2, height=480, width=640, seed=1).imgs_left)
    odd = torch.from_numpy(make_mono_sequence(n_frames=1, height=479, width=641, seed=3).imgs_left)
    cases = {"vga_50": (vga[:1], 50.0), "vga_1500": (vga[1:], 1500.0), "batch_2": (vga, 50.0),
             "odd_479x641": (odd, 50.0), "flat": (torch.full((1, 480, 640), 117.0), 50.0)}
    return {k: (v.contiguous().to(card), mh) for k, (v, mh) in cases.items()}


CARD_CASES = ["vga_50", "vga_1500", "batch_2", "odd_479x641", "flat"]


def same_bits(a, b):
    """Equal bit for bit, any NaN equal to any NaN in the same place."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.view(torch.int32)[~nan],
                                                            b.view(torch.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_kernel_stages_match_the_plain_version_bit_for_bit(card_frames, name):
    """The padded table, every octave's det and trace stacks and the flat
    masked scores equal the plain version's on the card, bit for bit."""
    frames, min_hessian = card_frames[name]
    n_octaves, n_layers = 4, 3
    b, h, w = frames.shape
    margin = detector.surf_margin(n_octaves, n_layers)
    shape = surf_hessian.SurfShape(b, h, w, n_octaves, n_layers + 2, margin)
    with cuda_build.on_card(frames.device, "surf_hessian") as stream:
        table = surf_hessian.padded_integral(frames, shape, stream)
        det, trace = surf_hessian.responses(table, shape, stream)
        scores = surf_hessian.peak_scores(det, shape, min_hessian, stream)

    iip = pad_integral(integral_image(frames), margin)
    assert same_bits(table, iip), name
    sizes = detector.filter_sizes(n_octaves, n_layers)
    for o, (d, t, s) in enumerate(zip(shape.split(det), shape.split(trace), shape.split(scores))):
        pd, pt = detector.hessian_octave(iip, margin, h, w, o, sizes[o])
        assert same_bits(d, pd) and same_bits(t, pt), (name, o)
        ps = detector.octave_scores(pd, o, sizes[o], h, w, min_hessian)
        assert same_bits(s.reshape(b, -1), ps), (name, o)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_detect_surf_matches_the_plain_version_on_the_card(card_frames, name):
    """``detect_surf`` on the card gives the plain version's keypoints, every
    field bit for bit (xy and scale too: the kernel sums ``_solve33``'s
    ``adj @ b`` in the order cuBLAS does on the card, see the source); five
    launches a call, no host sync, the input left as it was."""
    frames, min_hessian = card_frames[name]
    keep = frames.clone()
    detector.detect_surf(frames, 512, min_hessian)  # the first call builds the library
    before = COUNTERS["surf_hessian.launches"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = detector.detect_surf(frames, 512, min_hessian)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert COUNTERS["surf_hessian.launches"] == before + LAUNCHES_PER_CALL
    ref = detector.Keypoints(*detector.detect_surf_reference(frames, 512, min_hessian))
    torch.cuda.synchronize()
    assert torch.equal(got.mask, ref.mask), name
    assert same_bits(got.score, ref.score) and same_bits(got.laplacian, ref.laplacian), name
    assert same_bits(got.xy, ref.xy) and same_bits(got.scale, ref.scale), name
    assert same_bits(frames, keep)
    if name == "flat":
        assert not got.mask.any() and not got.xy.any() and not got.scale.any()
    else:
        assert int(got.count.min()) > 0, name
