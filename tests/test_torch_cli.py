"""The port's CLI (``python -m ergo_uvo_tpu_torch.cli``) on the CPU.

Its host helpers against the JAX CLI's (stamp pairing, stamp files, the
sequence digest, the checkpoint callback's trimming of pad frames; only host
code runs on the JAX side, nothing is compiled), then the port's own runs
with ``--device cpu``: the synthetic summary, the mono JPEG-directory path
(every frame streamed, the ``--ranges`` check, a resume after frames were
appended, a changed prefix refused), stereo pairing by stamp with a dropped
right frame, and the flags that are not ported yet.  Frames of 160x128, at
most 9 of them.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import ergo_uvo_tpu.cli as jcli
from ergo_uvo_tpu.pipeline.mono import MonoFrameOutput as JMonoFrameOutput
from ergo_uvo_tpu.pipeline.mono import mono_vo_init_from as j_mono_vo_init_from
from ergo_uvo_tpu.utils.checkpoint import load_stream_run as j_load_stream_run
from ergo_uvo_tpu_torch import cli
from ergo_uvo_tpu_torch.config import MonoVOConfig
from ergo_uvo_tpu_torch.io import make_mono_sequence, make_stereo_sequence
from ergo_uvo_tpu_torch.pipeline.mono import MonoFrameOutput, mono_vo_init_from
from ergo_uvo_tpu_torch.utils.checkpoint import load_stream_run

H, W = 128, 160

PARAMS_YAML = """
node_freq: 4.0
preprocessing:
  desired_width: 160
  clahe: false
  clip_limit: 3.0
vo_params:
  feature_detector: SURF
  lowe_ratio_test: 0.7
  min_num_features: 10
surf_params:
  min_hessian: 60.0
tpu_params:
  max_keypoints: 128
  num_hypotheses: 32
"""

INTRINSICS_YAML = """
test_camera:
  camera_intrinsic:
    fx: {fx}
    fy: {fy}
    ccx: {ccx}
    ccy: {ccy}
  distortion_coefficient:
    radial: {{k1: 0.0, k2: 0.0}}
    tangential: {{p1: 0.0, p2: 0.0}}
"""

STEREO_PARAMS_YAML = PARAMS_YAML.replace("lowe_ratio_test: 0.7", "lowe_ratio_test: 0.8").replace(
    "min_num_features: 10", "min_num_features: 5").replace("num_hypotheses: 32",
                                                           "num_hypotheses: 64")

STEREO_INTRINSICS_YAML = """
test_rig:
  camera_intrinsic_left: {{fx: {fx}, fy: {fy}, ccx: {ccx}, ccy: {ccy}}}
  camera_intrinsic_right: {{fx: {fx}, fy: {fy}, ccx: {ccx}, ccy: {ccy}}}
  distortion_coefficient_left:
    radial: {{k1: 0.0, k2: 0.0}}
    tangential: {{p1: 0.0, p2: 0.0}}
  distortion_coefficient_right:
    radial: {{k1: 0.0, k2: 0.0}}
    tangential: {{p1: 0.0, p2: 0.0}}
  left_camera_rotation_matrix: {{rows: 3, cols: 3, data: [1, 0, 0, 0, 1, 0, 0, 0, 1]}}
  left_camera_translation_vector: {{rows: 3, cols: 1, data: [0, 0, 0]}}
  right_camera_rotation_matrix: {{rows: 3, cols: 3, data: [1, 0, 0, 0, 1, 0, 0, 0, 1]}}
  right_camera_translation_vector: {{rows: 3, cols: 1, data: [-0.33, 0.0, 0.0]}}
"""

# The keys of the JAX CLI's summaries (ergo_uvo_tpu/cli.py:433-506, :690-742)
# when a run has two chunks or more; the port adds "device".
JAX_MONO_SYNTHETIC_KEYS = {"frames", "dead_reckoned_frames", "published", "valid",
                           "mean_inliers", "compile_s", "steady_fps",
                           "mean_inlier_fraction", "ate_m"}
JAX_STEREO_SYNTHETIC_KEYS = {"frames", "published", "valid", "compile_s", "steady_fps", "ate_m"}


def _write_jpegs(directory, imgs, names=None):
    from PIL import Image

    directory.mkdir(exist_ok=True)
    for i, img in enumerate(imgs):
        name = names[i] if names else f"f_{i:04d}.jpg"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(
            directory / name, quality=97)


def _camera(K):
    return dict(fx=K[0, 0], fy=K[1, 1], ccx=K[0, 2], ccy=K[1, 2])


@pytest.fixture(scope="module")
def mono_dataset(tmp_path_factory):
    """9 synthetic frames of 160x128 as JPEGs (frames 0-5 in ``first6/``,
    all 9 in ``frames/``), the params and intrinsics YAMLs and 9 ranges."""
    root = tmp_path_factory.mktemp("cli_mono")
    seq = make_mono_sequence(n_frames=9, height=H, width=W, dt=0.25, seed=3)
    _write_jpegs(root / "frames", seq.imgs_left)
    _write_jpegs(root / "first6", seq.imgs_left[:6])
    (root / "params.yaml").write_text(PARAMS_YAML)
    (root / "intrinsics.yaml").write_text(INTRINSICS_YAML.format(**_camera(seq.K)))
    np.savetxt(root / "ranges.txt", seq.ranges)
    return root


def _mono_args(root, frames, out, *extra):
    return ["mono", "--params", str(root / "params.yaml"),
            "--intrinsics", str(root / "intrinsics.yaml"), "--camera", "test_camera",
            "--frames", str(frames), "--ranges", str(root / "ranges.txt"),
            "--out", str(out), "--device", "cpu", *extra]


def _run(capsys, argv):
    """(the summary line as a dict, what the run wrote to stderr)"""
    cli.main(argv)
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


def _records(path):
    """The JSONL records without their wall time."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "wall_time"} for line in f]


# ------------------------------------------------- helpers against the JAX CLI


@pytest.mark.fast
@pytest.mark.parametrize("case", ["skew_drop", "consume_once", "random"])
def test_pair_by_timestamp_equals_the_original(case):
    """The cases of tests/test_cli.py:293-305 and a seeded jittered stream
    with drops on both sides: the same pairs as the JAX CLI's."""
    if case == "skew_drop":
        tss_l, tss_r, skew = np.array([0.0, 0.1, 0.2, 0.3, 0.4]), np.array([0.01, 0.11, 0.31, 0.41]), 0.02
    elif case == "consume_once":
        tss_l, tss_r, skew = np.array([0.0, 0.001, 0.002]), np.array([0.0]), 0.01
    else:
        rng = np.random.default_rng(4)
        tss_l = np.sort(rng.uniform(0, 5, 40))
        tss_r = np.sort(np.delete(tss_l + rng.uniform(-0.03, 0.03, 40), [3, 17, 18]))
        tss_l = np.delete(tss_l, [25])
        skew = 0.02
    li, ri = cli._pair_by_timestamp(tss_l, tss_r, skew)
    jli, jri = jcli._pair_by_timestamp(tss_l, tss_r, skew)
    np.testing.assert_array_equal(li, jli)
    np.testing.assert_array_equal(ri, jri)
    assert len(li) > 0


@pytest.mark.fast
def test_load_timestamps_equals_the_original(tmp_path):
    """The same stamps, as float32, and the same refusals of a short file
    and of stamps that go back."""
    good, short, back = tmp_path / "good.txt", tmp_path / "short.txt", tmp_path / "back.txt"
    np.savetxt(good, [0.0, 0.1, 0.25, 0.3])
    np.savetxt(short, [0.0, 0.1])
    np.savetxt(back, [0.0, 0.2, 0.1])
    got, want = cli._load_timestamps(str(good), 3), jcli._load_timestamps(str(good), 3)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32
    for path, n, what, match in ((short, 5, "frames", "2 entries for 5 frames"),
                                 (short, 3, "left frames", "2 entries for 3 left frames"),
                                 (back, 3, "frames", "non-decreasing")):
        for mod in (cli, jcli):
            with pytest.raises(SystemExit, match=match):
                mod._load_timestamps(str(path), n, what)


@pytest.mark.fast
def test_seq_digest_covers_the_prefix():
    """Over a whole (paired) list the digest is the JAX CLI's; over a prefix
    it ignores what follows, and a changed prefix changes it."""
    left = [f"/a/f_{i:04d}.jpg" for i in range(6)]
    right = [f"/b/r_{i:04d}.jpg" for i in range(6)]
    assert cli._seq_digest(6, left) == jcli._seq_digest(left)
    assert cli._seq_digest(6, left, right) == jcli._seq_digest(left, right)
    assert cli._seq_digest(4, left) == cli._seq_digest(4, left + ["/a/g.jpg"])
    assert cli._seq_digest(4, left) == cli._seq_digest(4, left[:4])
    assert cli._seq_digest(4, left) != cli._seq_digest(4, left[:1] + ["/a/x.jpg"] + left[2:])


@pytest.mark.fast
def test_ckpt_cb_trims_pads_like_the_original(tmp_path):
    """tests/test_streaming.py:254 on both callbacks: 10 real frames in
    chunks of 4 (12 rows, 2 of them pads), a checkpoint every 2 chunks.
    After each checkpoint both heads count the same real frames and
    segments, and both hold the same rows; the pad rows never land."""
    n_fields = len(MonoFrameOutput._fields)

    def chunk(n, base, out_type):
        return out_type(*[np.full((n,), base + i, np.float32) for i in range(n_fields)])

    jstate = j_mono_vo_init_from(MonoVOConfig(max_keypoints=64))
    tstate = mono_vo_init_from(MonoVOConfig(max_keypoints=64), device="cpu")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcb = jcli._make_stream_ckpt_cb(jpath, every=2, n_real=10, chunk_size=4, start=0,
                                    n_segments=0)
    tcb = cli._make_stream_ckpt_cb(tpath, every=2, n_real=10, chunk_size=4, start=0,
                                   n_segments=0)
    for done, base, check in ((4, 1.0, False), (8, 2.0, True), (12, 3.0, False), (16, 4.0, True)):
        jcb(done, jstate, chunk(4, base, JMonoFrameOutput), np.zeros(2, np.uint32))
        tcb(done, tstate, chunk(4, base, MonoFrameOutput), torch.Generator().get_state())
        if not check:
            continue
        jfd, _, jouts, _, jmeta = j_load_stream_run(
            jpath, jstate, JMonoFrameOutput(*([np.zeros(0)] * n_fields)))
        tfd, _, touts, _, tmeta = load_stream_run(
            tpath, tstate, MonoFrameOutput(*([np.zeros(0)] * n_fields)), device="cpu")
        assert tfd == jfd and tmeta == jmeta
        for a, b in zip(touts, jouts):
            np.testing.assert_array_equal(a, b)
    assert tfd == 10 and len(touts.velocity) == 10
    np.testing.assert_array_equal(touts.velocity[8:], 3.0)


# ------------------------------------------------------------ the port's runs


@pytest.mark.parametrize("mode", ["mono", "stereo"])
def test_synthetic_prints_the_jax_summary_keys(capsys, tmp_path, mode):
    """``--synthetic 4 --synthetic-size 160x128 --device cpu`` (chunks of 2,
    so that there is a steady chunk; mono under ``--check-nan``): the JAX
    CLI's summary keys, plus ``device``, a finite ATE, a record and a
    trajectory row a frame."""
    out = tmp_path / "s.jsonl"
    extra = ["--check-nan"] if mode == "mono" else []
    summary, _ = _run(capsys, [mode, "--synthetic", "4", "--synthetic-size", "160x128",
                            "--device", "cpu", "--chunk-size", "2", "--out", str(out), *extra])
    want = JAX_MONO_SYNTHETIC_KEYS if mode == "mono" else JAX_STEREO_SYNTHETIC_KEYS
    assert want <= set(summary) <= want | {"device", "inlier_fraction_below_budget"}
    assert summary["device"] == "cpu" and summary["frames"] == 4
    assert np.isfinite(summary["ate_m"])
    assert len(_records(out)) == 4
    assert np.loadtxt(tmp_path / "s_trajectory.txt").shape == (4, 3)


def test_mono_jpeg_directory_streams_every_frame(mono_dataset, capsys, tmp_path):
    """9 frames at ``--chunk-size 4``: the padded stream gives a record and
    a trajectory row for each of the 9, not 8, and tracks."""
    out = tmp_path / "run.jsonl"
    summary, _ = _run(capsys, _mono_args(mono_dataset, mono_dataset / "frames", out,
                                      "--chunk-size", "4"))
    assert summary["frames"] == 9 and summary["published"] >= 7
    assert [r["frame"] for r in _records(out)] == list(range(9))
    assert np.loadtxt(tmp_path / "run_trajectory.txt").shape == (9, 3)


@pytest.mark.fast
def test_mono_jpeg_directory_checks_ranges_length(mono_dataset, tmp_path):
    short = tmp_path / "short_ranges.txt"
    np.savetxt(short, np.ones(3))
    argv = _mono_args(mono_dataset, mono_dataset / "frames", tmp_path / "r.jsonl")
    argv[argv.index("--ranges") + 1] = str(short)
    with pytest.raises(SystemExit, match="3 entries for 9 frames"):
        cli.main(argv)


@pytest.fixture(scope="module")
def checkpointed_six(mono_dataset, tmp_path_factory):
    """A run over the first 6 frames in chunks of 3 with a checkpoint after
    every chunk: (its directory of frames, the checkpoint's files)."""
    root = tmp_path_factory.mktemp("ckpt6")
    frames = root / "frames"
    shutil.copytree(mono_dataset / "first6", frames)
    ckpt = root / "stream.npz"
    cli.main(_mono_args(mono_dataset, frames, root / "a.jsonl", "--chunk-size", "3",
                        "--checkpoint", str(ckpt), "--checkpoint-every", "1"))
    return frames, sorted(root.glob("stream.npz*"))


def _copy_run(checkpointed, tmp_path):
    frames, files = checkpointed
    shutil.copytree(frames, tmp_path / "frames")
    for f in files:
        shutil.copy(f, tmp_path / f.name)
    return tmp_path / "frames", tmp_path / "stream.npz"


def test_resume_after_frames_were_appended(mono_dataset, checkpointed_six, capsys, tmp_path):
    """Three frames appended to a checkpointed 6-frame run: ``--resume``
    restores the 6 frames and the generator, streams the 3 new ones, and
    gives the records and trajectory of one uninterrupted 9-frame run, bit
    for bit.  (The JAX CLI's whole-list digest refuses this resume.)"""
    frames, ckpt = _copy_run(checkpointed_six, tmp_path)
    for i in (6, 7, 8):
        shutil.copy(mono_dataset / "frames" / f"f_{i:04d}.jpg", frames)
    resumed, err = _run(capsys, _mono_args(mono_dataset, frames, tmp_path / "b.jsonl",
                                           "--chunk-size", "3", "--checkpoint", str(ckpt),
                                           "--checkpoint-every", "1", "--resume"))
    assert "resuming at frame 6" in err
    fresh, _ = _run(capsys, _mono_args(mono_dataset, mono_dataset / "frames", tmp_path / "c.jsonl",
                                    "--chunk-size", "3"))
    assert resumed["frames"] == fresh["frames"] == 9
    assert _records(tmp_path / "b.jsonl") == _records(tmp_path / "c.jsonl")
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "b_trajectory.txt"),
                                  np.loadtxt(tmp_path / "c_trajectory.txt"))
    done, *_ = load_stream_run(str(ckpt), mono_vo_init_from(MonoVOConfig(), device="cpu"),
                               cli._outs_example(MonoFrameOutput), device="cpu")
    assert done == 9


def test_changed_prefix_is_refused(mono_dataset, checkpointed_six, capsys, tmp_path):
    """A frame of the checkpointed prefix renamed: ``--resume`` is refused
    and names ``--force-resume``, which then resumes with a warning."""
    frames, ckpt = _copy_run(checkpointed_six, tmp_path)
    (frames / "f_0001.jpg").rename(frames / "f_0001b.jpg")
    argv = _mono_args(mono_dataset, frames, tmp_path / "d.jsonl", "--chunk-size", "3",
                      "--checkpoint", str(ckpt), "--resume")
    with pytest.raises(SystemExit, match="force-resume"):
        cli.main(argv)
    summary, err = _run(capsys, argv + ["--force-resume"])
    assert summary["frames"] == 6 and "continuing (--force-resume)" in err


@pytest.mark.fast
def test_resume_requires_checkpoint_path(mono_dataset, tmp_path):
    with pytest.raises(SystemExit, match="--resume requires"):
        cli.main(_mono_args(mono_dataset, mono_dataset / "frames", tmp_path / "x.jsonl",
                            "--resume"))


def test_stereo_dropped_right_frame_pairs_by_stamp(capsys, tmp_path):
    """tests/test_cli.py:337 at 160x128: the right stream misses frame 4 and
    its stamps jitter; nearest-stamp pairing drops exactly the unmatched
    left frame and streams the other 8 pairs (chunks of 4)."""
    seq = make_stereo_sequence(n_frames=9, height=H, width=W, dt=0.25, seed=5)
    _write_jpegs(tmp_path / "left", seq.imgs_left)
    _write_jpegs(tmp_path / "right", np.delete(seq.imgs_right, 4, axis=0),
                 [f"f_{i:04d}.jpg" for i in range(9) if i != 4])
    (tmp_path / "params.yaml").write_text(STEREO_PARAMS_YAML)
    (tmp_path / "intrinsics.yaml").write_text(STEREO_INTRINSICS_YAML.format(**_camera(seq.K)))
    tss_l = 0.25 * np.arange(9)
    tss_r = np.delete(tss_l + np.random.default_rng(0).uniform(-0.02, 0.02, 9), 4)
    np.savetxt(tmp_path / "tl.txt", tss_l)
    np.savetxt(tmp_path / "tr.txt", np.sort(tss_r))
    out = tmp_path / "sync.jsonl"
    summary, err = _run(capsys, [
        "stereo", "--params", str(tmp_path / "params.yaml"),
        "--intrinsics", str(tmp_path / "intrinsics.yaml"), "--camera", "test_rig",
        "--frames-left", str(tmp_path / "left"), "--frames-right", str(tmp_path / "right"),
        "--timestamps-left", str(tmp_path / "tl.txt"),
        "--timestamps-right", str(tmp_path / "tr.txt"), "--max-skew", "0.05",
        "--out", str(out), "--chunk-size", "4", "--device", "cpu",
    ])
    assert summary["frames"] == 8 and summary["pairs_dropped"] == 1
    assert "dropped 1 left frames" in err
    assert summary["published"] >= 6
    assert len(_records(out)) == 8
    assert np.isfinite(np.loadtxt(tmp_path / "sync_trajectory.txt")).all()


@pytest.mark.fast
@pytest.mark.parametrize("flag", [["--ba-window", "4"], ["--loop-closure"]])
def test_unported_flags_exit_with_their_roadmap_item(tmp_path, flag):
    """Window BA and loop closure are not ported: the run exits and names
    the roadmap item, instead of ignoring the flag."""
    with pytest.raises(SystemExit, match="Queue 1 item 11"):
        cli.main(["mono", "--synthetic", "4", "--device", "cpu",
                  "--out", str(tmp_path / "x.jsonl"), *flag])
    assert not (tmp_path / "x.jsonl").exists()
