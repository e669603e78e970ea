"""The port's main paths against the JAX package's own outputs at full width.

``tests/fixtures/torch_parity_main.npz`` holds JAX's ``run_mono_vo`` and
``run_stereo_vo`` outputs on 12 frames (pairs) of 640x480, jitted and under
``jax.disable_jit()``, each under ``PRNGKey(0)``, with the minimal sets JAX
draws for every match mask the port presents (see
``ergo_uvo_tpu_torch/eval/parity.py``).  The configs are ``chip_smoke.py``'s
main paths: SURF (min_hessian 60), 512 keypoints, 512 hypotheses, LMEDS,
Lowe 0.7; the stereo rig's right camera 0.33 m along -x.  The frames are not
stored: ``make_mono_sequence(12, 480, 640, dt=0.05, seed=1)`` and
``make_stereo_sequence(12, 480, 640, seed=2)`` are regenerated and checked
against the stored SHA-256.  ``chip_smoke.py``'s ``parity_mono`` and
``parity_stereo`` hold the port on the card to the same fixture; here the
port runs on the CPU over mono frames 0-5 and stereo pairs 0-3.

The contract is the repo's for re-scheduled runs (tests/test_pipeline.py:
230-241), held to JAX's eager run (its jitted run may decide a float
near-tie the other way): discrete outputs exact, counts within 2, velocity
to atol 5e-3 m/s, the mono scale factor to rtol 1e-2, stereo t to 2e-3 and
R to 1e-3.

Regenerate the fixture (JAX's jitted and eager runs at 640x480, ~15 min):

    JAX_PLATFORMS=cpu python tests/test_torch_parity_main.py --write

The writer holds the port's CPU run to the contract and each mask it
presents to the mask JAX's eager run presented before it writes.
"""

import json
import sys
from pathlib import Path

if __name__ == "__main__":  # run as a script: the packages live at the repo root
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ergo_uvo_tpu.config as jconfig
from ergo_uvo_tpu.estimation.sampling import sample_minimal_sets as j_sample
from ergo_uvo_tpu.features.integral import box_sum as j_box_sum
from ergo_uvo_tpu.features.integral import integral_image as j_integral_image
from ergo_uvo_tpu.features.integral import pad_integral as j_pad_integral
import ergo_uvo_tpu_torch.config as tconfig
from ergo_uvo_tpu_torch.convert import stereo_rig_from_numpy
from ergo_uvo_tpu_torch.eval import parity
from ergo_uvo_tpu_torch.features.integral import box_sum, integral_image, pad_integral
from ergo_uvo_tpu_torch.pipeline import run_mono_vo, run_stereo_vo

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_parity_main.npz"
KEY = jax.random.PRNGKey(0)
SEQUENCES = {"mono": dict(n_frames=12, height=480, width=640, dt=0.05, seed=1),
             "stereo": dict(n_frames=12, height=480, width=640, seed=2)}
CONFIG = dict(surf=dict(min_hessian=60.0), max_keypoints=512, num_hypotheses=512)
T_RIGHT = [-0.33, 0.0, 0.0]
CPU_FRAMES = {"mono": 6, "stereo": 4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops are faster on one thread than spread over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def method_keys(kind, frame):
    """JAX's key for each method of a frame: ``split(key, T)[i]``, split once
    more into the essential and homography keys in mono."""
    k = jax.random.split(KEY, SEQUENCES[kind]["n_frames"])[frame]
    if kind == "stereo":
        return {"pnp": k}
    k_e, k_h = jax.random.split(k)
    return {"essential": k_e, "homography": k_h}


def rig_arrays(seq):
    K32 = seq.K.astype(np.float32)
    return dict(K_left=K32, K_right=K32, R_right=np.eye(3, dtype=np.float32),
                t_right=np.asarray(T_RIGHT, np.float32))


def port_run(kind, seq, cfg, sampler, n=None):
    """The port's runner on the CPU over the first ``n`` frames; outputs by field."""
    n = n or len(seq.timestamps)
    if kind == "mono":
        _, outs = run_mono_vo(seq.imgs_left[:n], seq.timestamps[:n], seq.ranges[:n], seq.K, cfg,
                              sampler=sampler, device="cpu")
    else:
        rig = stereo_rig_from_numpy(rig_arrays(seq), "cpu")
        _, outs = run_stereo_vo(seq.imgs_left[:n], seq.imgs_right[:n], seq.timestamps[:n], rig,
                                cfg, sampler=sampler, device="cpu")
    return {k: v.numpy() for k, v in outs._asdict().items()}


@pytest.fixture(scope="module")
def fixture():
    return parity.load_fixture(FIXTURE)


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_port_holds_the_contract_at_full_width(fixture, kind):
    """The port on the CPU, given JAX's sets, against JAX's eager outputs on
    the first frames, and every mask it presents equal to the stored one."""
    seq = parity.fixture_sequence(fixture, kind)
    cfg = parity.fixture_config(fixture, kind, tconfig)
    sampler = parity.FixtureSampler(fixture, kind)
    port = port_run(kind, seq, cfg, sampler, CPU_FRAMES[kind])
    assert sampler.failures == []
    n = CPU_FRAMES[kind]
    assert sorted(sampler.asked) == [e for e in parity.set_entries(fixture, kind) if e[0] < n]
    report = parity.contract_report(port, parity.reference_outputs(fixture, kind),
                                    parity.CONTRACTS[kind])
    assert report["failures"] == [], report
    assert port["published"][1:].all() and port["validity"][1:].all()


@pytest.mark.parametrize("kind, entry", [("mono", 0), ("stereo", -1)])
def test_fixture_sets_are_jax_draws(fixture, kind, entry):
    """A stored (frame, method) entry, redrawn live by JAX's
    ``sample_minimal_sets`` from the stored mask under the key JAX splits for
    it, equals the stored sets."""
    frame, method = [e for e in parity.set_entries(fixture, kind) if e[0] > 0][entry]
    prefix = f"{kind}_sets/{frame}/{method}"
    idx = fixture[f"{prefix}/idx"]
    with jax.disable_jit():
        got, valid = j_sample(method_keys(kind, frame)[method],
                              jnp.asarray(fixture[f"{prefix}/mask"]), *idx.shape)
    np.testing.assert_array_equal(np.asarray(got), idx)
    np.testing.assert_array_equal(np.asarray(valid), fixture[f"{prefix}/valid"])


@pytest.mark.parametrize("shape, margin, box", [((32, 40), 8, (-2, -3, 3, 4)),
                                                ((16, 16), 8, (-3, -3, 4, 4))])
def test_box_sum_matches_jax(shape, margin, box):
    """``box_sum`` bit for bit with JAX's at tests/test_features.py:43-60's
    cases (the second on ones, where the edge padding clamps)."""
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 255, shape) if shape == (32, 40) else np.ones(shape)).astype(np.float32)
    h, w = shape
    want = j_box_sum(j_pad_integral(j_integral_image(jnp.asarray(img)), margin), margin, h, w,
                     *box)
    got = box_sum(pad_integral(integral_image(torch.from_numpy(img)), margin), margin, h, w, *box)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_akaze_names_exported():
    from ergo_uvo_tpu_torch.features import akaze, describe_akaze, detect_akaze

    assert detect_akaze is akaze.detect_akaze and describe_akaze is akaze.describe_akaze


# ----------------------------------------------------------------- writer


def jax_runs(kind, seq):
    """JAX's runner jitted and eagerly; the eager run also returns each mask
    JAX's sampler was handed, by (frame, method)."""
    import ergo_uvo_tpu.estimation.essential as jessential
    import ergo_uvo_tpu.estimation.homography as jhomography
    import ergo_uvo_tpu.estimation.pnp as jpnp
    from ergo_uvo_tpu.pipeline import run_mono_vo as j_run_mono_vo
    from ergo_uvo_tpu.pipeline import run_stereo_vo as j_run_stereo_vo
    from ergo_uvo_tpu.pipeline.stereo import StereoRig as JStereoRig

    cfg = parity.fixture_config({f"{kind}/config": json.dumps(CONFIG)}, kind, jconfig)
    if kind == "mono":
        run = j_run_mono_vo
        args = (jnp.asarray(seq.imgs_left), jnp.asarray(seq.timestamps),
                jnp.asarray(seq.ranges), jnp.asarray(seq.K))
    else:
        run = j_run_stereo_vo
        rig = JStereoRig(**{k: jnp.asarray(v) for k, v in rig_arrays(seq).items()})
        args = (jnp.asarray(seq.imgs_left), jnp.asarray(seq.imgs_right),
                jnp.asarray(seq.timestamps), rig)
    _, jit_outs = jax.jit(run, static_argnames="cfg")(*args, cfg=cfg, key=KEY)

    by_key = {np.asarray(k).tobytes(): (f, m) for f in range(len(seq.timestamps))
              for m, k in method_keys(kind, f).items()}
    masks = {}

    def recording(key, mask, num_hypotheses, set_size):
        masks[by_key[np.asarray(key).tobytes()]] = np.asarray(mask)
        return j_sample(key, mask, num_hypotheses, set_size)

    modules = (jessential, jhomography, jpnp)
    saved = [m.sample_minimal_sets for m in modules]
    try:
        for m in modules:
            m.sample_minimal_sets = recording
        with jax.disable_jit():
            _, eager_outs = run(*args, cfg=cfg, key=KEY)
    finally:
        for m, f in zip(modules, saved):
            m.sample_minimal_sets = f
    return jax.tree.map(np.asarray, jit_outs), jax.tree.map(np.asarray, eager_outs), masks


def fixture_arrays(kind):
    """One kind's arrays of the fixture, checked on the CPU before they are kept."""
    from ergo_uvo_tpu_torch.io import make_mono_sequence, make_stereo_sequence

    make = make_mono_sequence if kind == "mono" else make_stereo_sequence
    seq = make(**SEQUENCES[kind])
    jit_outs, eager_outs, jax_masks = jax_runs(kind, seq)
    out = {f"{kind}/sequence": np.array(json.dumps(SEQUENCES[kind])),
           f"{kind}/config": np.array(json.dumps(CONFIG)),
           f"{kind}/sha256": np.array(parity.sequence_digest(seq, kind))}
    out.update({f"{kind}_jit/{k}": v for k, v in jit_outs._asdict().items()})
    out.update({f"{kind}_eager/{k}": v for k, v in eager_outs._asdict().items()})

    def jax_sampler(frame, method, mask, num_hypotheses, set_size):
        mask = mask.numpy()
        with jax.disable_jit():
            idx, valid = j_sample(method_keys(kind, frame)[method], jnp.asarray(mask),
                                  num_hypotheses, set_size)
        prefix = f"{kind}_sets/{frame}/{method}"
        out[f"{prefix}/mask"] = mask
        out[f"{prefix}/idx"] = np.asarray(idx).astype(np.int16)
        out[f"{prefix}/valid"] = np.asarray(valid)
        return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))

    cfg = parity.fixture_config(out, kind, tconfig)
    port_run(kind, seq, cfg, jax_sampler)
    asked = parity.set_entries(out, kind)
    assert asked == sorted(jax_masks), (asked, sorted(jax_masks))
    for (frame, method), mask in jax_masks.items():
        assert np.array_equal(out[f"{kind}_sets/{frame}/{method}/mask"], mask), \
            f"{kind} frame {frame}, {method}: the port's mask is not JAX's"
    # Replayed from the stored arrays, the port holds the contract against
    # the eager run on every frame.
    sampler = parity.FixtureSampler(out, kind)
    report = parity.contract_report(port_run(kind, seq, cfg, sampler),
                                    parity.reference_outputs(out, kind), parity.CONTRACTS[kind])
    assert sampler.failures == [] and report["failures"] == [], (sampler.failures, report)
    jit_vs_eager = parity.contract_report(parity.reference_outputs(out, kind, "jit"),
                                          parity.reference_outputs(out, kind),
                                          parity.CONTRACTS[kind])
    print(json.dumps({"kind": kind, "sets": len(asked), "jax_eager_masks": len(jax_masks),
                      "port_vs_eager": report, "jit_vs_eager": jit_vs_eager}), flush=True)
    return out


def trace_section_parity(seed):
    """``bench.py::section_parity``'s mono SIFT loop (24 frames of 320x240,
    512 keypoints, 256 hypotheses, ``PRNGKey(seed)``) through JAX jitted, JAX
    under ``jax.disable_jit()`` and the port given JAX's sets; one JSON line
    with every frame where the port's discrete outputs differ from JAX's
    jitted run, each classed as a disagreement of JAX's jitted and eager runs
    (the port equals the eager run) or as the port's own."""
    from ergo_uvo_tpu.pipeline import run_mono_vo as j_run_mono_vo
    from ergo_uvo_tpu_torch.io import make_mono_sequence

    seq = make_mono_sequence(n_frames=24, height=240, width=320, dt=0.25, seed=seed)
    key = jax.random.PRNGKey(seed)
    kw = dict(feature_detector="SIFT", max_keypoints=512, num_hypotheses=256)
    args = (jnp.asarray(seq.imgs_left), jnp.asarray(seq.timestamps), jnp.asarray(seq.ranges),
            jnp.asarray(seq.K))
    runs = {"jit": jax.jit(j_run_mono_vo, static_argnames="cfg")(
        *args, cfg=jconfig.MonoVOConfig(**kw), key=key)}
    with jax.disable_jit():
        runs["eager"] = j_run_mono_vo(*args, cfg=jconfig.MonoVOConfig(**kw), key=key)
    runs = {k: jax.tree.map(np.asarray, v[1]) for k, v in runs.items()}

    def sampler(frame, method, mask, num_hypotheses, set_size):
        k_e, k_h = jax.random.split(jax.random.split(key, 24)[frame])
        with jax.disable_jit():
            idx, valid = j_sample({"essential": k_e, "homography": k_h}[method],
                                  jnp.asarray(mask.numpy()), num_hypotheses, set_size)
        return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))

    _, port = run_mono_vo(seq.imgs_left, seq.timestamps, seq.ranges, seq.K,
                          tconfig.MonoVOConfig(**kw), sampler=sampler, device="cpu")
    port = {k: v.numpy() for k, v in port._asdict().items()}
    frames = []
    for i in range(24):
        row = {name: {"port": int(port[name][i]), "jit": int(getattr(runs["jit"], name)[i]),
                      "eager": int(getattr(runs["eager"], name)[i])}
               for name in parity.MONO_CONTRACT.exact + parity.MONO_CONTRACT.counts}
        if all(r["port"] == r["jit"] for r in row.values()):
            continue
        dv = {run: float(np.abs(port["velocity"][i] - runs[run].velocity[i]).max())
              for run in runs}
        same_as_eager = all(r["port"] == r["eager"] for r in row.values())
        frames.append({"frame": i, "class": "jax_jit_vs_eager" if same_as_eager else "port",
                       "fields": {k: r for k, r in row.items() if len(set(r.values())) > 1},
                       "max_abs_dvelocity": dv})
        if not same_as_eager:
            frames[-1]["stages"] = trace_stages(seq, kw, key, i, runs["eager"])
    print(json.dumps({"seed": seed, "frames_differing_from_jit": frames}), flush=True)
    return frames


def trace_stages(seq, kw, key, i, eager):
    """Frame ``i`` of a ``trace_section_parity`` run taken apart, both
    packages eager: each frontend on frames i-1 and i (feature counts, the
    largest |difference| of the keypoints both keep in a slot), each matcher
    on its own features, then JAX's matched points fed to both relative
    poses (the port given JAX's sets) and JAX's pose to both triangulation
    gates, so that a stage that differs on identical inputs shows."""
    from ergo_uvo_tpu.estimation.relative_pose import estimate_relative_pose as j_pose
    from ergo_uvo_tpu.features.frontend import detect_and_describe as j_detect
    from ergo_uvo_tpu.features.matcher import match_descriptors as j_match
    from ergo_uvo_tpu.geometry.camera import projection_matrix as j_proj
    from ergo_uvo_tpu.geometry.triangulation import filter_3d_points as j_filter
    from ergo_uvo_tpu.geometry.triangulation import triangulate_points as j_tri
    from ergo_uvo_tpu_torch.estimation.relative_pose import estimate_relative_pose as t_pose
    from ergo_uvo_tpu_torch.features.frontend import detect_and_describe_cfg
    from ergo_uvo_tpu_torch.features.matcher import match_descriptors as t_match
    from ergo_uvo_tpu_torch.geometry.camera import projection_matrix as t_proj
    from ergo_uvo_tpu_torch.geometry.triangulation import filter_3d_points as t_filter
    from ergo_uvo_tpu_torch.geometry.triangulation import triangulate_points as t_tri

    jcfg, tcfg = jconfig.MonoVOConfig(**kw), tconfig.MonoVOConfig(**kw)
    K = seq.K.astype(np.float32)
    out = {}
    with jax.disable_jit():
        jf = [j_detect(jnp.asarray(seq.imgs_left[f]), jcfg.surf, jcfg.max_keypoints,
                       jcfg.feature_detector, jcfg.orb_threshold, jcfg.sift_contrast_threshold,
                       jcfg.sift_edge_threshold, akaze=jcfg.akaze) for f in (i - 1, i)]
        tf = [detect_and_describe_cfg(torch.from_numpy(seq.imgs_left[f]), tcfg) for f in (i - 1, i)]
        for f, (jk, _), (tk, _) in zip((i - 1, i), jf, tf):
            both = np.asarray(jk.mask) & tk.mask.numpy()
            out[f"features_{f}"] = {
                "jax": int(jk.count), "port": int(tk.count),
                "masks_equal": bool(np.array_equal(np.asarray(jk.mask), tk.mask.numpy())),
                "max_abs_dxy": float(np.abs(np.asarray(jk.xy) - tk.xy.numpy())[both].max())}
        jm = j_match(jf[0][1], jf[0][0].mask, jf[1][1], jf[1][0].mask, jcfg.lowe_ratio_test)
        tm = t_match(tf[0][1], tf[0][0].mask, tf[1][1], tf[1][0].mask, tcfg.lowe_ratio_test)
        jmask = np.asarray(jm.mask)
        out["matches"] = {"jax": int(jm.count), "port": int(tm.count),
                          "masks_equal": bool(np.array_equal(jmask, tm.mask.numpy()))}
        prev_xy = np.where(jmask[:, None], np.asarray(jf[0][0].xy), 0.0).astype(np.float32)
        curr_xy = np.where(jmask[:, None], np.asarray(jf[1][0].xy)[np.asarray(jm.idx)],
                           0.0).astype(np.float32)
        k_frame = jax.random.split(key, 24)[i]
        R_prev, t_prev = eager.R[i - 1], eager.t[i - 1]
        jp = j_pose(k_frame, jnp.asarray(prev_xy), jnp.asarray(curr_xy), jnp.asarray(jmask),
                    jnp.asarray(K), jcfg, jnp.asarray(R_prev), jnp.asarray(t_prev))
        k_e, k_h = jax.random.split(k_frame)

        def sampler(method, mask, num_hypotheses, set_size):
            idx, valid = j_sample({"essential": k_e, "homography": k_h}[method],
                                  jnp.asarray(mask.numpy()), num_hypotheses, set_size)
            return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))

        tp = t_pose(*(torch.from_numpy(np.array(a)) for a in (prev_xy, curr_xy, jmask, K)),
                    tcfg, torch.from_numpy(np.array(R_prev)), torch.from_numpy(np.array(t_prev)),
                    sampler=sampler)
        out["relative_pose_on_jax_points"] = {
            "jax": {"used_essential": bool(jp.used_essential), "num_inliers": int(jp.num_inliers)},
            "port": {"used_essential": bool(tp.used_essential),
                     "num_inliers": int(tp.num_inliers)},
            "max_abs_dR": float(np.abs(np.asarray(jp.R) - tp.R.numpy()).max()),
            "max_abs_dt": float(np.abs(np.asarray(jp.t) - tp.t.numpy()).max())}
        R, t = np.asarray(jp.R), np.asarray(jp.t)
        tri = np.asarray(jp.triangulation_inliers) & jmask
        eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        X = j_tri(j_proj(K, eye, zero), j_proj(K, R, t), prev_xy, curr_xy)
        jg, _ = j_filter(X, tri, K, eye, zero, K, R, t, prev_xy, curr_xy,
                         jcfg.reprojection_threshold, min_points=jcfg.min_num_3d_points)
        T = [torch.from_numpy(np.array(a)) for a in (K, eye, zero, R, t, prev_xy, curr_xy, tri)]
        tX = t_tri(t_proj(T[0], T[1], T[2]), t_proj(T[0], T[3], T[4]), T[5], T[6])
        tg, _ = t_filter(tX, T[7], T[0], T[1], T[2], T[0], T[3], T[4], T[5], T[6],
                         tcfg.reprojection_threshold, min_points=tcfg.min_num_3d_points)
        out["triangulation_on_jax_pose"] = {
            "jax": int(np.asarray(jg).sum()), "port": int(tg.sum()),
            "max_abs_dX": float(np.abs(np.asarray(X) - tX.numpy())[tri].max())}
    return out


def main(argv):
    if argv[1:2] == ["--trace-section-parity"]:
        for seed in [int(a) for a in argv[2:]] or [0, 1, 2]:
            trace_section_parity(seed)
        return 0
    if argv[1:] != ["--write"]:
        print(__doc__)
        return 2
    torch.set_num_threads(4)
    arrays = {}
    for kind in ("mono", "stereo"):
        arrays.update(fixture_arrays(kind))
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, {len(arrays)} arrays)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
