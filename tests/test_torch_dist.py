"""The port's distributed layer (``ergo_uvo_tpu_torch/dist/``) on gloo worlds of processes (CPU).

``tests/test_dist.py`` runs the JAX package on one process's 8-device
virtual mesh.  Here every rank is a process of its own, and a spawned world
costs seconds, so the worlds are of 1, 2 and 4 processes: one world of each
size for the module (module-scoped fixtures), each running all of its cases
and writing its results for the tests to read.  Window BA therefore runs on
the meshes (2, 2), (4, 1) and (1, 4) in the world of 4 and (2, 1) and (1, 2)
in the world of 2, where JAX runs (2, 4), (4, 2), (8, 1) and (1, 8): they
cover a ring of 2 and of 4 keyframe shards, landmark sums over 2 and 4
shards, and both at once.

Held to, with ``tests/test_dist.py``'s tolerances:

* sharded BA against the port's ``ba_solve`` (final cost, ``t`` and ``X``
  after scale normalisation), its convergence, two ``all_reduce`` calls an
  LM iteration (counted), and its first step against the JAX package's
  ``ba_step`` run eagerly on the same arrays;
* window BA against ``ba_solve`` at every mesh, and its convergence;
* the ranks' ``shard_frame_batches`` rows against the JAX package's sharded
  arrays, and the per-process ingestion against them;
* ``run_mono_vo_batch``: each stream equal to ``run_mono_vo`` with generator
  seed ``seed + b``, bit for bit, and the same at worlds 1 and 2;
* the dry run, ``python -m ergo_uvo_tpu_torch.dist.dryrun --device cpu``;
* no fallback: ``device=None`` raises without a card.

Every world has a wall-clock limit and every collective a timeout, so a hang
fails its tests instead of the run.  The workers live in this module, which
imports no JAX at import time: a spawned process imports it by its path.
The JAX package is imported inside the tests that compare with it.
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ergo_uvo_tpu_torch.dist.dryrun import spawn_world

REPO = Path(__file__).resolve().parent.parent
K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
WORLD_TIMEOUT = 150.0  # seconds of wall clock for a world (a collective: 60 s)
SEED = 3  # run_mono_vo_batch's seed: stream b draws from seed + b

# name: (P, L, seed, iters, num_fixed) as in tests/test_dist.py; "first_step"
# runs in float64 (see test_sharded_ba_first_step_matches_jax_eager)
SHARDED = {"match": (4, 64, 0, 8, 1), "converge": (4, 128, 9, 15, 1),
           "first_step": (4, 64, 0, 1, 1)}
WINDOW = {"match": (8, 64, 0, 8, 2), "converge": (8, 128, 11, 15, 2)}
WINDOW_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}
VO_STREAMS, VO_FRAMES = 4, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_ba_scene(P=5, L=64, seed=0, pix_noise=0.1, pose_noise=0.05, lm_noise=0.3):
    """tests/test_optim.py's scene and generator, in numpy with the port's
    ``so3_exp``: (Rs, ts, X, R0, t0, X0, obs, mask)."""
    from ergo_uvo_tpu_torch.geometry import so3_exp

    def so3(w):
        return so3_exp(torch.from_numpy(np.asarray(w, np.float32))).numpy()

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(5, 9, L)],
                 -1).astype(np.float32)
    Rs, ts, obs = [], [], []
    for p in range(P):
        R = so3(0.03 * rng.standard_normal(3))
        tr = np.array([0.25 * p, 0.02 * p, 0.0], np.float32)
        pc = X @ R.T + tr
        uv = pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        obs.append(uv + pix_noise * rng.standard_normal((L, 2)))
        Rs.append(R)
        ts.append(tr)
    Rs, ts, obs = np.stack(Rs), np.stack(ts), np.stack(obs).astype(np.float32)
    mask = np.ones((P, L), bool)
    R0 = np.stack([so3(pose_noise * rng.standard_normal(3)) @ Rs[p] for p in range(P)])
    R0[0] = Rs[0]
    t0 = ts + pose_noise * rng.standard_normal((P, 3)).astype(np.float32)
    t0[0] = ts[0]
    X0 = X + lm_noise * rng.standard_normal((L, 3)).astype(np.float32)
    return Rs, ts, X, R0.astype(np.float32), t0.astype(np.float32), X0, obs, mask


def _scene(case):
    P, L, seed, _, _ = case
    return make_ba_scene(P=P, L=L, seed=seed)


def _vo_config():
    from ergo_uvo_tpu_torch.config import MonoVOConfig, SurfConfig

    return MonoVOConfig(surf=SurfConfig(min_hessian=80.0, n_octaves=2),
                        max_keypoints=128, num_hypotheses=64)


def _vo_streams():
    """tests/test_dist.py:129-132's streams: (imgs (B,T,H,W), ts, ranges, K)."""
    from ergo_uvo_tpu_torch.io import make_mono_sequence

    seqs = [make_mono_sequence(n_frames=VO_FRAMES, height=128, width=160, seed=s)
            for s in range(VO_STREAMS)]
    return (np.stack([s.imgs_left for s in seqs]), np.stack([s.timestamps for s in seqs]),
            np.stack([s.ranges for s in seqs]), seqs[0].K)


def _ingest_frames():
    """tests/test_dist.py:104-122's source: 16 frames of 32x48."""
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 255, (16, 32, 48)).astype(np.float32),
            np.arange(16, dtype=np.float32), np.ones(16, np.float32))


@contextlib.contextmanager
def _counting(counts):
    """Count ``dist.all_reduce`` and ``dist.all_gather`` calls."""
    import torch.distributed as dist

    saved = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def wrap(name):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return saved[name](*args, **kwargs)
        return call

    for name in saved:
        setattr(dist, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _host(x):
    return type(x)(*(f.cpu() for f in x)) if isinstance(x, tuple) else x.cpu()


def _suite(rank, world, out_dir):
    """Every case of a world, run on each rank; the rank's results go to
    ``out_dir/rank<r>.pt``."""
    from ergo_uvo_tpu_torch.dist import mesh as tmesh
    from ergo_uvo_tpu_torch.dist import (
        make_mesh,
        make_mesh_2d,
        run_mono_vo_batch,
        shard_frame_batches,
        shard_frame_batches_multiprocess,
        sharded_ba_solve,
        window_sharded_ba_solve,
    )
    from ergo_uvo_tpu_torch.io.sequence import ArraySource
    from ergo_uvo_tpu_torch.pipeline.mono import run_mono_vo

    res = {}
    mesh = make_mesh(device="cpu")
    for name, case in SHARDED.items():
        _, _, _, R0, t0, X0, obs, mask = _scene(case)
        Kd = K
        if name == "first_step":
            Kd, obs, R0, t0, X0 = (a.astype(np.float64) for a in (K, obs, R0, t0, X0))
        counts = {}
        with _counting(counts):
            state, costs = sharded_ba_solve(mesh, Kd, obs, mask, R0, t0, X0, iters=case[3],
                                            num_fixed=case[4])
        res["sharded", name] = (_host(state), costs, counts)
    for shape in WINDOW_MESHES.get(world, []):
        mesh2 = make_mesh_2d(*shape, device="cpu")
        for name, case in WINDOW.items():
            if name == "converge" and shape != (2, 2):
                continue
            _, _, _, R0, t0, X0, obs, mask = _scene(case)
            (R, t, X, lam), costs = window_sharded_ba_solve(
                mesh2, K, obs, mask, R0, t0, X0, iters=case[3], num_fixed=case[4])
            res["window", shape, name] = (R, t, X, costs)

    if world > 1:
        imgs, tss, rgs = _ingest_frames()
        res["ingest"] = list(shard_frame_batches(ArraySource(imgs, tss, ranges=rgs), mesh, 8))
        # This rank decodes only its rows of each global batch of 8.
        share = 8 // world
        mine = np.concatenate([np.arange(g * 8 + rank * share, g * 8 + (rank + 1) * share)
                               for g in range(2)])
        res["ingest_mp"] = list(shard_frame_batches_multiprocess(
            ArraySource(imgs[mine], tss[mine], ranges=rgs[mine]), mesh, 8))

    if world in (1, 2):
        imgs, tss, rgs, Kc = _vo_streams()
        cfg = _vo_config()
        if world == 1:
            res["vo"] = _host_all(run_mono_vo_batch(mesh, imgs, tss, rgs, Kc, cfg, seed=SEED,
                                                    device="cpu"))
            res["vo_refs"] = [_host_all(run_mono_vo(
                imgs[b], tss[b], rgs[b], Kc, cfg, torch.Generator("cpu").manual_seed(SEED + b),
                device="cpu")) for b in range(VO_STREAMS)]
            # A CPU world builds no CUDA mesh: the backend check, with the
            # card's absence taken out of the way.
            real = tmesh.resolve_device
            tmesh.resolve_device = lambda d: torch.device("cuda", 0)
            try:
                make_mesh(device="cuda")
                res["cuda_mesh_on_gloo"] = "built"
            except RuntimeError as e:
                res["cuda_mesh_on_gloo"] = str(e)
            finally:
                tmesh.resolve_device = real
        else:
            # The streams through sharded ingestion: global batch t holds
            # frame t of every stream; this rank keeps its streams' rows.
            B, T = imgs.shape[:2]
            flat = [a.swapaxes(0, 1).reshape(B * T, *a.shape[2:]) for a in (imgs, tss, rgs)]
            batches = list(shard_frame_batches(ArraySource(*flat[:2], ranges=flat[2]), mesh, B))
            local = [torch.stack([b[i] for b in batches], 1) for i in range(3)]
            res["vo"] = _host_all(run_mono_vo_batch(mesh, *local, Kc, cfg, seed=SEED, local=True,
                                                    device="cpu"))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _host_all(pair):
    return tuple(_host(x) for x in pair)


def _world(tmp_path_factory, world):
    out = tmp_path_factory.mktemp(f"world{world}")
    spawn_world(_suite, world, (str(out),), "cpu", timeout=WORLD_TIMEOUT)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.fixture
def worlds(request):
    return lambda n: request.getfixturevalue(f"world{n}")


@pytest.fixture(scope="module")
def ba_refs():
    """The port's single-device ``ba_solve`` on every scene."""
    from ergo_uvo_tpu_torch.optim.ba import BAProblem, ba_solve

    refs = {}
    for kind, cases in (("sharded", SHARDED), ("window", WINDOW)):
        for name, case in cases.items():
            _, _, _, R0, t0, X0, obs, mask = _scene(case)
            prob = BAProblem(torch.from_numpy(K), torch.from_numpy(obs), torch.from_numpy(mask),
                             case[4])
            refs[kind, name] = ba_solve(prob, *(torch.from_numpy(a) for a in (R0, t0, X0)),
                                        iters=case[3])
    return refs


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _tensors(item)]
    return []


def _ranks_agree(ranks, key):
    """Every rank returns the same global result; returns rank 0's."""
    for other in ranks[1:]:
        for a, b in zip(_tensors(ranks[0][key]), _tensors(other[key]), strict=True):
            assert torch.equal(a, b), key
    return ranks[0][key]


# ---------------------------------------------------------------- sharded BA


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_ba_matches_single_device(worlds, ba_refs, world):
    """tests/test_dist.py:25-50: the final cost, then t and X after scale
    normalisation (one fixed pose leaves the scale free)."""
    state, costs, _ = _ranks_agree(worlds(world), ("sharded", "match"))
    ref_state, ref_costs = ba_refs["sharded", "match"]
    assert costs.shape == (SHARDED["match"][3],) and state.X.shape == (64, 3)
    np.testing.assert_allclose(costs[-1].numpy(), ref_costs[-1].numpy(), rtol=1e-3)
    s_ref, s_sh = float(ref_state.t[-1].norm()), float(state.t[-1].norm())
    np.testing.assert_allclose(state.t.numpy() / s_sh, ref_state.t.numpy() / s_ref, atol=2e-3)
    np.testing.assert_allclose(state.X.numpy() / s_sh, ref_state.X.numpy() / s_ref, atol=5e-3)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_ba_converges(worlds, world):
    """tests/test_dist.py:52-60."""
    _, costs, _ = _ranks_agree(worlds(world), ("sharded", "converge"))
    costs = costs.numpy()
    noise_floor = 4 * 128 * 2 * 0.1**2
    assert costs[-1] < max(0.05 * costs[0], 1.5 * noise_floor), costs[[0, -1]]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_ba_two_all_reduces_per_iteration(worlds, world):
    """Two ``all_reduce`` calls an LM iteration on every rank, and X gathered once."""
    for rank in worlds(world):
        for name, case in SHARDED.items():
            assert rank["sharded", name][2] == {"all_reduce": 2 * case[3], "all_gather": 1}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_ba_first_step_matches_jax_eager(worlds, world):
    """The first LM step against the JAX package's ``ba_step`` run eagerly
    (no ``shard_map`` compile) on the same arrays: the cost to 1e-4, the
    state to 1e-6.

    Both run in float64.  In float32 this step is ill-conditioned (one fixed
    pose leaves the scale to the damping): JAX's own eager and jitted runs
    already disagree on its cost by more than 1e-4, so float32 cannot hold
    an implementation to 1e-4 here."""
    import jax
    import jax.numpy as jnp

    from ergo_uvo_tpu.optim.ba import BAState, ba_step

    _, _, _, R0, t0, X0, obs, mask = _scene(SHARDED["first_step"])
    with jax.enable_x64(True), jax.disable_jit():
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        ref, cost = ba_step(f64(K), f64(obs), jnp.asarray(mask),
                            BAState(f64(R0), f64(t0), f64(X0), jnp.float64(1e-3)), 1)
        assert cost.dtype == jnp.float64
    state, costs, _ = _ranks_agree(worlds(world), ("sharded", "first_step"))
    assert costs.dtype == torch.float64 and costs.shape == (1,)
    np.testing.assert_allclose(float(costs[0]), float(cost), rtol=1e-4)
    for got, want in zip(state, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ----------------------------------------------------------------- window BA


@pytest.mark.parametrize("world,shape", [(w, s) for w, shapes in WINDOW_MESHES.items()
                                         for s in shapes])
def test_window_ba_matches_single_device(worlds, ba_refs, world, shape):
    """tests/test_dist.py:66-88: two fixed poses fix the gauge, so t and X
    compare as they are."""
    R, t, X, costs = _ranks_agree(worlds(world), ("window", shape, "match"))
    ref_state, ref_costs = ba_refs["window", "match"]
    assert R.shape == (8, 3, 3) and X.shape == (64, 3) and costs.shape == (8,)
    np.testing.assert_allclose(costs[-1].numpy(), ref_costs[-1].numpy(), rtol=1e-3)
    np.testing.assert_allclose(t.numpy(), ref_state.t.numpy(), atol=2e-3)
    np.testing.assert_allclose(X.numpy(), ref_state.X.numpy(), atol=5e-3)


def test_window_ba_converges_from_noise(world4):
    """tests/test_dist.py:90-100, at the (2, 2) mesh."""
    _, _, _, costs = _ranks_agree(world4, ("window", (2, 2), "converge"))
    costs = costs.numpy()
    noise_floor = 8 * 128 * 2 * 0.1**2
    assert costs[-1] < max(0.05 * costs[0], 1.5 * noise_floor), costs[[0, -1]]


# ------------------------------------------------------------- data parallel


@pytest.mark.parametrize("world", [2, 4])
def test_shard_frame_batches_match_jax(worlds, world):
    """The ranks' rows, concatenated, equal the JAX package's
    ``shard_frame_batches`` on the 8-device virtual mesh."""
    import jax

    from ergo_uvo_tpu.dist import make_mesh as jax_mesh
    from ergo_uvo_tpu.dist import shard_frame_batches as jax_shard
    from ergo_uvo_tpu.io.sequence import ArraySource

    imgs, tss, rgs = _ingest_frames()
    ref = list(jax_shard(ArraySource(imgs, tss, ranges=rgs), jax_mesh(8), 8))
    assert len(jax.devices()) >= 8 and len(ref) == 2
    ranks = worlds(world)
    for g, (imgs_d, tss_d, rgs_d) in enumerate(ref):
        for i, want in enumerate((imgs_d, tss_d, rgs_d)):
            got = torch.cat([r["ingest"][g][i] for r in ranks])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert ranks[0]["ingest"][g][0].shape == (8 // world, 32, 48)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_frame_batches_multiprocess(worlds, world):
    """A source that yields only the rank's share gives the same rows."""
    for r in worlds(world):
        assert len(r["ingest_mp"]) == len(r["ingest"]) == 2
        for mine, whole in zip(r["ingest_mp"], r["ingest"]):
            for a, b in zip(mine, whole):
                assert torch.equal(a, b)


def test_run_mono_vo_batch_streams_equal_run_mono_vo(world1):
    """Stream b equals ``run_mono_vo`` with generator seed ``seed + b``, bit
    for bit, in the same process."""
    state, outs = world1[0]["vo"]
    assert outs.velocity.shape == (VO_STREAMS, VO_FRAMES, 3)
    for b, (ref_state, ref_outs) in enumerate(world1[0]["vo_refs"]):
        for f in outs._fields:
            assert torch.equal(getattr(outs, f)[b], getattr(ref_outs, f)), (b, f)
        for f in state._fields:
            assert torch.equal(getattr(state, f)[b], getattr(ref_state, f)), (b, f)


def test_run_mono_vo_batch_same_at_worlds_1_and_2(world1, world2):
    """World 2, fed through ``shard_frame_batches``, gives world 1's
    result on both ranks, bit for bit."""
    want_state, want_outs = world1[0]["vo"]
    assert bool(want_state.initialized.all())
    assert bool(want_outs.validity[:, 1:].all())
    for r in world2:
        state, outs = r["vo"]
        for got, want in ((state, want_state), (outs, want_outs)):
            for f in want._fields:
                assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------- the dry run


def test_dryrun_two_processes():
    """``python -m ergo_uvo_tpu_torch.dist.dryrun --device cpu``: 2 processes,
    each feeding its landmark rows, costs within 2e-3 of ``ba_solve``
    (tests/test_multiprocess.py:33)."""
    out = subprocess.run(
        [sys.executable, "-m", "ergo_uvo_tpu_torch.dist.dryrun", "--device", "cpu",
         "--timeout", str(WORLD_TIMEOUT)],
        capture_output=True, text=True, timeout=WORLD_TIMEOUT + 60, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    d = json.loads([line for line in out.stdout.splitlines() if line.startswith("{")][-1])
    assert d["ok"] is True and d["processes"] == 2 and d["batches"] == 2
    assert d["ba_costs"] == pytest.approx(d["ref_costs"], rel=2e-3)
    assert d["landmarks_max_abs_diff"] <= 1e-3


# ---------------------------------------------------------------- no fallback


def test_no_card_no_mesh():
    """``device=None`` is the card: without one, the mesh and the batch runner
    raise before anything else; a CPU world refuses to build a CUDA mesh."""
    from ergo_uvo_tpu_torch.dist import init_world, make_mesh, make_mesh_2d, run_mono_vo_batch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (make_mesh, lambda: make_mesh_2d(1), lambda: init_world(0, 1),
                 lambda: run_mono_vo_batch(None, *_vo_streams(), _vo_config())):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def test_cuda_mesh_never_on_gloo(world1):
    assert "runs on nccl" in world1[0]["cuda_mesh_on_gloo"]


def test_placements():
    """``landmark_sharding`` and ``replicated`` are JAX's NamedSharding specs
    as DTensor placements."""
    from torch.distributed.tensor import Replicate, Shard

    from ergo_uvo_tpu_torch.dist import landmark_sharding, replicated

    class Mesh2:
        mesh_dim_names, ndim = ("kf", "lm"), 2

    assert landmark_sharding(Mesh2, 3, 1, "lm") == [Replicate(), Shard(1)]
    assert landmark_sharding(Mesh2, 2, 0, "kf") == [Shard(0), Replicate()]
    assert replicated(Mesh2) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        landmark_sharding(Mesh2, 2, 2, "lm")
