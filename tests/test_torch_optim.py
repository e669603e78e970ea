"""The port's BA, pose graph and keyframe window against the JAX package (CPU).

* ``tests/test_optim.py``'s contracts (``TestBA``, ``TestPoseGraph``,
  ``TestWindowedBA``) on the port: the same scenes, the same gates.
* Parity on the same numpy arrays: every piece of the LM step, ``ba_step``,
  ``ba_solve``, the pose-graph residuals and Gauss-Newton step,
  ``optimize_pose_graph``, ``global_descriptor``, ``detect_loop_closures``
  (ties included) and ``build_ba_problem`` (float and ``binary=``), each with
  its tolerance; masks and chosen pairs exact.
* ``optim/ba.py`` and ``optim/pose_graph.py`` read nothing back (an AST scan).

JAX runs its own jitted functions; nothing here compiles a pipeline.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ergo_uvo_tpu.geometry import so3_exp as j_so3_exp
from ergo_uvo_tpu.optim import ba as jba
from ergo_uvo_tpu.optim import keyframes as jkf
from ergo_uvo_tpu.optim import pose_graph as jpg
from ergo_uvo_tpu_torch.optim import ba as tba
from ergo_uvo_tpu_torch.optim import keyframes as tkf
from ergo_uvo_tpu_torch.optim import pose_graph as tpg

PORT_DIR = Path(__file__).resolve().parent.parent / "ergo_uvo_tpu_torch"
K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops on these small images are faster on one thread than spread
    over a shared host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def so3(w):
    return np.asarray(j_so3_exp(jnp.asarray(np.asarray(w, np.float32))))


def t(a):
    return torch.from_numpy(np.array(a))


def host(tup):
    return type(tup)(*(np.asarray(x) for x in tup))


def make_ba_scene(P=5, L=64, seed=0, pix_noise=0.1, pose_noise=0.05, lm_noise=0.3):
    """tests/test_optim.py's scene, as numpy: (Rs, ts, X, R0, t0, X0, obs, mask)."""
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


def t_problem(obs, mask, num_fixed=1):
    return tba.BAProblem(K=t(K), obs_uv=t(obs), obs_mask=t(mask), num_fixed_poses=num_fixed)


# ------------------------------------------------ tests/test_optim.py, on the port


class TestBA:
    def test_reduces_cost_and_recovers_poses(self):
        Rs, ts, X, R0, t0, X0, obs, mask = make_ba_scene()
        state, costs = tba.ba_solve(t_problem(obs, mask), t(R0), t(t0), t(X0), iters=25)
        costs = costs.numpy()
        noise_floor = 5 * 64 * 2 * 0.1**2
        assert costs[-1] < max(0.02 * costs[0], 1.5 * noise_floor), costs[[0, -1]]
        err0 = np.linalg.norm(t0 - ts, axis=-1).mean()
        err1 = np.linalg.norm(state.t.numpy() - ts, axis=-1).mean()
        assert err1 < 0.5 * err0, (err0, err1)

    def test_masked_observations_ignored(self):
        Rs, ts, X, R0, t0, X0, obs, mask = make_ba_scene()
        obs[2, :10] = 1e5  # poisoned but masked out
        mask[2, :10] = False
        _, costs = tba.ba_solve(t_problem(obs, mask), t(R0), t(t0), t(X0), iters=15)
        costs = costs.numpy()
        assert np.isfinite(costs).all() and costs[-1] < 0.2 * costs[0]

    def test_gauge_fixed_pose_unchanged(self):
        Rs, ts, X, R0, t0, X0, obs, mask = make_ba_scene()
        state, _ = tba.ba_solve(t_problem(obs, mask), t(R0), t(t0), t(X0), iters=10)
        np.testing.assert_allclose(state.R[0].numpy(), R0[0], atol=1e-6)
        np.testing.assert_allclose(state.t[0].numpy(), t0[0], atol=1e-6)


def _chain(T=12):
    """tests/test_optim.py's ground-truth chain: a turn of 2 pi / T a node."""
    R_gt = [np.eye(3, dtype=np.float32)]
    t_gt = [np.zeros(3, np.float32)]
    dR = so3([0, 0, 2 * np.pi / T])
    for _ in range(1, T):
        R_gt.append((dR @ R_gt[-1]).astype(np.float32))
        t_gt.append(t_gt[-1] + np.array([1.0, 0, 0], np.float32))
    return np.stack(R_gt), np.stack(t_gt)


def _edges(R_gt, t_gt, ei, ej):
    R_rel = np.stack([R_gt[j] @ R_gt[i].T for i, j in zip(ei, ej)])
    t_rel = np.stack([t_gt[j] - R_gt[j] @ R_gt[i].T @ t_gt[i] for i, j in zip(ei, ej)])
    return R_rel.astype(np.float32), t_rel.astype(np.float32)


def _drifted_graph(T=12, seed=1, extra_loops=()):
    """Noisy nodes, exact odometry and a loop edge 0 -> T-1 (plus ``extra_loops``)."""
    R_gt, t_gt = _chain(T)
    rng = np.random.default_rng(seed)
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for k in range(1, T):
        R0.append((so3(0.03 * rng.standard_normal(3)) @ R_gt[k]).astype(np.float32))
        t0.append((t_gt[k] + 0.2 * rng.standard_normal(3)).astype(np.float32))
    ei = list(range(T - 1)) + [0] + [i for i, _ in extra_loops]
    ej = list(range(1, T)) + [T - 1] + [j for _, j in extra_loops]
    R_rel, t_rel = _edges(R_gt, t_gt, ei, ej)
    w = np.ones(len(ei), np.float32)
    arrays = dict(R=np.stack(R0), t=np.stack(t0), edge_i=np.array(ei, np.int32),
                  edge_j=np.array(ej, np.int32), edge_R=R_rel, edge_t=t_rel, edge_weight=w)
    return R_gt, t_gt, arrays


class TestPoseGraph:
    def test_residuals_zero_at_ground_truth(self):
        R_gt, t_gt = _chain()
        T = len(R_gt)
        ei = np.arange(T - 1, dtype=np.int32)
        R_rel, t_rel = _edges(R_gt, t_gt, ei, ei + 1)
        g = tpg.PoseGraph(R=t(R_gt), t=t(t_gt), edge_i=t(ei), edge_j=t(ei + 1), edge_R=t(R_rel),
                          edge_t=t(t_rel), edge_weight=torch.ones(T - 1))
        assert float(tpg.pose_graph_residuals(g).abs().max()) < 1e-4

    def test_optimization_corrects_drift(self):
        R_gt, t_gt, a = _drifted_graph()
        g_opt, costs = tpg.optimize_pose_graph(tpg.PoseGraph(**{k: t(v) for k, v in a.items()}),
                                               iters=15)
        err0 = np.linalg.norm(a["t"] - t_gt, axis=-1).mean()
        err1 = np.linalg.norm(g_opt.t.numpy() - t_gt, axis=-1).mean()
        assert err1 < 0.2 * err0, (err0, err1)
        costs = costs.numpy()
        assert costs[-1] < 1e-3 * max(costs[0], 1e-12) or err1 < 0.02

    def test_loop_closure_detection(self):
        rng = np.random.default_rng(2)
        descs = rng.standard_normal((30, 64)).astype(np.float32)
        descs[25] = descs[3] + 0.01 * rng.standard_normal(64).astype(np.float32)  # revisit
        descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
        pairs, _, valid = tpg.detect_loop_closures(t(descs), min_gap=10, top_k=4)
        assert bool(valid[0]) and tuple(pairs[0].tolist()) == (3, 25)

    def test_global_descriptor_masked(self):
        desc = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
        mask = np.zeros(16, bool)
        mask[:4] = True
        manual = desc[:4].mean(0)
        manual /= np.linalg.norm(manual)
        np.testing.assert_allclose(tpg.global_descriptor(t(desc), t(mask)).numpy(), manual,
                                   atol=1e-5)


def _window_scene(seed=3, L=96, P=4, D=64, binary=False):
    """tests/test_optim.py::TestWindowedBA's keyframes sharing one landmark
    field (two exact anchor poses, noisy others).  With ``binary`` the
    descriptors are {0,1} rows of D bits with 2% of the bits flipped a
    keyframe; a few slots are masked and a few descriptors shuffled, so the
    association has misses and mismatches to drop."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(5, 9, L)],
                 -1).astype(np.float32)
    if binary:
        desc = (rng.random((L, D)) < 0.5).astype(np.float32)
    else:
        desc = rng.standard_normal((L, D)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    frames, gt = [], []
    for p in range(P):
        R = so3(0.02 * rng.standard_normal(3))
        tr = np.array([0.3 * p, 0.0, 0.0], np.float32)
        pc = X @ R.T + tr
        uv = (pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)
        uv += 0.1 * rng.standard_normal((L, 2)).astype(np.float32)
        if p <= 1:
            R0, t0 = R, tr
        else:
            R0 = so3(0.02 * rng.standard_normal(3)) @ R
            t0 = tr + 0.05 * rng.standard_normal(3).astype(np.float32)
        d = desc.copy()
        if binary:
            flip = rng.random(d.shape) < 0.02
            d = np.where(flip, 1.0 - d, d).astype(np.float32)
        mask = np.ones(L, bool)
        if p > 0:
            mask[rng.choice(L, 6, replace=False)] = False
            swap = rng.choice(L, 4, replace=False)
            d[swap] = d[np.roll(swap, 1)]
        frames.append((uv, d, mask, R0.astype(np.float32), t0.astype(np.float32)))
        gt.append((R, tr))
    return frames, gt


class TestWindowedBA:
    def test_window_refine_on_synthetic_features(self):
        frames, gt = _window_scene()
        wba = tkf.WindowedBA(window_size=4, iters=15)
        for f in frames:
            wba.push_keyframe(*(t(v) for v in f))
        assert wba.full
        state, costs, lm_mask = wba.refine(t(K))
        costs = costs.numpy()
        assert int(lm_mask.sum()) > 60
        noise_floor = 4 * 96 * 2 * 0.1**2
        assert costs[-1] < max(0.3 * costs[0], 2.0 * noise_floor), costs[[0, -1]]
        err = np.linalg.norm(state.t.numpy() - np.stack([g[1] for g in gt]), axis=-1).mean()
        assert err < 0.04, err
        # The refined poses are written back into the window.
        np.testing.assert_array_equal(wba.window().R.numpy(), state.R.numpy())


# ------------------------------------------------------------- parity with JAX


@pytest.mark.fast
def test_lm_step_pieces_match_jax():
    """Residuals, Jacobians, normal equations, the Schur halves, the 3x3
    inverses and the update against JAX on one scene with masked
    observations, to 1e-4 relative of each quantity's scale (float32 sums
    over 64 landmarks in another order); the reduced solve's (dp, dl) to
    1e-4."""
    Rs, ts, X, R0, t0, X0, obs, mask = make_ba_scene(seed=4)
    mask[1, :7] = False
    mask[3, 20:30] = False
    lam = np.float32(1e-3)
    jr, jpc, jiz = jba.reprojection_residuals(*map(jnp.asarray, (K, R0, t0, X0, obs, mask)))
    tr_, tpc, tiz = tba.reprojection_residuals(*map(t, (K, R0, t0, X0, obs, mask)))

    def close(a, b, what, rel=1e-4):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1.0), err_msg=what)

    for a, b, what in ((tr_, jr, "r"), (tpc, jpc, "pc"), (tiz, jiz, "inv_z")):
        close(a, b, what)
    jJ = jba._jacobians(jnp.asarray(K), jnp.asarray(R0), jpc, jiz, jnp.asarray(mask))
    tJ = tba._jacobians(t(K), t(R0), tpc, tiz, t(mask))
    for a, b in zip(tJ, jJ):
        close(a, b, "J")
    jN = jba._normal_equations(*jJ, jr)
    tN = tba._normal_equations(*tJ, tr_)
    for a, b, what in zip(tN, jN, ("H_pp", "H_ll", "H_pl", "b_p", "b_l")):
        close(a, b, what)
    H_pp, H_ll, H_pl, b_p, b_l = jN
    jC = jba._schur_corrections(H_ll, H_pl, b_l, lam)
    tC = tba._schur_corrections(*(t(x) for x in (H_ll, H_pl, b_l)), t(lam))
    for a, b, what in zip(tC, jC, ("Hll_inv", "S_corr", "rhs_corr")):
        close(a, b, what)
    close(tba._solve33_mat(t(H_ll)), jba._solve33_mat(H_ll), "_solve33_mat")
    jd = jba._schur_reduce_solve(H_pp, b_p, *jC, H_pl, b_l, lam, 2)
    td = tba._schur_reduce_solve(*(t(x) for x in (H_pp, b_p, *jC, H_pl, b_l)), t(lam), 2)
    for a, b, what in zip(td, jd, ("dp", "dl")):
        close(a, b, what, 1e-3)
    for a, b, what in zip(tba._schur_solve(*(t(x) for x in jN), t(lam), 2),
                          jba._schur_solve(*jN, lam, 2), ("dp", "dl")):
        close(a, b, what, 1e-3)
    dp, dl = (np.asarray(x) for x in jd)
    np.testing.assert_array_equal(dp[:2], 0.0)  # the fixed poses do not move
    for a, b in zip(tba._apply_updates(*map(t, (R0, t0, X0, dp, dl))),
                    jba._apply_updates(*map(jnp.asarray, (R0, t0, X0, dp, dl)))):
        close(a, b, "update")


# Tolerances by the number of fixed poses: of the step's cost and the first
# four costs (rtol), of the step's new state (rtol, atol), of the final cost
# (rtol) and of the final state (rtol, atol).  With one fixed pose,
# monocular BA's scale direction is damped by lambda alone: the reduced 30x30
# system's condition number is ~7e6, the two packages' float32 LU solves
# (LAPACK builds that pivot and block differently) agree on dp to about 4%
# there.  Over 12 iterations the two reconstructions then drift apart along
# that direction, by a common scale of up to 5% of t and X: with one fixed
# pose the final state is compared after one least-squares scale.
BA_TOL = {
    1: dict(cost=5e-2, state=(1e-2, 2e-2), final_cost=5e-2, final_state=(1e-2, 2e-2), scale=5e-2),
    2: dict(cost=1e-4, state=(0.0, 1e-4), final_cost=2e-2, final_state=(0.0, 2e-3), scale=0.0),
}


@pytest.mark.fast
@pytest.mark.parametrize("num_fixed", [1, 2])
def test_ba_step_and_solve_match_jax(num_fixed):
    """``ba_step`` from the same state: the cost, the damping, the same
    accept decision and the new state; ``ba_solve`` over 12 iterations: the
    first four costs, the final cost and the final poses and landmarks (up
    to scale with one fixed pose), each to ``BA_TOL`` (near convergence LM's accept decision may flip on float
    rounding, so the sequence of decisions is not compared); the fixed poses
    bit for bit."""
    tol = BA_TOL[num_fixed]
    Rs, ts, X, R0, t0, X0, obs, mask = make_ba_scene(seed=5)
    mask[2, ::5] = False
    lam = np.float32(1e-3)
    jstate = jba.BAState(*map(jnp.asarray, (R0, t0, X0)), jnp.asarray(lam))
    tstate = tba.BAState(*map(t, (R0, t0, X0)), t(lam))
    js, jc = jba.ba_step(*map(jnp.asarray, (K, obs, mask)), jstate, num_fixed)
    ts_, tc = tba.ba_step(*map(t, (K, obs, mask)), tstate, num_fixed)
    np.testing.assert_allclose(float(tc), float(jc), rtol=tol["cost"])
    assert float(ts_.lm_lambda) == pytest.approx(float(js.lm_lambda), rel=1e-6)
    for a, b in zip(ts_[:3], js[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), *tol["state"])

    jprob = jba.BAProblem(jnp.asarray(K), jnp.asarray(obs), jnp.asarray(mask), num_fixed)
    jst, jcosts = jba.ba_solve(jprob, *map(jnp.asarray, (R0, t0, X0)), iters=12)
    tst, tcosts = tba.ba_solve(t_problem(obs, mask, num_fixed), *map(t, (R0, t0, X0)), iters=12)
    jcosts, tcosts = np.asarray(jcosts), tcosts.numpy()
    assert tcosts.shape == (12,)
    np.testing.assert_allclose(tcosts[:4], jcosts[:4], rtol=tol["cost"])
    np.testing.assert_allclose(tcosts[-1], jcosts[-1], rtol=tol["final_cost"])
    jt, jX = np.asarray(jst.t[num_fixed:]), np.asarray(jst.X)
    tt, tX = tst.t[num_fixed:].numpy(), tst.X.numpy()
    scale = 1.0
    if tol["scale"]:
        scale = float(((tt * jt).sum() + (tX * jX).sum()) / ((jt * jt).sum() + (jX * jX).sum()))
        assert abs(scale - 1.0) <= tol["scale"], scale
    for a, b in ((tst.R.numpy(), np.asarray(jst.R)), (tt / scale, jt), (tX / scale, jX)):
        np.testing.assert_allclose(a, b, *tol["final_state"])
    np.testing.assert_array_equal(tst.R[:num_fixed].numpy(), R0[:num_fixed])
    np.testing.assert_array_equal(tst.t[:num_fixed].numpy(), t0[:num_fixed])


@pytest.mark.fast
def test_pose_graph_matches_jax():
    """The adjoint, the residuals, one Gauss-Newton step (with repeated
    edge indices: two loop edges into node 0, an unused zero-weight slot)
    and 10 steps of ``optimize_pose_graph``, num_fixed 1 and 2, against JAX:
    residuals and the first step's graph to 1e-4, the first cost to 1e-5
    relative, every cost to 1e-3 of the first and the final nodes to 1e-3."""
    _, _, a = _drifted_graph(T=12, seed=3, extra_loops=((0, 8), (2, 11)))
    a = dict(a)
    a["edge_weight"] = a["edge_weight"].copy()
    a["edge_weight"][-1] = 0.0  # an unused slot
    a["edge_weight"][-3] = 10.0  # a loop edge's weight
    jg = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in a.items()})
    tg = tpg.PoseGraph(**{k: t(v) for k, v in a.items()})
    from ergo_uvo_tpu.geometry.se3 import SE3 as JSE3
    from ergo_uvo_tpu_torch.geometry.se3 import SE3 as TSE3

    np.testing.assert_allclose(tpg._adjoint(TSE3(tg.R, tg.t)).numpy(),
                               np.asarray(jpg._adjoint(JSE3(jg.R, jg.t))), atol=1e-6)
    np.testing.assert_allclose(tpg.pose_graph_residuals(tg).numpy(),
                               np.asarray(jpg.pose_graph_residuals(jg)), atol=1e-4)
    for num_fixed in (1, 2):
        jg1, jc = jpg.pose_graph_gn_step(jg, num_fixed)
        tg1, tc = tpg.pose_graph_gn_step(tg, num_fixed)
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
        for name in ("R", "t"):
            np.testing.assert_allclose(getattr(tg1, name).numpy(), np.asarray(getattr(jg1, name)),
                                       atol=1e-4, err_msg=name)
        jopt, jcosts = jpg.optimize_pose_graph(jg, iters=10, num_fixed=num_fixed)
        topt, tcosts = tpg.optimize_pose_graph(tg, iters=10, num_fixed=num_fixed)
        np.testing.assert_allclose(tcosts.numpy(), np.asarray(jcosts), atol=1e-3 * float(jcosts[0]))
        for name in ("R", "t"):
            np.testing.assert_allclose(getattr(topt, name).numpy(), np.asarray(getattr(jopt, name)),
                                       atol=1e-3, err_msg=name)
        np.testing.assert_array_equal(topt.t[:num_fixed].numpy(), a["t"][:num_fixed])
        for name in ("edge_i", "edge_j", "edge_R", "edge_t", "edge_weight"):
            np.testing.assert_array_equal(getattr(topt, name).numpy(), a[name])


@pytest.mark.fast
@pytest.mark.parametrize("top_k", [4, 8, 64])
def test_retrieval_matches_jax(top_k):
    """``global_descriptor`` (an all-masked frame included) to 1e-6;
    ``detect_loop_closures`` on 30 frames with a revisit and exact ties
    (three frames share one descriptor, so their pairs tie; at top_k 64 the
    slots run into the -inf ones): the same pairs in the same order, the
    same validity, scores to 1e-6."""
    rng = np.random.default_rng(7)
    T, Kk, D = 30, 24, 64
    desc = rng.standard_normal((T, Kk, D)).astype(np.float32)
    desc[25] = desc[3] + 0.01 * rng.standard_normal((Kk, D)).astype(np.float32)
    desc[14] = desc[27] = desc[1]
    mask = rng.random((T, Kk)) < 0.8
    mask[5] = False
    jgd = jpg.global_descriptor(jnp.asarray(desc), jnp.asarray(mask))
    tgd = tpg.global_descriptor(t(desc), t(mask))
    np.testing.assert_allclose(tgd.numpy(), np.asarray(jgd), atol=1e-6)
    gd = np.asarray(jgd)
    jp, js, jv = (np.asarray(x) for x in jpg.detect_loop_closures(jnp.asarray(gd), min_gap=10,
                                                                   top_k=top_k,
                                                                   min_similarity=0.5))
    tp, ts_, tv = tpg.detect_loop_closures(t(gd), min_gap=10, top_k=top_k, min_similarity=0.5)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(ts_.numpy(), js, atol=1e-6)
    assert tv.numpy()[:4].all() and (top_k == 4 or not tv.numpy()[-1])


@pytest.mark.fast
@pytest.mark.parametrize("binary", [False, True])
def test_build_ba_problem_matches_jax(binary):
    """``build_ba_problem`` on a window with misses and mismatches, float
    descriptors (D = 64) and {0,1} bits (D = 256, ``binary=``): the
    observation mask and the landmark mask exact, observed pixels exact
    where observed, X0 to 1e-4 relative; then ``WindowedBA.refine`` on the
    window: costs to 1e-3 relative in the first four iterations."""
    frames, _ = _window_scene(seed=11, binary=binary, D=256 if binary else 64)
    jw = jkf.KeyframeWindow(*(jnp.asarray(np.stack(v)) for v in zip(*frames)))
    tw = tkf.KeyframeWindow(*(t(np.stack(v)) for v in zip(*frames)))
    jprob, jX0, jlm = jkf.build_ba_problem(jw, jnp.asarray(K), 0.8, binary=binary)
    tprob, tX0, tlm = tkf.build_ba_problem(tw, t(K), 0.8, binary=binary)
    jm = np.asarray(jprob.obs_mask)
    np.testing.assert_array_equal(tprob.obs_mask.numpy(), jm)
    np.testing.assert_array_equal(tlm.numpy(), np.asarray(jlm))
    assert 40 < int(jlm.sum()) < 96 and not jm.all()
    np.testing.assert_array_equal(tprob.obs_uv.numpy()[jm], np.asarray(jprob.obs_uv)[jm])
    assert tprob.num_fixed_poses == jprob.num_fixed_poses == 2
    np.testing.assert_allclose(tX0.numpy(), np.asarray(jX0), rtol=1e-4, atol=1e-4)

    jwba, twba = jkf.WindowedBA(window_size=4, iters=8), tkf.WindowedBA(window_size=4, iters=8)
    for f in frames:
        jwba.push_keyframe(*map(jnp.asarray, f))
        twba.push_keyframe(*map(t, f))
    _, jc, _ = jwba.refine(jnp.asarray(K), binary=binary)
    _, tc, _ = twba.refine(t(K), binary=binary)
    np.testing.assert_allclose(tc.numpy()[:4], np.asarray(jc)[:4], rtol=1e-3)


@pytest.mark.fast
def test_solvers_read_nothing_back():
    """``optim/ba.py`` and ``optim/pose_graph.py`` call no ``.item()``,
    ``.cpu()``, ``.tolist()`` or ``.numpy()``: an LM or Gauss-Newton step
    queues its work without waiting for the card."""
    banned = {"item", "cpu", "tolist", "numpy"}
    offenders = []
    for name in ("ba", "pose_graph"):
        path = PORT_DIR / "optim" / f"{name}.py"
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in banned):
                offenders.append(f"{name}.py: {ast.unparse(node)}")
    assert offenders == [], offenders


def _jax_dicts():
    """The JAX package's BAProblem, BAState and PoseGraph as numpy dicts
    (``jax.tree.map(np.asarray, x)._asdict()``)."""
    Rs, ts, X, R0, t0, X0, obs, mask = make_ba_scene(seed=8)
    problem = jba.BAProblem(jnp.asarray(K), jnp.asarray(obs), jnp.asarray(mask), 2)
    state = jba.BAState(*map(jnp.asarray, (R0, t0, X0)), jnp.asarray(np.float32(1e-3)))
    _, _, a = _drifted_graph(T=6, seed=9)
    graph = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in a.items()})
    return {name: jax.tree.map(np.asarray, x)._asdict()
            for name, x in (("ba_problem", problem), ("ba_state", state), ("pose_graph", graph))}


@pytest.mark.fast
@pytest.mark.parametrize("name", ["ba_problem", "ba_state", "pose_graph"])
def test_converters_round_trip(name):
    """``convert.<name>_from_numpy`` takes the JAX package's tuple as a numpy
    dict and ``<name>_to_numpy`` gives the same dict back: every field bit
    for bit with its dtype (``num_fixed_poses`` an int in the port's tuple);
    a dict that lacks a field raises."""
    from ergo_uvo_tpu_torch import convert

    d = _jax_dicts()[name]
    port = getattr(convert, f"{name}_from_numpy")(d, "cpu")
    back = getattr(convert, f"{name}_to_numpy")(port)
    assert set(back) == set(d)
    for field, value in d.items():
        np.testing.assert_array_equal(back[field], value, err_msg=field)
        assert back[field].dtype == value.dtype, field
    if name == "ba_problem":
        assert port.num_fixed_poses == 2 and isinstance(port.num_fixed_poses, int)
        assert all(isinstance(x, torch.Tensor) for x in port[:3])
    else:
        assert all(isinstance(x, torch.Tensor) for x in port)
    with pytest.raises(KeyError):
        getattr(convert, f"{name}_from_numpy")({k: v for k, v in d.items() if k != "K" and k != "R"},
                                               "cpu")
