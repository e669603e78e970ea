"""Faithful host-side re-execution of the reference UVO pipelines with OpenCV.

A numpy + cv2 copy of ``ergo_uvo_tpu/eval/reference_oracle.py`` (whose
package imports JAX), held equal to it by
``tests/test_torch_host_modules.py``.  It is the measurement oracle for the
BASELINE headline metric ("ATE <= reference ATE"): the reference publishes
no numbers and its C++/ROS stack does not run without ROS, so this module
re-executes its exact algorithm — the same OpenCV calls, thresholds, and
failure cascade, frame by frame — to *generate* the baseline trajectory the
engine is held to.  It is not on the device path: numpy + cv2 only, cv2
imported lazily (:func:`_cv2`).

Fidelity map (file:line into the reference):
  * detect_features dispatch ......... uvo_libraries/src/VO_utility.cpp:91-126
    (SIFT and ORB run in cv2 5.0; SURF needs xfeatures2d and AKAZE is
    absent from the cv2 5.0 build this was written against, so those
    configs raise).
  * mono match: BF kNN k=2 + Lowe, hardcoded NORM_L2 .. VO_utility.cpp:551-573
  * stereo match: norm by detector family ............. VO_utility.cpp:515-543
  * select_estimation_method (median px displacement < DISTANCE ->
    homography) ....................................... VO_utility.cpp:725-748
  * estimate_relative_pose retry/switch-once loop, VPF + MIN_NUM_INLIERS
    gates, inliers taken from the pre-recoverPose mask but VPF counted on
    the recoverPose-updated mask ...................... VO_utility.cpp:134-180
  * recover_pose_homography (decomposeHomographyMat + 0<Z<HOMOGRAPHY_DISTANCE
    cheirality vote over ALL matches + unit-norm t) ... VO_utility.cpp:581-624
  * extract_3Dpoints (mean two-view reprojection gate, Z>0, mean±3σ depth
    gate) ............................................. VO_utility.cpp:188-237
  * convert_3Dpoints_camera (cheirality in target frame, source-frame
    rows returned) .................................... VO_utility.cpp:46-63
  * compute_scale_factor = range / median(Z) .......... VO_utility.cpp:23-38
  * mono_VO loop state machine ........... uvo/include/visual_odometry.h:167-398
  * stereo_VO loop ....................... uvo/include/visual_odometry.h:406-741
  * output computation ................... visual_odometry.h:126-159
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def _cv2():
    import cv2

    return cv2


def _make_detector(cfg):
    """detect_features dispatch (VO_utility.cpp:91-126) for detectors this
    cv2 build ships.  The reference's hardcoded creation arguments are
    reproduced exactly (ORB: 10000 feats, 1.2 scale, 8 levels, HARRIS, FAST
    thr 10; SIFT: 10000, 3, 0.03, 10, 1.6)."""
    cv2 = _cv2()
    name = cfg.feature_detector.upper()
    if name == "SIFT":
        return cv2.SIFT_create(10000, 3, 0.03, 10, 1.6)
    if name == "ORB":
        return cv2.ORB_create(10000, 1.2, 8, 31, 0, 2, cv2.ORB_HARRIS_SCORE, 31, 10)
    raise NotImplementedError(
        f"reference oracle: this OpenCV build cannot run {name} "
        "(SURF needs xfeatures2d, AKAZE is absent from this cv2 build); "
        "use the SIFT or ORB config for parity measurement"
    )


def _match_mono(desc1, desc2, ratio):
    """The mono node's match_features overload: BF kNN k=2 with HARDCODED
    NORM_L2 (VO_utility.cpp:551-573) + Lowe ratio.  Binary (uint8) ORB
    descriptors are promoted to float32 so the L2 norm the C++ requests is
    computable (OpenCV's BFMatcher would assert on uint8+L2)."""
    cv2 = _cv2()
    if desc1 is None or desc2 is None or len(desc1) < 2 or len(desc2) < 2:
        return []
    d1 = desc1.astype(np.float32) if desc1.dtype != np.float32 else desc1
    d2 = desc2.astype(np.float32) if desc2.dtype != np.float32 else desc2
    knn = cv2.BFMatcher(cv2.NORM_L2, False).knnMatch(d1, d2, 2)
    return [m[0] for m in knn if len(m) == 2 and m[0].distance < ratio * m[1].distance]


def _match_stereo(desc1, desc2, ratio, detector_name):
    """The keypoint-free match_features overload (VO_utility.cpp:515-543):
    Hamming for AKAZE/ORB, L2 for SURF/SIFT."""
    cv2 = _cv2()
    if desc1 is None or desc2 is None or len(desc1) < 2 or len(desc2) < 2:
        return []
    norm = (
        cv2.NORM_HAMMING
        if detector_name.upper() in ("AKAZE", "ORB")
        else cv2.NORM_L2
    )
    knn = cv2.BFMatcher(norm, False).knnMatch(desc1, desc2, 2)
    return [m[0] for m in knn if len(m) == 2 and m[0].distance < ratio * m[1].distance]


def _select_estimation_method(pts1, pts2, distance_threshold):
    """median pixel displacement >= DISTANCE -> essential (VO_utility.cpp:725-748)."""
    d = np.linalg.norm(pts1 - pts2, axis=1)
    return float(np.median(d)) >= distance_threshold


def _proj(K, R, t):
    return K @ np.hstack([R, t.reshape(3, 1)])


def _reproject_errors(pts3d, R, t, K, pts2d):
    """cv2.projectPoints + per-point pixel error (VO_utility.cpp:632-651)."""
    cv2 = _cv2()
    rvec, _ = cv2.Rodrigues(np.asarray(R, np.float64))
    proj, _ = cv2.projectPoints(
        np.asarray(pts3d, np.float64), rvec, np.asarray(t, np.float64).reshape(3, 1),
        np.asarray(K, np.float64), None,
    )
    return np.linalg.norm(proj.reshape(-1, 2) - pts2d, axis=1)


def _extract_3d_points(pts1, pts2, R1, t1, R2, t2, K1, K2, points4d, cfg):
    """extract_3Dpoints (VO_utility.cpp:188-237): dehomogenize, mean two-view
    reprojection gate + Z>0, then mean±3σ depth gate.  Returns (points Nx3 in
    cam1 frame, indices into the matched set)."""
    w = points4d[3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    pts3d = (points4d[:3] / w).T.astype(np.float64)  # (N, 3) cam1 frame
    n = len(pts3d)
    if n < cfg.min_num_3d_points:
        return np.zeros((0, 3)), np.zeros(0, int)
    e1 = _reproject_errors(pts3d, R1, t1, K1, pts1)
    e2 = _reproject_errors(pts3d, R2, t2, K2, pts2)
    mean_err = 0.5 * (e1 + e2)
    good = (mean_err < cfg.reprojection_threshold) & (pts3d[:, 2] > 0)
    good_idx = np.flatnonzero(good)
    good_pts = pts3d[good_idx]
    if len(good_pts) < cfg.min_num_3d_points:
        return np.zeros((0, 3)), np.zeros(0, int)
    z = good_pts[:, 2]
    # compute_mean_and_variance (math_utility.cpp:35-63) is the population
    # mean/variance over the depth column.
    mu, var = float(z.mean()), float(z.var())
    keep = (z <= mu + 3.0 * np.sqrt(var)) & (z >= mu - 3.0 * np.sqrt(var))
    return good_pts[keep], good_idx[keep]


def _convert_3dpoints_camera(pts, R, t):
    """convert_3Dpoints_camera (VO_utility.cpp:46-63): filter by cheirality in
    the target frame, return the UNTRANSFORMED (source-frame) rows."""
    z_target = pts @ np.asarray(R)[2] + float(np.asarray(t).reshape(3)[2])
    return pts[z_target > 0]


def _recover_pose_homography(H, pts1, pts2, K, cfg):
    """recover_pose_homography (VO_utility.cpp:581-624): decompose, vote by
    triangulated-point cheirality (0 < Z < HOMOGRAPHY_DISTANCE) over ALL
    matched points, normalize t.  Returns (found, R, t)."""
    cv2 = _cv2()
    n_sol, Rs, ts, _ = cv2.decomposeHomographyMat(H, np.asarray(K, np.float64))
    P1 = _proj(K, np.eye(3), np.zeros(3))
    best, best_good = -1, 0
    for i in range(n_sol):
        P2 = _proj(K, Rs[i], np.asarray(ts[i]).reshape(3))
        X4 = cv2.triangulatePoints(P1, P2, pts1.T, pts2.T)
        w = np.where(np.abs(X4[3]) < 1e-12, 1e-12, X4[3])
        z = X4[2] / w
        good = int(np.sum((z > 0) & (z < cfg.homography_distance)))
        if good > best_good:
            best, best_good = i, good
    if best < 0:
        return False, None, None
    t = np.asarray(ts[best]).reshape(3)
    return True, np.asarray(Rs[best]), t / max(np.linalg.norm(t), 1e-12)


def _find_essential(pts1, pts2, K, cfg):
    """findEssentialMat with the reference's (method, confidence, threshold,
    maxIters) argument order (VO_utility.cpp:147)."""
    cv2 = _cv2()
    try:
        return cv2.findEssentialMat(
            pts1, pts2, np.asarray(K, np.float64),
            method=int(cfg.essential.outlier_method),
            prob=float(cfg.essential.confidence),
            threshold=float(cfg.essential.threshold),
            maxIters=int(cfg.essential.max_iters),
        )
    except TypeError:  # older cv2 without maxIters kwarg
        return cv2.findEssentialMat(
            pts1, pts2, np.asarray(K, np.float64),
            method=int(cfg.essential.outlier_method),
            prob=float(cfg.essential.confidence),
            threshold=float(cfg.essential.threshold),
        )


def _estimate_relative_pose(pts1, pts2, K, cfg, use_essential, R_prev, t_prev):
    """estimate_relative_pose (VO_utility.cpp:134-180): try the selected
    method; on VPF/inlier-count failure switch method ONCE, then give up.

    Mirrors the C++ call order exactly: inlier point sets are extracted from
    the mask findEssentialMat/findHomography returned, while the VPF /
    MIN_NUM_INLIERS acceptance counts the mask AFTER recoverPose refines it
    (recoverPose updates the mask in place; findHomography's does not change).
    Returns (success, R, t, inl1, inl2, used_essential).
    """
    cv2 = _cv2()
    switch_method = False
    R_out, t_out = R_prev, t_prev
    inl1 = inl2 = np.zeros((0, 2), np.float64)
    while True:
        if use_essential:
            E, mask = _find_essential(pts1, pts2, K, cfg)
            if E is None or E.shape != (3, 3):
                mask = np.zeros((len(pts1), 1), np.uint8)
            else:
                m = mask.copy()
                inl1 = pts1[m.ravel() != 0]
                inl2 = pts2[m.ravel() != 0]
                _, R_out, t_out, mask = cv2.recoverPose(
                    E, pts1, pts2, np.asarray(K, np.float64), mask=mask
                )
                t_out = t_out.reshape(3)
        else:
            H, mask = cv2.findHomography(
                pts1, pts2, int(cfg.homography.outlier_method),
                float(cfg.homography.threshold), None,
                int(cfg.homography.max_iters), float(cfg.homography.confidence),
            )
            if H is None:
                mask = np.zeros((len(pts1), 1), np.uint8)
            else:
                inl1 = pts1[mask.ravel() != 0]
                inl2 = pts2[mask.ravel() != 0]
                found, R_h, t_h = _recover_pose_homography(H, pts1, pts2, K, cfg)
                if found:
                    R_out, t_out = R_h, t_h
        valid = int(np.count_nonzero(mask))
        vpf = valid / max(len(pts1), 1)
        if vpf >= cfg.valid_point_fraction and valid >= cfg.min_num_inliers:
            return True, R_out, t_out, inl1, inl2, use_essential
        if switch_method:
            return False, R_out, t_out, inl1, inl2, use_essential
        switch_method = True
        use_essential = not use_essential


class OracleOutput(NamedTuple):
    """Per-frame record aligned with MonoFrameOutput / StereoFrameOutput."""

    velocity: np.ndarray  # (T, 3)
    validity: np.ndarray  # (T,) bool
    published: np.ndarray  # (T,) bool
    R: np.ndarray  # (T, 3, 3)
    t: np.ndarray  # (T, 3)
    scale_factor: np.ndarray  # (T,)  (mono; ones for stereo)


def run_mono_oracle(imgs, timestamps, ranges, K, cfg) -> OracleOutput:
    """Re-execute the reference mono_VO loop (visual_odometry.h:167-398).

    `imgs`: (T, H, W) preprocessed gray frames (uint8 or float in [0,255]) —
    preprocessing parity (resize/undistort/CLAHE) is covered separately by
    tests/test_image.py golden tests, so the oracle consumes the same frames
    the engine does and the comparison isolates the VO algorithm itself.
    """
    det = _make_detector(cfg)
    T = len(imgs)
    K = np.asarray(K, np.float64)
    out_v = np.zeros((T, 3))
    out_valid = np.zeros(T, bool)
    out_pub = np.zeros(T, bool)
    out_R = np.tile(np.eye(3), (T, 1, 1))
    out_t = np.zeros((T, 3))
    out_sf = np.ones(T)

    R_cp = np.eye(3)
    t_cp = np.zeros(3)
    SF = 1.0
    prev_kp = prev_desc = None
    prev_time = float(timestamps[0])
    initialized = False
    P1 = _proj(K, np.eye(3), np.zeros(3))

    for k in range(T):
        img = np.clip(np.asarray(imgs[k]), 0, 255).astype(np.uint8)
        ts = float(timestamps[k])
        kp, desc = det.detectAndCompute(img, None)
        if not initialized:
            # init handshake (visual_odometry.h:227-245)
            if len(kp) >= cfg.min_num_features:
                prev_kp, prev_desc, prev_time = kp, desc, ts
                initialized = True
            continue
        dt = ts - prev_time
        if len(kp) < cfg.min_num_features:
            # skip image: shift state, publish nothing (:276-284)
            prev_kp, prev_desc, prev_time = kp, desc, ts
            continue
        matches = _match_mono(prev_desc, desc, cfg.lowe_ratio_test)
        if len(matches) < cfg.min_num_features:
            prev_kp, prev_desc, prev_time = kp, desc, ts
            continue
        pts1 = np.array([prev_kp[m.queryIdx].pt for m in matches], np.float64)
        pts2 = np.array([kp[m.trainIdx].pt for m in matches], np.float64)
        use_essential = _select_estimation_method(pts1, pts2, cfg.distance)
        success, R_cp, t_cp, inl1, inl2, _ = _estimate_relative_pose(
            pts1, pts2, K, cfg, use_essential, R_cp, t_cp
        )
        valid = success
        if success and len(inl1) > 0:
            # triangulation + scale (visual_odometry.h:349-375)
            cv2 = _cv2()
            P2 = _proj(K, R_cp, t_cp)
            X4 = cv2.triangulatePoints(P1, P2, inl1.T, inl2.T)
            good_pts, _ = _extract_3d_points(
                inl1, inl2, np.eye(3), np.zeros(3), R_cp, t_cp, K, K, X4, cfg
            )
            if len(good_pts) < cfg.min_num_3d_points:
                valid = False
            else:
                curr_pts = _convert_3dpoints_camera(good_pts, R_cp, t_cp)
                if len(curr_pts) >= 3:
                    # compute_scale_factor (VO_utility.cpp:23-38): Z row of
                    # the source-frame points that pass target cheirality.
                    SF = float(ranges[k]) / float(np.median(curr_pts[:, 2]))
                else:
                    valid = False
        # mono_output_computation (:126-140) — publishes every processed frame
        safe_dt = dt if abs(dt) > 1e-9 else 1.0
        out_v[k] = -SF * (R_cp.T @ t_cp) / safe_dt
        out_valid[k] = valid
        out_pub[k] = True
        out_R[k], out_t[k], out_sf[k] = R_cp, t_cp, SF
        prev_kp, prev_desc, prev_time = kp, desc, ts
    return OracleOutput(out_v, out_valid, out_pub, out_R, out_t, out_sf)


def run_stereo_oracle(
    imgs_l, imgs_r, timestamps, K_l, K_r, R_right, t_right, cfg
) -> OracleOutput:
    """Re-execute the reference stereo_VO loop (visual_odometry.h:406-741):
    stereo match -> triangular match (prev stereo-matched left vs FULL curr
    left set) -> triangulate the previous pair -> solvePnPRansac -> velocity
    = t_prevCam_currCam / dt, with every failure branch holding the last
    translation (validity 0, "assume constant motion")."""
    cv2 = _cv2()
    det = _make_detector(cfg)
    name = cfg.feature_detector
    T = len(imgs_l)
    K_l = np.asarray(K_l, np.float64)
    K_r = np.asarray(K_r, np.float64)
    R_right = np.asarray(R_right, np.float64)
    t_right = np.asarray(t_right, np.float64).reshape(3)
    out = OracleOutput(
        np.zeros((T, 3)), np.zeros(T, bool), np.zeros(T, bool),
        np.tile(np.eye(3), (T, 1, 1)), np.zeros((T, 3)), np.ones(T),
    )
    P_eye_l = _proj(K_l, np.eye(3), np.zeros(3))
    P_lw = _proj(K_r, R_right, t_right)

    rvec = np.zeros((3, 1))
    tvec = np.zeros((3, 1))
    t_pc = np.zeros(3)
    R_cp = np.eye(3)
    prev_kp_l = prev_kp_r = None  # stereo-matched sets
    prev_desc_l = None
    prev_time = float(timestamps[0])
    initialized = False

    def detect(img):
        return det.detectAndCompute(
            np.clip(np.asarray(img), 0, 255).astype(np.uint8), None
        )

    for k in range(T):
        ts = float(timestamps[k])
        kp_l, d_l = detect(imgs_l[k])
        kp_r, d_r = detect(imgs_r[k])
        if not initialized:
            # init: need detections AND > MIN stereo matches (:474-506)
            if len(kp_l) >= cfg.min_num_features and len(kp_r) >= cfg.min_num_features:
                sm = _match_stereo(d_l, d_r, cfg.lowe_ratio_test, name)
                if len(sm) > cfg.min_num_features:
                    prev_kp_l = [kp_l[m.queryIdx] for m in sm]
                    prev_kp_r = [kp_r[m.trainIdx] for m in sm]
                    prev_desc_l = np.stack([d_l[m.queryIdx] for m in sm])
                    prev_time = ts
                    initialized = True
            continue
        dt = ts - prev_time
        valid = False
        curr_set_l = curr_set_r = []
        curr_desc_l_set = None
        if len(kp_l) >= cfg.min_num_features and len(kp_r) >= cfg.min_num_features:
            sm = _match_stereo(d_l, d_r, cfg.lowe_ratio_test, name)
            if len(sm) > cfg.min_num_features:
                curr_set_l = [kp_l[m.queryIdx] for m in sm]
                curr_set_r = [kp_r[m.trainIdx] for m in sm]
                curr_desc_l_set = np.stack([d_l[m.queryIdx] for m in sm])
                # triangular matching: prev stereo-matched left -> FULL curr
                # left descriptor set (:592)
                tm = _match_stereo(prev_desc_l, d_l, cfg.lowe_ratio_test, name)
                if len(tm) > cfg.min_num_features:
                    p_l = np.array(
                        [prev_kp_l[m.queryIdx].pt for m in tm], np.float64
                    )
                    p_r = np.array(
                        [prev_kp_r[m.queryIdx].pt for m in tm], np.float64
                    )
                    c_l = np.array([kp_l[m.trainIdx].pt for m in tm], np.float64)
                    X4 = cv2.triangulatePoints(P_eye_l, P_lw, p_l.T, p_r.T)
                    good_pts, good_idx = _extract_3d_points(
                        p_l, p_r, np.eye(3), np.zeros(3), R_right, t_right,
                        K_l, K_r, X4, cfg,
                    )
                    if len(good_pts) > cfg.min_num_3d_points:
                        img_pts = c_l[good_idx]
                        ok, rvec, tvec, inliers = cv2.solvePnPRansac(
                            good_pts.astype(np.float32),
                            img_pts.astype(np.float32),
                            K_l, np.zeros(4), rvec, tvec,
                            useExtrinsicGuess=bool(cfg.use_extrinsic_guess),
                            iterationsCount=int(cfg.iterations_count),
                            reprojectionError=float(cfg.reprojection_error),
                            confidence=float(cfg.confidence),
                            flags=int(cfg.pnp_method_flag),
                        )
                        n_inl = 0 if inliers is None else len(inliers)
                        if ok and n_inl >= cfg.min_num_inliers:
                            R_cp, _ = cv2.Rodrigues(rvec)
                            t_pc = (-R_cp.T @ tvec).reshape(3)
                            valid = True
        # stereo_output_computation (:148-159) — publishes every frame after
        # init with the (possibly held) t_prevCam_currCam.
        safe_dt = dt if abs(dt) > 1e-9 else 1.0
        out.velocity[k] = t_pc / safe_dt
        out.validity[k] = valid
        out.published[k] = True
        out.R[k], out.t[k] = R_cp, t_pc
        # state shift (:723-733): the carried stereo-matched set empties when
        # this frame's gates failed.
        prev_kp_l, prev_kp_r = list(curr_set_l), list(curr_set_r)
        prev_desc_l = curr_desc_l_set
        prev_time = ts
    return out
