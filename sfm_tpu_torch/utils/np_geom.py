"""Host-side numpy geometry helpers.

The orchestrator's bookkeeping math (pose composition, edge checks, CSV
export) runs on a handful of 3-vectors and 3x3 matrices in float64: that
is host work, not worth a device launch or a host sync each. These are
the numpy twins of ops/lie.py for host use only.
"""

from __future__ import annotations

import numpy as np


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues (3,) -> (3,3), host numpy."""
    theta = float(np.linalg.norm(w))
    if theta < 1e-12:
        W = hat(w)
        return np.eye(3) + W
    a = w / theta
    W = hat(a)
    return (
        np.eye(3)
        + np.sin(theta) * W
        + (1.0 - np.cos(theta)) * (W @ W)
    )


def so3_log(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (3,), host numpy; robust near 0 and pi."""
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = float(np.arccos(tr))
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-9:
        return 0.5 * v
    s = np.sin(theta)
    if abs(s) < 1e-6:
        # near pi
        B = (R + np.eye(3)) * 0.5
        k = int(np.argmax(np.diag(B)))
        axis = B[:, k]
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        if np.dot(axis, v) < 0:
            axis = -axis
        return theta * axis
    return (theta / (2.0 * s)) * v


def hat(w: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )


def rot_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle between two rotations in degrees."""
    return float(np.rad2deg(np.linalg.norm(so3_log(Ra.T @ Rb))))


def dir_angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    """Unsigned angle between directions (min vs ±b) in degrees."""
    an = a / max(np.linalg.norm(a), 1e-30)
    bn = b / max(np.linalg.norm(b), 1e-30)
    return float(np.rad2deg(np.arccos(np.clip(abs(float(an @ bn)), 0.0, 1.0))))


def normalize_by_K(K: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Pixel -> K-normalized coords, host numpy (twin of
    ops/epipolar.normalize_by_K)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - s * y) / fx
    return np.stack([x, y], axis=-1)


def export_keep_mask(K, R_cw, t_cw, uv, tvalid, pid, X,
                     thresh_norm: float) -> np.ndarray:
    """Per-point keep mask for artifact export.

    Keep a point iff its BEST (minimum) reprojection residual over all
    observing keyframes is within ``thresh_norm`` (K-normalized units)
    and in front of that camera. A point past the window BA's
    gross-outlier gate (ops/ba._CUTOFF x huber) carried zero weight in
    every solve — it is pure noise in the exported PLY. The reference
    exports every triangulated point after its RANSAC gates
    (cpp:1877-1893); this applies the same robust-kernel cutoff the
    in-loop BA already used.

    ``R_cw`` (F,3,3) camera-to-world rotations, ``t_cw`` (F,3) camera
    centers, ``uv`` (F,T,2) pixel observations, ``tvalid`` (F,T),
    ``pid`` (F,T) per-slot point ids. Returns (len(X),) bool."""
    n_pts = len(X)
    if n_pts == 0 or len(R_cw) == 0:
        return np.ones(n_pts, bool)
    kk, ss = np.nonzero(tvalid & (pid >= 0) & (pid < n_pts))
    if len(kk) == 0:
        # no observations at all: no signal to cull on — export
        # everything (matches the host pipeline's empty-obs gate)
        return np.ones(n_pts, bool)
    return export_keep_mask_obs(K, R_cw, t_cw, kk, pid[kk, ss],
                                uv[kk, ss], X, thresh_norm)


def export_keep_mask_obs(K, R_cw, t_cw, obs_kf, obs_pid, obs_uv, X,
                         thresh_norm: float) -> np.ndarray:
    """Flat-observation-table form of `export_keep_mask` (host
    pipeline's MapState obs layout): ``obs_kf``/``obs_pid`` (M,) indices
    into poses/points, ``obs_uv`` (M,2) pixels."""
    n_pts = len(X)
    if n_pts == 0:
        return np.ones(0, bool)
    if len(obs_kf) == 0:
        return np.ones(n_pts, bool)  # no signal to cull on
    R_wc = np.swapaxes(R_cw, -1, -2)
    t_wc = -np.einsum("fij,fj->fi", R_wc, t_cw)
    Xc = np.einsum("oij,oj->oi", R_wc[obs_kf], X[obs_pid]) + t_wc[obs_kf]
    z = Xc[:, 2]
    proj = Xc[:, :2] / np.where(np.abs(z) < 1e-6, 1e-6, z)[:, None]
    obs = normalize_by_K(K, obs_uv)
    err = np.linalg.norm(proj - obs, axis=1)
    err = np.where(z > 1e-6, err, np.inf)
    best = np.full(n_pts, np.inf)
    np.minimum.at(best, obs_pid, err)
    return best < thresh_norm
