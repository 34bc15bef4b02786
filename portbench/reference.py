"""The plain reference that decides ``correct``: PyTorch and numpy only, no
module of the program.

- ``track_fb``: forward-backward pyramidal Lucas-Kanade, a frozen copy of
  the plain versions of the port's tracker (``ops/image.build_pyramid``,
  ``ops/klt.lk_track`` / ``lk_track_fb`` and K3's plain version
  ``ops/kernels/lk_kernels.lk_level_plain`` as the benchmark was written),
  float32, run on the pyramids it builds itself from the raw frames.
- ``sim3_align``, ``ate_ratio``, ``edge_rot_deg``, ``cylinder_rel``: the
  keyframe trajectory, the pose-graph edges and the sparse map of an
  exported sequence graded against the renderer's ground truth, float64.
- ``read_centres``, ``read_edges``, ``read_ply``: the exported files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

MARGIN = 6  # per-level search margin in px beyond the patch (the port's)


# ---------------------------------------------------------------------------
# pyramidal LK, plain
# ---------------------------------------------------------------------------


def pyramid(img_u8, levels: int, device) -> list:
    """Finest first: the frame as float32, then 2x2 box means (odd edges
    truncated)."""
    img = torch.as_tensor(np.array(img_u8)).to(device=device,
                                                 dtype=torch.float32)
    pyr = [img]
    for _ in range(levels - 1):
        a = pyr[-1]
        H2, W2 = a.shape[0] // 2, a.shape[1] // 2
        pyr.append(a[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2)
                   .mean(dim=(1, 3)))
    return pyr


def _window_start(origins, back: int, H: int, W: int, win: int):
    start = torch.floor(torch.nan_to_num(origins)) - float(back)
    hi = torch.tensor([W - win, H - win], dtype=origins.dtype,
                      device=origins.device)
    return torch.minimum(torch.clamp(start, min=0.0), hi)


def _gather_windows(img, starts, win: int):
    H, W = img.shape
    sx = torch.clamp(starts[..., 0], 0, max(W - win, 0)).to(torch.int64)
    sy = torch.clamp(starts[..., 1], 0, max(H - win, 0)).to(torch.int64)
    ar = torch.arange(win, device=img.device)
    rows = (sy[..., None] + ar)[..., :, None]
    cols = (sx[..., None] + ar)[..., None, :]
    return img[rows, cols]


def _load_blocks(img, origins, P: int, margin: int):
    WIN = P + 2 * margin + 3
    H, W = img.shape
    start = _window_start(origins, margin + 1, H, W, WIN)
    return _gather_windows(img, start.to(torch.int32), WIN), start


def _qf(origins, anchors, P: int, WINx: int, WINy: int):
    q = origins - anchors
    hi = torch.tensor([WINx - P - 2.0, WINy - P - 2.0], dtype=q.dtype,
                      device=q.device)
    qi = torch.minimum(torch.clamp(torch.floor(q), min=1.0), hi)
    qii = torch.nan_to_num(qi, nan=1.0).to(torch.int64) - 1
    return qii, q - qi


def _sub_windows(B, qii, S: int):
    *lead, WINy, WINx = B.shape
    ar = torch.arange(S, device=B.device)
    q = qii.reshape(-1, 2)
    rows = (q[:, 1, None] + ar)[:, :, None]
    cols = (q[:, 0, None] + ar)[:, None, :]
    lin = (rows * WINx + cols).reshape(-1, S * S)
    return B.reshape(-1, WINy * WINx).gather(1, lin).reshape(*lead, S, S)


def _bil(block, fx, fy, P: int, ox: int, oy: int):
    y0, x0 = 1 + oy, 1 + ox
    w00 = block[..., y0: y0 + P, x0: x0 + P]
    w01 = block[..., y0: y0 + P, x0 + 1: x0 + P + 1]
    w10 = block[..., y0 + 1: y0 + P + 1, x0: x0 + P]
    w11 = block[..., y0 + 1: y0 + P + 1, x0 + 1: x0 + P + 1]
    fx = fx[..., None, None]
    fy = fy[..., None, None]
    return (w00 * (1.0 - fx) * (1.0 - fy) + w01 * fx * (1.0 - fy)
            + w10 * (1.0 - fx) * fy + w11 * fx * fy)


def lk_level(img0, img1, p0_l, v, iters: int, radius: int, min_det: float,
             margin: int = MARGIN):
    """``iters`` LK updates of the flows ``v`` (T,2) of the template
    positions ``p0_l`` (T,2) at one pyramid level."""
    P = 2 * radius + 1
    blk0, a0 = _load_blocks(img0, p0_l - radius, P, 0)
    blk1, a1 = _load_blocks(img1, p0_l + v - radius, P, margin)
    qii0, f0 = _qf(p0_l - radius, a0, P, blk0.shape[-1], blk0.shape[-2])
    tmpl = _bil(_sub_windows(blk0, qii0, P + 3), f0[..., 0], f0[..., 1],
                P, 0, 0)
    S = P + 3
    WINy1, WINx1 = blk1.shape[-2:]
    for _ in range(iters):
        qii, f = _qf(p0_l + v - radius - a1, 0.0, P, WINx1, WINy1)
        sub = _sub_windows(blk1, qii, S)
        fx, fy = f[..., 0], f[..., 1]
        cur = _bil(sub, fx, fy, P, 0, 0)
        gx = 0.5 * (_bil(sub, fx, fy, P, 1, 0) - _bil(sub, fx, fy, P, -1, 0))
        gy = 0.5 * (_bil(sub, fx, fy, P, 0, 1) - _bil(sub, fx, fy, P, 0, -1))
        r = tmpl - cur
        gxx = torch.sum(gx * gx, dim=(-2, -1))
        gxy = torch.sum(gx * gy, dim=(-2, -1))
        gyy = torch.sum(gy * gy, dim=(-2, -1))
        bx = torch.sum(gx * r, dim=(-2, -1))
        by = torch.sum(gy * r, dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        inv_det = torch.where(det.abs() > min_det, 1.0 / det,
                              torch.zeros_like(det))
        dvx = (gyy * bx - gxy * by) * inv_det
        dvy = (gxx * by - gxy * bx) * inv_det
        v = v + torch.stack([dvx, dvy], dim=-1)
    return v


def _track(pyr0, pyr1, pts, valid, levels, iters, radius, min_det=1e-4):
    v = torch.zeros_like(pts)
    for L in range(levels - 1, -1, -1):
        v = lk_level(pyr0[L], pyr1[L], pts / float(2 ** L), v, iters, radius,
                     min_det)
        if L > 0:
            v = v * 2.0
    new = pts + v
    H, W = pyr1[0].shape
    b = float(radius)
    inb = ((new[:, 0] >= b) & (new[:, 0] < W - b) & (new[:, 1] >= b)
           & (new[:, 1] < H - b))
    return new, valid & inb


@torch.no_grad()
def track_fb(pyr0, pyr1, pts, valid, levels: int, iters: int, radius: int,
             fb_thresh: float):
    """Forward positions (T,2) and the forward-backward gate (T,) of the
    tracks ``pts`` (T,2) with mask ``valid`` (T,) from pyramid ``pyr0``
    to ``pyr1``."""
    pts = pts.to(torch.float32)
    fwd, ok_f = _track(pyr0, pyr1, pts, valid, levels, iters, radius)
    back, ok_b = _track(pyr1, pyr0, fwd, ok_f, levels, iters, radius)
    fb = torch.linalg.vector_norm(back - pts, dim=-1)
    return fwd, ok_f & ok_b & (fb < fb_thresh)


# ---------------------------------------------------------------------------
# the exported sequence against the renderer's ground truth
# ---------------------------------------------------------------------------


def read_centres(path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(kf_ids, frame indices, centres (N,3)) of a keyframe-centres CSV."""
    rows = [ln.split(",") for ln in Path(path).read_text().splitlines()[1:]
            if ln.strip()]
    kf = np.array([int(r[0]) for r in rows], np.int64)
    fr = np.array([int(r[1]) for r in rows], np.int64)
    C = np.array([[float(r[3]), float(r[4]), float(r[5])] for r in rows],
                 np.float64).reshape(-1, 3)
    return kf, fr, C


def read_edges(path) -> list[tuple[int, int, str, np.ndarray, np.ndarray]]:
    """(i, j, kind, rvec, t) of each pose-graph edge (x_j = R_ji x_i +
    t_ji, R_ji = exp(rvec))."""
    out = []
    for ln in Path(path).read_text().splitlines()[1:]:
        if not ln.strip():
            continue
        r = ln.split(",")
        out.append((int(r[0]), int(r[1]), r[2],
                    np.array([float(x) for x in r[3:6]]),
                    np.array([float(x) for x in r[6:9]])))
    return out


def read_ply(path) -> np.ndarray:
    """The (N,3) vertices of an ASCII PLY point cloud."""
    lines = Path(path).read_text().splitlines()
    n, start = 0, 0
    for i, line in enumerate(lines):
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        if line.strip() == "end_header":
            start = i + 1
            break
    if n == 0:
        return np.zeros((0, 3))
    return np.loadtxt(lines[start: start + n], ndmin=2)[:, :3]


def sim3_align(src: np.ndarray, dst: np.ndarray):
    """Umeyama: (s, R, t) with dst ~ s R src + t, least squares."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.ones(3)
    D[2] = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    R = U @ np.diag(D) @ Vt
    s = float((S * D).sum() / max((xs * xs).sum() / len(src), 1e-18))
    return s, R, mu_d - s * R @ mu_s


def ate_ratio(est: np.ndarray, gt: np.ndarray) -> float:
    """Sim(3)-aligned RMSE of ``est`` against ``gt`` over the largest
    distance of a GT centre from their mean."""
    s, R, t = sim3_align(est, gt)
    err = np.linalg.norm(s * est @ R.T + t - gt, axis=1)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    return float(np.sqrt(np.mean(err ** 2)) / extent)


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + Kx
    Kx = Kx / th
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _angle_deg(R: np.ndarray) -> float:
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def edge_rot_deg(edges, kf_frame: dict, gt_R: np.ndarray) -> np.ndarray:
    """Rotation error (degrees) of each edge i -> j against the ground
    truth relative rotation of the keyframes' frames."""
    out = []
    for i, j, _, rvec, _ in edges:
        Ri, Rj = gt_R[kf_frame[i]], gt_R[kf_frame[j]]
        out.append(_angle_deg(_so3_exp(rvec) @ (Rj @ Ri.T).T))
    return np.array(out)


def cylinder_rel(points: np.ndarray, est_C: np.ndarray, gt_C: np.ndarray,
                 radius: float) -> np.ndarray:
    """| r - radius | / radius of each map point, carried into the ground
    truth frame by the Sim(3) that aligns the keyframe centres; r is the
    distance from the cylinder's axis (the world z axis)."""
    s, R, t = sim3_align(est_C, gt_C)
    X = s * points @ R.T + t
    return np.abs(np.hypot(X[:, 0], X[:, 1]) - radius) / radius
