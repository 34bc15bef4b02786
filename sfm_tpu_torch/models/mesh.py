"""Geometry export models: sparse Delaunay mesh + dense stereo grid mesh.

Counterpart of sfm_tpu/models/mesh.py.

Sparse mesh (reference: cpp/src/templering_sfm.cpp:1245-1461, the
hand-rolled Bowyer-Watson ``delaunay_triangulate_2d`` +
``build_mesh_from_sparse_points``): the irregular triangulation stays on
the host in numpy, with scipy.spatial.Delaunay (Qhull); the same code as
the JAX twin, so the same vertices and faces bit for bit.

Dense stereo mesh (reference: python/src/templering_sfm.py:1099-1266 —
cv2.stereoRectify + StereoSGBM + reprojectImageTo3D + subsampled grid):
rectification is a pair of rotation homographies applied by bilinear warp,
matching cost is a (D,H,W) SAD volume of box-filtered absolute-difference
planes, aggregated by 4-direction semi-global scans, then winner-take-all
with parabolic subpixel refinement and left-right consistency gating.
Plain PyTorch in float32 on the images' device (the JAX twin writes it as
XLA ops and a ``lax.scan``; it reaches no Pallas kernel).  The grid
vertices and quad faces are host numpy, as in the twin.

The box sums are the direct shifted adds of ``image.box_filter``, not the
twin's cumulative-sum differences: across the 1e6 wrapped-column sentinel
those sums reach ~7e8 in float32 (ulp 64), so the twin's valid costs carry
absolute errors of tens of units; here they are exact to float32 rounding.
The two agree on the disparity up to that noise (and to argmin ties on
flat, untextured regions).
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.ops import image as im
from sfm_tpu_torch.utils import debug
from sfm_tpu_torch.utils.device import resolve

# ---------------------------------------------------------------------------
# sparse Delaunay mesh (cpp semantics)
# ---------------------------------------------------------------------------


def build_sparse_mesh(K, kf, points_xyz, max_points: int = 2500,
                      grid_px: int = 4, max_edge_px: float = 80.0,
                      seed: int = 42):
    """Project map points into keyframe ``kf``, grid-dedup, Delaunay,
    reject long-edged triangles. Returns (vertices_world (V,3),
    faces (F,3)). ref: cpp:1371-1461."""
    from scipy.spatial import Delaunay, QhullError

    R_wc, t_wc = kf.pose_wc
    X = np.asarray(points_xyz, np.float64)
    if len(X) < 3:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    Xc = X @ R_wc.T + t_wc
    z = Xc[:, 2]
    uvh = Xc @ np.asarray(K, np.float64).T
    uv = uvh[:, :2] / np.where(np.abs(uvh[:, 2:3]) < 1e-12, 1e-12,
                               uvh[:, 2:3])
    H, W = 2.0 * K[1, 2], 2.0 * K[0, 2]
    ok = ((z > 1e-6) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
          & (uv[:, 1] < H))
    idx = np.nonzero(ok)[0]
    if len(idx) < 3:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # grid-cell dedup with seeded shuffle (ref cpp:1412-1438)
    rng = np.random.default_rng(seed)
    order = rng.permutation(idx)
    seen: dict[tuple, int] = {}
    for i in order:
        cell = (int(uv[i, 0] // grid_px), int(uv[i, 1] // grid_px))
        if cell not in seen:
            seen[cell] = i
        if len(seen) >= max_points:
            break
    keep = np.array(sorted(seen.values()))
    pts2 = uv[keep]
    try:
        tri = Delaunay(pts2)
    except QhullError:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    faces = tri.simplices
    # reject triangles with any pixel edge > max_edge_px (ref cpp:1449-1459)
    a, b, c = pts2[faces[:, 0]], pts2[faces[:, 1]], pts2[faces[:, 2]]
    ok_f = (
        (np.linalg.norm(a - b, axis=1) <= max_edge_px)
        & (np.linalg.norm(b - c, axis=1) <= max_edge_px)
        & (np.linalg.norm(c - a, axis=1) <= max_edge_px)
    )
    return X[keep], faces[ok_f]


# ---------------------------------------------------------------------------
# dense stereo grid mesh (python semantics, batched block matcher)
# ---------------------------------------------------------------------------


def _rectify_rotations(R_ji, t_ji):
    """Minimal stereoRectify: rotations R1,R2 bringing both cameras to a
    common fronto-parallel frame with baseline along +x
    (cv2.stereoRectify's core geometry, ref py:1148-1152)."""
    t = t_ji / (np.linalg.norm(t_ji) + 1e-18)
    # new x-axis along the baseline (cam1 -> cam2 direction in cam1 frame
    # is -R_ji^T t_ji)
    e1 = -R_ji.T @ t
    e1 = e1 / np.linalg.norm(e1)
    z = np.array([0.0, 0.0, 1.0])
    e2 = np.cross(z, e1)
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 = e2 / n2
    e3 = np.cross(e1, e2)
    R_rect = np.stack([e1, e2, e3])  # cam1 -> rectified
    R1 = R_rect
    R2 = R_rect @ R_ji.T
    return R1, R2


_COST_INVALID = 1e6  # wrapped-region sentinel, pre-aggregation


def _sgm_scan(vol_nhd, P1: float, P2: float, reverse: bool = False):
    """One-direction semi-global aggregation (the SGM recurrence of
    StereoSGBM, ref py:1168-1182) along the leading axis of a
    (N,H,D)-ordered cost volume (any strides), first to last or, with
    ``reverse``, last to first:

      L(p,d) = C(p,d) + min(L(q,d), L(q,d±1)+P1, min_d' L(q,d')+P2)
                      - min_d' L(q,d')

    Each step writes into one preallocated (N,H,D+2) buffer whose two
    edge lanes hold +inf (the twin's ``inf`` concat), so L(q,d±1) are
    views.  Returns the (N,H,D) view of it."""
    N, H, D = vol_nhd.shape
    with debug.nan_ok():  # the +inf edge lanes: never an output value
        buf = torch.full((N, H, D + 2), float("inf"), dtype=vol_nhd.dtype,
                         device=vol_nhd.device)
    out = buf[..., 1:-1]
    steps = range(N - 1, -1, -1) if reverse else range(N)
    first = steps[0]
    out[first] = vol_nhd[first]
    prev = first
    for n in steps[1:]:
        Lp = out[prev]
        m = torch.amin(Lp, dim=-1, keepdim=True)  # (H,1)
        cand = torch.minimum(
            torch.minimum(Lp, m + P2),
            torch.minimum(buf[prev, :, :-2], buf[prev, :, 2:]) + P1,
        )
        torch.sub(vol_nhd[n] + cand, m, out=out[n])
        prev = n
    return out


def _sgm_aggregate(vol, P1: float, P2: float):
    """4-direction (left/right/up/down) semi-global sum over a (D,H,W)
    cost volume. Wrapped-region sentinel lanes keep their huge cost
    through the recurrence: L for an invalid lane stays ~_COST_INVALID
    (C dominates, and cand-m is bounded by the valid lanes' spread), so
    it never wins any min reduction — neither the normalizing m nor the
    d±1/P2 candidates of neighboring valid lanes. The sentinel is
    re-imposed exactly on the output.  The four directions are summed in
    the twin's order ((lr + rl) + (tb + bt)), with at most four volumes
    (the input among them) alive."""
    whd = vol.permute(2, 1, 0)  # (W,H,D) view
    agg = _sgm_scan(whd, P1, P2)  # left -> right
    agg += _sgm_scan(whd, P1, P2, reverse=True)  # right -> left
    hwd = vol.permute(1, 2, 0)  # (H,W,D) view
    aggv = _sgm_scan(hwd, P1, P2)  # top -> bottom
    aggv += _sgm_scan(hwd, P1, P2, reverse=True)  # bottom -> top
    out = agg.permute(2, 1, 0) + aggv.permute(2, 0, 1)
    return out.masked_fill_(vol >= _COST_INVALID, 4.0 * _COST_INVALID)


def _disparity_sad(img_l, img_r, num_disp: int, block_radius: int,
                   sgm: bool = True):
    """(H,W) float32 rectified pair -> (disparity (H,W) float32, lr_ok
    (H,W) bool), on the images' device. Replaces StereoSGBM
    (py:1168-1182): a (D,H,W) SAD volume of box-filtered absolute-
    difference planes, 4-direction semi-global aggregation (``sgm``;
    disable for the plain block matcher), winner-take-all with parabolic
    subpixel refinement, and left-right consistency gating derived from
    the same aggregated volume (vol_r[d,y,x] = vol_l[d,y,x+d])."""
    H, W = img_l.shape
    dev = img_l.device
    ds = torch.arange(num_disp, device=dev)[:, None]  # (D,1)
    xs = torch.arange(W, device=dev)[None, :]  # (1,W)
    # the right image rolled by d along x, one gather for all planes;
    # the wrapped columns x < d are held out with the sentinel
    src = torch.remainder(xs - ds, W)[:, None, :].expand(num_disp, H, W)
    shifted = torch.gather(img_r.expand(num_disp, H, W), 2, src)
    ad = torch.abs(img_l - shifted).masked_fill_(
        (xs < ds)[:, None, :], _COST_INVALID)  # (D,H,W)
    del shifted
    vol = im.box_filter(ad, block_radius)
    del ad
    if sgm:
        # cv2.StereoSGBM penalty convention: P1 = 8*blockSize^2,
        # P2 = 32*blockSize^2 (costs here are block SUMS of |dI|)
        win = float((2 * block_radius + 1) ** 2)
        vol = _sgm_aggregate(vol, 8.0 * win, 32.0 * win)
    best = torch.argmin(vol, dim=0)  # (H,W), first minimum
    dm1 = torch.clamp(best - 1, 0, num_disp - 1)
    dp1 = torch.clamp(best + 1, 0, num_disp - 1)

    def take(d_idx):
        return torch.gather(vol, 0, d_idx[None])[0]

    c0 = take(best)
    cm = take(dm1)
    cp = take(dp1)
    denom = cm + cp - 2.0 * c0
    curved = torch.abs(denom) > 1e-9  # the lanes that divide (no 0/0)
    sub = torch.where(
        curved, 0.5 * (cm - cp) / torch.where(curved, denom,
                                              torch.ones_like(denom)),
        torch.zeros_like(denom))
    disp = best.to(img_l.dtype) + torch.clamp(sub, -0.5, 0.5)

    # left-right consistency from the same (aggregated) volume:
    # vol_r[d, y, xr] = vol_l[d, y, xr + d]
    xl = torch.clamp(xs + ds, max=W - 1)[:, None, :]  # (D,1,W)
    best_r = torch.argmin(
        torch.gather(vol, 2, xl.expand(num_disp, H, W)), dim=0)
    xr = torch.clamp(xs - best, 0, W - 1)
    d_r = torch.gather(best_r, 1, xr)
    lr_ok = torch.abs(best - d_r) <= 1
    return disp, lr_ok


def _warp(img_u8, K, R_rect, device):
    """Inverse warp of an (H,W) image into the rectified frame: rectified
    pixel -> original pixel via the homography K R_rect^T K^{-1}, then
    bilinear sampling; float32 on ``device``."""
    H, W = img_u8.shape
    Hmat = torch.as_tensor(K @ R_rect.T @ np.linalg.inv(K),
                           dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    p = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1).reshape(-1, 3)
    q = p @ Hmat.T
    q = q[:, :2] / q[:, 2:3]
    img = torch.as_tensor(np.array(img_u8, np.float32), device=device)
    return im.bilinear(img, q).reshape(H, W)


def rectified_pair(K, kf1, kf2, img1_u8, img2_u8, device):
    """The keyframe pair rectified (ref py:1148-1152): (rect1, rect2) float32
    on ``device``, the rectifying rotation R1 of camera 1 and the
    baseline; None when the cameras coincide."""
    # relative pose cam1 -> cam2
    R_ji = kf2.R_cw.T @ kf1.R_cw
    Rwj, twj = kf2.pose_wc
    t_ji = Rwj @ kf1.t_cw + twj
    baseline = float(np.linalg.norm(t_ji))
    if baseline < 1e-9:
        return None
    Rr1, Rr2 = _rectify_rotations(R_ji, t_ji)
    K = np.asarray(K, np.float64)
    return (_warp(img1_u8, K, Rr1, device), _warp(img2_u8, K, Rr2, device),
            Rr1, baseline)


def export_stereo_grid_mesh(K, kf1, kf2, img1_u8, img2_u8, cfg,
                            device="cuda"):
    """Dense mesh from one rectified keyframe pair (ref py:1099-1266).

    Returns (vertices_world, faces). ``cfg`` is a StereoMeshConfig; the
    warp and the matcher run on ``device``."""
    pair = rectified_pair(K, kf1, kf2, img1_u8, img2_u8, resolve(device))
    if pair is None:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    rect1, rect2, Rr1, baseline = pair
    K = np.asarray(K, np.float64)
    H, W = img1_u8.shape

    num_disp = int(np.ceil(cfg.num_disparities / 16.0) * 16)
    block_r = max(int(cfg.block_size) // 2, 1)
    disp, lr_ok = _disparity_sad(rect1, rect2, num_disp, block_r,
                                 sgm=cfg.sgm)
    disp = disp.cpu().numpy()
    lr_ok = lr_ok.cpu().numpy()

    fx = K[0, 0]
    valid = lr_ok & (disp >= cfg.disp_min)
    z = np.where(valid, fx * baseline / np.maximum(disp, 1e-6), np.nan)
    zs = z[np.isfinite(z)]
    if zs.size == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    z_max = np.percentile(zs, cfg.z_max_percentile)  # ref py:1188-1194
    valid &= np.nan_to_num(z, nan=np.inf) <= z_max

    # subsampled grid vertices (ref py:1196-1216)
    step = max(int(cfg.step), 1)
    gy = np.arange(0, H, step)
    gx = np.arange(0, W, step)
    vid = -np.ones((len(gy), len(gx)), np.int64)
    verts_rect = []
    disp_grid = np.zeros((len(gy), len(gx)))
    for iy, y in enumerate(gy):
        for ix, x in enumerate(gx):
            if not valid[y, x]:
                continue
            d = disp[y, x]
            zz = fx * baseline / d
            X = (x - K[0, 2]) / fx * zz
            Y = (y - K[1, 2]) / K[1, 1] * zz
            vid[iy, ix] = len(verts_rect)
            verts_rect.append([X, Y, zz])
            disp_grid[iy, ix] = d
    if len(verts_rect) < 3:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts_rect = np.asarray(verts_rect)

    # quads -> 2 triangles with disparity-jump rejection (ref py:1222-1251)
    faces = []
    for iy in range(len(gy) - 1):
        for ix in range(len(gx) - 1):
            q = [vid[iy, ix], vid[iy, ix + 1], vid[iy + 1, ix],
                 vid[iy + 1, ix + 1]]
            if min(q) < 0:
                continue
            ds = [disp_grid[iy, ix], disp_grid[iy, ix + 1],
                  disp_grid[iy + 1, ix], disp_grid[iy + 1, ix + 1]]
            if max(ds) - min(ds) > cfg.disp_jump:
                continue
            faces.append([q[0], q[1], q[2]])
            faces.append([q[1], q[3], q[2]])
    faces = (np.asarray(faces, np.int64) if faces
             else np.zeros((0, 3), np.int64))

    # rectified cam1 -> cam1 -> world (ref py:1256-1261)
    verts_cam1 = verts_rect @ Rr1  # R1^T applied to rows
    verts_world = verts_cam1 @ kf1.R_cw.T + kf1.t_cw
    return verts_world, faces
