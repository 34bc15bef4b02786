"""Synthetic TempleRing-style dataset generator with exact ground truth.

The reference ships the Middlebury TempleRing images + ``templeR_par.txt``
(absent from this mount); this module renders a drop-in replacement: a
textured cylinder viewed from a ring of calibrated cameras, written out in
the exact Middlebury layout (PNG/PGM images + par/ang files) so the full
pipeline, the eval tools, and the benchmarks all run against known-exact
ground truth. Geometry conventions match ref py:153-166 (x ~ K(RX+t),
R,t world→camera).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticRingSpec:
    n_frames: int = 12
    width: int = 640
    height: int = 480
    fx: float = 1520.0
    fy: float = 1520.0
    cylinder_radius: float = 0.10
    cylinder_zmin: float = -0.10
    cylinder_zmax: float = 0.10
    ring_radius: float = 0.60
    ring_z: float = 0.05
    arc_deg: float = 360.0  # total camera arc; 47-frame temple covers full ring
    # optional explicit longitude path (degrees); overrides arc_deg/n_frames
    # spacing — e.g. an out-and-back path for loop-closure tests
    path_lons_deg: tuple | None = None
    texture_size: int = 1024
    texture_blur: float = 2.0
    # "noise": three-octave blurred random field (dense corner coverage;
    # the bench default). "structured": quasi-periodic theta bands +
    # large albedo patches + a small fine octave — the 32x32 global loop
    # descriptor (ref cpp:1100-1129) then scores >=0.94 at a true ring
    # revisit, like the reference's real temple images at its stock
    # loop gate (cpp:1827-1831), while mid-ring pairs stay well below.
    texture_kind: str = "noise"
    seed: int = 7
    background: int = 110  # near the texture mean: keeps the silhouette
    # (a depth-discontinuity curve whose "corners" are not fixed 3D
    # points) from dominating the corner detector
    noise_std: float = 1.5  # sensor noise (intensity levels); also keeps
    # eight-point E matrices away from exact rank-2 degeneracy, which the
    # reference C++ svd3 (cpp:537-593) cannot handle (divides by s3≈0)


def _look_at_wc(C: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World→camera rotation for a camera at C looking at target
    (camera x right, y down, z forward)."""
    z = target - C
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(z, up)) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def _make_texture(spec: SyntheticRingSpec) -> np.ndarray:
    """Smooth high-contrast random texture (θ-periodic) for stable LK."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(spec.seed)
    W = spec.texture_size
    H = spec.texture_size // 2
    # three octaves: fine (LK gradients), medium (corner structure),
    # coarse (large-scale shading) — keeps interior corners stronger than
    # the object silhouette so detectors don't collapse onto the
    # (geometrically degenerate) boundary
    tex = gaussian_filter(rng.standard_normal((H, W)), spec.texture_blur, mode="wrap")
    medium = gaussian_filter(rng.standard_normal((H, W)), spec.texture_blur * 3, mode="wrap")
    coarse = gaussian_filter(rng.standard_normal((H, W)), spec.texture_blur * 8, mode="wrap")
    tex = tex + 2.5 * medium + 3.0 * coarse
    lo, hi = np.percentile(tex, [1, 99])
    tex = np.clip((tex - lo) / (hi - lo), 0.0, 1.0)
    return (25.0 + 210.0 * tex).astype(np.float64)


def _make_texture_structured(spec: SyntheticRingSpec) -> np.ndarray:
    """Structured (quasi-periodic) cylinder texture.

    Variance is dominated by low-frequency theta bands (incommensurate
    harmonics k=3,5,7 with random phases, z-modulated) plus large albedo
    patches, so two views of the same longitude correlate ~0.99 at 32x32
    thumbnail scale while views >=45 deg apart fall below ~0.7 — the
    regime the reference's stock 0.94 loop-closure gate was tuned for on
    real temple images (ref cpp:1827-1831). A small-amplitude fine octave
    keeps Shi-Tomasi corners and LK gradients alive without diluting the
    descriptor (fine variance fraction ~6%)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(spec.seed)
    W = spec.texture_size
    H = spec.texture_size // 2
    th = (np.arange(W) + 0.5) / W * 2.0 * np.pi
    zz = (np.arange(H) + 0.5) / H
    bands = np.zeros((H, W))
    for k, a in ((3, 1.0), (5, 0.8), (7, 0.6)):
        ph = rng.uniform(0, 2 * np.pi)
        phz = rng.uniform(0, 2 * np.pi)
        bands += a * np.cos(k * th[None, :] + ph) * (
            0.6 + 0.4 * np.cos(2 * np.pi * 2 * zz[:, None] + phz))
    bands /= bands.std()
    blobs = gaussian_filter(rng.standard_normal((H, W)), 48, mode="wrap")
    blobs /= blobs.std()
    med = gaussian_filter(rng.standard_normal((H, W)),
                          spec.texture_blur * 4, mode="wrap")
    med /= med.std()
    fine = gaussian_filter(rng.standard_normal((H, W)),
                           spec.texture_blur, mode="wrap")
    fine /= fine.std()
    tex = 1.0 * bands + 0.8 * blobs + 0.35 * med + 0.25 * fine
    lo, hi = np.percentile(tex, [1, 99])
    tex = np.clip((tex - lo) / (hi - lo), 0.0, 1.0)
    return (25.0 + 210.0 * tex).astype(np.float64)


def make_ring_cameras(spec: SyntheticRingSpec):
    """Returns (K, R_list, t_list, centers, lons) — R,t world→camera."""
    K = np.array(
        [
            [spec.fx, 0.0, spec.width / 2.0 - 0.5],
            [0.0, spec.fy, spec.height / 2.0 - 0.5],
            [0.0, 0.0, 1.0],
        ]
    )
    target = np.zeros(3)
    Rs, ts, Cs, lons = [], [], [], []
    n = len(spec.path_lons_deg) if spec.path_lons_deg is not None else spec.n_frames
    for i in range(n):
        if spec.path_lons_deg is not None:
            phi = np.deg2rad(spec.path_lons_deg[i])
        else:
            phi = np.deg2rad(spec.arc_deg) * i / max(spec.n_frames, 1)
        C = np.array(
            [
                spec.ring_radius * np.cos(phi),
                spec.ring_radius * np.sin(phi),
                spec.ring_z,
            ]
        )
        R = _look_at_wc(C, target)
        t = -R @ C
        Rs.append(R)
        ts.append(t)
        Cs.append(C)
        lons.append(np.rad2deg(phi) - 180.0)
    return K, np.stack(Rs), np.stack(ts), np.stack(Cs), np.array(lons)


def render_frame(spec: SyntheticRingSpec, K, R, t, texture) -> np.ndarray:
    """Ray-cast the textured cylinder for one camera; returns uint8 image."""
    H, W = spec.height, spec.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    Kinv = np.linalg.inv(K)
    d_cam = np.stack([u.ravel(), v.ravel(), np.ones(H * W)], axis=0)  # (3,HW)
    d_cam = Kinv @ d_cam
    d_world = R.T @ d_cam  # (3,HW)
    C = -R.T @ t  # camera center

    dx, dy, dz = d_world
    a = dx * dx + dy * dy
    b = 2.0 * (C[0] * dx + C[1] * dy)
    c = C[0] * C[0] + C[1] * C[1] - spec.cylinder_radius**2
    disc = b * b - 4.0 * a * c
    hit = disc > 0.0
    sq = np.sqrt(np.maximum(disc, 0.0))
    tt = (-b - sq) / (2.0 * np.maximum(a, 1e-18))
    z_hit = C[2] + tt * dz
    valid = hit & (tt > 1e-6) & (z_hit >= spec.cylinder_zmin) & (z_hit <= spec.cylinder_zmax)

    x_hit = C[0] + tt * dx
    y_hit = C[1] + tt * dy
    theta = np.arctan2(y_hit, x_hit)  # [-pi, pi]
    th, tw = texture.shape
    tu = (theta + np.pi) / (2.0 * np.pi) * tw
    tv = (z_hit - spec.cylinder_zmin) / (spec.cylinder_zmax - spec.cylinder_zmin) * (th - 1)
    tv = np.clip(tv, 0.0, th - 1.001)

    u0 = np.floor(tu).astype(np.int64)
    v0 = np.floor(tv).astype(np.int64)
    fu = tu - u0
    fv = tv - v0
    u0 = np.mod(u0, tw)
    u1 = np.mod(u0 + 1, tw)
    v1 = np.minimum(v0 + 1, th - 1)
    val = (
        texture[v0, u0] * (1 - fu) * (1 - fv)
        + texture[v0, u1] * fu * (1 - fv)
        + texture[v1, u0] * (1 - fu) * fv
        + texture[v1, u1] * fu * fv
    )
    img = np.full(H * W, float(spec.background))
    img[valid] = val[valid]
    if spec.noise_std > 0:
        # deterministic per-view sensor noise (seeded from pose)
        nrng = np.random.default_rng(
            abs(hash((round(float(t[0]), 6), round(float(t[1]), 6), spec.seed)))
            % (2**32)
        )
        img = img + nrng.standard_normal(H * W) * spec.noise_std
    return np.clip(img, 0, 255).astype(np.uint8).reshape(H, W)


def generate_dataset(out_dir: str | Path, spec: SyntheticRingSpec | None = None,
                     write_png: bool = True, write_pgm: bool = False,
                     name_prefix: str = "synthR",
                     pgm_dir: str | Path | None = None) -> Path:
    """Render the full dataset into ``out_dir`` in Middlebury layout:
    ``{prefix}%04d.png`` images + ``{prefix}_par.txt`` + ``{prefix}_ang.txt``.
    With ``name_prefix='templeR'`` and ``pgm_dir=<root>/templeRing_pgm`` the
    output is a drop-in input for the reference C++ pipeline (which expects
    that exact layout, ref cpp:1678-1680). Returns out_dir."""
    from sfm_tpu_torch.utils.dataset import write_pgm as _write_pgm

    spec = spec or SyntheticRingSpec()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if pgm_dir is not None:
        pgm_dir = Path(pgm_dir)
        pgm_dir.mkdir(parents=True, exist_ok=True)
        write_pgm = True
    elif write_pgm:
        pgm_dir = out / "templeRing_pgm"
        pgm_dir.mkdir(exist_ok=True)
    texture = (_make_texture_structured(spec)
               if spec.texture_kind == "structured" else _make_texture(spec))
    K, Rs, ts, Cs, lons = make_ring_cameras(spec)
    n_frames = len(Rs)

    par_lines = [str(n_frames)]
    ang_lines = []
    lat = -np.rad2deg(np.arctan2(spec.ring_z, spec.ring_radius))
    for i in range(n_frames):
        name = f"{name_prefix}{i + 1:04d}.png"
        img = render_frame(spec, K, Rs[i], ts[i], texture)
        if write_png:
            from PIL import Image

            Image.fromarray(img).save(out / name)
        if write_pgm:
            _write_pgm(pgm_dir / f"{name_prefix}{i + 1:04d}.pgm", img)
        vals = np.concatenate([K.ravel(), Rs[i].ravel(), ts[i]])
        par_lines.append(name + " " + " ".join(f"{x:.17g}" for x in vals))
        ang_lines.append(f"{lat:.6f} {lons[i]:.6f} {name}")

    (out / f"{name_prefix}_par.txt").write_text("\n".join(par_lines) + "\n")
    (out / f"{name_prefix}_ang.txt").write_text("\n".join(ang_lines) + "\n")
    return out
