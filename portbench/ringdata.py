"""The benchmark's own ring renderer: a frozen copy of the port's synthetic
TempleRing generator (``sfm_tpu_torch/utils/synthetic.py`` as the benchmark
was written), numpy, scipy and PIL only, so that a later change to the
program cannot move the data the benchmark measures with.

A textured cylinder is ray-cast from a ring of calibrated cameras and
written in the Middlebury TempleRing layout (``templeR0001.png`` ...,
``templeR_par.txt``, ``templeR_ang.txt``), which the port reads through
its own loader.  The camera paths are those of the JAX bench and the smoke
run: a uniform arc (``arc``), the alternating small/large steps of the
dense variant (``alternating``), and any explicit list (``lons``).

``tests/test_portbench_data.py`` holds this copy byte for byte to the
program's generator.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class RingSpec:
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
    arc_deg: float = 360.0
    path_lons_deg: tuple | None = None
    texture_size: int = 1024
    texture_blur: float = 2.0
    texture_kind: str = "noise"
    seed: int = 7
    background: int = 110
    noise_std: float = 1.5


def _look_at_wc(C: np.ndarray, target: np.ndarray) -> np.ndarray:
    z = target - C
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(z, up)) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def _make_texture(spec: RingSpec) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(spec.seed)
    W = spec.texture_size
    H = spec.texture_size // 2
    tex = gaussian_filter(rng.standard_normal((H, W)), spec.texture_blur,
                          mode="wrap")
    medium = gaussian_filter(rng.standard_normal((H, W)),
                             spec.texture_blur * 3, mode="wrap")
    coarse = gaussian_filter(rng.standard_normal((H, W)),
                             spec.texture_blur * 8, mode="wrap")
    tex = tex + 2.5 * medium + 3.0 * coarse
    lo, hi = np.percentile(tex, [1, 99])
    tex = np.clip((tex - lo) / (hi - lo), 0.0, 1.0)
    return (25.0 + 210.0 * tex).astype(np.float64)


def _make_texture_structured(spec: RingSpec) -> np.ndarray:
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


def texture(spec: RingSpec) -> np.ndarray:
    return (_make_texture_structured(spec)
            if spec.texture_kind == "structured" else _make_texture(spec))


def ring_cameras(spec: RingSpec):
    """(K, R (N,3,3), t (N,3), centres (N,3), longitudes): R, t world ->
    camera, x ~ K (R X + t)."""
    K = np.array([[spec.fx, 0.0, spec.width / 2.0 - 0.5],
                  [0.0, spec.fy, spec.height / 2.0 - 0.5],
                  [0.0, 0.0, 1.0]])
    target = np.zeros(3)
    Rs, ts, Cs, lons = [], [], [], []
    n = (len(spec.path_lons_deg) if spec.path_lons_deg is not None
         else spec.n_frames)
    for i in range(n):
        if spec.path_lons_deg is not None:
            phi = np.deg2rad(spec.path_lons_deg[i])
        else:
            phi = np.deg2rad(spec.arc_deg) * i / max(spec.n_frames, 1)
        C = np.array([spec.ring_radius * np.cos(phi),
                      spec.ring_radius * np.sin(phi), spec.ring_z])
        R = _look_at_wc(C, target)
        Rs.append(R)
        ts.append(-R @ C)
        Cs.append(C)
        lons.append(np.rad2deg(phi) - 180.0)
    return K, np.stack(Rs), np.stack(ts), np.stack(Cs), np.array(lons)


def render_frame(spec: RingSpec, K, R, t, tex) -> np.ndarray:
    """Ray-cast the textured cylinder for one camera: (H,W) uint8."""
    H, W = spec.height, spec.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    d_cam = np.linalg.inv(K) @ np.stack([u.ravel(), v.ravel(),
                                         np.ones(H * W)], axis=0)
    d_world = R.T @ d_cam
    C = -R.T @ t
    dx, dy, dz = d_world
    a = dx * dx + dy * dy
    b = 2.0 * (C[0] * dx + C[1] * dy)
    c = C[0] * C[0] + C[1] * C[1] - spec.cylinder_radius ** 2
    disc = b * b - 4.0 * a * c
    hit = disc > 0.0
    sq = np.sqrt(np.maximum(disc, 0.0))
    tt = (-b - sq) / (2.0 * np.maximum(a, 1e-18))
    z_hit = C[2] + tt * dz
    valid = (hit & (tt > 1e-6) & (z_hit >= spec.cylinder_zmin)
             & (z_hit <= spec.cylinder_zmax))
    x_hit = C[0] + tt * dx
    y_hit = C[1] + tt * dy
    theta = np.arctan2(y_hit, x_hit)
    th, tw = tex.shape
    tu = (theta + np.pi) / (2.0 * np.pi) * tw
    tv = ((z_hit - spec.cylinder_zmin)
          / (spec.cylinder_zmax - spec.cylinder_zmin) * (th - 1))
    tv = np.clip(tv, 0.0, th - 1.001)
    u0 = np.floor(tu).astype(np.int64)
    v0 = np.floor(tv).astype(np.int64)
    fu = tu - u0
    fv = tv - v0
    u0 = np.mod(u0, tw)
    u1 = np.mod(u0 + 1, tw)
    v1 = np.minimum(v0 + 1, th - 1)
    val = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
           + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)
    img = np.full(H * W, float(spec.background))
    img[valid] = val[valid]
    if spec.noise_std > 0:
        # per-view sensor noise, seeded from the pose (as the program's
        # generator does: hash() of floats and ints is stable across runs)
        nrng = np.random.default_rng(
            abs(hash((round(float(t[0]), 6), round(float(t[1]), 6),
                      spec.seed))) % (2 ** 32))
        img = img + nrng.standard_normal(H * W) * spec.noise_std
    return np.clip(img, 0, 255).astype(np.uint8).reshape(H, W)


def write_pngs(out_dir, spec: RingSpec, frames, tex=None) -> None:
    """Render the cameras ``frames`` of ``spec`` to ``templeR%04d.png``
    files in ``out_dir`` (numbered as the ring numbers them), on the
    texture ``tex`` (made from ``spec`` where not given)."""
    from PIL import Image

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tex = texture(spec) if tex is None else tex
    K, Rs, ts, _, _ = ring_cameras(spec)
    for i in frames:
        Image.fromarray(render_frame(spec, K, Rs[i], ts[i], tex)).save(
            out / f"templeR{int(i) + 1:04d}.png")


def write_par(out_dir, spec: RingSpec, frames) -> None:
    """``templeR_par.txt`` and ``templeR_ang.txt`` of the cameras
    ``frames``, in the Middlebury layout."""
    out = Path(out_dir)
    K, Rs, ts, _, lons = ring_cameras(spec)
    par_lines = [str(len(frames))]
    ang_lines = []
    lat = -np.rad2deg(np.arctan2(spec.ring_z, spec.ring_radius))
    for i in frames:
        name = f"templeR{int(i) + 1:04d}.png"
        vals = np.concatenate([K.ravel(), Rs[i].ravel(), ts[i]])
        par_lines.append(name + " " + " ".join(f"{x:.17g}" for x in vals))
        ang_lines.append(f"{lat:.6f} {lons[i]:.6f} {name}")
    (out / "templeR_par.txt").write_text("\n".join(par_lines) + "\n")
    (out / "templeR_ang.txt").write_text("\n".join(ang_lines) + "\n")


def _png_job(args):
    write_pngs(*args)


def write_rings(rings, processes: int = 1) -> None:
    """Write each ring (out_dir, spec, frames) in the Middlebury layout.
    With ``processes`` > 1 each ring's texture is made in one spawned
    process and its frames rendered in that many (split by frame), all
    joined before this returns."""
    if processes <= 1:
        for d, spec, fr in rings:
            write_pngs(d, spec, fr)
    else:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(processes) as pool:
            texs = pool.map(texture, [spec for _, spec, _ in rings])
            pool.map(_png_job, [
                (d, spec, list(fr[k::processes]), tex)
                for (d, spec, fr), tex in zip(rings, texs)
                for k in range(processes) if len(fr[k::processes])])
    for d, spec, fr in rings:
        write_par(d, spec, fr)


# ---------------------------------------------------------------------------
# camera paths (the traffic files name one and its parameters)
# ---------------------------------------------------------------------------


def alternating_lons(frames: int, small_deg: float,
                     large_first: bool = False) -> np.ndarray:
    """The dense variant's longitudes (bench.py ``bench_dense_variant``,
    ``chip_smoke.stockgate_lons``): steps alternating ``small_deg`` and a
    large step chosen so that the path ends at 360 degrees."""
    a = float(small_deg)
    n_inc = frames - 1
    n_first, n_second = (n_inc + 1) // 2, n_inc // 2
    n_large, n_small = ((n_first, n_second) if large_first
                        else (n_second, n_first))
    b = (360.0 - n_small * a) / n_large
    pattern = ([b, a] if large_first else [a, b]) * ((n_inc + 1) // 2)
    return np.concatenate([[0.0], np.cumsum(pattern[:n_inc])])


def ring_spec(render: dict, path: dict, seed: int) -> RingSpec:
    """The RingSpec of a configuration's ``render`` block (camera, object,
    texture) on a traffic file's ``path``, texture seed ``seed``."""
    kind = path["type"]
    spec = RingSpec(**render, seed=int(seed))
    if kind == "arc":
        return dataclasses.replace(spec, n_frames=int(path["frames"]),
                                   arc_deg=float(path["arc_deg"]))
    if kind == "alternating":
        lons = alternating_lons(int(path["frames"]), path["small_deg"],
                                bool(path.get("large_first", False)))
    elif kind == "lons":
        lons = np.asarray(path["lons_deg"], np.float64)
    else:
        raise ValueError(f"unknown camera path type {kind!r}")
    return dataclasses.replace(spec, n_frames=len(lons),
                               path_lons_deg=tuple(float(x) for x in lons))
