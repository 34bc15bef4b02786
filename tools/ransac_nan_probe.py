"""LO-RANSAC falling back to its raw count-best hypothesis when a polished
candidate goes NaN, in the JAX package and in the port, on the CPU.

``find_E_ransac`` (both packages) polishes its 16 LO-RANSAC starts by
Gauss-Newton.  A start whose inlier set has shrunk to a track or two leaves
a 5x5 normal matrix of rank one or two plus the 1e-8 damping, whose
float32 Cholesky can return NaN.  The NaN candidate counts 0 cheirality
votes of 0 available, so it passes the gate (0 >= 0.9 x 0), and its NaN
cost wins the argmin; the solve then keeps no inlier and falls back to the
raw count-best hypothesis, which on a narrow field of view can be the
wrong motion (forward where the camera moved sideways).

This reproduces it on one frame pair: frames 0 and 1 of a 14-frame 320x240
ring whose steps alternate 6 and 2 degrees (texture blur 1.5, the camera
of tests/test_torch_loop.py), the tracks of either package's tracker
after its bootstrap (``--tracker``; 512 tracks, 4 levels; the two differ
by up to ~5e-5 px), the priorities of the JAX ``ScanSfM``'s first frame at
seed 12345, 256 hypotheses, Sampson 2e-5.  It solves the pair in both
packages once as tracked and then ``--trials`` times with each track
coordinate moved by -2..2 float32 ulps (``np.random.default_rng(1)``),
and prints one JSON line: per package the solves whose translation is the
forward one (|t_z| > 0.5) and, for the port, the solves in which a
polished candidate was NaN.  Which inputs trip it differs between the
packages (the port writes the Gauss-Newton Jacobian out, JAX takes it by
forward-mode differentiation, and the rank-one normal matrix's Cholesky
turns their last-bit differences into NaN or not), so each package shows
it on some inputs.

    JAX_PLATFORMS=cpu python tools/ransac_nan_probe.py \
        [--tracker port|jax] [--trials 200]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sfm_tpu.ops import epipolar as jep  # noqa: E402
from sfm_tpu_torch import config  # noqa: E402
from sfm_tpu_torch.models import scan_pipeline as sp, tracker  # noqa: E402
from sfm_tpu_torch.ops import epipolar as tep  # noqa: E402
from sfm_tpu_torch.utils.dataset import TempleRing  # noqa: E402
from sfm_tpu_torch.utils.synthetic import (SyntheticRingSpec,  # noqa: E402
                                           generate_dataset)
from tools import jax_draws  # noqa: E402

SEED, H, T = 12345, 256, 512


def pair_tracks(root: Path, which: str = "port"):
    """The ring's K and the tracks frame 0 -> 1 of ``which`` package's
    tracker: (K, prev, cur, matched) as numpy."""
    steps = ([6.0, 2.0] * 14)[:13]
    spec = SyntheticRingSpec(
        n_frames=14, width=320, height=240, fx=1100.0 * 320 / 480,
        fy=1100.0 * 320 / 480, texture_blur=1.5,
        path_lons_deg=tuple(np.concatenate([[0.0], np.cumsum(steps)])))
    generate_dataset(root, spec)
    ds = TempleRing.from_dir(root)
    if which == "jax":
        from sfm_tpu import config as jconfig
        from sfm_tpu.models import scan_pipeline as jsp, tracker as jtr

        cfg = jconfig.SystemConfig(
            frames=14, klt=jconfig.KLTConfig(
                max_tracks=T, min_tracks=300, pyr_levels=4, win_radius=6,
                iters=16, min_distance=8))
        carry = jsp.bootstrap_carry(cfg, 16, 4096, ds.load_gray(0), 0,
                                    jax.random.PRNGKey(SEED))
        pyr = jsp._build_pyr(jnp.asarray(ds.load_gray(1)), 4)
        trk, prev, matched = jtr.step(carry.prev_pyr, pyr, carry.trk,
                                      cfg.klt)
        return (np.asarray(ds.K, np.float32), np.asarray(prev),
                np.asarray(trk.pos), np.asarray(matched))
    cfg = config.SystemConfig(
        frames=14, klt=config.KLTConfig(max_tracks=T, min_tracks=300,
                                        pyr_levels=4, win_radius=6,
                                        iters=16, min_distance=8))
    with torch.no_grad():
        carry = sp.bootstrap_carry(cfg, 16, 4096,
                                   torch.as_tensor(np.array(ds.load_gray(0))),
                                   0, device="cpu")
        pyr = sp._build_pyr(torch.as_tensor(np.array(ds.load_gray(1))), 4)
        trk, prev, matched = tracker.step(carry.prev_pyr, pyr, carry.trk,
                                          cfg.klt, device="cpu")
    return (np.asarray(ds.K, np.float32), prev.numpy(), trk.pos.numpy(),
            matched.numpy())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--tracker", choices=("port", "jax"), default="port",
                    help="whose tracker makes the tracks")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="ransac_probe_") as tmp:
        K, prev, cur, matched = pair_tracks(Path(tmp), args.tracker)
    _, k1, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    pri = torch.as_tensor(jax_draws.scan_draws(SEED, H, T)(1)[0])
    Kj, Kt = jnp.asarray(K), torch.as_tensor(K)
    solve_j = jax.jit(lambda a, b, m: jep.find_E_ransac(
        k1, jep.normalize_by_K(Kj, a), jep.normalize_by_K(Kj, b), m,
        num_hypotheses=H, sampson_thresh=2e-5, min_inliers=30).t)
    polish, nan_seen = tep._polish_rt, []

    def polish_watched(*a, **k):
        R, t = polish(*a, **k)
        nan_seen.append(bool(torch.isnan(t).any()))
        return R, t

    def solve_t(b):
        nan_seen.clear()
        with torch.no_grad():
            t = tep.find_E_ransac(
                None, tep.normalize_by_K(Kt, torch.as_tensor(prev)),
                tep.normalize_by_K(Kt, torch.as_tensor(b)),
                torch.as_tensor(matched), num_hypotheses=H,
                sampson_thresh=2e-5, min_inliers=30, pri=pri).t
        return t.numpy(), any(nan_seen)

    tep._polish_rt = polish_watched
    rng = np.random.default_rng(1)
    rows = []
    for trial in range(args.trials + 1):
        b = cur
        if trial:
            d = rng.integers(-2, 3, cur.shape)
            b = cur.copy()
            for _ in range(2):
                step = np.where(np.abs(d) > 0, np.sign(d), 0)
                b = np.where(step != 0, np.nextafter(
                    b, np.where(step > 0, np.inf, -np.inf)), b).astype(
                        np.float32)
                d = d - step
        tj = np.asarray(solve_j(jnp.asarray(prev), jnp.asarray(b),
                                jnp.asarray(matched)))
        tt, nan = solve_t(b)
        rows.append((abs(float(tj[2])) > 0.5, abs(float(tt[2])) > 0.5, nan))
    tep._polish_rt = polish
    r = np.array(rows[1:])
    print(json.dumps({
        "pair": "frames 0-1", "tracker": args.tracker,
        "tracks_matched": int(matched.sum()),
        "unperturbed": {"jax_forward": bool(rows[0][0]),
                        "port_forward": bool(rows[0][1]),
                        "port_nan_candidate": bool(rows[0][2])},
        "trials": args.trials, "jax_forward": int(r[:, 0].sum()),
        "port_forward": int(r[:, 1].sum()),
        "port_nan_candidate": int(r[:, 2].sum()),
        "port_forward_with_nan": int((r[:, 1] & r[:, 2]).sum()),
        "both_forward": int((r[:, 0] & r[:, 1]).sum())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
