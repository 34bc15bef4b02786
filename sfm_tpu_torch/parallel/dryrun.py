"""Entry points of the parallel layer: the per-frame two-view stage, and a
multi-device dry run of every sharded program.

Counterpart of the JAX package's ``__graft_entry__.py``.  ``entry()``
returns the per-frame two-view stage (K-normalisation -> LO-RANSAC
essential matrix -> relative pose + parallax) with example tensors.
``dryrun_multichip(n)`` starts n ranks (one card each, or gloo ranks on
the CPU), builds the ``("scene", "hyp")`` mesh over them and runs, on tiny
shapes, the scene-sharded frame step (LK + LO-RANSAC + Schur-LM BA with
all-reduced metrics), the hypothesis-sharded RANSAC and the production
multi-scene program ``run_scenes_scan(mesh=...)`` on small synthetic
rings.

    python -m sfm_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sfm_tpu_torch.config import (BAConfig, KLTConfig, KeyframeConfig,
                                  LoopConfig, RansacConfig, SystemConfig)
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.ops import ba as ba_ops, epipolar, linalg
from sfm_tpu_torch.parallel import mesh as mesh_lib, multiscene
from sfm_tpu_torch.parallel.distributed import launch, scene_shard
from sfm_tpu_torch.parallel.multi_scan import run_scenes_scan, scene_seed
from sfm_tpu_torch.utils.device import resolve, to_device

# the multi-scene program's rings: frames, and the capacities of the run
RING_FRAMES = 9
RING_CHUNK = 4
RING_P_CAP = 2048
RING_P_BA = 256


def entry(device="cuda"):
    """The per-frame two-view stage and example arguments for it on
    ``device``: fn(gen, K, pts_i, pts_j, valid) -> (R, t, num_inliers,
    parallax), 512 correspondences, 256 hypotheses."""
    dev = resolve(device)
    N = 512
    H = 256

    def fn(gen, K, pts_i, pts_j, valid):
        xi = epipolar.normalize_by_K(K, pts_i)
        xj = epipolar.normalize_by_K(K, pts_j)
        rp = epipolar.find_E_ransac(
            gen, xi, xj, valid,
            num_hypotheses=H, sampson_thresh=2e-5, min_inliers=32,
        )
        flow = torch.linalg.vector_norm(pts_j - pts_i, dim=-1)
        parallax = torch.nan_to_num(linalg.nanmedian(
            torch.where(valid, flow, torch.full_like(flow, float("nan")))))
        return rp.R, rp.t, rp.num_inliers, parallax

    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, 3)) * 0.3 + np.array([0, 0, 4.0])
    Xj = X + np.array([0.3, 0.0, 0.0])
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]], np.float32)
    pi = (X[:, :2] / X[:, 2:3]) * 800.0 + np.array([320, 240])
    pj = (Xj[:, :2] / Xj[:, 2:3]) * 800.0 + np.array([320, 240])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    example_args = (
        gen,
        to_device(K, dev),
        to_device(pi.astype(np.float32), dev),
        to_device(pj.astype(np.float32), dev),
        torch.ones(N, dtype=torch.bool, device=dev),
    )
    return fn, example_args


def ring_config() -> SystemConfig:
    """The multi-scene program's configuration: the JAX dry run's (loop
    closure with the descriptor flavor, 256 tracks, 3 levels)."""
    return SystemConfig(
        frames=RING_FRAMES,
        klt=KLTConfig(max_tracks=256, min_tracks=150, pyr_levels=3,
                      win_radius=5, iters=8, min_distance=8),
        keyframe=KeyframeConfig(min_inliers=40, min_gap=1, parallax_px=5.0),
        ransac=RansacConfig(num_hypotheses=128, sampson_thresh=2e-5,
                            min_inliers=20),
        ba=BAConfig(window=4, iters=2, max_points=256, global_iters=3),
        loop=LoopConfig(enabled=True, method="descriptor"),
    )


def render_rings(root, n_scenes: int) -> list:
    """``n_scenes`` synthetic 320x240 rings of ``RING_FRAMES`` frames under
    ``root`` (texture seeds 7, 8, ...), as TempleRing handles."""
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import (SyntheticRingSpec,
                                               generate_dataset)

    dss = []
    for s in range(n_scenes):
        spec = SyntheticRingSpec(
            n_frames=RING_FRAMES, width=320, height=240, fx=760.0, fy=760.0,
            arc_deg=55.0, texture_blur=1.5, seed=7 + s)
        out = Path(root) / f"ring{s}"
        generate_dataset(out, spec)
        dss.append(TempleRing.from_dir(out))
    return dss


def _dryrun_rank(n_devices: int, device) -> dict:
    """One rank of ``dryrun_multichip``: every sharded program once."""
    hyp = 2 if (n_devices % 2 == 0 and n_devices >= 2) else 1
    mesh = mesh_lib.make_mesh(n_devices, hyp_axis=hyp, device=device)
    dev = mesh_lib.rank_device(mesh, device)
    S = mesh.size(0)
    rng = np.random.default_rng(0)  # the same batch on every rank

    # --- scene-sharded training step (dp over scenes) -------------------
    T, H, W = 64, 64, 96
    kcfg = KLTConfig(max_tracks=T, min_tracks=8, pyr_levels=2, win_radius=3,
                     iters=4)
    step = multiscene.make_scene_step(mesh, kcfg, num_hypotheses=64,
                                      ba_iters=2)
    imgs = rng.standard_normal((S, H, W)).astype(np.float32) * 40 + 128
    moved = np.roll(imgs, 1, axis=2)
    pyr0 = (scene_shard(mesh, imgs), scene_shard(mesh, imgs[:, ::2, ::2]))
    pyr1 = (scene_shard(mesh, moved), scene_shard(mesh, moved[:, ::2, ::2]))
    state = tracker.TrackerState(
        pos=scene_shard(mesh, rng.uniform(8, 56, (S, T, 2)).astype(
            np.float32)),
        valid=scene_shard(mesh, np.ones((S, T), bool)),
        ids=scene_shard(mesh, np.tile(np.arange(T, dtype=np.int32), (S, 1))),
        next_id=scene_shard(mesh, np.full((S,), T, np.int32)),
    )
    P_, M_ = 16, 64
    t_wc = np.zeros((S, 2, 3), np.float32)
    t_wc[:, 1, 0] = 0.5
    prob = ba_ops.BAProblem(
        R_wc=scene_shard(mesh, np.tile(np.eye(3, dtype=np.float32),
                                       (S, 2, 1, 1))),
        t_wc=scene_shard(mesh, t_wc),
        X=scene_shard(mesh, (rng.standard_normal((S, P_, 3)) * 0.3
                             + np.array([0, 0, 4.0])).astype(np.float32)),
        cam_idx=scene_shard(mesh, np.tile(np.arange(M_, dtype=np.int32) % 2,
                                          (S, 1))),
        pid_idx=scene_shard(mesh, np.tile(np.arange(M_, dtype=np.int32)
                                          % P_, (S, 1))),
        obs=scene_shard(mesh, np.zeros((S, M_, 2), np.float32)),
        obs_valid=scene_shard(mesh, np.ones((S, M_), bool)),
        point_valid=scene_shard(mesh, np.ones((S, P_), bool)),
    )
    gens = []
    for s in mesh_lib.local_scenes(mesh, S):
        g = torch.Generator(device=dev)
        g.manual_seed(scene_seed(0, s))
        gens.append(g)
    Kmat = torch.tensor([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]],
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        _, _, _, metrics = step(gens, Kmat, pyr0, pyr1, state, prob)

        # --- hypothesis-sharded RANSAC (tp-analogue over 'hyp') ---------
        if hyp > 1:
            X3 = rng.standard_normal((128, 3)) * 0.3 + np.array([0, 0, 4.0])
            Xr = X3 @ np.array([[1, 0, 0.02], [0, 1, 0],
                                [-0.02, 0, 1]]).T + np.array([0.2, 0, 0])
            xi = to_device((X3[:, :2] / X3[:, 2:3]).astype(np.float32), dev)
            xj = to_device((Xr[:, :2] / Xr[:, 2:3]).astype(np.float32), dev)
            E, cost = multiscene.find_E_sharded(
                1, xi, xj, torch.ones(128, dtype=torch.bool, device=dev),
                mesh, num_hypotheses_total=256, sampson_thresh=1e-4)
            if not bool(torch.isfinite(E).all()):
                raise FloatingPointError(f"find_E_sharded: E {E}")

    # --- the production multi-scene program, scene-sharded --------------
    with tempfile.TemporaryDirectory(prefix="sfm_dryrun_") as td:
        dss = render_rings(td, S)
        res = run_scenes_scan(dss, ring_config(), frames=RING_FRAMES,
                              chunk=RING_CHUNK, p_cap=RING_P_CAP,
                              p_ba=RING_P_BA, mesh=mesh, device=device)
    kf_per_scene = [int(x) for x in res["n_keyframes"]]
    pts_per_scene = [int(x) for x in res["n_points"]]
    if not all(k >= 3 for k in kf_per_scene):
        raise AssertionError(f"keyframes per scene {kf_per_scene}")
    if not all(p > 50 for p in pts_per_scene):
        raise AssertionError(f"points per scene {pts_per_scene}")
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": dist.get_backend(),
           "tracks_alive": int(metrics["tracks_alive"]),
           "inliers": int(metrics["inliers"]),
           "keyframes": kf_per_scene, "points": pts_per_scene}
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok: mesh={out['mesh']} "
              f"backend={out['backend']} "
              f"tracks_alive={out['tracks_alive']} "
              f"inliers={out['inliers']} "
              f"multiscene_scan: keyframes={kf_per_scene} "
              f"points={pts_per_scene}", flush=True)
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run every sharded program once on ``n_devices`` ranks: NCCL, one
    card each (``device="cuda"``, the default; raises when the host has
    fewer cards), or gloo ranks on the CPU (``device="cpu"``).  Rank 0
    prints one ``dryrun_multichip ok: ...`` line; a rank that fails makes
    the call raise.  Returns rank 0's summary."""
    return launch(_dryrun_rank, n_devices, args=(n_devices, device),
                  device=device)[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.n_devices, args.device)
