"""Multi-scene batch reconstruction (BASELINE config 5: N TempleRing-style
sequences in parallel across devices).

Counterpart of sfm_tpu/parallel/batch_runner.py.  Scope: lockstep visual
odometry; all scenes advance frame by frame together.  The scenes are
spread over the ``scene`` coordinates of a ``("scene", "hyp")`` mesh, and
each rank runs its own: per frame ONE tracker step for all of them (one
K3 launch per level and direction, one K1 corner map over the scenes
that replenish), then LO-RANSAC scene by scene, the pose composed where
the estimate is valid and frozen where it is not.  At the end the
trajectories of all scenes are gathered over the ``scene`` group, so every
rank returns the whole batch.  Keyframing is not part of this runner (the
JAX twin's shared schedule); per-scene mapping is
``parallel/multi_scan.run_scenes_scan``.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import KLTConfig, RansacConfig
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.ops import epipolar, image as im
from sfm_tpu_torch.parallel.mesh import gather_scenes, local_scenes, \
    rank_device
from sfm_tpu_torch.parallel.multi_scan import scene_seed
from sfm_tpu_torch.parallel.multiscene import scene_draws
from sfm_tpu_torch.utils.device import to_device

f32 = torch.float32


def _per_scene_frame(gen, pri, K, prev_pos, state, matched, pose_R, pose_t,
                     rcfg: RansacConfig):
    """One scene's frame after the (batched) tracker step: estimate the
    relative pose, compose it where it is valid, freeze it otherwise.
    Returns (pose_R, pose_t, inliers)."""
    xi = epipolar.normalize_by_K(K, prev_pos)
    xj = epipolar.normalize_by_K(K, state.pos)
    rp = epipolar.find_E_ransac(
        gen, xi, xj, matched, num_hypotheses=rcfg.num_hypotheses,
        sampson_thresh=rcfg.sampson_thresh, min_inliers=rcfg.min_inliers,
        pri=pri)
    R_ij = rp.R.T
    t_ij = -(R_ij @ rp.t)
    pose_t_new = pose_R @ t_ij + pose_t
    pose_R_new = pose_R @ R_ij
    pose_R = torch.where(rp.ok, pose_R_new, pose_R)
    pose_t = torch.where(rp.ok, pose_t_new, pose_t)
    return pose_R, pose_t, rp.num_inliers


def make_batch_frame_step(kcfg: KLTConfig, rcfg: RansacConfig):
    """The frame step of a rank's S scenes.

    step(draws, K (3,3), pyr0, pyr1 (tuples of (S,H,W)), states (S
    ``TrackerState``s), pose_R (S,3,3), pose_t (S,3))
      -> (states', pose_R', pose_t', inliers (S,))

    The tracker step replenishes the starved scenes (the JAX twin does so
    after its step; a replenish draws nothing, so the order does not
    matter).  ``draws``: see ``parallel/multiscene``.  The JAX twin takes
    the mesh here for its ``shard_map``; a rank's step needs none."""

    def step(draws, K, pyr0, pyr1, states, pose_R, pose_t):
        out = tracker.step_scenes(pyr0, pyr1, states, kcfg)
        Rs, ts, inl = [], [], []
        for s, (st, prev_pos, matched) in enumerate(out):
            gen, pri = scene_draws(draws, s)
            R, t, n = _per_scene_frame(gen, pri, K, prev_pos, st, matched,
                                       pose_R[s], pose_t[s], rcfg)
            Rs.append(R)
            ts.append(t)
            inl.append(n)
        return ([st for st, _, _ in out], torch.stack(Rs), torch.stack(ts),
                torch.stack(inl))

    return step


def run_scenes(datasets, mesh, kcfg: KLTConfig | None = None,
               rcfg: RansacConfig | None = None, frames: int | None = None,
               seed: int = 0, device="cuda", _pri_source=None):
    """Reconstruct N scene trajectories in lockstep on the mesh.

    ``datasets``: TempleRing handles (equal lengths, one K); S must divide
    by the mesh's scene axis.  This rank runs the scenes of its ``scene``
    coordinate on its device (``device``: ``"cuda"``, the default, or
    ``"cpu"``, as the mesh was made).  Scene s draws from a generator
    seeded ``multi_scan.scene_seed(seed, s)`` with its global s, whatever
    rank it lands on; tests hand in priorities instead through
    ``_pri_source``, a callable (scene, frame) -> (H,N).

    Returns, on every rank, a dict with the camera centers (S, F, 3) and
    inlier counts (S, F-1) of ALL scenes (gathered over the ``scene``
    group)."""
    dev = rank_device(mesh, device)
    kcfg = kcfg or KLTConfig(max_tracks=512, min_tracks=300)
    rcfg = rcfg or RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=40)
    scenes = local_scenes(mesh, len(datasets))
    n = frames or min(len(d) for d in datasets)
    K = to_device(datasets[0].K, dev, f32)
    step = make_batch_frame_step(kcfg, rcfg)

    def pyr_batch(i):
        pyrs = [im.build_pyramid(to_device(np.array(datasets[s].load_gray(i)),
                                           dev, f32), kcfg.pyr_levels)
                for s in scenes]
        return tuple(torch.stack(lv).contiguous() for lv in zip(*pyrs))

    gens = []
    for s in scenes:
        g = torch.Generator(device=dev)
        g.manual_seed(scene_seed(seed, s))
        gens.append(g)
    with torch.no_grad():
        pyr0 = pyr_batch(0)
        states = tracker.bootstrap_scenes(pyr0[0], kcfg)
        pose_R = torch.eye(3, dtype=f32, device=dev).repeat(len(scenes), 1, 1)
        pose_t = torch.zeros((len(scenes), 3), dtype=f32, device=dev)
        centers, inl_hist = [pose_t], []
        for i in range(1, n):
            pyr1 = pyr_batch(i)
            draws = gens if _pri_source is None else torch.stack(
                [to_device(np.asarray(_pri_source(s, i), np.float32), dev)
                 for s in scenes])
            states, pose_R, pose_t, inl = step(draws, K, pyr0, pyr1, states,
                                               pose_R, pose_t)
            pyr0 = pyr1
            centers.append(pose_t)
            inl_hist.append(inl)
        # camera centers: the pose is cam->world, so center = t
        local = (torch.stack(centers, 1).cpu().numpy(),
                 torch.stack(inl_hist, 1).cpu().numpy() if inl_hist else None)
    parts = gather_scenes(mesh, local)
    return {
        "centers": np.concatenate([c for c, _ in parts]),  # (S, F, 3)
        "inliers": (np.concatenate([i for _, i in parts])
                    if inl_hist else None),
    }
