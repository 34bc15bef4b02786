"""PyTorch port vs JAX package: loop closure, pose graph and the finalize
refinement, on the CPU: the unit checks.

Unit checks on random inputs made from a seed (descriptor scoring, the
three pose-graph solvers in float64, the structure-only point polish),
and the host path's fallback E-RANSAC verification on two frames of a
reduced out-and-back ring (320x240, 15 frames: out to 35 degrees and back
in 5-degree steps), in which every return keyframe revisits an outbound
one.  The pipeline runs over that ring (one JAX run, two port runs) and
the checks made on them are in tests/test_torch_loop_run.py, a file of
its own: pytest-xdist's ``--dist loadfile`` hands out the files that
collect more tests first, so that file's runs start after the JAX
package's longest file.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ops import (ba as jba, descriptors as jdesc,
                         posegraph as jpg)

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.ops import ba, descriptors, posegraph as pg

torch.set_num_threads(1)

LONS = tuple(list(np.arange(0, 36, 5.0)) + list(np.arange(30, -1, -5.0)))


def _cfg(mod, **over):
    """The loop configuration of tests/test_scan_pipeline.py's out-and-back
    test at 320x240 (parallax gate scaled with the width), from either
    package's config module."""
    return mod.SystemConfig(
        frames=len(LONS),
        klt=mod.KLTConfig(max_tracks=512, min_tracks=300, pyr_levels=4,
                          win_radius=6, iters=16, min_distance=8),
        keyframe=mod.KeyframeConfig(min_inliers=60, min_gap=1,
                                    parallax_px=8.0),
        ransac=mod.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=30),
        ba=mod.BAConfig(window=4, iters=3, max_points=256, global_iters=5),
        loop=mod.LoopConfig(enabled=True, min_kf_gap=6, score_thresh=0.94,
                            min_tracked=120, ransac_iters=1024,
                            ransac_thresh=2e-5, min_inliers=80,
                            device_verify=True),
        pose_graph=mod.PoseGraphConfig(mode="se3", iters=10),
        **over,
    )


@pytest.fixture(scope="module")
def out_and_back(tmp_path_factory):
    from sfm_tpu.utils.dataset import TempleRing
    from sfm_tpu.utils.synthetic import SyntheticRingSpec, generate_dataset

    out = tmp_path_factory.mktemp("torch_loop")
    spec = SyntheticRingSpec(n_frames=len(LONS), width=320, height=240,
                             fx=1100.0 * 320 / 480, fy=1100.0 * 320 / 480,
                             path_lons_deg=LONS)
    generate_dataset(out, spec)
    return TempleRing.from_dir(out)


# ---------------------------------------------------------------------------
# unit checks
# ---------------------------------------------------------------------------


def test_torch_score_bank_matches_jax(rng):
    """Cosine scores of one descriptor against a bank with invalid rows:
    the same matvec (float32, summation order aside) and -inf rows."""
    bank = rng.standard_normal((16, descriptors.DESC_DIM)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    valid = rng.random(16) < 0.7
    d = bank[3] + 0.1 * rng.standard_normal(descriptors.DESC_DIM).astype(
        np.float32)
    ref = np.asarray(jdesc.score_bank(jnp.asarray(bank), jnp.asarray(valid),
                                      jnp.asarray(d)))
    out = descriptors.score_bank(torch.as_tensor(bank),
                                 torch.as_tensor(valid),
                                 torch.as_tensor(d)).numpy()
    assert np.isneginf(out[~valid]).all() and np.isneginf(ref[~valid]).all()
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-6)


def _random_graph(rng, N=12):
    """A noisy chain of N poses plus three loop edges (one of them to node
    0), two padding edges, half the edges with t_full set."""
    from scipy.spatial.transform import Rotation

    R = Rotation.random(N, random_state=int(rng.integers(1 << 30)))
    R = R.as_matrix()
    C = rng.standard_normal((N, 3))
    ei = np.r_[np.arange(N - 1), [0, 2, 5], [0, 0]]
    ej = np.r_[np.arange(1, N), [N - 1, N - 3, N - 2], [0, 0]]
    E = len(ei)
    noise = Rotation.from_rotvec(rng.normal(0, 0.02, (E, 3))).as_matrix()
    Rm = np.stack([R[j].T @ R[i] @ q for i, j, q in zip(ei, ej, noise)])
    tm = np.stack([R[j].T @ (C[i] - C[j]) for i, j in zip(ei, ej)])
    tm += rng.normal(0, 0.02, (E, 3))
    valid = np.ones(E, bool)
    valid[-2:] = False
    C0 = C + rng.normal(0, 0.1, (N, 3))
    w_rot = rng.uniform(0.5, 2.0, E)
    w_trans = rng.uniform(0.5, 2.0, E)
    t_full = rng.random(E) < 0.5
    s_meas = rng.uniform(0.8, 1.25, E)
    return (R, C0, ei, ej, Rm, tm, w_rot, w_trans, valid, t_full), s_meas


@pytest.mark.parametrize("solver", ["se3_dir", "se3_full", "sim3",
                                    "centers"])
def test_torch_posegraph_matches_jax(rng, solver):
    """One random float64 graph with loop edges through each solver on
    both sides.  Same residuals, exact per-edge Jacobians (forward mode on
    both sides), the same LM schedule and Cholesky solves in float64: the
    poses agree to 1e-8 (observed ~1e-14)."""
    arrays, s_meas = _random_graph(rng)
    jp = jpg.PoseGraphProblem(*(jnp.asarray(a) for a in arrays))
    tp = pg.PoseGraphProblem(*(torch.as_tensor(a) for a in arrays))
    assert tp.R_cw.dtype == torch.float64
    if solver.startswith("se3"):
        mode = solver[4:]
        rj, cj, ij = jpg.optimize_se3(jp, mode=mode, iters=10)
        rt, ct, it = pg.optimize_se3(tp, mode=mode, iters=10)
    elif solver == "sim3":
        rj, cj, sj, ij = jpg.optimize_sim3(jp, s_meas=jnp.asarray(s_meas),
                                           mode="dir", iters=10)
        rt, ct, st, it = pg.optimize_sim3(tp, s_meas=torch.as_tensor(s_meas),
                                          mode="dir", iters=10)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-8)
    else:
        rj, cj, ij = jpg.optimize_centers(jp)
        rt, ct, it = pg.optimize_centers(tp)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-8)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-8)
    if "cost" in ij:
        assert float(it["cost"]) < float(it["cost0"])
        np.testing.assert_allclose(float(it["cost"]), float(ij["cost"]),
                                   rtol=1e-8)


def test_torch_refine_points_matches_jax(rng):
    """The frozen-pose point polish on a random float32 problem (6 poses,
    300 points, 10 % of the observations masked, 5 points invalid), with
    the gather plan on both sides.  Float32, per-point 3x3 solves summed
    in another order: points agree to 1e-5 relative to their depth, the
    costs to 1e-4 relative.  A cap below the largest per-point count
    drops the observations past it on both sides, to the same result
    (it raises only under the numeric checks, tests/test_torch_debug.py)."""
    from scipy.spatial.transform import Rotation

    F, P, M = 6, 300, 1200
    R = Rotation.from_rotvec(rng.normal(0, 0.1, (F, 3))).as_matrix()
    t = rng.normal(0, 0.2, (F, 3))
    X = rng.normal(0, 1, (P, 3)) + [0, 0, 5]
    cam = rng.integers(0, F, M)
    pid = rng.integers(0, P, M)
    Xc = np.einsum("mij,mj->mi", R[cam], X[pid]) + t[cam]
    obs = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (M, 2))
    ov = rng.random(M) < 0.9
    pv = np.ones(P, bool)
    pv[-5:] = False
    arrays = [R.astype(np.float32), t.astype(np.float32),
              (X + rng.normal(0, 0.05, (P, 3))).astype(np.float32),
              cam.astype(np.int32), pid.astype(np.int32),
              obs.astype(np.float32), ov, pv]
    cap = int(np.bincount(pid[ov], minlength=P).max())
    Xj, ij = jba.refine_points(jba.BAProblem(*map(jnp.asarray, arrays)),
                               iters=5, max_obs_per_point=cap)
    prob = ba.BAProblem(*map(torch.as_tensor, arrays))
    Xt, it = ba.refine_points(prob, iters=5, max_obs_per_point=cap)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5 * 1e-5)
    for k in ("cost0", "cost"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-4)
    assert float(it["cost"]) < 0.5 * float(it["cost0"])
    # without a cap the plan takes the table's own largest count
    Xn, _ = ba.refine_points(prob, iters=5)
    assert torch.equal(Xn, Xt)
    Xj, ij = jba.refine_points(jba.BAProblem(*map(jnp.asarray, arrays)),
                               iters=5, max_obs_per_point=cap - 1)
    Xt, it = ba.refine_points(prob, iters=5, max_obs_per_point=cap - 1)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5 * 1e-5)
    for k in ("cost0", "cost"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-4)


def test_torch_e_ransac_loop_verify_recovers_relative_pose(out_and_back):
    """The host path's fallback verification (taken for an old keyframe
    with fewer than 30 mapped tracks, which the runs above never meet):
    Shi-Tomasi re-detect, LK re-track and E-RANSAC on frames 3 and 5 (10
    degrees apart), through ``ScanSfM._verify_pair`` with its seeded
    generator.  It accepts the pair and recovers the ground-truth relative
    pose: rotation within 5e-3, translation direction within 1e-2 (the
    JAX package's twin lands within 2e-3 and 2.2e-3 of it on the same
    pair)."""
    ds = out_and_back
    cfg = _cfg(config)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, device_verify=False))
    s = sp.ScanSfM(ds.K, cfg, n_frames=len(ds.records), device="cpu")
    R, t, inliers, n_tracked = s._verify_pair(
        torch.as_tensor(np.array(ds.load_gray(3))),
        torch.as_tensor(np.array(ds.load_gray(5))))
    assert R is not None
    assert n_tracked >= cfg.loop.min_tracked
    assert inliers >= cfg.loop.min_inliers
    r3, r5 = ds.records[3], ds.records[5]
    R_ji = r5.R @ r3.R.T
    t_ji = r5.t - R_ji @ r3.t
    np.testing.assert_allclose(R, R_ji, atol=5e-3)
    np.testing.assert_allclose(t, t_ji / np.linalg.norm(t_ji), atol=1e-2)
