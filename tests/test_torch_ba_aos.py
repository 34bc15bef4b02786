"""PyTorch port vs JAX package: bundle adjustment on the array-of-structures
path (F*P > 8192, the global final BA of ``SfMSystem``), on the CPU, in
float64 as the JAX package computes it under x64.

One problem at F=9 poses, P=1024 points, M=4096 observation rows (some of
them padding, some (camera, point) pairs observed twice, a few gross
outliers), made from a seed with numpy and handed to both sides.  The JAX
package sums the blocks with ``segment_sum``, the port with its
fixed-order sort-based plan: the sums differ only in order, so the cost
and the blocks agree to ~1e-12 relative; the LM steps then follow the same
accept/reject history.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ops import ba as jba, lie as jlie

from sfm_tpu_torch.ops import ba

torch.set_num_threads(1)

F, P, M = 9, 1024, 4096
HD = 2e-3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    X_gt = rng.standard_normal((P, 3)) * np.array([0.5, 0.5, 0.3]) \
        + np.array([0.0, 0.0, 4.0])
    R_gt, t_gt = [], []
    for f in range(F):
        ang = 0.08 * (f - F / 2)
        Rm = np.asarray(jlie.so3_exp(jnp.asarray([0.0, ang, 0.0])))
        C = np.array([4.0 * np.sin(ang), 0.1 * f, 4.0 - 4.0 * np.cos(ang)])
        R_gt.append(Rm)
        t_gt.append(-Rm @ C)
    R_gt, t_gt = np.stack(R_gt), np.stack(t_gt)
    m_real = 3800
    cam = rng.integers(0, F, m_real)
    pid = rng.integers(0, P, m_real)
    cam[:50], pid[:50] = cam[50:100], pid[50:100]   # doubly observed pairs
    Xc = np.einsum("mij,mj->mi", R_gt[cam], X_gt[pid]) + t_gt[cam]
    obs = Xc[:, :2] / Xc[:, 2:3] + rng.standard_normal((m_real, 2)) * 1e-4
    obs[100:130] += rng.standard_normal((30, 2)) * 0.05  # gross outliers
    R0 = [R_gt[0]]
    t0 = [t_gt[0]]
    for f in range(1, F):
        dw = rng.standard_normal(3) * 0.01
        R0.append(np.asarray(jlie.so3_exp(jnp.asarray(dw))) @ R_gt[f])
        t0.append(t_gt[f] + rng.standard_normal(3) * 0.01)
    pad = M - m_real
    leaves = dict(
        R_wc=np.stack(R0), t_wc=np.stack(t0),
        X=X_gt + rng.standard_normal((P, 3)) * 0.01,
        cam_idx=np.concatenate([cam, np.zeros(pad, int)]).astype(np.int32),
        pid_idx=np.concatenate([pid, np.zeros(pad, int)]).astype(np.int32),
        obs=np.concatenate([obs, np.zeros((pad, 2))]),
        obs_valid=np.concatenate([rng.random(m_real) < 0.95,
                                  np.zeros(pad, bool)]),
        point_valid=rng.random(P) < 0.97)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in leaves.items()})
    pt = ba.BAProblem(**{k: torch.as_tensor(v) for k, v in leaves.items()})
    assert pt.X.dtype == torch.float64 and pj.X.dtype == jnp.float64
    return leaves, pj, pt


def test_torch_ba_cost_matches_jax(problem):
    """The port's one robust cost (what both Hessian layouts accept or
    reject on) equals both of JAX's forms, tensor and SoA, to 1e-12
    relative."""
    _, pj, pt = problem
    cj = float(jba.ba_cost(pj, HD))
    ct = float(ba.ba_cost(pt, HD))
    assert abs(ct - cj) <= 1e-12 * cj
    assert abs(float(jba.ba_cost_soa(pj, HD)) - ct) <= 1e-12 * ct


def test_torch_linearize_aos_matches_jax(problem):
    """Every block of the AoS linearization equals JAX's segment sums to
    1e-10 relative to the block's largest entry (sums of the same float64
    terms in another order), and the fixed-order plan gives bit-identical
    blocks on a second call."""
    _, pj, pt = problem
    out_j = jba._linearize(pj, HD)
    out_t = ba._linearize(pt, HD)
    for name, a, b in zip(("Hcc", "bc", "Hpp", "bp", "W"), out_t, out_j):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * float(np.abs(b).max()),
                                   err_msg=name)
    again = ba._linearize(pt, HD, ba._aos_plans(pt))
    assert all(torch.equal(a, b) for a, b in zip(out_t, again))


def test_torch_solve_schur_aos_matches_jax(problem):
    """The Schur step from the same (JAX) blocks: pose and point updates
    within 1e-9 relative to the largest update."""
    _, pj, pt = problem
    Hcc, bc, Hpp, bp, W = jba._linearize(pj, HD)
    lam = 1e-3
    dxj, dXj = jba._solve_schur(Hcc, bc, Hpp, bp, W, pj.point_valid,
                                jnp.float64(lam), 1)
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    dxt, dXt = ba._solve_schur(t(Hcc), t(bc), t(Hpp), t(bp), t(W),
                               pt.point_valid,
                               torch.tensor(lam, dtype=torch.float64), 1)
    dxj, dXj = np.asarray(dxj), np.asarray(dXj)
    np.testing.assert_allclose(dxt.numpy(), dxj, rtol=0,
                               atol=1e-9 * float(np.abs(dxj).max()))
    np.testing.assert_allclose(dXt.numpy(), dXj, rtol=0,
                               atol=1e-9 * float(np.abs(dXj).max()))
    assert np.all(dxt.numpy()[0] == 0.0)  # gauge: pose 0 fixed


def test_torch_bundle_adjust_aos_matches_jax(problem):
    """Ten LM steps on both sides: cost0 to 1e-12 relative, the final cost
    to 1e-8 relative, poses within 1e-9 and valid points within 1e-8 (the
    same accept/reject history in float64); the cost falls by over 10x;
    pose 0 is the gauge and stays as it was."""
    leaves, pj, pt = problem
    Rj, tj, Xj, ij = jba.bundle_adjust(pj, iters=10, huber_delta=HD, n_fix=1)
    with torch.no_grad():
        Rt, t_t, Xt, it = ba.bundle_adjust(pt, iters=10, huber_delta=HD,
                                           n_fix=1)
    c0 = float(ij["cost0"])
    assert abs(float(it["cost0"]) - c0) <= 1e-12 * c0
    assert float(it["cost"]) < 0.1 * float(it["cost0"])
    np.testing.assert_allclose(float(it["cost"]), float(ij["cost"]),
                               rtol=1e-8)
    np.testing.assert_allclose(it["cost_hist"].numpy(),
                               np.asarray(ij["cost_hist"]), rtol=1e-8)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(tj), atol=1e-9)
    pv = leaves["point_valid"]
    np.testing.assert_allclose(Xt.numpy()[pv], np.asarray(Xj)[pv],
                               atol=1e-8)
    np.testing.assert_array_equal(Rt[0].numpy(), leaves["R_wc"][0])
    assert Rt.dtype == torch.float64
