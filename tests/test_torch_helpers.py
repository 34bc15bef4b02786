"""PyTorch port vs JAX package: the public helpers that no pipeline path
calls (SE(3) exp/log, ``compose_right_inv_ij``, ``quat_to_rot``,
``rvec_from_R``, ``smallest_eigvec_sym``, ``edge_errors``, ``to_float``,
``patch_grid``), on the CPU, same numpy inputs on both sides.

Both sides compute in their inputs' dtype (the JAX package runs with x64
on), float64 and float32 alike, over a leading batch axis.  The formulas
are the same term for term, so the sides differ only by the rounding of
the transcendental functions (XLA's and ATen's sin/cos/arccos differ by
an ulp or so) and by the order of a few sums.  Each tolerance below says
what that leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ops import image as jimage, lie as jlie, linalg as jlinalg, \
    umeyama as jume

from sfm_tpu_torch.ops import image, lie, linalg, umeyama

torch.set_num_threads(1)

# the JAX side traced once per shape and dtype (op-by-op dispatch of the
# Jacobi sweeps and the Taylor branches costs seconds a call on the CPU)
jquat_to_rot = jax.jit(jlie.quat_to_rot)
jcompose_right_inv_ij = jax.jit(jlie.compose_right_inv_ij)
jse3_exp = jax.jit(jlie.se3_exp)
jse3_log = jax.jit(jlie.se3_log)
jrvec_from_R = jax.jit(jlie.rvec_from_R)
jsmallest_eigvec_sym = jax.jit(jlinalg.smallest_eigvec_sym)
jedge_errors = jax.jit(jume.edge_errors)

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                      torch.float32)}
# the generic bars: a few ulps of O(1) results
ATOL = {"f64": 1e-13, "f32": 2e-6}


def _sides(a, dt):
    """The same numpy array as a JAX array and a torch tensor of dtype dt."""
    npt, tdt = DTYPES[dt]
    a = np.asarray(a).astype(npt)
    return jnp.asarray(a), torch.as_tensor(a).to(tdt)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rotations(rng, n, max_angle=np.pi * 0.98):
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w = axes * rng.uniform(0, max_angle, size=(n, 1))
    return _np(lie.so3_exp(torch.as_tensor(w)))


def _twists(rng, n, theta):
    """(n,6) twists with rotation angle ``theta`` and random axes/v."""
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return np.concatenate([axes * theta, rng.standard_normal((n, 3))], -1)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_torch_quat_to_rot_matches_jax(rng, dt):
    """Same polynomial in the same order: a few ulps; leading dims (2,5)."""
    q = rng.standard_normal((2, 5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qj, qt = _sides(q, dt)
    Rt = lie.quat_to_rot(qt)
    assert Rt.shape == (2, 5, 3, 3) and Rt.dtype == qt.dtype
    np.testing.assert_allclose(_np(Rt), _np(jquat_to_rot(qj)),
                               rtol=0, atol=ATOL[dt])
    # (w,x,y,z) order: w = 1 is the identity, a unit quaternion a rotation
    np.testing.assert_allclose(
        _np(Rt @ Rt.transpose(-1, -2)), np.broadcast_to(np.eye(3), Rt.shape),
        atol=10 * ATOL[dt])
    eye = lie.quat_to_rot(torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert torch.equal(eye, torch.eye(3))


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_torch_compose_right_inv_ij_matches_jax(rng, dt):
    """JAX's result to a few ulps, and tests/test_lie.py's semantics: the
    composed pose puts camera j's origin where x_i = R_ji^T(0 - t_ji)
    lands in the world (1e-12 in float64, as test_lie.py; 1e-5 in
    float32 for |t| ~ 3)."""
    R_cw, R_ji = _rotations(rng, 16), _rotations(rng, 16)
    t_cw, t_ji = rng.standard_normal((16, 3)), rng.standard_normal((16, 3))
    args = [_sides(a, dt) for a in (R_cw, t_cw, R_ji, t_ji)]
    Rj, tj = jcompose_right_inv_ij(*[a[0] for a in args])
    Rt, tt_ = lie.compose_right_inv_ij(*[a[1] for a in args])
    assert Rt.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(Rt), _np(Rj), rtol=0, atol=4 * ATOL[dt])
    np.testing.assert_allclose(_np(tt_), _np(tj), rtol=0, atol=8 * ATOL[dt])
    x_i = np.einsum("nji,nj->ni", R_ji, -t_ji)
    world = np.einsum("nij,nj->ni", R_cw, x_i) + t_cw
    np.testing.assert_allclose(_np(tt_), world, rtol=0,
                               atol={"f64": 1e-12, "f32": 1e-5}[dt])
    np.testing.assert_allclose(_np(Rt), np.einsum("nij,nkj->nik", R_cw, R_ji),
                               rtol=0, atol=10 * ATOL[dt])


# rotation angles: the small-angle Taylor branch (theta^2 < 1e-8) at a
# quarter of the switch and at 0, the generic branch at four times the
# switch, a generic angle, and so3_log's near-pi branch (pi - theta <
# 1e-3) and just outside it
THETAS = {"zero": 0.0, "small": 0.5e-4, "above_small": 2e-4, "generic": 1.3,
          "near_pi": np.pi - 2e-4, "below_near_pi": np.pi - 5e-3}


# how far se3_log(se3_exp(xi)) may land from xi: JAX's formulas' own
# accuracy, which the port shares (it matches JAX to ATOL on every case).
#   float64: 1e-8 as tests/test_lie.py (just above the switch _EPS = 1e-12
#   beside theta^3 = 8e-12 biases (t - sin t)/t^3 by 1e-1 of W^2 ~ 4e-8:
#   3.6e-9 measured); near pi so3_log takes the axis from (R+I)/2, whose
#   skew part sin(t)/2 ~ 1e-4 tilts it: 1e-3; 5e-3 below pi the generic
#   branch divides by 2 sin t ~ 1e-2: 1e-7.
#   float32: 2e-6 on O(1) twists; 5e-3 below pi, where sin t inherits
#   the relative error of 1 + cos t ~ 1.25e-5 held to a 6e-8 spacing.
#   None: JAX's float32 formula does not invert there, and neither does
#   the port's, identically: at theta^2 = 4e-8 cos(theta) rounds to 1, so
#   b = (1-cos t)/t^2 = 0 and se3_log's a/(2b) gives inf/NaN; near pi
#   so3_log's clip at -1 + 10 eps caps theta at pi - 1.55e-3, outside
#   its near-pi branch, and the generic branch shrinks w.
ROUNDTRIP = {
    "f64": {"zero": 1e-8, "small": 1e-8, "above_small": 1e-8,
            "generic": 1e-8, "near_pi": 1e-3, "below_near_pi": 1e-7},
    "f32": {"zero": 2e-6, "small": 2e-6, "above_small": None,
            "generic": 2e-6, "near_pi": None, "below_near_pi": 5e-3},
}


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("case", list(THETAS))
def test_torch_se3_exp_log_match_jax(rng, dt, case):
    """se3_exp and se3_log against JAX on each side of each branch switch:
    ATOL (1e-13 in float64, 2e-6 in float32 on |v| ~ 3) on (R, t) and on
    the twist, NaNs in the same places; then the round trip to the bars
    of ROUNDTRIP."""
    xi = _twists(rng, 12, THETAS[case])
    xij, xit = _sides(xi, dt)
    Rj, tj = jse3_exp(xij)
    Rt, tt_ = lie.se3_exp(xit)
    assert Rt.shape == (12, 3, 3) and tt_.shape == (12, 3)
    assert Rt.dtype == tt_.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(_np(Rt), _np(Rj), rtol=0, atol=ATOL[dt])
    np.testing.assert_allclose(_np(tt_), _np(tj), rtol=0, atol=ATOL[dt])
    # se3_log of the same (R, t) on both sides
    R64, t64 = lie.se3_exp(torch.as_tensor(xi))
    Rj_in, Rt_in = _sides(R64.numpy(), dt)
    tj_in, tt_in = _sides(t64.numpy(), dt)
    lj = _np(jse3_log(Rj_in, tj_in))
    lt = _np(lie.se3_log(Rt_in, tt_in))
    assert lt.shape == (12, 6) and lt.dtype == DTYPES[dt][0]
    np.testing.assert_array_equal(np.isnan(lt), np.isnan(lj))
    np.testing.assert_allclose(lt, lj, rtol=0, atol=ATOL[dt])
    bar = ROUNDTRIP[dt][case]
    if bar is None:
        assert not np.allclose(lj, xi, atol=1e-2)
        return
    # the log inverts the exp (sign of the axis included)
    np.testing.assert_allclose(lt, xi, rtol=0, atol=bar)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_torch_se3_exp_log_roundtrip(rng, dt):
    """tests/test_lie.py:84-90's round trip on the port: 1e-8 in float64
    as there; 1e-3 in float32 (standard-normal twists reach |w| ~ 3, where
    so3_log's arccos costs ~sqrt(eps) ~ 4e-4 in theta)."""
    xi = rng.standard_normal((32, 6))
    xit = _sides(xi, dt)[1]
    R, t = lie.se3_exp(xit)
    np.testing.assert_allclose(_np(lie.se3_log(R, t)), xi, rtol=0,
                               atol={"f64": 1e-8, "f32": 1e-3}[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_torch_rvec_from_R_is_so3_log(rng, dt):
    """An alias: bit for bit the port's so3_log, and JAX's rvec_from_R to
    the arccos' ulp (rotations up to 0.98 pi: ~1e-13 / 2e-5 absolute)."""
    Rj, Rt = _sides(_rotations(rng, 24), dt)
    rt = lie.rvec_from_R(Rt)
    assert torch.equal(rt, lie.so3_log(Rt))
    np.testing.assert_allclose(_np(rt), _np(jrvec_from_R(Rj)), rtol=0,
                               atol={"f64": 1e-13, "f32": 2e-5}[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [4, 9])
def test_torch_smallest_eigvec_sym_matches_jax(rng, dt, n):
    """Column 0 of the same Jacobi sweeps, no sign fix-up on either side:
    the vector agrees sign included wherever the gap to the next
    eigenvalue is not tiny (gap > 0.05; 1e-10 in float64, 1e-4 in float32
    as test_torch_jacobi_eigh_matches_jax), and is a unit eigenvector of
    the smallest eigenvalue everywhere (residual a few ulps of |A|)."""
    A = rng.standard_normal((20, n, n))
    A = A + A.transpose(0, 2, 1)
    Aj, At = _sides(A, dt)
    vt = linalg.smallest_eigvec_sym(At)
    vj = _np(jsmallest_eigvec_sym(Aj))
    assert vt.shape == (20, n) and vt.dtype == DTYPES[dt][1]
    w = np.linalg.eigvalsh(A)
    ok = (w[:, 1] - w[:, 0]) > 0.05
    assert ok.sum() >= 10
    np.testing.assert_allclose(_np(vt)[ok], vj[ok], rtol=0,
                               atol={"f64": 1e-10, "f32": 1e-4}[dt])
    scale = np.abs(w).max()
    res = np.einsum("nij,nj->ni", A, _np(vt)) - w[:, :1] * _np(vt)
    np.testing.assert_allclose(res, 0, atol={"f64": 1e-12,
                                             "f32": 2e-5}[dt] * scale)
    np.testing.assert_allclose(np.linalg.norm(_np(vt), axis=-1), 1,
                               atol=10 * ATOL[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_torch_edge_errors_matches_jax(rng, dt):
    """Random pairs: rotation errors up to 0.98 pi and directions
    anywhere.  Away from c = 1 arccos is well conditioned: 1e-10 deg in
    float64, 1e-3 deg in float32 (the rotation error goes through
    so3_log's arccos: ~1e-5 rad near pi)."""
    R_est, R_gt = _rotations(rng, 40), _rotations(rng, 40)
    t_est = rng.standard_normal((40, 3)) * 3.0
    t_gt = rng.standard_normal((40, 3))
    args = [_sides(a, dt) for a in (R_est, t_est, R_gt, t_gt)]
    rj, tj = jedge_errors(*[a[0] for a in args])
    rt, tt_ = umeyama.edge_errors(*[a[1] for a in args])
    assert rt.shape == tt_.shape == (40,)
    assert rt.dtype == tt_.dtype == DTYPES[dt][1]
    bar = {"f64": 1e-10, "f32": 1e-3}[dt]
    np.testing.assert_allclose(_np(rt), _np(rj), rtol=0, atol=bar)
    np.testing.assert_allclose(_np(tt_), _np(tj), rtol=0, atol=bar)
    # degrees, the direction error the min over +-GT: in [0, 90]
    assert _np(tt_).min() >= 0 and _np(tt_).max() <= 90.0
    assert _np(rt).max() > 90.0


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_torch_edge_errors_exact_and_flipped(rng, dt):
    """tests/test_umeyama.py:60-73 on a batch: an exact edge has zero
    rotation error (< 1e-6 deg) and, with the sign of t flipped too, no
    direction error but what arccos makes of the last bit of c = 1:
    sqrt(2 ulp) rad, so under 1e-5 deg in float64 (test_umeyama.py holds
    1e-3) and 0.05 deg in float32; the port and JAX agree to the same
    bars."""
    R = _rotations(rng, 16)
    t = rng.standard_normal((16, 3))
    (Rj, Rt), (tj, tt_) = _sides(R, dt), _sides(t, dt)
    for sgn in (1.0, -1.0):
        rj, dj = jedge_errors(Rj, sgn * tj, Rj, tj)
        rt, dt_err = umeyama.edge_errors(Rt, sgn * tt_, Rt, tt_)
        assert _np(rt).max() < 1e-6
        near1 = {"f64": 1e-5, "f32": 5e-2}[dt]
        np.testing.assert_allclose(_np(rt), _np(rj), rtol=0, atol=near1)
        np.testing.assert_allclose(_np(dt_err), _np(dj), rtol=0, atol=near1)
        assert _np(dt_err).max() < near1


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("radius", [0, 1, 3, 6])
def test_torch_patch_grid_matches_jax(dt, radius):
    """Integers in (dx, dy) order, x fastest: equal, dtype kept."""
    npt, tdt = DTYPES[dt]
    g = image.patch_grid(radius, tdt)
    gj = np.asarray(jimage.patch_grid(radius, jnp.dtype(npt)))
    assert g.dtype == tdt and g.shape == ((2 * radius + 1) ** 2, 2)
    np.testing.assert_array_equal(g.numpy(), gj)
    assert torch.equal(image.patch_grid(radius, tdt, device="cpu"), g)
    if radius:
        assert g[1].tolist() == [-radius + 1, -radius]


def test_torch_patch_grid_default_dtype_is_float32():
    assert image.patch_grid(2).dtype == torch.float32


def test_torch_to_float_matches_jax(rng):
    """uint8 -> float32 in [0, 255], exact; always float32 (a float64 or
    a numpy input too, as JAX's astype)."""
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    out = image.to_float(torch.as_tensor(img))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jimage.to_float(jnp.asarray(img))))
    assert image.to_float(img).dtype == torch.float32
    f64 = image.to_float(torch.as_tensor(img, dtype=torch.float64))
    assert f64.dtype == torch.float32 and torch.equal(f64, out)
