"""The port's geometry export (sfm_tpu_torch/models/mesh.py) against the JAX
package's (sfm_tpu/models/mesh.py) on the CPU, the same numpy inputs on both
sides (those of tests/test_cli_and_mesh.py).

The sparse Delaunay mesh and the rectification are the same host numpy code:
bit-identical.  The disparity is held to shares: ``lr_ok`` equal on >= 99 %
of the pixels, the integer disparity equal on >= 99 % of the pixels both
keep, |delta disp| <= 0.05 px at the 99th percentile; and to the JAX tests'
own ground-truth bars.  The reference of the shares is the JAX function run
on float64 inputs (the package enables x64): in float32 the twin's box
filter differences cumulative sums across the 1e6 sentinel (ulp 64 at
~7e8), and on the slanted ramp's flat band that noise alone puts the JAX
float32 result outside the bars against its own float64 result (plain
matcher: 96 % equal integer disparity, 0.25 px at p99); the port sums
directly, and its float32 result meets them (observed: >= 99.86 %,
1.4e-6 px).  On the textured fronto-parallel pair the bars hold against the
JAX float32 result as well.  The dense stereo mesh meets the cylinder bars,
with vertex and face counts within 2 % of JAX's and a median radius error
within 0.002 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation

from sfm_tpu.config import StereoMeshConfig as JStereoMeshConfig
from sfm_tpu.models import mesh as jmesh
from sfm_tpu.models.mapstate import Keyframe as JKeyframe

from sfm_tpu_torch.config import StereoMeshConfig
from sfm_tpu_torch.models import mesh
from sfm_tpu_torch.models.mapstate import Keyframe
from sfm_tpu_torch.utils.dataset import TempleRing
from sfm_tpu_torch.utils.synthetic import SyntheticRingSpec, generate_dataset


def _kfs(R_cw, t_cw, frame_idx=0):
    """The same keyframe as the JAX package's and the port's dataclass."""
    kw = dict(kf_id=frame_idx, frame_idx=frame_idx, img_name="x",
              R_cw=np.asarray(R_cw, np.float64),
              t_cw=np.asarray(t_cw, np.float64), ids=np.zeros(1, np.int32),
              uv=np.zeros((1, 2)), valid=np.zeros(1, bool))
    return JKeyframe(**kw), Keyframe(**kw)


@pytest.mark.parametrize("variant", ["reference", "seeded"])
def test_torch_sparse_mesh_bit_identical(rng, variant):
    """tests/test_cli_and_mesh.py's camera and points, and a variant (a
    rotated camera, another seed, cap and grid): the same vertices and
    faces bit for bit."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    pts = rng.uniform(-0.5, 0.5, (500, 3))
    if variant == "reference":
        jkf, tkf = _kfs(np.eye(3), [0, 0, -4.0])
        kw = dict(max_points=400, grid_px=8, max_edge_px=120.0)
    else:
        R = Rotation.from_rotvec([0.05, -0.1, 0.02]).as_matrix()
        jkf, tkf = _kfs(R, [0.1, -0.05, -3.5])
        kw = dict(max_points=200, grid_px=4, max_edge_px=80.0, seed=7)
    vj, fj = jmesh.build_sparse_mesh(K, jkf, pts, **kw)
    vt, ft = mesh.build_sparse_mesh(K, tkf, pts, **kw)
    assert len(vt) > 100 and len(ft) > 100 and ft.max() < len(vt)
    assert np.array_equal(vt, vj) and np.array_equal(ft, fj)


def test_torch_rectify_rotations_exact(rng):
    for _ in range(4):
        R = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix()
        t = rng.normal(0, 1, 3)
        for a, b in zip(mesh._rectify_rotations(R, t),
                        jmesh._rectify_rotations(R, t)):
            assert np.array_equal(a, b)


def _fronto(rng):
    """tests/test_cli_and_mesh.py test_stereo_mesh_runs: a 96x128
    fronto-parallel pair at disparity 6."""
    H, W = 96, 128
    img = (gaussian_filter(rng.standard_normal((H, W + 32)), 1.5) * 60 + 128)
    d_true = 6
    left = img[:, 16: W + 16].astype(np.float32)
    right = img[:, 16 + d_true: W + 16 + d_true].astype(np.float32)
    return left, right, np.full(W, float(d_true))


def _slanted(rng):
    """tests/test_cli_and_mesh.py test_stereo_sgm_beats_plain_sad: a
    slanted plane (disparity 4..12 across x) with a textureless band."""
    H, W = 96, 128
    img = (gaussian_filter(rng.standard_normal((H, W + 48)), 2.5) * 25 + 128)
    img[:, 80:110] = 128.0
    left = img[:, 24: W + 24].astype(np.float32)
    d_r = 4.0 + 8.0 * np.arange(W) / W
    src = 24 + np.arange(W) + d_r
    right = np.stack([np.interp(src, np.arange(img.shape[1]), row)
                      for row in img]).astype(np.float32)
    xl = np.arange(W, dtype=np.float64)
    xr = (xl - 4.0) / (1.0 + 8.0 / W)
    return left, right, xl - xr


def _inner():
    inner = np.zeros((96, 128), bool)
    inner[8:-8, 24:-8] = True
    return inner


def _disp_both(left, right, sgm, jax_dtype=jnp.float64):
    """JAX (inputs cast to ``jax_dtype``) and the port (float32)."""
    dj, oj = jmesh._disparity_sad(jnp.asarray(left, jax_dtype),
                                  jnp.asarray(right, jax_dtype), 16, 3,
                                  sgm=sgm)
    dt, ot = mesh._disparity_sad(torch.as_tensor(left),
                                 torch.as_tensor(right), 16, 3, sgm=sgm)
    assert dt.dtype == torch.float32 and ot.dtype == torch.bool
    return np.asarray(dj), np.asarray(oj), dt.numpy(), ot.numpy()


def _share_bars(dj, oj, dt, ot):
    assert dt.shape == dj.shape and np.isfinite(dt).all()
    assert (ot == oj).mean() >= 0.99, (ot == oj).mean()
    both = ot & oj
    # the integer disparity: the same rounding, or the same value to 1e-3
    # px (a subpixel offset clipped to +-0.5 puts it on a half-integer,
    # where one float32 ulp tips the rounding)
    same = (np.rint(dt) == np.rint(dj)) | (np.abs(dt - dj) <= 1e-3)
    assert same[both].mean() >= 0.99, same[both].mean()
    assert np.percentile(np.abs(dt - dj)[both], 99) <= 0.05


@pytest.mark.parametrize("sgm", [False, True])
def test_torch_disparity_fronto_matches_jax(rng, sgm):
    """The fronto-parallel pair: the share bars against JAX in float64 and
    in float32, and the JAX test's own bars (coverage > 0.2 of the inner
    region, median within 0.5 px of the true disparity)."""
    left, right, d_true = _fronto(rng)
    _share_bars(*_disp_both(left, right, sgm, jnp.float32))
    dj, oj, dt, ot = _disp_both(left, right, sgm)
    _share_bars(dj, oj, dt, ot)
    m = ot & _inner()
    assert m.mean() > 0.2
    assert abs(np.median(dt[m]) - d_true[0]) < 0.5, np.median(dt[m])


def test_torch_disparity_slanted_matches_jax(rng):
    """The slanted ramp with its textureless band, plain and SGM: the share
    bars against JAX (float64) for each, and the JAX test's own bars (SGM's
    coverage-of-correct above the plain matcher's and above 0.8)."""
    left, right, d_true = _slanted(rng)
    good = {}
    for sgm in (False, True):
        dj, oj, dt, ot = _disp_both(left, right, sgm)
        _share_bars(dj, oj, dt, ot)
        hit = ot & (np.abs(dt - d_true[None, :]) < 1.0)
        good[sgm] = hit[_inner()].mean()
    assert good[True] > good[False], good
    assert good[True] > 0.8, good


def test_torch_stereo_mesh_matches_jax(tmp_path):
    """tests/test_cli_and_mesh.py test_stereo_mesh_depth_quality: the dense
    export on a rendered 480x360 pair with GT poses, through both packages.
    The port's vertices land on the GT cylinder (radius 0.10: median
    |r - 0.10| < 0.02, >= 50 % within 0.02), with vertex and face counts
    within 2 % of JAX's and a median radius error within 0.002 of JAX's."""
    spec = SyntheticRingSpec(n_frames=2, width=480, height=360,
                             fx=1100.0, fy=1100.0, arc_deg=5.0)
    generate_dataset(tmp_path, spec)
    ds = TempleRing.from_dir(tmp_path)
    pairs = [_kfs(*r.pose_cw, frame_idx=i) for i, r in enumerate(ds.records)]
    g0, g1 = ds.load_gray(0), ds.load_gray(1)
    kw = dict(num_disparities=160, step=4, block_size=7)
    vj, fj = jmesh.export_stereo_grid_mesh(
        ds.K, pairs[0][0], pairs[1][0], g0, g1, JStereoMeshConfig(**kw))
    vt, ft = mesh.export_stereo_grid_mesh(
        ds.K, pairs[0][1], pairs[1][1], g0, g1, StereoMeshConfig(**kw),
        device="cpu")
    assert len(vt) > 300 and len(ft) > 200 and ft.max() < len(vt)
    assert abs(len(vt) - len(vj)) <= 0.02 * len(vj), (len(vt), len(vj))
    assert abs(len(ft) - len(fj)) <= 0.02 * len(fj), (len(ft), len(fj))
    err_t = np.abs(np.hypot(vt[:, 0], vt[:, 1]) - spec.cylinder_radius)
    err_j = np.abs(np.hypot(vj[:, 0], vj[:, 1]) - spec.cylinder_radius)
    assert np.median(err_t) < 0.02, np.median(err_t)
    assert np.mean(err_t < 0.02) > 0.5, np.mean(err_t < 0.02)
    assert abs(np.median(err_t) - np.median(err_j)) <= 0.002
