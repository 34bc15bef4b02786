"""PyTorch port vs JAX package: the scan pipeline with bfloat16 LK block
storage (SFM_TPU_LK_BF16=1), on the CPU.

One JAX and one port ScanSfM run of the 12-frame synthetic ring at the
small configuration of tests/test_torch_pipeline.py, both with bfloat16
LK storage (the JAX package's memoized storage dtype patched and the
traces that read it evicted, ``test_torch_lk_bf16.JaxLkStorage``; the
port's switch set for its run), held to the bars that file holds the
float32 runs to.  The LK level and the tracker in bfloat16 are held to
the JAX package in tests/test_torch_lk_bf16.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.ops import umeyama
from sfm_tpu_torch.ops.kernels import lk_kernels

from test_torch_lk_bf16 import JaxLkStorage

torch.set_num_threads(1)


CHUNK, P_CAP, P_BA = 4, 4096, 256


def _small_cfg(mod):
    """tests/test_torch_pipeline.py's small configuration (that of
    tests/test_scan_pipeline.py with global_iters=0), from either
    package's config module."""
    return mod.SystemConfig(
        frames=12,
        klt=mod.KLTConfig(max_tracks=512, min_tracks=300, pyr_levels=4,
                          win_radius=6, iters=16, min_distance=8),
        keyframe=mod.KeyframeConfig(min_inliers=60, min_gap=1,
                                    parallax_px=12.0),
        ransac=mod.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=30),
        ba=mod.BAConfig(window=4, iters=3, max_points=256, global_iters=0),
        loop=mod.LoopConfig(enabled=False),
    )


@pytest.fixture(scope="module")
def bf16_runs(synthetic_ring):
    """One JAX and one port ScanSfM run of the 12-frame ring, both with
    bfloat16 LK storage."""
    ds = synthetic_ring
    n = len(ds.records)
    with JaxLkStorage(jnp.bfloat16):
        sj = jsp.ScanSfM(ds.K, _small_cfg(jconfig), n_frames=n, chunk=CHUNK,
                         p_cap=P_CAP, p_ba=P_BA)
        for i in range(n):
            sj.process(i, ds.records[i].img, ds.load_gray(i))
        sj.finalize()
    old = os.environ.get("SFM_TPU_LK_BF16")
    os.environ["SFM_TPU_LK_BF16"] = "1"
    n16 = lk_kernels.bf16_launches
    try:
        st = sp.ScanSfM(ds.K, _small_cfg(config), n_frames=n, chunk=CHUNK,
                        p_cap=P_CAP, p_ba=P_BA, device="cpu")
        for i in range(n):
            st.process(i, ds.records[i].img, ds.load_gray(i))
        st.finalize()
    finally:
        if old is None:
            os.environ.pop("SFM_TPU_LK_BF16", None)
        else:
            os.environ["SFM_TPU_LK_BF16"] = old
    assert lk_kernels.bf16_launches == n16  # the CPU launches no kernel
    return ds, sj, st


def test_torch_scan_bf16_keyframes_map_and_ate(bf16_runs):
    """The port's ScanSfM with bfloat16 LK storage against the JAX
    package's, both on the 12-frame ring: the bars of
    test_torch_scan_keyframes_and_map (keyframes within one of JAX's, an
    odometry edge per keyframe, a map of the same order, the JAX twin's
    metric keys) and of test_torch_scan_ate_on_ring (Sim(3) ATE under 5 %
    of the trajectory's extent)."""
    ds, sj, s = bf16_runs
    kf_t = [kf.frame_idx for kf in s.kfs]
    kf_j = [kf.frame_idx for kf in sj.kfs]
    assert kf_t == sorted(kf_t) and kf_t[0] == 0
    assert abs(len(kf_t) - len(kf_j)) <= 1
    assert len(set(kf_t) ^ set(kf_j)) <= 1
    assert len(s.kfs) >= 4
    assert len(s.edges) == len(s.kfs) - 1
    assert len(s.map_xyz) > 200
    assert 0.5 < len(s.map_xyz) / len(sj.map_xyz) < 2.0
    assert len(s.metrics) == len(ds.records)
    for mt, mj in zip(s.metrics, sj.metrics):
        assert set(mt) == set(mj), (mt, mj)
    est = np.stack([kf.center for kf in s.kfs])
    gt = np.stack([ds.records[kf.frame_idx].center for kf in s.kfs])
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    assert float(res["rmse"]) / extent < 0.05
