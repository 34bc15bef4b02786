"""PyTorch port vs JAX package: the scan pipeline as a whole, on the CPU.

Checks on the 12-frame synthetic ring with the small configuration of
tests/test_scan_pipeline.py, with loop closure off and ``ba.global_iters=0``
(loop closure and the finalize refinement are held to the JAX package in
tests/test_torch_loop.py and tests/test_torch_loop_run.py):

(a) one frame from the same state.  The JAX pipeline runs k frames, its
    carry is pulled leaf by leaf and converted (``carry_from_numpy``), and
    frame k+1 goes through both sides with the same RANSAC sampling
    priorities (JAX draws them from the carry's key; the port takes them
    through ``pri=``).  Over many frames the pipeline is chaotic (one
    flipped inlier moves a pose, which moves every later frame), so parity
    is checkable frame by frame only;
(b) the port alone from the first frame to the exported artifacts, held to
    the accuracy bar of the JAX package's own end-to-end test and to the
    JAX run's keyframe list.

This file holds the port's run (``torch_run``) with the checks of (b) that
need no JAX run, and what the constructor refuses.  The one JAX run
(``jax_run``), (a), and the checks of (b) against it or beside it are in
tests/test_torch_pipeline_run.py, a file of its own: pytest-xdist's
``--dist loadfile`` hands out the files that collect more tests first, so
that file's runs start after the JAX package's longest file.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.utils import artifacts

torch.set_num_threads(1)

CHUNK, P_CAP, P_BA = 4, 4096, 256
STEP_AFTER = (4, 8)  # frames done when the JAX carry is snapshotted


def _small_cfg(mod):
    """``_small_cfg`` of tests/test_scan_pipeline.py with global_iters=0,
    built from either package's config module."""
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


def _leaves(c) -> dict:
    """A JAX ScanCarry as nested dicts of numpy arrays."""
    d = {k: np.asarray(getattr(c, k))
         for k in ("R_cw", "t_cw", "last_kf_frame", "kf_count", "slot_pid",
                   "fo_kf", "fo_uv", "X", "n_pts", "key")}
    d["trk"] = {k: np.asarray(v) for k, v in c.trk._asdict().items()}
    d["prev_pyr"] = [np.asarray(p) for p in c.prev_pyr]
    d["ring"] = {k: np.asarray(v) for k, v in c.ring._asdict().items()}
    return d


@pytest.fixture(scope="module")
def torch_run(synthetic_ring):
    ds = synthetic_ring
    n = len(ds.records)
    s = sp.ScanSfM(ds.K, _small_cfg(config), n_frames=n, chunk=CHUNK,
                   p_cap=P_CAP, p_ba=P_BA, device="cpu")
    for i in range(n):
        s.process(i, ds.records[i].img, ds.load_gray(i))
    s.finalize()
    return ds, s


# ---------------------------------------------------------------------------
# (b) the port alone, end to end
# ---------------------------------------------------------------------------


def test_torch_scan_export_artifacts(torch_run, tmp_path):
    """The three artifacts parse with the readers of BOTH packages."""
    from sfm_tpu.utils import artifacts as jart

    ds, s = torch_run
    info = s.export(tmp_path, dataset=ds)
    assert info["keyframes"] == len(s.kfs)
    assert info["culled"] <= 0.1 * info["map_points"]
    centers = tmp_path / "keyframes_camera_centers.csv"
    edges = tmp_path / "posegraph_edges.csv"
    ply = tmp_path / "templeRing_sparse_points.ply"
    rows = artifacts.read_csv_centers(centers)
    assert len(rows) == len(jart.read_csv_centers(centers)) == len(s.kfs)
    xyz = artifacts.read_ply_xyz(ply)
    np.testing.assert_array_equal(xyz, jart.read_ply_xyz(ply))
    assert len(xyz) == info["map_points"] - info["culled"]
    lines = edges.read_text().splitlines()
    assert "kind" in lines[0] and len(lines) == 1 + len(s.edges)


def test_torch_scan_observation_backfill(torch_run):
    """Every map point is observed by at least two keyframes."""
    _, s = torch_run
    n_obs = np.zeros(len(s.map_xyz), np.int64)
    for row in s._ring_pid:
        np.add.at(n_obs, row[row >= 0], 1)
    assert (n_obs >= 2).mean() > 0.9


@pytest.mark.parametrize("case", ["orb_loops", "gt_scale_without_records",
                                  "default_config"])
def test_torch_scan_refuses_what_waits(synthetic_ring, case):
    """What the constructor refuses, and what it now takes: the ORB loop
    flavor constructs, as in the JAX package, and keeps its keyframe images
    for the ORB features (it is held to the JAX package in
    tests/test_torch_orb.py); use_gt_scale without the dataset's GT
    records raises ValueError, as in the JAX package; the default
    configuration (loop closure with device-side verification, the final
    structure refinement) constructs."""
    K = synthetic_ring.K
    if case == "orb_loops":
        cfg = dataclasses.replace(
            _small_cfg(config),
            loop=config.LoopConfig(enabled=True, method="orb"))
        jsp.ScanSfM(K, dataclasses.replace(
            _small_cfg(jconfig),
            loop=jconfig.LoopConfig(enabled=True, method="orb")), n_frames=12)
        s = sp.ScanSfM(K, cfg, n_frames=12, device="cpu")
        assert s._keep_images and s._orb_bank is None and not s._orb_ids
    elif case == "gt_scale_without_records":
        cfg = dataclasses.replace(_small_cfg(config), use_gt_scale=True)
        jcfg = dataclasses.replace(_small_cfg(jconfig), use_gt_scale=True)
        with pytest.raises(ValueError, match="gt_records"):
            jsp.ScanSfM(K, jcfg, n_frames=12)
        with pytest.raises(ValueError, match="gt_records"):
            sp.ScanSfM(K, cfg, n_frames=12, device="cpu")
        s = sp.ScanSfM(K, cfg, n_frames=12, device="cpu",
                       gt_records=synthetic_ring.records)
        assert s._gt_C.shape == (len(synthetic_ring.records), 3)
    else:
        cfg = config.SystemConfig()
        assert cfg.loop.enabled and cfg.loop.device_verify
        assert cfg.ba.global_iters > 0
        s = sp.ScanSfM(K, cfg, n_frames=12, device="cpu")
        assert s.device.type == "cpu" and s.carry is None


def test_torch_scan_default_device_raises_without_cuda(synthetic_ring):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.ScanSfM(synthetic_ring.K, _small_cfg(config), n_frames=12)
