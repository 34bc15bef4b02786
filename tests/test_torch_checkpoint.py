"""Checkpoint / resume of the PyTorch port (sfm_tpu_torch.utils.checkpoint),
on the CPU: for ``SfMSystem``, ``ScanSfM`` and ``run_scenes_scan`` a run
saved mid-way and resumed in a fresh object gives the uninterrupted run's
artifacts bit for bit, and a scan checkpoint written by the JAX package
loads into the port with every carry leaf equal.  Sizes of
tests/test_checkpoint.py: the 12-frame 640x480 ``synthetic_ring``, and the
reduced 320x240 out-and-back ring of tests/test_torch_loop.py where a loop
closure is to span the resume.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.models.system import SfMSystem
from sfm_tpu_torch.parallel import multi_scan as ms
from sfm_tpu_torch.utils import checkpoint
from tests.test_torch_loop import LONS, _cfg
from tests.test_torch_pipeline import _leaves, _small_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oab_rings(tmp_path_factory):
    """Two scenes of the 320x240 out-and-back ring (texture seeds 7, 8)."""
    from sfm_tpu.utils.dataset import TempleRing
    from sfm_tpu.utils.synthetic import SyntheticRingSpec, generate_dataset

    dss = []
    for s in range(2):
        out = tmp_path_factory.mktemp(f"ck_ring{s}")
        generate_dataset(out, SyntheticRingSpec(
            n_frames=len(LONS), width=320, height=240,
            fx=1100.0 * 320 / 480, fy=1100.0 * 320 / 480,
            path_lons_deg=LONS, seed=7 + s))
        dss.append(TempleRing.from_dir(out))
    return dss


def _files(out) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


def _system_cfg(loop: bool):
    """tests/test_checkpoint.py's ``make_system`` configuration (and its
    loop configuration for the case that spans a loop closure)."""
    cfg = config.SystemConfig(
        frames=12,
        klt=config.KLTConfig(max_tracks=512, min_tracks=300, min_distance=8,
                             pyr_levels=3, win_radius=5, iters=10),
        ransac=config.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                   min_inliers=40),
        keyframe=config.KeyframeConfig(min_inliers=150, min_gap=1,
                                       parallax_px=6.0),
        ba=config.BAConfig(window=6, iters=5, max_points=512,
                           global_iters=0),
    )
    if loop:
        cfg = dataclasses.replace(
            cfg, frames=len(LONS),
            loop=config.LoopConfig(enabled=True, min_kf_gap=6,
                                   score_thresh=0.94, min_tracked=120,
                                   ransac_iters=1024, ransac_thresh=2e-5,
                                   min_inliers=80),
            pose_graph=config.PoseGraphConfig(mode="se3", iters=10))
    return cfg


@pytest.mark.parametrize("case", ["ring", "loop"])
def test_torch_system_checkpoint_resume_is_exact(synthetic_ring, oab_rings,
                                                 tmp_path, case):
    """``SfMSystem``: saved after ``cut`` frames and resumed in a fresh
    system (the previous frame's pyramid, the tracker table and the
    generator state restored from the file), the rest of the frames give
    the uninterrupted run's keyframes, edges, map and exported files bit
    for bit.  Case "loop": the out-and-back ring, cut before the first
    revisit, so the loop closure verifies against keyframes restored from
    the checkpoint."""
    ds, n, cut = ((synthetic_ring, 8, 5) if case == "ring"
                  else (oab_rings[0], len(LONS), 9))
    cfg = _system_cfg(case == "loop")

    def run(s, frames):
        with torch.no_grad():
            for i in frames:
                s.process(i, ds.records[i].img, ds.load_gray(i))

    full = SfMSystem(ds.K, cfg, device="cpu")
    run(full, range(n))
    a = SfMSystem(ds.K, cfg, device="cpu")
    run(a, range(cut))
    checkpoint.save_checkpoint(a, tmp_path / "ck")
    assert not any(e.is_loop for e in a.edges)
    b = SfMSystem(ds.K, cfg, device="cpu")
    checkpoint.load_checkpoint(b, tmp_path / "ck")
    assert len(b.kfs) == len(a.kfs) and b.map.num_points == a.map.num_points
    assert all(torch.equal(x, y) for x, y in zip(b.prev_pyr, a.prev_pyr))
    assert torch.equal(b._gen.get_state(), a._gen.get_state())
    run(b, range(cut, n))
    if case == "loop":
        loops = [e for e in b.edges if e.is_loop]
        assert loops and any(b.kfs[e.i].frame_idx < cut for e in loops)
    for s in (full, b):
        s.finalize()
        s.export(tmp_path / f"out{id(s)}")
    assert [k.frame_idx for k in b.kfs] == [k.frame_idx for k in full.kfs]
    for k, k_ref in zip(b.kfs, full.kfs):
        np.testing.assert_array_equal(k.R_cw, k_ref.R_cw)
        np.testing.assert_array_equal(k.t_cw, k_ref.t_cw)
    assert ([(e.i, e.j, e.is_loop) for e in b.edges]
            == [(e.i, e.j, e.is_loop) for e in full.edges])
    np.testing.assert_array_equal(b.map.xyz(), full.map.xyz())
    assert (_files(tmp_path / f"out{id(b)}")
            == _files(tmp_path / f"out{id(full)}"))


def test_torch_scan_checkpoint_resume_is_exact(synthetic_ring, tmp_path):
    """``ScanSfM``: saved at a chunk boundary (bootstrap + two chunks of
    3) and resumed in a fresh object, the run gives the uninterrupted
    run's keyframes, map and exported files bit for bit."""
    ds = synthetic_ring
    n = len(ds.records)
    cfg = _small_cfg(config)
    kw = dict(n_frames=n, chunk=3, p_cap=4096, p_ba=256, device="cpu")

    def run(s, frames, end=True):
        with torch.no_grad():
            for i in frames:
                s.process(i, ds.records[i].img, ds.load_gray(i))
            if end:
                s.finalize()

    ref = sp.ScanSfM(ds.K, cfg, **kw)
    run(ref, range(n))
    a = sp.ScanSfM(ds.K, cfg, **kw)
    run(a, range(7), end=False)
    checkpoint.save_scan_checkpoint(a, tmp_path / "ck")
    b = sp.ScanSfM(ds.K, cfg, **kw)
    checkpoint.load_scan_checkpoint(b, tmp_path / "ck")
    assert torch.equal(b.carry.gen.get_state(), a.carry.gen.get_state())
    run(b, range(7, n))
    for s, name in ((ref, "ref"), (b, "res")):
        s.export(tmp_path / name)
    assert [k.frame_idx for k in b.kfs] == [k.frame_idx for k in ref.kfs]
    np.testing.assert_array_equal(np.stack([k.center for k in b.kfs]),
                                  np.stack([k.center for k in ref.kfs]))
    np.testing.assert_array_equal(b.map_xyz, ref.map_xyz)
    assert _files(tmp_path / "res") == _files(tmp_path / "ref")


def test_torch_multiscene_checkpoint_resume_is_exact(oab_rings, tmp_path,
                                                     monkeypatch):
    """``run_scenes_scan`` on two scenes with loop closure: a run that
    checkpoints every chunk and dies after the second checkpoint, resumed
    from it, reproduces the uninterrupted run exactly: the metric rows,
    keyframes, map sizes, centers and loop edges of every scene (the
    revisit closes loops both before and after the resume)."""
    n = len(LONS)
    cfg = _cfg(config)
    kw = dict(frames=n, chunk=6, p_cap=4096, p_ba=256, device="cpu")
    ref = ms.run_scenes_scan(oab_rings, cfg, **kw)
    ck = tmp_path / "ms_ck"

    class _Die(Exception):
        pass

    orig = checkpoint.save_multiscene_checkpoint
    calls = []

    def save_then_die(*a, **k):
        orig(*a, **k)
        calls.append(a[-2])
        if len(calls) == 2:
            raise _Die()

    monkeypatch.setattr(checkpoint, "save_multiscene_checkpoint",
                        save_then_die)
    with pytest.raises(_Die):
        ms.run_scenes_scan(oab_rings, cfg, checkpoint_path=ck,
                           checkpoint_every=1, **kw)
    monkeypatch.undo()
    assert calls == [1, 2]
    res = ms.run_scenes_scan(oab_rings, cfg, checkpoint_path=ck,
                             resume=True, **kw)
    np.testing.assert_array_equal(res["metrics"], ref["metrics"])
    np.testing.assert_array_equal(res["n_keyframes"], ref["n_keyframes"])
    np.testing.assert_array_equal(res["n_points"], ref["n_points"])
    for s in range(2):
        np.testing.assert_array_equal(res["kf_frames"][s],
                                      ref["kf_frames"][s])
        np.testing.assert_array_equal(res["centers"][s], ref["centers"][s])
        np.testing.assert_array_equal(res["views"][s].map_xyz,
                                      ref["views"][s].map_xyz)
        loops = [(e.i, e.j) for e in res["loop_edges"][s]]
        assert loops == [(e.i, e.j) for e in ref["loop_edges"][s]]
        assert loops


def test_torch_loads_jax_scan_checkpoint(oab_rings, tmp_path):
    """A scan checkpoint written by the JAX package (bootstrap + one chunk
    of 3 frames of the out-and-back ring, device verification on, so the
    ring holds keyframe grays) loads into the port's ``ScanSfM``: every
    carry leaf equal to the JAX carry's, the keyframe images, names,
    metrics and pose-graph flag restored, and the generator seeded from
    ``cfg.ransac.seed`` (the JAX file's key has no torch counterpart)."""
    from sfm_tpu import config as jconfig
    from sfm_tpu.models import scan_pipeline as jsp
    from sfm_tpu.utils import checkpoint as jcheckpoint

    ds = oab_rings[0]
    kw = dict(n_frames=len(LONS), chunk=3, p_cap=4096, p_ba=256)
    js = jsp.ScanSfM(ds.K, _cfg(jconfig), **kw)
    for i in range(4):
        js.process(i, ds.records[i].img, ds.load_gray(i))
    jcheckpoint.save_scan_checkpoint(js, tmp_path / "jck")
    want = _leaves(js.carry)
    cfg = _cfg(config)
    ts = sp.ScanSfM(ds.K, cfg, device="cpu", **kw)
    checkpoint.load_scan_checkpoint(ts, tmp_path / "jck")
    got = sp.carry_to_numpy(ts.carry)
    for k in sp._CARRY_DTYPES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for grp in ("trk", "ring"):
        assert set(got[grp]) == set(want[grp])
        for k in got[grp]:
            np.testing.assert_array_equal(got[grp][k], want[grp][k],
                                          err_msg=f"{grp}.{k}")
    for p, q in zip(got["prev_pyr"], want["prev_pyr"]):
        np.testing.assert_array_equal(p, q)
    assert got["ring"]["img"][:4].any()  # the keyframe grays came along
    seeded = torch.Generator().manual_seed(cfg.ransac.seed)
    assert torch.equal(ts.carry.gen.get_state(), seeded.get_state())
    assert ts._names == js._names and ts.metrics == js.metrics
    assert sorted(ts._images) == sorted(js._images)
    assert ts._pg_ran == js._pg_ran
