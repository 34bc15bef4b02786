"""PyTorch port vs JAX package: the scan pipeline as a whole, on the CPU.

Two checks on the 12-frame synthetic ring with the small configuration of
tests/test_scan_pipeline.py, with loop closure off and ``ba.global_iters=0``
(loop closure and the finalize refinement are held to the JAX package in
tests/test_torch_loop.py):

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

One module-scoped fixture makes the one JAX run that both share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp, tracker as jtracker

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.ops import umeyama
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


def _jax_carry(d: dict):
    return jsp.ScanCarry(
        trk=jtracker.TrackerState(
            **{k: jnp.asarray(v) for k, v in d["trk"].items()}),
        prev_pyr=tuple(jnp.asarray(p) for p in d["prev_pyr"]),
        ring=jsp.KeyframeRing(
            **{k: jnp.asarray(v) for k, v in d["ring"].items()}),
        **{k: jnp.asarray(d[k])
           for k in ("R_cw", "t_cw", "last_kf_frame", "kf_count",
                     "slot_pid", "fo_kf", "fo_uv", "X", "n_pts", "key")})


@pytest.fixture(scope="module")
def jax_run(synthetic_ring):
    """The JAX pipeline over the whole ring; its carry is snapshotted after
    frames 4 and 8 (chunk boundaries), and from each snapshot one more
    frame is run through the same compiled ``run_chunk``."""
    ds = synthetic_ring
    n = len(ds.records)
    cfg = _small_cfg(jconfig)
    s = jsp.ScanSfM(ds.K, cfg, n_frames=n, chunk=CHUNK, p_cap=P_CAP,
                    p_ba=P_BA)
    snaps = {}
    for i in range(n):
        s.process(i, ds.records[i].img, ds.load_gray(i))
        if i in STEP_AFTER:
            assert not s._pending  # the chunk was flushed
            snaps[i] = _leaves(s.carry)
    s.finalize()

    steps = {}
    for k, leaves in snaps.items():
        g = ds.load_gray(k + 1)
        imgs = jnp.stack([jnp.asarray(g)] + [jnp.zeros_like(g)] * (CHUNK - 1))
        idxs = np.zeros((CHUNK,), np.int32)
        idxs[0] = k + 1
        fvalid = np.zeros((CHUNK,), bool)
        fvalid[0] = True
        carry, ys = jsp.run_chunk(cfg, s.p_ba, s._Kj, _jax_carry(leaves),
                                  imgs, jnp.asarray(idxs),
                                  jnp.asarray(fvalid))
        # the sampling priorities that frame drew (scan_pipeline's prefix
        # splits the key in three; find_E_ransac draws uniform (H,N))
        _, k1, k2 = jax.random.split(jnp.asarray(leaves["key"]), 3)
        shape = (cfg.ransac.num_hypotheses, cfg.klt.max_tracks)
        steps[k] = dict(
            leaves=leaves, gray=g, y=np.asarray(ys[0], np.float64),
            after=_leaves(carry),
            pri_frame=np.asarray(jax.random.uniform(k1, shape, jnp.float32)),
            pri_edge=np.asarray(jax.random.uniform(k2, shape, jnp.float32)))
    return ds, s, steps


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
# (a) one frame from a converted carry
# ---------------------------------------------------------------------------


def test_torch_carry_roundtrip_is_exact(jax_run):
    """JAX leaves -> port carry -> numpy: field for field, dtype for dtype
    (the PRNG key is dropped, the port carries a Generator)."""
    _, _, steps = jax_run
    leaves = steps[STEP_AFTER[0]]["leaves"]
    carry = sp.carry_from_numpy(leaves, device="cpu")
    assert isinstance(carry.gen, torch.Generator)
    back = sp.carry_to_numpy(carry)
    assert "key" not in back
    for k, v in leaves.items():
        if k == "key":
            continue
        if isinstance(v, dict):
            assert set(back[k]) == set(v), k
            pairs = [(f"{k}.{f}", back[k][f], v[f]) for f in v]
        elif isinstance(v, list):
            assert len(back[k]) == len(v)
            pairs = [(f"{k}[{i}]", a, b)
                     for i, (a, b) in enumerate(zip(back[k], v))]
        else:
            pairs = [(k, back[k], v)]
        for name, a, b in pairs:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    # the converted carry owns its memory: the port updates it in place
    assert not np.shares_memory(carry.X.numpy(), leaves["X"])
    carry.X.zero_()
    assert leaves["X"].any() and not sp.carry_to_numpy(carry)["X"].any()


@pytest.mark.parametrize("k", STEP_AFTER)
def test_torch_frame_step_from_jax_carry(jax_run, k):
    """Frame k+1 from the JAX carry after frame k, same priorities.

    Both sides compute in float32 and differ by summation order and fused
    multiply-adds only, so: the track table agrees on >= 99 % of the slots
    and matched tracks within 1e-3 px (as tracker.step alone); the same
    keyframe decision; inlier counts within 2 %; the new pose within 2e-3
    in rotation and 2 % of the step's baseline in position (the pose comes
    out of a ten-step PnP and a three-step window BA, each a chain of
    float32 6x6 solves, seeded from inlier sets that may differ by a few
    tracks); newly triangulated points within 2 % in count, and the map's
    common points within 2 % of the scene's depth at the median."""
    ds, _, steps = jax_run
    st = steps[k]
    cfg = _small_cfg(config)
    Kt = torch.as_tensor(np.asarray(ds.K, np.float32))
    carry = sp.carry_from_numpy(st["leaves"], device="cpu")
    with torch.no_grad():
        carry, y = sp.frame_step(
            cfg, P_BA, Kt, carry, torch.as_tensor(st["gray"]), k + 1,
            pri_frame=torch.as_tensor(st["pri_frame"]),
            pri_edge=torch.as_tensor(st["pri_edge"]))
    y = y.numpy().astype(np.float64)
    yj = st["y"]
    assert y.shape == yj.shape == (sp.NY,)
    got, want = sp.carry_to_numpy(carry), st["after"]

    # tracker
    vj, vt = want["trk"]["valid"], got["trk"]["valid"]
    assert (vj == vt).mean() >= 0.99
    # tracks that survived the frame keep slot and id on both sides; a
    # replenish (frame 5 has one) hands the free slots to new corners, whose
    # order may differ by a tie in the corner ranking
    old = st["leaves"]["trk"]["ids"]
    kept_j = vj & (want["trk"]["ids"] == old) & (old >= 0)
    kept_t = vt & (got["trk"]["ids"] == old) & (old >= 0)
    assert (kept_j == kept_t).mean() >= 0.99
    kept = kept_j & kept_t
    assert kept.sum() > 100
    d = np.abs(got["trk"]["pos"][kept] - want["trk"]["pos"][kept]).max(-1)
    assert (d < 1e-3).mean() >= 0.99
    assert abs((vt & ~kept_t).sum() - (vj & ~kept_j).sum()) <= 3
    assert abs(int(got["trk"]["next_id"])
               - int(want["trk"]["next_id"])) <= 3
    assert abs(y[sp.Y_ALIVE] - yj[sp.Y_ALIVE]) <= 0.01 * yj[sp.Y_ALIVE]

    # two-view result and the keyframe decision
    for col in (sp.Y_FRAME, sp.Y_VALID, sp.Y_KF, sp.Y_OK, sp.Y_KFID):
        assert y[col] == yj[col], col
    assert abs(y[sp.Y_INL] - yj[sp.Y_INL]) <= 0.02 * yj[sp.Y_INL]
    # the median flow moves by a rank or two of ~300 sorted flows when the
    # matched sets differ by a few tracks
    assert abs(y[sp.Y_PAR] - yj[sp.Y_PAR]) < 0.1
    assert int(got["kf_count"]) == int(want["kf_count"])
    assert int(got["last_kf_frame"]) == int(want["last_kf_frame"])

    # pose
    np.testing.assert_allclose(got["R_cw"], want["R_cw"], atol=2e-3)
    kf = int(want["kf_count"]) - 1
    ring_j = want["ring"]
    base = np.linalg.norm(ring_j["t_cw"][kf] - ring_j["t_cw"][kf - 1])
    assert np.linalg.norm(got["t_cw"] - want["t_cw"]) < 0.02 * base

    if yj[sp.Y_KF] > 0.5:
        for col in (sp.Y_EDGE_INL, sp.Y_PNP_INL, sp.Y_NEW_PTS, sp.Y_NPTS):
            assert abs(y[col] - yj[col]) <= max(0.02 * yj[col], 2), col
        assert abs(y[sp.Y_SCALE] - yj[sp.Y_SCALE]) < 0.02 * yj[sp.Y_SCALE]
        # BA costs: sums of a few thousand squared residuals of ~1e-4
        np.testing.assert_allclose(y[[sp.Y_BA0, sp.Y_BA1]],
                                   yj[[sp.Y_BA0, sp.Y_BA1]], rtol=0.05)
        ring_t = got["ring"]
        np.testing.assert_array_equal(ring_t["frame"], ring_j["frame"])
        np.testing.assert_array_equal(ring_t["kvalid"], ring_j["kvalid"])
        np.testing.assert_array_equal(ring_t["e_valid"], ring_j["e_valid"])
        np.testing.assert_allclose(ring_t["R_cw"], ring_j["R_cw"], atol=2e-3)
        assert np.abs(ring_t["t_cw"] - ring_j["t_cw"]).max() < 0.02 * base
        np.testing.assert_allclose(ring_t["e_Rji"][kf], ring_j["e_Rji"][kf],
                                   atol=2e-3)
        np.testing.assert_allclose(ring_t["desc"][kf], ring_j["desc"][kf],
                                   atol=1e-5)
        # observation table: same entries wherever both sides mapped a slot
        pj, pt = ring_j["pid"][:kf + 1], ring_t["pid"][:kf + 1]
        assert ((pj >= 0) == (pt >= 0)).mean() >= 0.99
        # map: points that existed before the frame keep their ids
        n0 = int(st["leaves"]["n_pts"])
        depth = float(np.median(np.linalg.norm(
            want["X"][:n0] - want["t_cw"], axis=1)))
        dX = np.linalg.norm(got["X"][:n0] - want["X"][:n0], axis=1)
        assert np.median(dX) < 0.02 * depth
    else:
        assert int(got["n_pts"]) == int(want["n_pts"])
        np.testing.assert_array_equal(got["X"], want["X"])


# ---------------------------------------------------------------------------
# (b) the port alone, end to end
# ---------------------------------------------------------------------------


def test_torch_scan_keyframes_and_map(jax_run, torch_run):
    """Same keyframe cadence as the JAX run (within one keyframe: the two
    runs draw different RANSAC samples), one odometry edge per keyframe
    after the first, a map of the same order, metrics for every frame with
    the JAX twin's keys."""
    ds, s = torch_run
    _, sj, _ = jax_run
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
    assert all(t.device.type == "cpu" for t in sp.carry_tensors(s.carry))


def test_torch_scan_ate_on_ring(torch_run):
    """The bar of tests/test_scan_pipeline.py: Sim(3)-aligned ATE under 5 %
    of the trajectory's extent."""
    ds, s = torch_run
    est = np.stack([kf.center for kf in s.kfs])
    gt = np.stack([ds.records[kf.frame_idx].center for kf in s.kfs])
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    ratio = float(res["rmse"]) / extent
    assert ratio < 0.05, f"port scan-pipeline ATE {ratio:.3%} of extent"


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
    flavor is not ported and says so; use_gt_scale without the dataset's
    GT records raises ValueError, as in the JAX package; the default
    configuration (loop closure with device-side verification, the final
    structure refinement) constructs."""
    K = synthetic_ring.K
    if case == "orb_loops":
        cfg = dataclasses.replace(
            _small_cfg(config),
            loop=config.LoopConfig(enabled=True, method="orb"))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sp.ScanSfM(K, cfg, n_frames=12, device="cpu")
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


def test_torch_run_chunk_padding_frames_are_noops(jax_run):
    """A padding frame (fvalid False) leaves the carry alone and gives an
    all-zero metrics row, as in the JAX twin."""
    ds, _, steps = jax_run
    st = steps[STEP_AFTER[0]]
    carry = sp.carry_from_numpy(st["leaves"], device="cpu")
    Kt = torch.as_tensor(np.asarray(ds.K, np.float32))
    img = torch.as_tensor(st["gray"])
    with torch.no_grad():
        carry, ys = sp.run_chunk(_small_cfg(config), P_BA, Kt, carry,
                                 [img, img], np.array([5, 6], np.int32),
                                 np.array([False, False]))
    assert ys.shape == (2, sp.NY) and not ys.any()
    back = sp.carry_to_numpy(carry)
    np.testing.assert_array_equal(back["X"], st["leaves"]["X"])
    np.testing.assert_array_equal(back["trk"]["pos"],
                                  st["leaves"]["trk"]["pos"])
