"""PyTorch port vs JAX package: the scan pipeline as a whole, on the CPU:
the checks that need the JAX run.

The one module-scoped JAX run of tests/test_torch_pipeline.py's 12-frame
ring and configuration (``jax_run``), with (a) of that file: one frame
from the same state on both sides; and the checks of (b) made against the
JAX run's keyframe list or beside it on the port's run (``torch_run``,
that file's fixture).
"""

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
from tests.test_torch_pipeline import (CHUNK, P_BA, P_CAP, STEP_AFTER,
                                       _leaves, _small_cfg)
from tests.test_torch_pipeline import torch_run  # noqa: F401 (fixture)

torch.set_num_threads(1)


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
# (b) the port alone, end to end: against the JAX run and beside it
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
