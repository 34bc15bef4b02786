"""PyTorch port vs JAX package: the ORB loop flavor, on the CPU.

Unit checks of ops/orb.py on frames of a synthetic ring (the BRIEF
pattern, keypoints and descriptors, Hamming matching, candidate ranking,
the batched bank score), then one module-scoped JAX run and one port run
of ``ScanSfM`` with ``loop.method="orb"`` on tests/test_torch_loop.py's
15-frame 320x240 out-and-back ring, the port handed the JAX run's own
per-frame RANSAC draws: the same ORB loop candidates and edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp
from sfm_tpu.ops import orb as jorb
from sfm_tpu.utils.dataset import TempleRing
from sfm_tpu.utils.synthetic import SyntheticRingSpec, generate_dataset

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.ops import orb

torch.set_num_threads(1)

CHUNK, P_CAP, P_BA = 3, 4096, 256
LONS = tuple(list(np.arange(0, 36, 5.0)) + list(np.arange(30, -1, -5.0)))


def orb_cfg(mod):
    """tests/test_torch_loop.py's ``_cfg`` with ``loop.method="orb"``, from
    either config module."""
    return mod.SystemConfig(
        frames=len(LONS),
        klt=mod.KLTConfig(max_tracks=512, min_tracks=300, pyr_levels=4,
                          win_radius=6, iters=16, min_distance=8),
        keyframe=mod.KeyframeConfig(min_inliers=60, min_gap=1,
                                    parallax_px=8.0),
        ransac=mod.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=30),
        ba=mod.BAConfig(window=4, iters=3, max_points=256, global_iters=5),
        loop=mod.LoopConfig(enabled=True, method="orb", min_kf_gap=6,
                            score_thresh=0.94, min_tracked=120,
                            ransac_iters=1024, ransac_thresh=2e-5,
                            min_inliers=80, device_verify=True),
        pose_graph=mod.PoseGraphConfig(mode="se3", iters=10),
    )


@pytest.fixture(scope="module")
def out_and_back(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_orb")
    generate_dataset(out, SyntheticRingSpec(
        n_frames=len(LONS), width=320, height=240, fx=1100.0 * 320 / 480,
        fy=1100.0 * 320 / 480, path_lons_deg=LONS))
    return TempleRing.from_dir(out)


def _feats_jax(img):
    xy, d, v = jorb.detect_and_describe(jnp.asarray(img, jnp.float32))
    return np.asarray(xy), np.asarray(d), np.asarray(v)


def _feats_port(img):
    xy, d, v = orb.detect_and_describe(torch.as_tensor(img).float(),
                                       device="cpu")
    return xy.numpy(), d.numpy(), v.numpy()


def test_torch_brief_pattern_is_jax_bit_for_bit():
    got = orb._brief_pattern().numpy()
    want = np.asarray(jorb._brief_pattern())
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (orb.N_BITS, 2, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(orb._PATTERN.numpy(), want)


def test_torch_detect_and_describe_matches_jax(out_and_back):
    """Keypoints: the same count, and >= 98 % of the port's keypoints at a
    JAX keypoint (the rest are corner-cell ranking ties, as for
    ``detect_corners``).  On keypoints both sides found, >= 99 % of the
    descriptor bits equal: a bit is a comparison of two blurred samples,
    and the blur's box sums are cumulative-sum differences in JAX and
    direct sums here (ops/image.box_filter), so a near-tie can flip."""
    img = out_and_back.load_gray(0)
    xj, dj, vj = _feats_jax(img)
    xt, dt, vt = _feats_port(img)
    assert xt.shape == xj.shape and dt.shape == dj.shape == (512, 256)
    assert int(vt.sum()) == int(vj.sum()) > 300
    key = {tuple(p): i for i, p in enumerate(xj[vj].round(3))}
    pairs = [(i, key[tuple(p)]) for i, p in
             zip(np.nonzero(vt)[0], xt[vt].round(3)) if tuple(p) in key]
    assert len(pairs) >= 0.98 * int(vt.sum())
    it, ij = np.array(pairs).T
    ij = np.nonzero(vj)[0][ij]
    assert np.mean(dt[it] == dj[ij]) >= 0.99
    assert set(np.unique(dt)) <= {0.0, 1.0}


def test_torch_match_hamming_and_candidates_match_jax(out_and_back):
    """On the same (JAX) descriptors the distances are integers on both
    sides, so best index, ratio test and distance agree exactly; the
    batched bank score counts equal JAX's vmapped ones; the host-side
    candidate ranking is the same."""
    ds = out_and_back
    feats = [_feats_jax(ds.load_gray(i)) for i in (0, 1, 14)]
    _, da, va = feats[0]
    for _, db, vb in feats[1:]:
        ij, okj, dj = (np.asarray(x) for x in jorb.match_hamming(
            jnp.asarray(da), jnp.asarray(va), jnp.asarray(db),
            jnp.asarray(vb)))
        it, okt, dt = (x.numpy() for x in orb.match_hamming(
            torch.as_tensor(da), torch.as_tensor(va), torch.as_tensor(db),
            torch.as_tensor(vb)))
        np.testing.assert_array_equal(okt, okj)
        np.testing.assert_array_equal(it[okj], ij[okj])
        np.testing.assert_array_equal(dt, dj)
        assert okj.sum() > 50
    bank = np.stack([f[1] for f in feats] + [np.zeros_like(da)])
    bval = np.stack([f[2] for f in feats] + [np.zeros_like(va)])
    cj = np.asarray(jsp._orb_score_bank(jnp.asarray(bank), jnp.asarray(bval),
                                        jnp.asarray(da), jnp.asarray(va)))
    ct = sp._orb_score_bank(torch.as_tensor(bank), torch.as_tensor(bval),
                            torch.as_tensor(da), torch.as_tensor(va)).numpy()
    np.testing.assert_array_equal(ct, cj)
    counts = np.random.default_rng(0).integers(0, 40, 20)
    for kf_id, gap, k in ((19, 6, 5), (10, 3, 2), (4, 6, 5)):
        assert orb.propose_candidates(counts, kf_id, gap, k) == \
            jorb.propose_candidates(counts, kf_id, gap, k)


@pytest.fixture(scope="module")
def orb_runs(out_and_back):
    ds = out_and_back
    n = len(ds.records)
    cfg_j = orb_cfg(jconfig)
    sj = jsp.ScanSfM(ds.K, cfg_j, n_frames=n, chunk=CHUNK, p_cap=P_CAP,
                     p_ba=P_BA)
    for i in range(n):
        sj.process(i, ds.records[i].img, ds.load_gray(i))
    sj.finalize()
    key = [jax.random.PRNGKey(cfg_j.ransac.seed)]
    shape = (cfg_j.ransac.num_hypotheses, cfg_j.klt.max_tracks)

    def draws(idx):
        key[0], k1, k2 = jax.random.split(key[0], 3)
        return (np.asarray(jax.random.uniform(k1, shape, jnp.float32)),
                np.asarray(jax.random.uniform(k2, shape, jnp.float32)))

    st = sp.ScanSfM(ds.K, orb_cfg(config), n_frames=n, chunk=CHUNK,
                    p_cap=P_CAP, p_ba=P_BA, device="cpu")
    st._pri_source = draws
    for i in range(n):
        st.process(i, ds.records[i].img, ds.load_gray(i))
    st.finalize()
    return ds, sj, st


def test_torch_scan_orb_loop_edges_match_jax(orb_runs):
    """``ScanSfM`` with ``loop.method="orb"`` no longer raises, scores every
    keyframe's ORB features (the same keyframes as JAX), and closes the
    same loops at the same frames as JAX: the same (candidate, keyframe)
    edges, their PnP inlier counts within 3 % (the runs differ by a track
    or two from frame 2 on, ROADMAP Queue 3).  The final bank scores of
    the last keyframe against every older one are within 5 % of JAX's."""
    ds, sj, st = orb_runs
    lj = [e for e in sj.edges if e.is_loop]
    lt = [e for e in st.edges if e.is_loop]
    assert [(e.i, e.j) for e in lt] == [(e.i, e.j) for e in lj]
    assert len(lj) >= 3
    for a, b in zip(lj, lt):
        assert abs(a.inliers - b.inliers) <= 0.03 * a.inliers, (a, b)
    assert [m.get("loop") for m in st.metrics] == \
        [m.get("loop") for m in sj.metrics]
    assert sorted(st._orb_ids) == sorted(sj._orb_ids) == \
        list(range(len(st.kfs)))
    last = max(st._orb_ids)
    cj = np.asarray(jsp._orb_score_bank(
        sj._orb_bank, sj._orb_bank_valid, *sj._orb_ids[last][1:]))
    ct = sp._orb_score_bank(st._orb_bank, st._orb_bank_valid,
                            *st._orb_ids[last][1:]).numpy()
    np.testing.assert_allclose(ct[:last], cj[:last], rtol=0.05, atol=2)
    assert st.host_verifications >= len(lt)
