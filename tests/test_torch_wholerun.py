"""PyTorch port vs JAX package over a whole run, on the CPU (marked
``slow``: tens of minutes; not part of tier-1).

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_wholerun.py -s

The 47-frame 640x480 360-degree synthetic ring at the bench configuration
of ``chip_smoke.smoke_config()`` (full width: 2200 tracks, 4 levels, 16 LK
iterations, radius 6, 1024 hypotheses, loop closure with device-side
verification, SE(3) pose graph, finalize at 10 iterations), through the
JAX package and through the port (``device="cpu"``), once with ``ScanSfM``
and once with ``SfMSystem``.  The port is handed the JAX package's own
RANSAC draws: ``ScanSfM``'s prefix splits its carry key in three every
frame (one (H,T) draw for the frame's two-view RANSAC, one for the
keyframe edge), ``SfMSystem`` splits its key once per RANSAC call.  Loop
verification draws nothing (PnP).

The pipeline is chaotic (tests/test_torch_pipeline.py): the first frame at
which a keyframe decision, a track count or an inlier count differs is
reported, not asserted; then the end counts and both Sim(3) ATE ratios.
Asserted: the same loop edges, keyframe count and map size within the
tolerances stated at the asserts, and both ATE ratios under 5 %.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp, system as jsystem

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp, system
from sfm_tpu_torch.ops import umeyama
from sfm_tpu_torch.utils.dataset import TempleRing
from sfm_tpu_torch.utils.synthetic import SyntheticRingSpec, generate_dataset

pytestmark = pytest.mark.slow

FRAMES = 47


def _overrides() -> dict:
    """The overrides of chip_smoke.smoke_config()."""
    return {
        "frames": FRAMES,
        "klt.max_tracks": 2200,
        "klt.pyr_levels": 4,
        "klt.iters": 16,
        "klt.win_radius": 6,
        "ransac.num_hypotheses": 1024,
        "ransac.sampson_thresh": 2e-5,
        "ba.iters": 3,
        "ba.window": 6,
        "loop.enabled": True,
        "loop.device_verify": True,
        "loop.score_thresh": 0.3,
        "loop.ransac_thresh": 2e-5,
    }


def _smoke_config(mod):
    """chip_smoke.smoke_config(), from either package's config module."""
    return mod.load_config(None, overrides=_overrides())


@pytest.fixture(scope="module")
def ring47(tmp_path_factory):
    """chip_smoke.ring_spec(): the 47-frame 640x480 360-degree ring."""
    out = tmp_path_factory.mktemp("ring47")
    generate_dataset(out, SyntheticRingSpec(
        n_frames=FRAMES, width=640, height=480, fx=1520.0, fy=1520.0,
        cylinder_radius=0.10, cylinder_zmin=-0.10, cylinder_zmax=0.10,
        ring_radius=0.60, ring_z=0.05, arc_deg=360.0, texture_blur=1.5),
        name_prefix="templeR")
    return TempleRing.from_dir(out)


def _ate_ratio(s, ds) -> float:
    est = np.stack([kf.center for kf in s.kfs]).astype(np.float64)
    gt = np.stack([ds.records[kf.frame_idx].center for kf in s.kfs])
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    return float(res["rmse"]) / extent


def _first_divergence(mj: list, mt: list):
    """First frame whose keyframe decision, track count or inlier count
    differs between two metrics lists, with the two values."""
    for a, b in zip(mj, mt):
        for k in ("keyframe", "tracks", "inliers"):
            if a.get(k) != b.get(k):
                return {"frame": a["frame"], "key": k,
                        "jax": a.get(k), "port": b.get(k)}
    return None


def _report(name, sj, st, ds, n_pts_j, n_pts_t) -> dict:
    rep = {
        "run": name,
        "first_divergence": _first_divergence(sj.metrics, st.metrics),
        "keyframes": [len(sj.kfs), len(st.kfs)],
        "map_points": [n_pts_j, n_pts_t],
        "loop_edges": [[(e.i, e.j) for e in s.edges if e.is_loop]
                       for s in (sj, st)],
        "ate_ratio": [_ate_ratio(sj, ds), _ate_ratio(st, ds)],
    }
    print("WHOLERUN " + json.dumps(rep))
    return rep


def _check(rep):
    kj, kt = rep["keyframes"]
    pj, pt = rep["map_points"]
    le_j, le_t = rep["loop_edges"]
    assert le_j == le_t, rep
    # one keyframe decision may flip once the runs have drifted apart (the
    # ring's parallax makes nearly every frame a keyframe; a flip drops or
    # adds one)
    assert abs(kj - kt) <= 2, rep
    # the map grows with the tracks each keyframe triangulates; after a
    # divergence tracks differ by a few percent, so the map size is held
    # to 10 %
    assert abs(pj - pt) <= 0.10 * pj, rep
    assert max(rep["ate_ratio"]) < 0.05, rep


def _scan_pair(ds, cfg_j, cfg_t, name):
    n = len(ds.records)
    sj = jsp.ScanSfM(ds.K, cfg_j, n_frames=n, chunk=32, p_cap=16384,
                     p_ba=1024)
    for i in range(n):
        sj.process(i, ds.records[i].img, ds.load_gray(i))
    sj.finalize()

    key = [jax.random.PRNGKey(cfg_j.ransac.seed)]
    shape = (cfg_j.ransac.num_hypotheses, cfg_j.klt.max_tracks)
    seen = []

    def draws(idx):
        # frames arrive in order, one split of the carry key each
        seen.append(idx)
        key[0], k1, k2 = jax.random.split(key[0], 3)
        return (np.asarray(jax.random.uniform(k1, shape, jnp.float32)),
                np.asarray(jax.random.uniform(k2, shape, jnp.float32)))

    st = sp.ScanSfM(ds.K, cfg_t, n_frames=n, chunk=32, p_cap=16384,
                    p_ba=1024, device="cpu")
    st._pri_source = draws
    with torch.no_grad():
        for i in range(n):
            st.process(i, ds.records[i].img, ds.load_gray(i))
        st.finalize()
    assert seen == list(range(1, n))
    _check(_report(name, sj, st, ds, len(sj.map_xyz), len(st.map_xyz)))


def test_torch_wholerun_scan_matches_jax(ring47):
    _scan_pair(ring47, _smoke_config(jconfig), _smoke_config(config), "scan")


def test_torch_wholerun_scan_orb_matches_jax(ring47):
    """The same with the ORB loop flavor (``loop.method="orb"``): the loop
    edges it closes on the ring (chip_smoke.py's ``orb`` phase prints them
    beside the card's)."""
    orb = {"loop.method": "orb"}
    cfg_j = jconfig.load_config(None, overrides={
        **_overrides(), **orb})
    cfg_t = config.load_config(None, overrides={**_overrides(), **orb})
    _scan_pair(ring47, cfg_j, cfg_t, "scan_orb")


class _JaxDraws:
    """The JAX SfMSystem's draws: one split of its key per RANSAC call,
    then ``uniform(sub, (H,N))``."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, H: int, N: int):
        self.key, sub = jax.random.split(self.key)
        return np.asarray(jax.random.uniform(sub, (H, N), jnp.float32))


def test_torch_wholerun_system_matches_jax(ring47):
    ds = ring47
    cfg_j, cfg_t = _smoke_config(jconfig), _smoke_config(config)
    sj = jsystem.SfMSystem(ds.K, cfg_j, gt_records=ds.records)
    for i in range(len(ds)):
        sj.process(i, ds.records[i].img, ds.load_gray(i))
    sj.finalize()
    st = system.SfMSystem(ds.K, cfg_t, gt_records=ds.records, device="cpu")
    st._pri_source = _JaxDraws(cfg_t.ransac.seed)
    for i in range(len(ds)):
        st.process(i, ds.records[i].img, ds.load_gray(i))
    st.finalize()
    assert st.global_ba_shape[0] * st.global_ba_shape[1] > 8192  # AoS path
    _check(_report("system", sj, st, ds, sj.map.num_points,
                   st.map.num_points))


def test_torch_wholerun_frame1_divergence(ring47):
    """Where the whole runs split: frame 0 -> 1 of the ring from the same
    tracker state (JAX's bootstrap), ``tracker.step`` of both packages.
    Every track on which their fb gates disagree is tracked once more by
    JAX alone (a batch of one): JAX's own answer for it then moves to the
    port's side of the gate, i.e. the track's JAX result depends on the
    batch it is tracked in (an LK track that does not converge amplifies
    the last bit of every sum).  Prints one ``FRAME1`` line per track."""
    from sfm_tpu.models import tracker as jtracker
    from sfm_tpu.ops import image as jim, klt as jklt

    from sfm_tpu_torch.models import tracker
    from sfm_tpu_torch.ops import image as im

    ds = ring47
    cfg_j, cfg_t = _smoke_config(jconfig), _smoke_config(config)
    kc = cfg_t.klt
    g0, g1 = (ds.load_gray(i).astype(np.float32) for i in (0, 1))
    pj = [tuple(jim.build_pyramid(jnp.asarray(g), kc.pyr_levels))
          for g in (g0, g1)]
    pt = [tuple(im.build_pyramid(torch.as_tensor(g), kc.pyr_levels))
          for g in (g0, g1)]
    sj = jtracker.bootstrap(pj[0][0], cfg_j.klt)
    leaves = {k: np.asarray(v) for k, v in sj._asdict().items()}
    st = tracker.TrackerState(**{k: torch.as_tensor(v)
                                 for k, v in leaves.items()})
    _, _, mj = jtracker.step(pj[0], pj[1], sj, cfg_j.klt)
    _, _, mt = tracker.step(pt[0], pt[1], st, kc, device="cpu")
    mj, mt = np.asarray(mj), mt.numpy()
    odd = np.nonzero(mj != mt)[0]
    assert len(odd) <= 0.002 * int(mj.sum()), odd
    for i in odd:
        p = leaves["pos"][i:i + 1]
        fwd, ok = jklt.lk_track(pj[0], pj[1], jnp.asarray(p),
                                jnp.ones(1, bool), kc.pyr_levels, kc.iters,
                                kc.win_radius)
        back, ok2 = jklt.lk_track(pj[1], pj[0], fwd, ok, kc.pyr_levels,
                                  kc.iters, kc.win_radius)
        fb = float(np.linalg.norm(np.asarray(back)[0] - p[0]))
        alone = bool(np.asarray(ok2)[0]) and fb < kc.fb_thresh
        print("FRAME1 " + json.dumps({
            "slot": int(i), "pos": p[0].tolist(), "jax_batch": bool(mj[i]),
            "port_batch": bool(mt[i]), "jax_alone": alone,
            "jax_alone_fb": fb}))
        assert alone == bool(mt[i])
