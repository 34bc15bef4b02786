"""PyTorch port vs JAX package: the multi-scene runner ``run_scenes_scan``,
on the CPU.

One module-scoped JAX run of two scenes of the reduced out-and-back ring of
tests/test_torch_loop.py (320x240, 15 frames, texture seeds 7 and 8, loop
closure, pose graph and the finalize refinement on), and the port's run of
the same scenes fed the JAX run's per-scene RANSAC draws through the
``_pri_source`` seam.  Then port-only runs for what the scene axis must not
change: a scene's result does not depend on the other scenes, and a
one-scene run is the single-scene ``ScanSfM``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.parallel import multi_scan as jms

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.parallel import multi_scan as ms
from tests.test_torch_loop import LONS, _cfg

torch.set_num_threads(1)

CHUNK, P_CAP, P_BA = 3, 4096, 256


def _ring(out, seed, lons=LONS):
    from sfm_tpu.utils.dataset import TempleRing
    from sfm_tpu.utils.synthetic import SyntheticRingSpec, generate_dataset

    spec = SyntheticRingSpec(n_frames=len(lons), width=320, height=240,
                             fx=1100.0 * 320 / 480, fy=1100.0 * 320 / 480,
                             path_lons_deg=lons, seed=seed)
    generate_dataset(out, spec)
    return TempleRing.from_dir(out)


@pytest.fixture(scope="module")
def two_rings(tmp_path_factory):
    return [_ring(tmp_path_factory.mktemp(f"ms_ring{s}"), 7 + s)
            for s in range(2)]


def _port_cfg(**over):
    """The loop configuration of tests/test_torch_loop.py with the host
    verification that the runner forces."""
    cfg = _cfg(config, **over)
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, device_verify=False))


def _jax_draws(seed: int, S: int, shape):
    """The JAX runner's per-scene draws: scene s's key is ``fold_in(base,
    s)`` (scene 0: ``base``), split three ways on every frame, the second
    and third keys giving the frame's two-view and edge priorities."""
    base = jax.random.PRNGKey(seed)
    keys = [base] + [jax.random.fold_in(base, s) for s in range(1, S)]
    seen = []

    def draws(s, idx):
        seen.append((s, idx))
        keys[s], k1, k2 = jax.random.split(keys[s], 3)
        return (np.asarray(jax.random.uniform(k1, shape, jnp.float32)),
                np.asarray(jax.random.uniform(k2, shape, jnp.float32)))
    return draws, seen


# scene 1 of the out-of-phase case: the out-and-back path with a
# 2.5-degree step out (frame 2) and one back (frame 12), under the 8-px
# parallax gate, so that scene 1 skips those frames while scene 0 (every
# step 5 degrees) keyframes on them; the frame after each skip keyframes
# two frames after its previous keyframe
LONS_OUT_OF_PHASE = (0.0, 5.0, 7.5, 12.5, 17.5, 22.5, 27.5, 32.5, 27.5,
                     22.5, 17.5, 12.5, 10.0, 5.0, 0.0)


def _jax_and_port(rings):
    """The JAX run of ``rings`` and the port's run with JAX's draws."""
    n = len(LONS)
    kw = dict(frames=n, chunk=CHUNK, p_cap=P_CAP, p_ba=P_BA)
    jres = jms.run_scenes_scan(rings, _cfg(jconfig), **kw)
    cfg = _cfg(config)
    draws, seen = _jax_draws(cfg.ransac.seed, 2,
                             (cfg.ransac.num_hypotheses, cfg.klt.max_tracks))
    tres = ms.run_scenes_scan(rings, cfg, device="cpu",
                              _pri_source=draws, **kw)
    assert sorted(seen) == [(s, i) for s in range(2) for i in range(1, n)]
    return jres, tres


@pytest.fixture(scope="module")
def runs(two_rings):
    """The JAX run and the port's run with JAX's draws."""
    return _jax_and_port(two_rings)


@pytest.fixture(scope="module")
def runs_out_of_phase(two_rings, tmp_path_factory):
    """The same with scene 1 on LONS_OUT_OF_PHASE (texture seed 8)."""
    slow = _ring(tmp_path_factory.mktemp("ms_ring_out"), 8,
                 lons=LONS_OUT_OF_PHASE)
    return _jax_and_port([two_rings[0], slow])


def test_torch_multi_scan_matches_jax(two_rings, runs):
    """Per scene: JAX's keyframe frames and loop edges (i, j), each edge's
    relative scale within 5e-3 (a PnP pose on track sets that may differ
    by a few tracks), and the bars ``test_torch_loop_closure_end_to_end``
    holds the single-scene run to: finalized centers within 1 % of the
    trajectory's extent, map size within 0.8-1.25x of JAX's.  The result
    dict has JAX's keys and timers."""
    _check_matches_jax(*runs)


def test_torch_multi_scan_matches_jax_out_of_phase(runs_out_of_phase):
    """The case of ``test_torch_multi_scan_matches_jax`` with scenes that
    keyframe on different frames (stock-gate cadence): on frames 2 and 12
    scene 0 keyframes and scene 1 does not, in both packages, so the
    port's runner, which runs the keyframe branch only for the scenes that
    keyframe, decides something where the JAX runner runs it for every
    scene and masks it back.  The same bars."""
    jres, tres = runs_out_of_phase
    for res in (jres, tres):
        kf = [set(int(f) for f in res["kf_frames"][s]) for s in range(2)]
        assert kf[0] - kf[1] == {2, 12} and not kf[1] - kf[0]
    _check_matches_jax(jres, tres)


def _check_matches_jax(jres, tres):
    assert set(tres) == set(jres)
    assert set(tres["timers"]) == set(jres["timers"]) == {
        "chunks", "loop_check", "finalize", "finalize_drain",
        "finalize_host", "finalize_refine"}
    assert tres["metrics"].shape == jres["metrics"].shape
    np.testing.assert_array_equal(tres["n_keyframes"], jres["n_keyframes"])
    for s in range(2):
        np.testing.assert_array_equal(tres["kf_frames"][s],
                                      jres["kf_frames"][s])
        loops = {(e.i, e.j): e for e in tres["loop_edges"][s]}
        loops_j = {(e.i, e.j): e for e in jres["loop_edges"][s]}
        assert len(loops) >= 1 and set(loops) == set(loops_j), s
        for ij, e in loops.items():
            assert abs(e.s_rel - loops_j[ij].s_rel) < 5e-3, (s, ij)
        est, est_j = tres["centers"][s], jres["centers"][s]
        extent = float(np.linalg.norm(est - est.mean(0), axis=1).max())
        assert np.linalg.norm(est - est_j, axis=1).max() < 0.01 * extent
        n_t, n_j = int(tres["n_points"][s]), int(jres["n_points"][s])
        assert 0.8 < n_t / n_j < 1.25, (s, n_t, n_j)
        v = tres["views"][s]
        assert v._pg_ran and v.pg_solves >= 1
        assert np.isfinite(v.map_xyz).all()


@pytest.fixture(scope="module")
def own_draws(two_rings):
    """The port's two-scene run with its own generators."""
    return ms.run_scenes_scan(two_rings, _cfg(config), frames=len(LONS),
                              chunk=CHUNK, p_cap=P_CAP, p_ba=P_BA,
                              device="cpu")


def _same_run(a_frames, a_centers, a_npts, b_frames, b_centers, b_npts):
    np.testing.assert_array_equal(a_frames, b_frames)
    np.testing.assert_allclose(a_centers, b_centers, atol=1e-6, rtol=0)
    assert a_npts == b_npts


def test_torch_multi_scan_scene_does_not_depend_on_others(two_rings,
                                                          own_draws):
    """Scene 1 of the two-scene run equals a one-scene run of scene 1 with
    that scene's generator (``seed=scene_seed(seed, 1)``), and that run
    equals the single-scene ``ScanSfM`` (same chunk, host verification,
    the same seed): the same keyframe frames, centers within 1e-6 (bit for
    bit is expected on the CPU) and the same map size."""
    ds = two_rings[1]
    n = len(LONS)
    seed1 = ms.scene_seed(_cfg(config).ransac.seed, 1)
    one = ms.run_scenes_scan([ds], _cfg(config), frames=n, chunk=CHUNK,
                             p_cap=P_CAP, p_ba=P_BA, seed=seed1,
                             device="cpu")
    _same_run(own_draws["kf_frames"][1], own_draws["centers"][1],
              int(own_draws["n_points"][1]), one["kf_frames"][0],
              one["centers"][0], int(one["n_points"][0]))
    assert ([(e.i, e.j) for e in own_draws["loop_edges"][1]]
            == [(e.i, e.j) for e in one["loop_edges"][0]])
    np.testing.assert_array_equal(own_draws["views"][1].map_xyz,
                                  one["views"][0].map_xyz)
    cfg = _port_cfg()
    cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, seed=seed1))
    s = sp.ScanSfM(ds.K, cfg, n_frames=n, chunk=CHUNK, p_cap=P_CAP,
                   p_ba=P_BA, device="cpu")
    with torch.no_grad():
        for i in range(n):
            s.process(i, ds.records[i].img, ds.load_gray(i))
        s.finalize()
    _same_run(one["kf_frames"][0], one["centers"][0],
              int(one["n_points"][0]), [kf.frame_idx for kf in s.kfs],
              np.stack([kf.center for kf in s.kfs]), len(s.map_xyz))
    assert ([(e.i, e.j) for e in one["loop_edges"][0]]
            == [(e.i, e.j) for e in s.loop_edges])
    assert len(s.loop_edges) >= 1


def _carry_bits(c) -> dict:
    d = sp.carry_to_numpy(c)
    flat = {k: v for k, v in d.items() if isinstance(v, np.ndarray)}
    flat.update({f"trk_{k}": v for k, v in d["trk"].items()})
    flat.update({f"ring_{k}": v for k, v in d["ring"].items()})
    flat.update({f"pyr{i}": p for i, p in enumerate(d["prev_pyr"])})
    flat["gen"] = c.gen.get_state().numpy()
    return flat


def test_torch_multi_scan_non_keyframe_scene_keeps_its_bits(
        two_rings, tmp_path):
    """A frame in which scene 0 keyframes and scene 1 does not (scene 1 is
    a ring whose camera moves 1 degree a frame, under the 8-px parallax
    gate): scene 1's carry after the two-scene frame, generator state
    included, is bit for bit its carry after the same frame run alone; so
    is scene 0's.  The keyframe branch never runs for scene 1 and so
    draws nothing from its generator."""
    slow = _ring(tmp_path / "slow", 8, lons=(0.0, 1.0, 2.0))
    dss = [two_rings[0], slow]
    cfg = _port_cfg()
    seeds = [ms.scene_seed(cfg.ransac.seed, s) for s in range(2)]
    g = [[torch.as_tensor(np.array(d.load_gray(i))) for i in range(2)]
         for d in dss]
    kw = dict(cfg=cfg, kf_cap=16, p_cap=P_CAP, idx0=0)

    def frame1(scenes):
        carries = ms._bootstrap_scenes(
            imgs0=torch.stack([g[s][0] for s in scenes]),
            seeds=[seeds[s] for s in scenes], **kw)
        imgs = torch.stack([g[s][1] for s in scenes])[:, None]
        with torch.no_grad():
            _, ys = ms._run_chunk_scenes(
                cfg, P_BA, torch.as_tensor(dss[0].K, dtype=torch.float32),
                carries, imgs, np.array([1]), np.array([True]))
        return carries, ys[:, 0].numpy()

    both, ys = frame1([0, 1])
    assert ys[0, sp.Y_KF] == 1.0 and ys[1, sp.Y_KF] == 0.0
    for s in range(2):
        (alone,), ys1 = frame1([s])
        np.testing.assert_array_equal(ys1[0], ys[s])
        a, b = _carry_bits(both[s]), _carry_bits(alone)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_multi_scan_refuses_what_waits(two_rings):
    """The default device raises without a card; ``finalize(drained=...)``
    with pending frames and ``finalize()`` before any frame raise as in
    the single-scene pipeline.  (``mesh=`` runs: see
    tests/test_torch_batch_runner.py.)"""
    cfg = _cfg(config)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ms.run_scenes_scan(two_rings, cfg)
    ds = two_rings[0]
    s = sp.ScanSfM(ds.K, cfg, n_frames=4, chunk=CHUNK, device="cpu")
    with pytest.raises(RuntimeError, match="before any frame"):
        s.finalize()
    s.process(0, ds.records[0].img, ds.load_gray(0))
    s.process(1, ds.records[1].img, ds.load_gray(1))
    with pytest.raises(AssertionError, match="pending"):
        s.finalize(drained={})
