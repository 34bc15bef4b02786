"""PyTorch port vs JAX package: the parallel layer's mesh, scene-batched
stages, hypothesis-sharded RANSAC, scene-sharded frame step and dry run,
on the CPU.

The JAX side runs in this process on conftest's 8 virtual CPU devices.
The port's sharded functions run in 4 gloo ranks (one job, started when
the module starts and running beside the JAX side; the rank functions are
in tests/test_torch_parallel_ranks.py, which imports no JAX), fed the same
numpy inputs and the JAX package's own draws: per scene
``jax.random.uniform(key, (H, N), f32)`` as ``find_E_ransac`` draws them,
per ``hyp`` rank the same under ``fold_in(key, hyp index)``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift

from sfm_tpu.config import KLTConfig as JKLTConfig
from sfm_tpu.models import tracker as jtracker
from sfm_tpu.ops import ba as jba, lie as jlie
from sfm_tpu.parallel import mesh as jmesh, multiscene as jms

from sfm_tpu_torch.config import KLTConfig
from sfm_tpu_torch.ops import ba, epipolar
from sfm_tpu_torch.parallel import distributed, dryrun, multiscene
from tests import test_torch_parallel_ranks as ranks
from tests.test_parallel import _toy_scene_batch
from tests.test_torch_solvers import make_ba_problem

torch.set_num_threads(1)

F32 = np.float32
MESH_CASES = [(4, 1), (4, 2), (4, 4), (4, 3), (8, 2)]
E_TOTAL, E_THRESH = 1024, 1e-5
STEP_S, STEP_T, STEP_H, STEP_W, STEP_HYP = 8, 64, 96, 128, 64


def _pri(key, H, N):
    return np.asarray(jax.random.uniform(key, (H, N), jnp.float32))


def worker_two_view_batch():
    """The scene batch of tests/distributed_worker.py (S = 4 scenes of 256
    correspondences from known relative poses) with its RANSAC settings,
    and the JAX package's per-scene draws from its keys."""
    rng = np.random.default_rng(0)
    S, N = 4, 256
    xi = np.zeros((S, N, 2), np.float64)
    xj = np.zeros((S, N, 2), np.float64)
    for s in range(S):
        w = rng.standard_normal(3) * 0.1
        R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
        t = rng.standard_normal(3)
        t /= np.linalg.norm(t)
        X = rng.uniform([-1, -1, 4], [1, 1, 8], (N, 3))
        xi[s] = X[:, :2] / X[:, 2:3]
        Xc = X @ R.T + 0.2 * t
        xj[s] = Xc[:, :2] / Xc[:, 2:3]
    kwargs = dict(num_hypotheses=128, sampson_thresh=1e-5, min_inliers=32)
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    pri = np.stack([_pri(k, kwargs["num_hypotheses"], N) for k in keys])
    return dict(xi=xi.astype(F32), xj=xj.astype(F32),
                valid=np.ones((S, N), bool), keys=keys, pri=pri,
                kwargs=kwargs)


def _step_problem():
    """tests/test_parallel.py:67-115's problem (8 scenes of 64 tracks on
    96x128 textures shifted by (1, 2) px, a tiny BA problem per scene), in
    float32, with the JAX package's per-scene draws."""
    rng = np.random.default_rng(0)
    S, T, H, W = STEP_S, STEP_T, STEP_H, STEP_W
    imgs0, imgs1, pos = [], [], []
    for _ in range(S):
        img = gaussian_filter(rng.standard_normal((H, W)), 2.0) * 60 + 128
        imgs0.append(img.astype(F32))
        imgs1.append(shift(img, (1.0, 2.0), order=3).astype(F32))
        pos.append(rng.uniform(10, 80, (T, 2)))
    i0, i1 = np.stack(imgs0), np.stack(imgs1)
    P_, M_ = 16, 64
    t_wc = np.zeros((S, 2, 3), F32)
    t_wc[:, 1, 0] = 0.5
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    return dict(
        kcfg=dict(max_tracks=T, min_tracks=8, pyr_levels=2, win_radius=3,
                  iters=6),
        H=STEP_HYP, keys=keys,
        pri=np.stack([_pri(k, STEP_HYP, T) for k in keys]),
        K=np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], F32),
        pyr0=(i0, np.ascontiguousarray(i0[:, ::2, ::2])),
        pyr1=(i1, np.ascontiguousarray(i1[:, ::2, ::2])),
        state=dict(pos=np.stack(pos).astype(F32), valid=np.ones((S, T), bool),
                   ids=np.tile(np.arange(T, dtype=np.int32), (S, 1)),
                   next_id=np.full((S,), T, np.int32)),
        prob=dict(
            R_wc=np.tile(np.eye(3, dtype=F32), (S, 2, 1, 1)), t_wc=t_wc,
            X=(rng.standard_normal((S, P_, 3)) * 0.3
               + np.array([0, 0, 4.0])).astype(F32),
            cam_idx=np.tile(np.arange(M_, dtype=np.int32) % 2, (S, 1)),
            pid_idx=np.tile(np.arange(M_, dtype=np.int32) % P_, (S, 1)),
            obs=np.zeros((S, M_, 2), F32), obs_valid=np.ones((S, M_), bool),
            point_valid=np.ones((S, P_), bool)),
    )


def _ring_step_problem():
    """The same step at the same shapes on a determined two-view problem:
    scene s is frames s and s + 1 of a synthetic ring rendered at 128x96
    (fx 304, 3 degrees a frame: flows within the reach of 2-level LK at
    radius 3), with 64 tracks at random pixels and other draws.
    (tests/test_parallel.py's textures are shifted in the image plane, so
    every pose that explains a uniform shift fits them equally.)"""
    from sfm_tpu_torch.utils.synthetic import (SyntheticRingSpec,
                                               _make_texture,
                                               make_ring_cameras,
                                               render_frame)

    p = _step_problem()
    spec = SyntheticRingSpec(n_frames=120, width=STEP_W, height=STEP_H,
                             fx=304.0, fy=304.0, texture_blur=1.5)
    K, Rs, ts, _, _ = make_ring_cameras(spec)
    tex = _make_texture(spec)
    frames = [render_frame(spec, K, Rs[i], ts[i], tex).astype(F32)
              for i in range(STEP_S + 1)]
    i0, i1 = np.stack(frames[:-1]), np.stack(frames[1:])
    rng = np.random.default_rng(1)
    keys = jax.random.split(jax.random.PRNGKey(1), STEP_S)
    p.update(
        K=K.astype(F32), keys=keys,
        pri=np.stack([_pri(k, STEP_HYP, STEP_T) for k in keys]),
        pyr0=(i0, np.ascontiguousarray(i0[:, ::2, ::2])),
        pyr1=(i1, np.ascontiguousarray(i1[:, ::2, ::2])))
    p["state"]["pos"] = rng.uniform(
        10, [STEP_W - 10, STEP_H - 10], (STEP_S, STEP_T, 2)).astype(F32)
    return p


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(0)
    xi, xj, Rg, tg = _toy_scene_batch(rng, 1, N=128)
    n_hyp = 4
    chunk = max(E_TOTAL // n_hyp, 8)
    key = jax.random.PRNGKey(3)
    E_pri = np.stack([_pri(jax.random.fold_in(key, h), chunk, 128)
                      for h in range(n_hyp)])
    E_in = dict(xi=np.asarray(xi[0], F32), xj=np.asarray(xj[0], F32),
                valid=np.ones(128, bool))
    E_gt = np.asarray(jlie.hat(jnp.asarray(tg[0]))) @ Rg[0]
    return dict(E_in=E_in, E_pri=E_pri, E_gt=E_gt, step=_step_problem(),
                ring_step=_ring_step_problem())


@pytest.fixture(scope="module", autouse=True)
def four_ranks(problems):
    """The 4-rank job, started with the module and read by the tests that
    need it (the JAX side of the tests before them runs meanwhile)."""
    steps = []
    for name in ("step", "ring_step"):
        s = {k: v for k, v in problems[name].items()
             if k != "keys"}
        s["kcfg"] = KLTConfig(**s["kcfg"])
        steps.append(s)
    data = dict(mesh_cases=MESH_CASES, E_in=problems["E_in"],
                E_pri=problems["E_pri"], E_total=E_TOTAL, E_thresh=E_THRESH,
                steps=steps)
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(distributed.launch, ranks.four_ranks, 4, (data,),
                        "cpu", 600.0)
        yield fut
        fut.result()


@pytest.fixture(scope="module")
def jax_step(problems, four_ranks):
    """The JAX twin's scene step on ``make_mesh(4)``, two scenes a
    device, on each of the two problems (one compiled step)."""
    p = problems["step"]
    step = jms.make_scene_step(jmesh.make_mesh(4), JKLTConfig(**p["kcfg"]),
                               num_hypotheses=p["H"], ba_iters=2)
    tree = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}  # noqa: E731
    out = []
    for p in (problems["step"], problems["ring_step"]):
        state = jtracker.TrackerState(**{k: jnp.asarray(v)
                                         for k, v in p["state"].items()})
        prob = jba.BAProblem(**{k: jnp.asarray(v)
                                for k, v in p["prob"].items()})
        new_state, rp, ba_out, metrics = step(
            p["keys"], jnp.asarray(p["K"]),
            tuple(jnp.asarray(a) for a in p["pyr0"]),
            tuple(jnp.asarray(a) for a in p["pyr1"]), state, prob)
        out.append(dict(state=tree(new_state), rp=tree(rp),
                        ba=tuple(np.asarray(v) for v in ba_out),
                        metrics={k: np.asarray(v)
                                 for k, v in metrics.items()}))
    return out


def _torch_step(four_ranks, which: int = 0) -> dict:
    """The ranks' step outputs on problem ``which`` (0: the shifted
    textures, 1: the ring) in scene order (rank r holds scenes 2r and
    2r + 1)."""
    outs = [o["steps"][which] for o in four_ranks.result()]
    assert [o["scenes"] for o in outs] == [[2 * r, 2 * r + 1]
                                           for r in range(4)]
    cat = lambda k, f: np.concatenate([o[k][f] for o in outs])  # noqa: E731
    return dict(
        state={f: cat("state", f) for f in outs[0]["state"]},
        rp={f: cat("rp", f) for f in outs[0]["rp"]},
        ba=tuple(np.concatenate([o["ba"][i] for o in outs])
                 for i in range(3)),
        metrics=[o["metrics"] for o in outs])


# ---------------------------------------------------------------------------
# scene-batched stages, in this process
# ---------------------------------------------------------------------------


def test_torch_batched_two_view_matches_jax():
    """``batched_two_view`` on tests/distributed_worker.py's four scenes
    against the JAX twin's ``vmap`` with the same draws, per scene at
    ``test_torch_find_E_ransac_matches_jax_shared_priorities``'s bars:
    the same ``ok``, inlier masks equal on 99 % of the points, counts
    within 2 %, R within 1e-3, t within 2e-3."""
    d = worker_two_view_batch()
    rj = jms.batched_two_view(d["keys"], jnp.asarray(d["xi"]),
                              jnp.asarray(d["xj"]), jnp.asarray(d["valid"]),
                              **d["kwargs"])
    with torch.no_grad():
        rt = multiscene.batched_two_view(
            torch.as_tensor(d["pri"]), torch.as_tensor(d["xi"]),
            torch.as_tensor(d["xj"]), torch.as_tensor(d["valid"]),
            **d["kwargs"])
    assert rt.R.shape == (4, 3, 3) and rt.inlier_mask.shape == (4, 256)
    for s in range(4):
        assert bool(rt.ok[s]) == bool(rj.ok[s]) is True
        mj, mt = np.asarray(rj.inlier_mask[s]), rt.inlier_mask[s].numpy()
        assert (mj == mt).mean() >= 0.99
        assert abs(int(rt.num_inliers[s]) - int(rj.num_inliers[s])) \
            <= 0.02 * int(rj.num_inliers[s])
        np.testing.assert_allclose(rt.R[s].numpy(), np.asarray(rj.R[s]),
                                   atol=1e-3)
        np.testing.assert_allclose(rt.t[s].numpy(), np.asarray(rj.t[s]),
                                   atol=2e-3)


def test_torch_batched_lk_matches_jax(problems):
    """``batched_lk`` (one ``lk_track_fb`` call on the stacks) on four
    scenes of 64 tracks, 96x128, 2 levels, against the JAX twin's
    ``vmap``, at ``test_torch_lk_track_fb_matches_jax``'s bars: accept
    masks equal on 99 % of the tracks, tracks both accept within 1e-3
    px."""
    p = problems["step"]
    sl = slice(0, 4)
    pyr0 = tuple(a[sl] for a in p["pyr0"])
    pyr1 = tuple(a[sl] for a in p["pyr1"])
    pts, valid = p["state"]["pos"][sl], p["state"]["valid"][sl]
    kw = dict(levels=2, iters=6, radius=3, fb_thresh=1.0)
    fj, okj = jms.batched_lk(tuple(map(jnp.asarray, pyr0)),
                             tuple(map(jnp.asarray, pyr1)),
                             jnp.asarray(pts), jnp.asarray(valid), **kw)
    ft, okt = multiscene.batched_lk(
        tuple(map(torch.as_tensor, pyr0)), tuple(map(torch.as_tensor, pyr1)),
        torch.as_tensor(pts), torch.as_tensor(valid), device="cpu", **kw)
    okj, okt = np.asarray(okj), okt.numpy()
    assert ft.shape == (4, STEP_T, 2)
    assert (okj == okt).mean() >= 0.99
    both = okj & okt
    assert both.sum() > 0.7 * both.size
    np.testing.assert_allclose(ft.numpy()[both], np.asarray(fj)[both],
                               atol=1e-3)


def test_torch_batched_ba_step_matches_jax():
    """``batched_ba_step`` on three window problems against the JAX
    twin's ``vmap`` (3 LM steps), at ``test_torch_bundle_adjust_
    matches_jax``'s bars: poses within 1e-4 (R) and 2e-4 (t), valid
    points within 1e-3, cost within 1 %."""
    rng = np.random.default_rng(0)
    leaves = [make_ba_problem(rng)[0] for _ in range(3)]
    stacked = {k: np.stack([lv[k] for lv in leaves]) for k in leaves[0]}
    Rj, tj, Xj, ij = jms.batched_ba_step(jba.BAProblem(
        **{k: jnp.asarray(v) for k, v in stacked.items()}))
    with torch.no_grad():
        Rt, t_t, Xt, it = multiscene.batched_ba_step(ba.BAProblem(
            **{k: torch.as_tensor(v) for k, v in stacked.items()}))
    assert Rt.shape == (3, 4, 3, 3) and it["cost"].shape == (3,)
    np.testing.assert_allclose(it["cost"].numpy(), np.asarray(ij["cost"]),
                               rtol=1e-2)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(tj), atol=2e-4)
    pv = stacked["point_valid"]
    np.testing.assert_allclose(Xt.numpy()[pv], np.asarray(Xj)[pv], atol=1e-3)


# ---------------------------------------------------------------------------
# hypothesis-sharded RANSAC, 4 ranks
# ---------------------------------------------------------------------------


def test_torch_find_E_sharded_matches_jax(problems, four_ranks):
    """``find_E_sharded`` over a (1, 4) mesh, each rank with the JAX
    twin's draws for its ``hyp`` index, against the JAX twin on a (1, 4)
    mesh: every rank returns the same (E, cost); E is the JAX twin's up to
    sign within 5e-4 (``eight_point_E``'s bar) and the min cost agrees
    within 1e-3 relative (the Sampson error's bar)."""
    Ej, cj = jms.find_E_sharded(
        jax.random.PRNGKey(3), *(jnp.asarray(problems["E_in"][k])
                                 for k in ("xi", "xj", "valid")),
        jmesh.make_mesh(4, hyp_axis=4), num_hypotheses_total=E_TOTAL,
        sampson_thresh=E_THRESH)
    Ej, cj = np.asarray(Ej), float(cj)
    outs = [o["E"] for o in four_ranks.result()]
    for E, c, _, _ in outs[1:]:
        np.testing.assert_array_equal(E, outs[0][0])
        np.testing.assert_array_equal(c, outs[0][1])
    E, c = outs[0][0], float(outs[0][1])
    assert min(np.abs(E - Ej).max(), np.abs(E + Ej).max()) < 5e-4
    np.testing.assert_allclose(c, cj, rtol=1e-3)


def test_torch_find_E_sharded_own_draws_recovers_truth(problems, four_ranks):
    """``find_E_sharded`` with each rank's own generator (seeded from the
    seed and its ``hyp`` index): every rank returns the same E, and it is
    the true essential matrix up to sign and scale within 0.05 (the bar
    of the JAX package's ``test_find_E_sharded_matches_truth``)."""
    outs = [o["E"] for o in four_ranks.result()]
    for _, _, E, c in outs[1:]:
        np.testing.assert_array_equal(E, outs[0][2])
        np.testing.assert_array_equal(c, outs[0][3])
    E_n = outs[0][2] / np.linalg.norm(outs[0][2])
    E_g = problems["E_gt"] / np.linalg.norm(problems["E_gt"])
    assert min(np.abs(E_n - E_g).max(), np.abs(E_n + E_g).max()) < 0.05


# ---------------------------------------------------------------------------
# the scene-sharded frame step, 4 ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", [0, 1], ids=["shift", "ring"])
def test_torch_make_scene_step_tracks_match_jax(problems, jax_step,
                                                 four_ranks, which):
    """``make_scene_step`` on a (4, 1) mesh, two scenes a rank, against
    the JAX twin on ``make_mesh(4)``, on each problem: the new track
    table's valid masks equal on 99 % of the slots, positions of tracks
    both keep within 1e-3 px (the LK bars), ids equal where both keep the
    track, ``next_id`` unchanged; on the shifted textures the recovered
    flow is the (2, 1) px shift."""
    t, j = _torch_step(four_ranks, which)["state"], jax_step[which]["state"]
    assert t["pos"].shape == (STEP_S, STEP_T, 2)
    assert (t["valid"] == j["valid"]).mean() >= 0.99
    both = t["valid"] & j["valid"]
    assert both.sum() > STEP_S * STEP_T // 4
    np.testing.assert_allclose(t["pos"][both], j["pos"][both], atol=1e-3)
    np.testing.assert_array_equal(t["ids"][both], j["ids"][both])
    np.testing.assert_array_equal(t["next_id"], j["next_id"])
    if which == 0:
        flow = t["pos"] - problems["step"]["state"]["pos"]
        np.testing.assert_allclose(np.median(flow[t["valid"]], axis=0),
                                   [2.0, 1.0], atol=0.3)


@pytest.mark.parametrize("which", [0, 1], ids=["shift", "ring"])
def test_torch_make_scene_step_poses_match_jax(problems, jax_step,
                                               four_ranks, which):
    """The step's per-scene LO-RANSAC against the JAX twin's (same draws):
    the same ``ok``, inlier counts within 2 % and inlier masks equal on
    99 % of the tracks (the ``find_E_ransac`` bars).  The poses are held
    bit for bit to the same stages called in this process without a group
    (``batched_lk`` on all eight scenes, then ``batched_two_view``), not
    to the JAX twin's: 64 tracks at 96x128 do not determine them.  On the
    shifted textures any pose whose epipolar geometry explains a uniform
    image shift fits (scene 1 ends in another such pose than JAX's), and
    on the ring two scenes end in the lateral and the forward basin of
    the small-baseline ambiguity on the two sides; which pose wins such a
    tie of the multi-start's truncated costs is rounding.  The two-view
    stage's poses are held to JAX's on a determined problem in
    ``test_torch_batched_two_view_matches_jax``."""
    t, j = _torch_step(four_ranks, which)["rp"], jax_step[which]["rp"]
    np.testing.assert_array_equal(t["ok"], j["ok"])
    assert t["num_inliers"].dtype == np.int32
    assert (np.abs(t["num_inliers"] - j["num_inliers"])
            <= 0.02 * j["num_inliers"]).all()
    assert ((t["inlier_mask"] == j["inlier_mask"]).mean(-1) >= 0.99).all()
    p = problems[("step", "ring_step")[which]]
    pos = torch.as_tensor(p["state"]["pos"])
    K = torch.as_tensor(p["K"])
    with torch.no_grad():
        new, ok = multiscene.batched_lk(
            tuple(map(torch.as_tensor, p["pyr0"])),
            tuple(map(torch.as_tensor, p["pyr1"])), pos,
            torch.as_tensor(p["state"]["valid"]), levels=2, iters=6,
            radius=3, device="cpu")
        rp = multiscene.batched_two_view(
            torch.as_tensor(p["pri"]), epipolar.normalize_by_K(K, pos),
            epipolar.normalize_by_K(K, new), ok,
            num_hypotheses=STEP_HYP, min_inliers=8)
    for k, v in rp._asdict().items():
        np.testing.assert_array_equal(t[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("which", [0, 1], ids=["shift", "ring"])
def test_torch_make_scene_step_ba_and_metrics_match_jax(jax_step,
                                                        four_ranks, which):
    """The step's BA outputs against the JAX twin's (poses within 1e-4 /
    2e-4, points within 1e-3: the BA bars), and the three metrics
    all-reduced over the ``scene`` group: the same on every rank, live
    tracks within 1 % and inliers within 2 % of the JAX twin's psums, BA
    cost within 1 %."""
    t = _torch_step(four_ranks, which)
    for a, b, tol in zip(t["ba"], jax_step[which]["ba"], (1e-4, 2e-4, 1e-3)):
        np.testing.assert_allclose(a, b, atol=tol)
    m = t["metrics"]
    for k in m[0]:
        assert all(np.array_equal(x[k], m[0][k]) for x in m[1:]), k
    j = jax_step[which]["metrics"]
    assert abs(int(m[0]["tracks_alive"]) - int(j["tracks_alive"])) \
        <= 0.01 * int(j["tracks_alive"])
    assert abs(int(m[0]["inliers"]) - int(j["inliers"])) \
        <= 0.02 * int(j["inliers"])
    np.testing.assert_allclose(float(m[0]["ba_cost"]), float(j["ba_cost"]),
                               rtol=1e-2)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", MESH_CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_torch_make_mesh_matches_jax(four_ranks, case):
    """JAX's ``test_mesh_shapes`` as cases, on 4 ranks: ``make_mesh(n,
    hyp)`` has the JAX twin's shape by axis name, and rank r sits where
    the JAX twin puts device r, at (r // hyp, r % hyp); ``n % hyp != 0``
    raises ``ValueError`` on both sides.  The one difference: a port mesh
    spans every rank (a rank is one device), so ``n`` other than the
    world size raises, where the JAX twin takes the first n devices."""
    n, hyp = case
    got = [o["mesh"][case] for o in four_ranks.result()]
    if n % hyp:
        with pytest.raises(ValueError, match="not divisible"):
            jmesh.make_mesh(n, hyp_axis=hyp)
        assert all("not divisible" in g for g in got), got
        return
    want = dict(jmesh.make_mesh(n, hyp_axis=hyp).shape)
    if n != 4:
        assert want == {"scene": n // hyp, "hyp": hyp}
        assert all("world size 4" in g for g in got), got
        return
    for r, (shape, coord) in enumerate(got):
        assert shape == want
        assert coord == (r // hyp, r % hyp)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_torch_dryrun_entry_matches_jax():
    """``dryrun.entry`` against ``__graft_entry__.entry``: the same example
    inputs; the parallax (a median of the flow, no draws) equal to
    ``jnp.nanmedian`` of the same flow within 1e-6 relative; and the stage
    recovers the pure x-translation of the example (R within 1e-3 of I,
    t within 1e-3 of (+-1, 0, 0), at least 95 % of the correspondences
    inliers)."""
    import __graft_entry__ as graft

    _, aj = graft.entry()
    ft, at = dryrun.entry(device="cpu")
    for a, b in zip(at[1:], aj[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, _, pi, pj, valid = aj
    flow = jnp.linalg.norm(jnp.asarray(pj) - jnp.asarray(pi), axis=-1)
    par_j = float(jnp.nan_to_num(jnp.nanmedian(
        jnp.where(jnp.asarray(valid), flow, jnp.nan))))
    with torch.no_grad():
        R, t, n, par = ft(*at)
    np.testing.assert_allclose(float(par), par_j, rtol=1e-6)
    np.testing.assert_allclose(R.numpy(), np.eye(3), atol=1e-3)
    np.testing.assert_allclose(np.abs(t.numpy()), [1.0, 0.0, 0.0], atol=1e-3)
    assert int(n) >= 0.95 * len(valid)


def test_torch_dryrun_multichip_cpu(four_ranks):
    """``dryrun_multichip(4, device="cpu")``: four gloo ranks on a (2, 2)
    mesh run the scene step, the hypothesis-sharded RANSAC and
    ``run_scenes_scan(mesh=...)`` on two 9-frame rings, and pass the JAX
    dry run's bars (>= 3 keyframes, > 50 points per scene).  (Waits for
    the 4-rank job first, so the two jobs do not share the cores.)"""
    four_ranks.result()
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"scene": 2, "hyp": 2}
    assert out["backend"] == "gloo"
    assert len(out["keyframes"]) == 2
    assert all(k >= 3 for k in out["keyframes"])
    assert all(p > 50 for p in out["points"])
    assert out["tracks_alive"] > 0
