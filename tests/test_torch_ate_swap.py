"""tools/chip_ate_spread.py's ``--swap`` and ``--compare-dumps --paired``,
on the CPU, without a pipeline run.

``--swap`` runs the plain PyTorch version in place of K3 or K1 inside the
tool's own process: the routes come back when the block ends, nothing
else (the environment, another process) sees the swap, and on CPU tensors
(where the wrappers already take the plain versions) the swapped calls
return what the unswapped ones do, bit for bit.  ``--paired`` holds two
dump directories frame by frame, edge by edge and run by run (the
odometry's Sim(3) ATE, also computed here by hand), pooled and run by
run (each side's median in a run, paired over runs): its signed median
differences and Wilcoxon p-values are computed here by hand, the p-value
by enumerating every sign pattern of the differences.
"""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.ops import features, klt
from sfm_tpu_torch.ops.kernels import lk_kernels, shi_tomasi_kernel
from tools import chip_ate_spread as cas

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {"k3": (lk_kernels, "lk_level_fused", "lk_level_plain"),
           "k1": (shi_tomasi_kernel, "shi_tomasi_score",
                  "shi_tomasi_score_plain")}


def _routes():
    return {k: getattr(m, r) for k, (m, r, _) in KERNELS.items()}


@pytest.mark.parametrize("spec", ["k3", "k1", "k3+k1"])
def test_torch_ate_swap_rebinds_in_process_only(spec):
    before, env = _routes(), dict(os.environ)
    # another process started inside the block sees the kernels' routes
    probe = ("from sfm_tpu_torch.ops.kernels import lk_kernels as l, "
             "shi_tomasi_kernel as s; "
             "print(l.lk_level_fused.__name__, s.shi_tomasi_score.__name__)")
    with cas.swapped(spec):
        now = _routes()
        for k, (m, _, plain) in KERNELS.items():
            want = getattr(m, plain) if k in spec.split("+") else before[k]
            assert now[k] is want
        assert dict(os.environ) == env
        out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert out == ["lk_level_fused", "shi_tomasi_score"]
    assert _routes() == before
    with pytest.raises(KeyError):
        with cas.swapped("k2"):
            pass
    assert _routes() == before


def test_torch_ate_swap_same_results_on_cpu():
    rng = np.random.default_rng(3)
    base = rng.random((48, 64)).astype(np.float32)
    img0 = torch.as_tensor(base)
    img1 = torch.roll(img0, shifts=(1, 2), dims=(0, 1))
    p0 = torch.as_tensor(rng.uniform(2.0, 60.0, (40, 2)).astype(np.float32))
    v = torch.as_tensor(rng.normal(0.0, 0.8, (40, 2)).astype(np.float32))
    ex = torch.zeros((4, 2))
    ev = torch.zeros(4, dtype=torch.bool)

    def run():
        return (klt._lk_level(img0, img1, p0, v, 8, 3, 1e-4),
                features.detect_corners(img0, ex, ev, 16, 8, device="cpu"))

    flow, corners = run()
    with cas.swapped("k3+k1"):
        flow_s, corners_s = run()
    assert torch.equal(flow, flow_s)
    for a, b in zip(corners, corners_s):
        assert torch.equal(a, b)


# --paired on two synthetic dump directories ---------------------------------


def _rot(axis, deg):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    t = np.deg2rad(deg)
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def _gt_ring(n):
    """n GT cameras on a circle, looking in: records with R, t, center."""
    recs = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        R = _rot([0, 1, 0], np.rad2deg(ang))
        C = np.array([np.sin(ang), 0.1 * i, -np.cos(ang)])
        recs.append(SimpleNamespace(R=R, t=-R @ C, center=C))
    return SimpleNamespace(records=recs)


def _dump(path, rows, gt, scale, rot_noise, c_noise):
    """A dump file: metrics rows (frame, column values) and one pre-pose-
    graph entry: GT poses scaled, with a per-camera rotation and centre
    perturbation."""
    pre = []
    for i, (rec, dr, dc) in enumerate(zip(gt.records, rot_noise, c_noise)):
        R = _rot([1, 0.3, 0.2], dr) @ rec.R  # world -> camera
        # the ring's R_cw: the camera's axes in the world
        pre.append([i, *(scale * rec.center + dc), *R.T.ravel()])
    y = []
    for fr, vals in rows.items():
        r = np.zeros(sp.NY)
        r[sp.Y_FRAME], r[sp.Y_VALID] = fr, 1.0
        for c, x in zip(cas.PAIRED_COLUMNS, vals):
            r[getattr(sp, c)] = x
        y.append(r.tolist())
    path.write_text(json.dumps({"rows": y, "pre_pg": [pre], "centers": []}))


def _edges_by_hand(gt, scale, rot_noise, c_noise):
    """Per consecutive pair: baseline ratio over the run's median, its
    distance from 1, rotation angle of R_est R_gt^T, angle between the
    translation directions."""
    n = len(gt.records)
    Rs = [_rot([1, 0.3, 0.2], d) @ r.R for d, r in zip(rot_noise, gt.records)]
    Cs = [scale * r.center + dc for r, dc in zip(gt.records, c_noise)]
    out = []
    for i in range(n - 1):
        a, b = gt.records[i], gt.records[i + 1]
        Rg = b.R @ a.R.T
        tg = b.t - Rg @ a.t
        Re = Rs[i + 1] @ Rs[i].T
        te = Rs[i + 1] @ (Cs[i] - Cs[i + 1])
        cosr = np.clip((np.trace(Re @ Rg.T) - 1) / 2, -1, 1)
        cosd = abs(te @ tg) / np.linalg.norm(te) / np.linalg.norm(tg)
        out.append([np.linalg.norm(Cs[i + 1] - Cs[i])
                    / np.linalg.norm(b.center - a.center),
                    np.rad2deg(np.arccos(cosr)),
                    np.rad2deg(np.arccos(min(cosd, 1.0)))])
    out = np.asarray(out)
    out[:, 0] /= np.median(out[:, 0])
    return np.insert(out, 1, np.abs(out[:, 0] - 1.0), axis=1)


def _ate_by_hand(est, gt):
    """Sim(3) RMSE (Umeyama) of ``est`` onto ``gt`` over the largest
    distance of a GT point from the GT centroid."""
    est, gt = np.asarray(est), np.asarray(gt)
    me, mg = est.mean(0), gt.mean(0)
    xe, xg = est - me, gt - mg
    U, S, Vt = np.linalg.svd(xg.T @ xe / len(est))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (xe ** 2).sum(1).mean()
    res = gt - (s * est @ R.T + (mg - s * R @ me))
    return (np.sqrt((res ** 2).sum(1).mean())
            / np.linalg.norm(xg, axis=1).max())


def _wilcoxon_by_hand(d):
    """Exact two-sided signed-rank p of differences without zeros or
    ties: every sign pattern of the ranks, equally likely."""
    d = np.asarray(d)
    ranks = np.argsort(np.argsort(np.abs(d))) + 1
    w = ranks[d > 0].sum()
    sums = [sum(r for r, s in zip(ranks, signs) if s)
            for signs in itertools.product([0, 1], repeat=len(d))]
    lo = np.mean([x <= w for x in sums])
    hi = np.mean([x >= w for x in sums])
    return min(1.0, 2 * min(lo, hi))


def test_torch_ate_swap_compare_paired(tmp_path):
    gt = _gt_ring(5)
    ref, mine = tmp_path / "jax", tmp_path / "port"
    ref.mkdir()
    mine.mkdir()
    # run a: frames 1-3; run b: frames 1-4 on the port's side (frame 4 has
    # no pair and is left out); ref columns, port = ref + d
    d_rows = {"scan1.json": {1: [3, -1, 7, 2.5, 11], 2: [5, 2, -4, -0.5, 13],
                             3: [-6, 4, 9, 1.5, -2]},
              "scan2.json": {1: [8, -3, 1, 3.5, 21], 2: [-1, 6, 5, -4.5, 17],
                             3: [2, 7, -8, 5.5, 23]}}
    # (rotation, centre) perturbations of each camera: port, reference
    noise = {"scan1.json": (([0.5, 1.0, 0.2, 2.0, 0.7],
                             [0.0, 2.4, 0.9, 0.3, 1.7]),
                            ([0.1, 0.0, 0.3, 0.0, 0.2],
                             [1.1, 0.0, 0.4, 0.0, 0.2])),
             "scan2.json": (([1.5, 0.1, 2.5, 0.4, 1.1],
                             [0.8, 0.2, 1.3, 2.9, 0.6]),
                            ([0.0, 0.2, 0.0, 0.4, 0.1],
                             [0.0, 0.3, 1.9, 0.1, 0.5]))}
    want_pairs = {c.lower(): ([], []) for c in cas.PAIRED_COLUMNS}
    want_runs = {}  # per metric: each run's (ref median, port median)
    edge_keys = ("edge_baseline_ratio", "edge_baseline_dev", "edge_rot_deg",
                 "edge_dir_deg")
    want_pairs.update({k: ([], []) for k in edge_keys})
    want_pairs["ate_ratio_pre_pose_graph"] = ([], [])
    gtc = np.stack([r.center for r in gt.records])
    for k, (name, rows_d) in enumerate(sorted(d_rows.items())):
        start = {key: len(v[0]) for key, v in want_pairs.items()}
        base = {fr: [10.0 * (fr + k) + j for j in range(5)] for fr in rows_d}
        port = {fr: [b + x for b, x in zip(base[fr], rows_d[fr])]
                for fr in rows_d}
        if k == 1:
            port[4] = [1.0] * 5
        for fr in sorted(rows_d):
            for j, c in enumerate(cas.PAIRED_COLUMNS):
                want_pairs[c.lower()][0].append(base[fr][j])
                want_pairs[c.lower()][1].append(port[fr][j])
        (rn, cn), (rr, cr) = noise[name]
        c_noise = [0.01 * x * np.array([1.0, -0.5, 0.3]) for x in cn]
        c_ref = [0.01 * x * np.array([-0.4, 1.0, 0.2]) for x in cr]
        _dump(ref / name, base, gt, 1.0, rr, c_ref)
        _dump(mine / name, port, gt, 2.0, rn, c_noise)
        e_ref = _edges_by_hand(gt, 1.0, rr, c_ref)
        e_mine = _edges_by_hand(gt, 2.0, rn, c_noise)
        for j, key in enumerate(edge_keys):
            want_pairs[key][0].extend(e_ref[:, j])
            want_pairs[key][1].extend(e_mine[:, j])
        for side, (sc, cn_) in enumerate(((1.0, c_ref), (2.0, c_noise))):
            want_pairs["ate_ratio_pre_pose_graph"][side].append(_ate_by_hand(
                [sc * c + dc for c, dc in zip(gtc, cn_)], gtc))
        for key, (a, b) in want_pairs.items():
            want_runs.setdefault(key, []).append(
                (np.median(a[start[key]:]), np.median(b[start[key]:])))
    (mine / "scan3.json").write_text("{}")  # one side only: not read

    got = {c["metric"]: c for c in cas.compare_paired(str(ref), str(mine),
                                                      gt)}
    assert list(got) == list(want_pairs)
    for key, (a, b) in want_pairs.items():
        d = np.asarray(b) - np.asarray(a)
        c = got[key]
        assert c["runs"] == ["scan1.json", "scan2.json"]
        assert c["n"] == len(d) == (6 if key.startswith("y_") else
                                    2 if key.startswith("ate_") else 8)
        np.testing.assert_allclose(c["median_diff"], np.median(d),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(c["ref_median"], np.median(a),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(c["median"], np.median(b),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(c["p"], _wilcoxon_by_hand(d), rtol=1e-9)
        # per run: each side's median in the run, paired over the runs
        ra, rb = np.asarray(want_runs[key]).T
        r = c["per_run"]
        if key == "edge_baseline_ratio":  # 1 in every run by definition
            np.testing.assert_allclose([ra, rb], 1.0, rtol=1e-12)
            assert r is None
            continue
        assert r["n"] == 2
        np.testing.assert_allclose(
            [r["ref_median"], r["median"], r["median_diff"]],
            [np.median(ra), np.median(rb), np.median(rb - ra)],
            rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(r["p"], _wilcoxon_by_hand(rb - ra),
                                   rtol=1e-9)
    # the signed-rank p needs distinct nonzero differences
    for a, b in want_pairs.values():
        d = np.abs(np.asarray(b) - np.asarray(a))
        assert len(np.unique(d)) == len(d) and d.min() > 1e-6
    # no difference at all: p = 1
    same = cas.paired_stat([3.0, 1.0, 2.0], [3.0, 1.0, 2.0])
    assert same == {"n": 3, "ref_median": 2.0, "median": 2.0,
                    "median_diff": 0.0, "p": 1.0}


def test_torch_ate_swap_compare_runs():
    """--compare LOG --against LOG: runs paired by (ring texture seed,
    RANSAC seed); a line without ``ring_seed`` is on the default ring."""
    def line(ring, seed, ate, pts, loop=True):
        d = {"pipeline": "scan", "seed": seed, "ate_ratio": ate,
             "map_points": pts,
             "loop_edges": [[3, 9], [0, 46]] if loop else [[3, 9]]}
        return d if ring is None else {**d, "ring_seed": ring}

    ref = [line(None, 1, 0.010, 900), line(8, 1, 0.020, 910, loop=False),
           line(9, 1, 0.015, 905), line(9, 2, 0.011, 930, loop=False),
           line(10, 1, 0.030, 950),
           {"pipeline": "host", "seed": 1, "ate_ratio": 0.5,
            "map_points": 1}]
    runs = [line(7, 1, 0.0135, 903), line(8, 1, 0.017, 911, loop=False),
            line(9, 1, 0.0165, 907, loop=False), line(9, 2, 0.0105, 936),
            line(11, 1, 0.9, 1)]
    got = cas.compare_runs(ref, runs)
    assert got["pairs"] == [[7, 1, 0.010, 0.0135], [8, 1, 0.020, 0.017],
                            [9, 1, 0.015, 0.0165], [9, 2, 0.011, 0.0105]]
    want = [0.010, 0.020, 0.015, 0.011]
    mine = [0.0135, 0.017, 0.0165, 0.0105]
    d = np.asarray(mine) - np.asarray(want)
    np.testing.assert_allclose(got["ate_ratio"]["median_diff"], np.median(d),
                               rtol=1e-12)
    np.testing.assert_allclose(got["ate_ratio"]["p"], _wilcoxon_by_hand(d),
                               rtol=1e-9)
    assert got["map_points"]["median_diff"] == 2.5
    # (ring, seed, reference lacks (0, 46), the runs lack it)
    assert got["no_loop_edge"] == [[8, 1, True, True], [9, 1, False, True],
                                   [9, 2, True, False]]
    # the detectable ratio: normal approximation, efficiency 3 / pi
    la, lb = np.log(want), np.log(mine)
    z = 1.6448536269514722 + 0.8416212335729143
    eff = np.sqrt(3.0 / np.pi)
    np.testing.assert_allclose(
        got["detectable_ratio"]["paired"],
        np.exp(z * np.std(lb - la, ddof=1) / 2.0 / eff), rtol=1e-12)
    np.testing.assert_allclose(
        got["detectable_ratio"]["unpaired"],
        np.exp(z * np.sqrt((np.var(la, ddof=1) + np.var(lb, ddof=1)) / 4)
               / eff), rtol=1e-12)
    np.testing.assert_allclose(got["median_ratio"],
                               np.median(mine) / np.median(want), rtol=1e-12)
