#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA device

Phases, one JSON line each on standard output:

  device    the card's name and power limit;
  build     compiles the CUDA kernels from sfm_tpu_torch/csrc/ with nvcc;
  kernels   holds each kernel against its plain PyTorch version on the card
            at the shapes the pipeline uses, and times both;
  pipeline  renders the 47-frame 640x480 360-degree synthetic ring, runs the
            full-width single-scene reconstruction through
            ScanSfM.process / finalize / export (loop closure off), checks
            that the kernels were launched by it, that the artifacts exist
            and that the trajectory is right (Sim(3) ATE under 5 % of the
            trajectory's extent).

The next-to-last lines are the ``{"kernels": [...]}`` summary and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase ends the run with a
non-zero exit code and no result line.  ``--only kernels`` stops after the
kernel phase (a short first check of a changed kernel).  ``--profile`` adds
a ``profile`` line: frames 1..4 of the ring twice more, plain for the wall
time and under ``torch.profiler`` for the device's busy time, with the
estimated idle share and the operators that took most device and most host
time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): the roofline the
# kernels' least times are reckoned against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

T_TRACKS = 2200
RADIUS = 6
ITERS = 16
LEVELS = 4
FRAMES = 47
HEAD_START_CYCLES = 10_000_000  # ~5 ms of device spin before a timed run
SHIFT_XY = (-8, 16)  # test flow of the LK kernel check: whole px at 4 levels


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn`` in ms: CUDA events around a
    run of ``n`` calls, after ``warm`` warm-up calls.  The device is first
    kept busy for a few ms (a spin kernel ahead of the first event), so the
    host issues the calls ahead of the device and a call of tens of
    microseconds is timed at the device's pace, not at the pace of the
    host that launches it.  (A plain version of hundreds of launches
    outlasts that head start and is timed at the host's pace, which is
    what it costs.)"""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time in ms the card could take, and what bounds it."""
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def textured(rng, H: int, W: int) -> np.ndarray:
    """Full-frame smooth random texture in [0,255] (every track has
    gradient under it, also the ones at the image border)."""
    from scipy.ndimage import gaussian_filter

    a = gaussian_filter(rng.random((H, W)), 1.5)
    a = (a - a.min()) / (a.max() - a.min())
    return (a * 255.0).astype(np.float32)


def ring_spec():
    from sfm_tpu_torch.utils.synthetic import SyntheticRingSpec

    return SyntheticRingSpec(
        n_frames=FRAMES, width=640, height=480, fx=1520.0, fy=1520.0,
        cylinder_radius=0.10, cylinder_zmin=-0.10, cylinder_zmax=0.10,
        ring_radius=0.60, ring_z=0.05, arc_deg=360.0, texture_blur=1.5)


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------


def check_shi_tomasi(dev, gray_u8) -> dict:
    from sfm_tpu_torch.ops.kernels import shi_tomasi_kernel as st

    r = 3
    img = torch.as_tensor(gray_u8, device=dev).to(torch.float32).contiguous()
    out = st.shi_tomasi_score(img, r)
    torch.cuda.synchronize()
    ref = st.shi_tomasi_score_plain(img, r)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    # same operations in the same order, correctly rounded on both sides:
    # the allowance covers one rounding of the largest response per sum
    tol = 1e-5 * scale
    H, W = img.shape
    flops = H * W * (4 + 3 + 3 * 4 * r + 10)
    b_ms, b_by = bound(2 * H * W * 4, flops)
    return {
        "name": "shi_tomasi_score", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/shi_tomasi.cu",
        "replaces": "sfm_tpu/ops/pallas/shi_tomasi_kernel.py:67",
        "shape": [H, W, r], "max_abs_err": err, "tol": tol,
        "ok": bool(err <= tol),
        "ms": time_ms(lambda: st.shi_tomasi_score(img, r)),
        "plain_ms": time_ms(lambda: st.shi_tomasi_score_plain(img, r)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def lk_inputs(dev, rng):
    """Two full-frame textures (the second shifted) as 4-level pyramids,
    and T positions per level spread over the whole frame, a band of them
    within one search window of each border."""
    from sfm_tpu_torch.ops import image as im

    a = textured(rng, 480, 640)
    b = np.roll(a, (SHIFT_XY[1], SHIFT_XY[0]), axis=(0, 1))
    pyr0 = [p.contiguous() for p in
            im.build_pyramid(torch.as_tensor(a, device=dev), LEVELS)]
    pyr1 = [p.contiguous() for p in
            im.build_pyramid(torch.as_tensor(b, device=dev), LEVELS)]
    return pyr0, pyr1


def level_points(rng, H, W, T, WIN):
    pts = rng.uniform([0, 0], [W - 1, H - 1], (T, 2))
    nb = T // 8  # tracks hugging each of the four borders
    pts[0 * nb:1 * nb, 0] = rng.uniform(0, min(WIN, W - 1), nb)
    pts[1 * nb:2 * nb, 0] = rng.uniform(max(W - 1 - WIN, 0), W - 1, nb)
    pts[2 * nb:3 * nb, 1] = rng.uniform(0, min(WIN, H - 1), nb)
    pts[3 * nb:4 * nb, 1] = rng.uniform(max(H - 1 - WIN, 0), H - 1, nb)
    return pts.astype(np.float32)


def check_lk_gather(dev, rng, pyr0, pyr1) -> dict:
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * RADIUS + 1
    WIN0, WIN = P + 3, P + 2 * lk.MARGIN + 3
    exact = True
    ms = plain_ms = None
    for L in range(LEVELS):
        H, W = pyr0[L].shape
        lo, hi = -2**31, 2**31 - 1

        def starts(win):
            s = np.stack([rng.integers(-40, W + 40, T_TRACKS),
                          rng.integers(-40, H + 40, T_TRACKS)], -1)
            # the corners of the clamp range, and the integers a garbage
            # position can cast to
            s[:5] = [[0, 0], [W, H], [W - win, H - win], [lo, lo], [hi, hi]]
            return torch.as_tensor(s.astype(np.int32), device=dev)

        s0, s1 = starts(WIN0), starts(WIN)
        o0, o1 = lk.lk_gather_pair(pyr0[L], s0, WIN0, pyr1[L], s1, WIN)
        torch.cuda.synchronize()
        r0, r1 = lk.lk_gather_pair_plain(pyr0[L], s0, WIN0, pyr1[L], s1, WIN)
        exact &= bool(torch.equal(o0, r0) and torch.equal(o1, r1))
        if L == 0:
            ms = time_ms(lambda: lk.lk_gather_pair(
                pyr0[0], s0, WIN0, pyr1[0], s1, WIN))
            plain_ms = time_ms(lambda: lk.lk_gather_pair_plain(
                pyr0[0], s0, WIN0, pyr1[0], s1, WIN))
    H, W = pyr0[0].shape
    out_bytes = T_TRACKS * (WIN0 * WIN0 + WIN * WIN) * 4
    b_ms, b_by = bound(2 * H * W * 4 + T_TRACKS * 16 + out_bytes, 0.0)
    return {
        "name": "lk_gather_pair", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/lk_gather_pair.cu",
        "replaces": "sfm_tpu/ops/pallas/block_gather_kernel.py:209",
        "shape": [T_TRACKS, WIN0, WIN], "max_abs_err": 0.0 if exact else 1.0,
        "tol": 0.0, "ok": exact, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def lk_step_chain(lk, img0, img1, p, v, good, args, tol, gap_factor):
    """One LK update at a time along the plain version's trajectory: the
    largest |kernel - plain| of any non-NaN track on any update, and the
    largest of it as a share of tol + gap_factor * |plain f32 - plain f64|
    on the same update."""
    _, radius, min_det = args
    img0d, img1d, pd = img0.double(), img1.double(), p.double()
    worst = excess = 0.0
    for _ in range(ITERS):
        k1 = lk.lk_level_fused(img0, img1, p, v, 1, radius, min_det)
        p1 = lk.lk_level_plain(img0, img1, p, v, 1, radius, min_det)
        p1d = lk.lk_level_plain(img0d, img1d, pd, v.double(), 1, radius,
                                min_det)
        d = (k1 - p1).abs().amax(-1)[good].double()
        gap = (p1.double() - p1d).abs().amax(-1)[good]
        if not bool(torch.isfinite(d).all()):
            return float("inf"), float("inf")
        worst = max(worst, float(d.max()))
        excess = max(excess, float((d / (tol + gap_factor * gap)).max()))
        v = p1
    return worst, excess


def check_lk_level(dev, rng, pyr0, pyr1) -> dict:
    """K3 against the plain version on all four levels: non-zero incoming
    flow, half of the tracks within one search window of a border, and a
    second run with 40 % NaN positions.

    All ``ITERS`` iterations in one launch:
    interior tracks (at least one search window from every border, so no
    window clamp bites): EVERY non-NaN track agrees within 1e-4 px.
    Border tracks: the window clamp bites and the bilinear fraction
    extrapolates, with weights of 10 and more; LK on such a patch may not
    converge and then amplifies the last bit of every sum from iteration
    to iteration, so that no two summation orders agree on the end point -
    not kernel and plain version, and not the plain version with itself in
    float64.  Where the plain version is stable (its float32 and float64
    runs agree within 1e-4 px; at least 90 % of the border tracks must
    be), kernel and plain version agree within 1e-3 px.  The median over
    all non-NaN tracks is under 1e-5 px, and every non-NaN track has a
    finite flow.

    One iteration at a time, so that NO track goes unchecked: from every
    iterate v_k of the plain version's trajectory (k = 0..ITERS-1) the
    kernel makes one update, and so does the plain version in float32 and
    in float64.  Without the amplification over iterations, EVERY non-NaN
    track, border or not, agrees within 1e-4 px plus twice the plain
    version's own float32/float64 gap on that same update (an update of
    tens of px on an extrapolated patch has a gap above 1e-4 px by
    itself).  ``max_step_excess`` is the largest |kernel - plain| over that
    allowance (under 1 passes)."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * RADIUS + 1
    WIN = P + 2 * lk.MARGIN + 3
    tol, tol_border, med_tol = 1e-4, 1e-3, 1e-5
    stable_tol, min_stable = 1e-4, 0.9
    step_gap_factor = 2.0
    worst = worst_border = worst_med = worst_step = worst_excess = 0.0
    ok = True
    per_level = []
    ms_levels = []
    plain_ms = None
    for L in range(LEVELS):
        H, W = pyr0[L].shape
        flow = np.array(SHIFT_XY, np.float32) / 2 ** L
        for nan_frac in (0.0, 0.4):
            pts = level_points(rng, H, W, T_TRACKS, WIN)
            bad = rng.random(T_TRACKS) < nan_frac
            pts[bad] = np.nan
            v0 = (flow + rng.uniform(-0.7, 0.7, (T_TRACKS, 2))).astype(
                np.float32)
            p = torch.as_tensor(pts, device=dev)
            v = torch.as_tensor(v0, device=dev)
            args = (ITERS, RADIUS, 1e-4)
            out = lk.lk_level_fused(pyr0[L], pyr1[L], p, v, *args)
            torch.cuda.synchronize()
            ref = lk.lk_level_plain(pyr0[L], pyr1[L], p, v, *args)
            ref64 = lk.lk_level_plain(pyr0[L].double(), pyr1[L].double(),
                                      p.double(), v.double(), *args)
            good = torch.as_tensor(~bad, device=dev)
            finite = bool(torch.isfinite(out[good]).all()
                          and torch.isfinite(ref[good]).all())
            pp = torch.nan_to_num(p)
            inner = (good & (pp[:, 0] >= WIN) & (pp[:, 0] <= W - 1 - WIN)
                     & (pp[:, 1] >= WIN) & (pp[:, 1] <= H - 1 - WIN))
            border = good & ~inner
            stable = border & ((ref.double() - ref64).abs().amax(-1)
                               < stable_tol)
            frac = float(stable.sum()) / max(float(border.sum()), 1.0)
            d = (out - ref).abs().amax(-1)
            err = float(d[inner].max()) if bool(inner.any()) else 0.0
            err_b = float(d[stable].max()) if bool(stable.any()) else 0.0
            med = float(d[good].median())
            worst, worst_border = max(worst, err), max(worst_border, err_b)
            worst_med = max(worst_med, med)
            err_s, excess = lk_step_chain(lk, pyr0[L], pyr1[L], p, v, good,
                                          args, tol, step_gap_factor)
            worst_step = max(worst_step, err_s)
            worst_excess = max(worst_excess, excess)
            ok &= (finite and err <= tol and err_b <= tol_border
                   and med < med_tol and frac >= min_stable
                   and excess <= 1.0)
            per_level.append({"level": L, "nan_frac": nan_frac,
                              "n_interior": int(inner.sum()),
                              "max_abs_err": err,
                              "max_abs_err_border": err_b,
                              "border_stable_frac": frac,
                              "max_abs_err_step": err_s,
                              "max_step_excess": excess,
                              "median_abs_err": med, "finite": finite})
            if nan_frac == 0.0:
                ms_levels.append(time_ms(lambda: lk.lk_level_fused(
                    pyr0[L], pyr1[L], p, v, *args)))
                if L == 0:
                    plain_ms = time_ms(lambda: lk.lk_level_plain(
                        pyr0[0], pyr1[0], p, v, *args), n=3, warm=1)
    ms = ms_levels[0]
    H, W = pyr0[0].shape
    # what the function needs: cur and the four gradient neighbours are the
    # same bilinear map at shifted pixels, so one map of (P+2)^2 px per
    # iteration covers them (7 flops a pixel, the four weights formed
    # once); then per patch pixel 2 differences and halvings, the residual,
    # 5 products and 5 sums (15 flops); the template is one P^2 map
    n_map, n_px = (P + 2) * (P + 2), P * P
    flops = T_TRACKS * (ITERS * (n_map * 7 + n_px * 15) + n_px * 7)
    b_ms, b_by = bound(2 * H * W * 4 + T_TRACKS * 24, flops)
    return {
        "name": "lk_level_fused", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/lk_level_fused.cu",
        "replaces": "sfm_tpu/ops/pallas/lk_iter_kernel.py:246 + "
                    "sfm_tpu/ops/pallas/block_gather_kernel.py:209",
        "shape": [T_TRACKS, P, WIN, ITERS], "max_abs_err": worst,
        "max_abs_err_border": worst_border, "tol_border": tol_border,
        "max_abs_err_step": worst_step, "max_step_excess": worst_excess,
        "tol_step": f"{tol} + {step_gap_factor} * |plain f32 - plain f64|",
        "median_abs_err": worst_med, "tol": tol, "ok": bool(ok),
        "levels": per_level, "ms_levels": ms_levels, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def phase_kernels(dev, frame0) -> list[dict]:
    rng = np.random.default_rng(0)
    pyr0, pyr1 = lk_inputs(dev, rng)
    with torch.no_grad():
        rows = [check_shi_tomasi(dev, frame0),
                check_lk_gather(dev, rng, pyr0, pyr1),
                check_lk_level(dev, rng, pyr0, pyr1)]
    for r in rows:
        r["kernel_ms"] = r["ms"]
    return rows


# ---------------------------------------------------------------------------
# phase: pipeline
# ---------------------------------------------------------------------------


def smoke_config():
    """The bench configuration of the JAX package at full width, with loop
    closure and the final structure refinement off (this slice of the
    port)."""
    from sfm_tpu_torch.config import load_config

    return load_config(None, overrides={
        "frames": FRAMES,
        "klt.max_tracks": T_TRACKS,
        "klt.pyr_levels": LEVELS,
        "klt.iters": ITERS,
        "klt.win_radius": RADIUS,
        "ransac.num_hypotheses": 1024,
        "ransac.sampson_thresh": 2e-5,
        "ba.iters": 3,
        "ba.window": 6,
        "ba.global_iters": 0,
        "loop.enabled": False,
    })


def run_pipeline(dev, K, frames, names, out_dir):
    from sfm_tpu_torch.models.scan_pipeline import ScanSfM

    cfg = smoke_config()
    s = ScanSfM(K, cfg, n_frames=FRAMES, chunk=32, p_cap=16384, p_ba=1024,
                device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, g in enumerate(frames):
        s.process(i, names[i], g)
    s.finalize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    info = s.export(out_dir)
    return s, info, dt


def phase_pipeline(dev) -> tuple[dict, dict]:
    from sfm_tpu_torch.ops import umeyama
    from sfm_tpu_torch.ops.kernels import lk_kernels, shi_tomasi_kernel
    from sfm_tpu_torch.utils import artifacts
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    with tempfile.TemporaryDirectory(prefix="sfm_smoke_") as tmp:
        tmp = Path(tmp)
        generate_dataset(tmp / "templeRing", ring_spec(),
                         name_prefix="templeR")
        ds = TempleRing.from_dir(tmp / "templeRing")
        frames = [ds.load_gray(i) for i in range(FRAMES)]
        names = [r.img for r in ds.records]

        # warm-up run: builds nothing new, but pays every first-call cost
        run_pipeline(dev, ds.K, frames, names, tmp / "warm")

        lk_kernels.level_launches = 0
        lk_kernels.gather_launches = 0
        shi_tomasi_kernel.launches = 0
        s, info, dt = run_pipeline(dev, ds.K, frames, names, tmp / "out")
        counts = {"lk_level_fused": lk_kernels.level_launches,
                  "lk_gather_pair": lk_kernels.gather_launches,
                  "shi_tomasi_score": shi_tomasi_kernel.launches}

        # every tensor of the carry lives on the card
        from sfm_tpu_torch.models.scan_pipeline import carry_tensors
        on_card = all(t.is_cuda for t in carry_tensors(s.carry))

        out = tmp / "out"
        files = ["keyframes_camera_centers.csv", "posegraph_edges.csv",
                 "templeRing_sparse_points.ply"]
        have = all((out / f).exists() for f in files)
        centers = artifacts.read_csv_centers(out / files[0])
        ply = artifacts.read_ply_xyz(out / files[2])

        est = np.stack([kf.center for kf in s.kfs]).astype(np.float64)
        gt = np.stack([ds.records[kf.frame_idx].center for kf in s.kfs])
        res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                          with_scale=True)
        extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
        ratio = float(res["rmse"]) / extent

    n_kf, n_pts = len(s.kfs), len(s.map_xyz)
    expect_k3 = (FRAMES - 1) * LEVELS * 2
    checks = {
        "carry_on_cuda": on_card,
        "k3_launches": counts["lk_level_fused"] == expect_k3,
        "k1_launches": counts["shi_tomasi_score"] >= 1,
        "artifacts": have and len(centers) == n_kf and len(ply) > 0,
        "keyframes": n_kf >= 30,
        "map_points": n_pts > 2000,
        "finite": bool(np.isfinite(est).all()
                       and np.isfinite(s.map_xyz).all()),
        "ate": ratio < 0.05,
    }
    line = {
        "phase": "pipeline", "frames": FRAMES, "keyframes": n_kf,
        "map_points": n_pts, "exported_points": int(len(ply)),
        "ate_ratio": ratio, "wall_s": dt, "fps": FRAMES / dt,
        "launches": counts, "checks": checks,
        "ok": all(checks.values()),
    }
    return line, counts


def phase_profile(dev, n_frames: int = 5, top: int = 12) -> dict:
    """Where a frame's time goes: frames 1..``n_frames``-1 of the ring
    twice in this process (after the warm-up the pipeline phase gave) -
    once plain, for the wall time, and once under torch.profiler, for the
    device's busy time and the operators.  The profiler slows the host
    several times over and the device hardly at all, so the idle share is
    the estimate 1 - busy (profiled pass) / wall (plain pass)."""
    from torch.profiler import ProfilerActivity, profile

    from sfm_tpu_torch.models.scan_pipeline import ScanSfM
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    def run_pass(ds, frames):
        s = ScanSfM(ds.K, smoke_config(), n_frames=FRAMES,
                    chunk=n_frames - 1, p_cap=16384, p_ba=1024, device=dev)
        s.process(0, ds.records[0].img, frames[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n_frames):
            s.process(i, ds.records[i].img, frames[i])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with tempfile.TemporaryDirectory(prefix="sfm_prof_") as tmp:
        generate_dataset(Path(tmp), short_ring_spec(n_frames),
                         name_prefix="templeR")
        ds = TempleRing.from_dir(Path(tmp))
        frames = [ds.load_gray(i) for i in range(n_frames)]
        wall_ms = run_pass(ds, frames)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof_ms = run_pass(ds, frames)
    ev = prof.key_averages()
    # device kernels are the events of device type CUDA; an operator's row
    # repeats the time of the kernels it launched and is left out of the sums
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in ev if e.device_type == cuda]
    ops = [e for e in ev if e.device_type != cuda]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    by_dev = sorted(kernels, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(ops, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]
    n = n_frames - 1
    return {
        "phase": "profile", "frames": n, "wall_ms": wall_ms,
        "wall_ms_profiler_on": wall_prof_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_estimate": 1.0 - busy_ms / wall_ms,
        "device_idle_share_profiler_on": 1.0 - busy_ms / wall_prof_ms,
        "wall_ms_per_frame": wall_ms / n,
        "device_busy_ms_per_frame": busy_ms / n,
        "kernel_launches_per_frame": sum(e.count for e in kernels) / n,
        "top_device": [{"name": e.key[:70], "n": e.count,
                        "ms": dev_us(e) / 1e3} for e in by_dev],
        "top_host": [{"name": e.key[:70], "n": e.count,
                      "ms": e.self_cpu_time_total / 1e3} for e in by_cpu],
    }


def short_ring_spec(n: int):
    """The first ``n`` cameras of the ring (the angular step is kept)."""
    import dataclasses

    spec = ring_spec()
    return dataclasses.replace(spec, n_frames=n,
                               arc_deg=spec.arc_deg * n / spec.n_frames)


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="stop after this phase")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of 4 frames")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    import sfm_tpu_torch  # noqa: F401  (sets the precision policy)
    from sfm_tpu_torch.ops.kernels import build
    from sfm_tpu_torch.utils.synthetic import (make_ring_cameras,
                                               render_frame, _make_texture)

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build.load(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds,
          "ptxas": [ln for ln in build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    spec = ring_spec()
    K, Rs, ts, _, _ = make_ring_cameras(spec)
    frame0 = render_frame(spec, K, Rs[0], ts[0], _make_texture(spec))
    rows = phase_kernels(dev, frame0)
    emit({"phase": "kernels", "kernels": rows})
    if not all(r["ok"] for r in rows):
        print("chip_smoke: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    if args.only == "kernels":
        return 0

    with torch.no_grad():
        line, counts = phase_pipeline(dev)
    emit(line)
    if not line["ok"]:
        print("chip_smoke: the pipeline phase failed", file=sys.stderr)
        return 1
    if args.profile:
        with torch.no_grad():
            emit(phase_profile(dev))

    for r in rows:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("max_abs_err_border", "tol_border", "max_abs_err_step",
             "max_step_excess", "tol_step")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
