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
            ScanSfM.process / finalize / export at the bench configuration
            (loop closure with device-side verification, pose graph, final
            structure refinement), checks that the kernels were launched by
            it, that the artifacts exist, that the loop closed and that the
            trajectory is right (Sim(3) ATE under 5 % of the trajectory's
            extent);
  arms      the tracker's other arms, which run the template-passed-in
            kernel K4 and the one-image gather K5: lk_track_fb on one frame
            pair with SFM_TPU_LK_FUSED_TMPL=0 (held to the default arm), with
            SFM_TPU_LK_FUSED=0, and on a pair of unequal shapes; then an
            8-frame prefix of the ring through ScanSfM with
            SFM_TPU_LK_FUSED_TMPL=0 (K4 and K5 on their path through the
            system);
  host      the same ring through the CLI's default pipeline,
            SfMSystem.process / finalize / export (warm-up run, then the
            measured run; the global BA on the AoS path), with its stage
            timers;
  cli       ``python -m sfm_tpu_torch --synthetic 8`` in a subprocess, with
            ``--pipeline host`` (the default) and ``--pipeline scan``;
  orb       the ring through ScanSfM with the ORB loop flavor;
  orb_host  the ring through SfMSystem with the ORB loop flavor.

The next-to-last lines are the ``{"kernels": [...]}`` summary and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase ends the run with a
non-zero exit code and no result line.  ``--only kernels`` stops after the
kernel phase (a short first check of a changed kernel).  ``--profile`` adds
a ``profile`` line: frames 1..4 of the ring twice more, plain for the wall
time and under ``torch.profiler`` for the device's busy time, with the
estimated idle share and the operators that took most device and most host
time; and a ``loop_ab`` line: the 47-frame run with loop closure off and on,
in turns, for what loop closure costs on this card.
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
# K3/K4 at other patch radii, T_RADII tracks each: the kernels instantiate
# their loop for radius 1..10 and take any other radius (12 here) at run time
RADII_EXTRA = (3, 5, 7, 10, 12)
T_RADII = 512
RADII_SEED = 0  # seed of their inputs (tools/chip_lk_survey.py: other seeds)
# K1 at every radius the port uses (3: replenish, 2: loop verification) and
# the ends of the kernel's range; the window gathers at the widths of these
# LK radii (the kernels compile the widths of radius 1..10) and at one width
# outside that set
ST_RADII = (1, 2, 3, 8)
GATHER_RADII = (1, 3, 6, 10)
GATHER_WIN_OTHER = 39


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


def check_shi_tomasi(dev, gray_u8, aux) -> dict:
    """K1 against its plain version, bit for bit, at each radius of
    ST_RADII on the ring's first frame (640x480), on its pyramid's level 3
    (80x60: partial tiles on both axes) and on a 481x641 texture drawn from
    ``aux`` (partial tiles, and rows that are no whole number of 16-byte
    chunks); timed on the frame at radius 3 and 2."""
    from sfm_tpu_torch.ops import image as im
    from sfm_tpu_torch.ops.kernels import shi_tomasi_kernel as st

    img = torch.as_tensor(gray_u8, device=dev).to(torch.float32).contiguous()
    images = [img, im.build_pyramid(img, LEVELS)[-1].contiguous(),
              torch.as_tensor(textured(aux, 481, 641), device=dev)]
    exact, err, checked = True, 0.0, []
    for x in images:
        for r in ST_RADII:
            out = st.shi_tomasi_score(x, r)
            torch.cuda.synchronize()
            ref = st.shi_tomasi_score_plain(x, r)
            exact &= out.shape == ref.shape and bool(torch.equal(out, ref))
            err = max(err, float((out - ref).abs().max()))
            checked.append([*x.shape, r])
    r = 3
    H, W = img.shape
    flops = H * W * (4 + 3 + 3 * 4 * r + 10)
    b_ms, b_by = bound(2 * H * W * 4, flops)
    return {
        "name": "shi_tomasi_score", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/shi_tomasi.cu",
        "replaces": "sfm_tpu/ops/pallas/shi_tomasi_kernel.py:67",
        "shape": [H, W, r], "checked": checked, "radii_checked": ST_RADII,
        "max_abs_err": err, "tol": 0.0, "ok": exact,
        "ms": time_ms(lambda: st.shi_tomasi_score(img, r)),
        "ms_r2": time_ms(lambda: st.shi_tomasi_score(img, 2)),
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


def garbage_starts(g, H: int, W: int, win: int, T: int = T_TRACKS):
    """(T,2) int32 window starts drawn from ``g`` up to 40 px outside the
    image, the first five the corners of the clamp range and the integers
    a garbage position can cast to."""
    s = np.stack([g.integers(-40, W + 40, T), g.integers(-40, H + 40, T)], -1)
    s[:5] = [[0, 0], [W, H], [W - win, H - win], [-2**31, -2**31],
             [2**31 - 1, 2**31 - 1]]
    return s.astype(np.int32)


def gather_widths(margin: int) -> list[tuple[int, int]]:
    """(template, search) window widths of the LK levels at GATHER_RADII,
    and one pair outside the widths the gather kernels compile."""
    pairs = [(2 * r + 4, 2 * r + 4 + 2 * margin) for r in GATHER_RADII]
    return pairs + [(GATHER_WIN_OTHER - 2 * margin, GATHER_WIN_OTHER)]


def lk_gather_library(img, sx, sy, win: int):
    """The window gather as one PyTorch call on starts already clamped
    into the image (int64): a strided view of every window, then one
    aten::index.  The yardstick of ``library_ms``; the port never calls
    it."""
    return img.unfold(0, win, 1).unfold(1, win, 1)[sy, sx]


def check_lk_gather(dev, rng, aux, pyr0, pyr1) -> dict:
    """K2, bit-exact against slicing on all four levels at every pair of
    ``gather_widths`` with garbage starts; timed at level 0 with the
    pipeline's widths.  The pipeline's pair draws its starts from ``rng``,
    the others from ``aux``."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * RADIUS + 1
    WIN0, WIN = P + 3, P + 2 * lk.MARGIN + 3
    exact = True
    for L in range(LEVELS):
        H, W = pyr0[L].shape
        for w0, w1 in gather_widths(lk.MARGIN):
            g = rng if (w0, w1) == (WIN0, WIN) else aux
            s0, s1 = (torch.as_tensor(garbage_starts(g, H, W, w), device=dev)
                      for w in (w0, w1))
            o0, o1 = lk.lk_gather_pair(pyr0[L], s0, w0, pyr1[L], s1, w1)
            torch.cuda.synchronize()
            r0, r1 = lk.lk_gather_pair_plain(pyr0[L], s0, w0, pyr1[L], s1,
                                             w1)
            exact &= bool(torch.equal(o0, r0) and torch.equal(o1, r1))
            if L == 0 and (w0, w1) == (WIN0, WIN):
                args = (pyr0[0], s0, WIN0, pyr1[0], s1, WIN)
                ms = time_ms(lambda: lk.lk_gather_pair(*args))
                plain_ms = time_ms(lambda: lk.lk_gather_pair_plain(*args))
                c0 = lk._clamp_starts(s0, H, W, WIN0)
                c1 = lk._clamp_starts(s1, H, W, WIN)
                two_calls_ms = time_ms(lambda: (
                    lk_gather_library(pyr0[0], *c0, WIN0),
                    lk_gather_library(pyr1[0], *c1, WIN)))
    H, W = pyr0[0].shape
    out_bytes = T_TRACKS * (WIN0 * WIN0 + WIN * WIN) * 4
    b_ms, b_by = bound(2 * H * W * 4 + T_TRACKS * 16 + out_bytes, 0.0)
    return {
        "name": "lk_gather_pair", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/lk_gather_pair.cu",
        "replaces": "sfm_tpu/ops/pallas/block_gather_kernel.py:209",
        "shape": [T_TRACKS, WIN0, WIN],
        "widths_checked": gather_widths(lk.MARGIN),
        "max_abs_err": 0.0 if exact else 1.0,
        "tol": 0.0, "ok": exact, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        # no one call gathers two images' windows
        "library_ms": None, "library_two_calls_ms": two_calls_ms,
    }


def k3_level(pyr0, pyr1, L, p, v, iters, which, radius=RADIUS):
    """One level of K3 ("kernel"), or of its plain version in float32
    ("plain") or float64 ("plain64")."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    if which == "kernel":
        return lk.lk_level_fused(pyr0[L], pyr1[L], p, v, iters, radius, 1e-4)
    cast = (lambda t: t.double()) if which == "plain64" else (lambda t: t)
    return lk.lk_level_plain(cast(pyr0[L]), cast(pyr1[L]), cast(p), cast(v),
                             iters, radius, 1e-4)


def k4_inputs(pyr0, pyr1, L, p, v, dtype=torch.float32, radius=RADIUS):
    """K4's inputs as the template-passed-in arm makes them: the search
    windows, the template patch and the base (window gathers by slicing,
    which K5 matches bit for bit)."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * radius + 1
    img0, img1 = pyr0[L].to(dtype), pyr1[L].to(dtype)
    p, v = p.to(dtype), v.to(dtype)
    o0 = p - radius
    blk0, a0 = lk._load_blocks(img0, o0, P, 0)
    tmpl = lk.template_patch(blk0, a0, o0, P)
    blk1, a1 = lk._load_blocks(img1, p + v - radius, P, lk.MARGIN)
    return blk1, tmpl, o0 - a1, v


def k4_level(pyr0, pyr1, L, p, v, iters, which, radius=RADIUS):
    """One level of K4 ("kernel"), or of its plain version in float32
    ("plain") or float64 ("plain64"), on inputs made at (p, v)."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    dtype = torch.float64 if which == "plain64" else torch.float32
    blk1, tmpl, base, v = k4_inputs(pyr0, pyr1, L, p, v, dtype, radius)
    fn = lk.lk_level_tmpl if which == "kernel" else lk.lk_level_tmpl_plain
    return fn(blk1, tmpl, base, v, iters, 1e-4)


def lk_step_chain(level, p, v, good, tol, gap_factor):
    """One LK update at a time along the plain version's trajectory
    (``level(p, v, iters, which)`` runs one level): the largest |kernel -
    plain| of any non-NaN track on any update, and the largest of it as a
    share of tol + gap_factor * |plain f32 - plain f64| on the same
    update."""
    worst = excess = 0.0
    for _ in range(ITERS):
        k1 = level(p, v, 1, "kernel")
        p1 = level(p, v, 1, "plain")
        p1d = level(p, v, 1, "plain64")
        d = (k1 - p1).abs().amax(-1)[good].double()
        gap = (p1.double() - p1d).abs().amax(-1)[good]
        if not bool(torch.isfinite(d).all()):
            return float("inf"), float("inf")
        worst = max(worst, float(d.max()))
        excess = max(excess, float((d / (tol + gap_factor * gap)).max()))
        v = p1
    return worst, excess


def check_lk_level(dev, rng, pyr0, pyr1, level=k3_level, radius=RADIUS,
                   T=T_TRACKS, timed=True) -> dict:
    """K3 (or, with ``level=k4_level``, K4) against the plain version on
    all four levels at patch radius ``radius`` with ``T`` tracks: non-zero
    incoming flow, half of the tracks within one search window of a
    border, and a second run with 40 % NaN positions.  ``timed=False``
    checks only and returns a short summary.

    All ``ITERS`` iterations in one launch:
    interior tracks (at least one search window from every border, so no
    window clamp bites): EVERY non-NaN track agrees within 1e-4 px.
    Border tracks: the window clamp bites and the bilinear fraction
    extrapolates, with weights of 10 and more; LK on such a patch may not
    converge and then amplifies the last bit of every sum from iteration
    to iteration, so that no two summation orders agree on the end point -
    not kernel and plain version, and not the plain version with itself in
    float64.  So on border tracks the kernel is held to the plain version's
    own reproducibility: how far the plain version's end point moves under
    three perturbations of its rounding - its float64 run, its float32 run
    on the transposed problem (images transposed, x and y swapped: the same
    arithmetic with every sum and bilinear blend taken in another order),
    and its float32 run from positions one float32 rounding further
    (torch.nextafter toward +inf on both axes; K3's plain version forms the
    patch origin from p + v - radius, its kernel from p - radius, and the
    two differ by such a rounding).  ``gap`` is the largest of the three
    moves.
    - Where the plain version is stable (gap under 1e-4 px), kernel and
      plain version agree within 1e-3 px.  Against fewer perturbations,
      about one border track in a thousand passes as stable while a change
      of summation order or a rounding of its position moves it by more
      than 1e-3 px.
    - Over the check's eight cells (4 levels, 2 NaN shares), the kernel
      ends more than 1e-3 px from the plain version on no more border
      tracks than the plain version's gap exceeds 1e-3 px on.  (At 512
      tracks a cell holds some 10 such tracks, and a count of one cell
      against another is mostly counting noise; PERF.md, Findings.)
    The median over all non-NaN tracks is under 1e-5 px, and every non-NaN
    track has a finite flow.

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

    P = 2 * radius + 1
    WIN = P + 2 * lk.MARGIN + 3
    k4 = level is k4_level
    tol, tol_border, med_tol, stable_tol = 1e-4, 1e-3, 1e-5, 1e-4
    pyr0T = [q.T.contiguous() for q in pyr0]
    pyr1T = [q.T.contiguous() for q in pyr1]

    def swap(a):
        return a[:, [1, 0]].contiguous()
    step_gap_factor = 2.0
    worst = worst_border = worst_med = worst_step = worst_excess = 0.0
    far = far_plain = 0  # border tracks > tol_border: kernel's, plain's gap
    # the same for each perturbation alone
    far_by = dict.fromkeys(("transposed", "float64", "shifted"), 0)
    ok = True
    per_level = []
    ms_levels = []
    plain_ms = ms_by_iters = None
    for L in range(LEVELS):
        H, W = pyr0[L].shape
        flow = np.array(SHIFT_XY, np.float32) / 2 ** L
        for nan_frac in (0.0, 0.4):
            pts = level_points(rng, H, W, T, WIN)
            bad = rng.random(T) < nan_frac
            pts[bad] = np.nan
            v0 = (flow + rng.uniform(-0.7, 0.7, (T, 2))).astype(np.float32)
            p = torch.as_tensor(pts, device=dev)
            v = torch.as_tensor(v0, device=dev)

            def run(p, v, iters, which, L=L):
                return level(pyr0, pyr1, L, p, v, iters, which, radius)

            out = run(p, v, ITERS, "kernel")
            torch.cuda.synchronize()
            ref = run(p, v, ITERS, "plain")
            ref64 = run(p, v, ITERS, "plain64")
            good = torch.as_tensor(~bad, device=dev)
            finite = bool(torch.isfinite(out[good]).all()
                          and torch.isfinite(ref[good]).all())
            pp = torch.nan_to_num(p)
            inner = (good & (pp[:, 0] >= WIN) & (pp[:, 0] <= W - 1 - WIN)
                     & (pp[:, 1] >= WIN) & (pp[:, 1] <= H - 1 - WIN))
            border = good & ~inner
            refT = swap(level(pyr0T, pyr1T, L, swap(p), swap(v), ITERS,
                              "plain", radius))
            refS = run(torch.nextafter(p, torch.full_like(p, float("inf"))),
                       v, ITERS, "plain")
            gaps = torch.stack([(ref - refT).abs().amax(-1).double(),
                                (ref.double() - ref64).abs().amax(-1),
                                (ref - refS).abs().amax(-1).double()])
            gap = gaps.amax(0)
            stable = border & (gap < stable_tol)
            d = (out - ref).abs().amax(-1)
            n_far = int((border & (d > tol_border)).sum())
            n_far_plain = int((border & (gap > tol_border)).sum())
            far, far_plain = far + n_far, far_plain + n_far_plain
            for k, g in zip(far_by, gaps):
                far_by[k] += int((border & (g > tol_border)).sum())
            err = float(d[inner].max()) if bool(inner.any()) else 0.0
            err_b = float(d[stable].max()) if bool(stable.any()) else 0.0
            med = float(d[good].median())
            worst, worst_border = max(worst, err), max(worst_border, err_b)
            worst_med = max(worst_med, med)
            err_s, excess = lk_step_chain(run, p, v, good, tol,
                                          step_gap_factor)
            worst_step = max(worst_step, err_s)
            worst_excess = max(worst_excess, excess)
            ok &= (finite and err <= tol and err_b <= tol_border
                   and med < med_tol and excess <= 1.0)
            per_level.append({"level": L, "nan_frac": nan_frac,
                              "n_interior": int(inner.sum()),
                              "max_abs_err": err,
                              "max_abs_err_border": err_b,
                              "n_border": int(border.sum()),
                              "n_border_stable": int(stable.sum()),
                              "n_border_far": n_far,
                              "n_border_far_plain": n_far_plain,
                              "max_abs_err_step": err_s,
                              "max_step_excess": excess,
                              "median_abs_err": med, "finite": finite})
            if timed and nan_frac == 0.0:
                if k4:  # the kernel alone, on inputs made once
                    ins = k4_inputs(pyr0, pyr1, L, p, v, radius=radius)
                    kern = lambda n=ITERS: lk.lk_level_tmpl(*ins, n, 1e-4)  # noqa: E731
                    plain = lambda: lk.lk_level_tmpl_plain(*ins, ITERS, 1e-4)  # noqa: E731
                else:
                    kern = lambda n=ITERS: run(p, v, n, "kernel")  # noqa: E731
                    plain = lambda: run(p, v, ITERS, "plain")  # noqa: E731
                ms_levels.append(time_ms(kern))
                if L == 0:
                    plain_ms = time_ms(plain, n=3, warm=1)
                    # the launch's fixed part (windows, template, flow
                    # in/out) against the cost of each update
                    ms_by_iters = {n: time_ms(lambda n=n: kern(n))
                                   for n in (0, 1, 4)}
                    ms_by_iters[ITERS] = ms_levels[0]
    ok &= far <= far_plain
    if not timed:
        return {"radius": radius, "tracks": T, "max_abs_err": worst,
                "max_abs_err_border": worst_border,
                "border_far": [far, far_plain], "border_far_by": far_by,
                "max_step_excess": worst_excess, "median_abs_err": worst_med,
                "ok": bool(ok)}
    ms = ms_levels[0]
    H, W = pyr0[0].shape
    # what the function needs: cur and the four gradient neighbours are the
    # same bilinear map at shifted pixels, so one map of (P+2)^2 px per
    # iteration covers them (7 flops a pixel, the four weights formed
    # once); then per patch pixel 2 differences and halvings, the residual,
    # 5 products and 5 sums (15 flops); K3 also builds the template, one
    # P^2 map, which K4 is given
    n_map, n_px = (P + 2) * (P + 2), P * P
    flops = T * ITERS * (n_map * 7 + n_px * 15)
    if k4:
        # in: the search windows, the templates, base and flow; out: flow
        b_ms, b_by = bound(T * ((WIN * WIN + n_px) * 4 + 24), flops)
        ident = {"name": "lk_level_tmpl",
                 "source": "sfm_tpu_torch/csrc/lk_level_tmpl.cu",
                 "replaces": "sfm_tpu/ops/pallas/lk_iter_kernel.py:184"}
    else:
        b_ms, b_by = bound(2 * H * W * 4 + T * 24, flops + T * n_px * 7)
        ident = {"name": "lk_level_fused",
                 "source": "sfm_tpu_torch/csrc/lk_level_fused.cu",
                 "replaces": "sfm_tpu/ops/pallas/lk_iter_kernel.py:246 + "
                             "sfm_tpu/ops/pallas/block_gather_kernel.py:209"}
    return {
        **ident, "route": "cuda",
        "shape": [T, P, WIN, ITERS], "max_abs_err": worst,
        "max_abs_err_border": worst_border, "tol_border": tol_border,
        "max_abs_err_step": worst_step, "max_step_excess": worst_excess,
        "tol_step": f"{tol} + {step_gap_factor} * |plain f32 - plain f64|",
        "border_far": [far, far_plain], "border_far_by": far_by,
        "median_abs_err": worst_med, "tol": tol, "ok": bool(ok),
        "levels": per_level, "ms_levels": ms_levels,
        "ms_by_iters": ms_by_iters, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def check_lk_level_radii(dev, pyr0, pyr1, level, row,
                        seed=RADII_SEED) -> dict:
    """Adds to ``row``, the full-size check of K3 or K4 at the pipeline's
    radius, ``check_lk_level`` with its rules and tolerances at each radius
    of RADII_EXTRA with T_RADII tracks, on inputs made from ``seed``.
    ``tools/chip_lk_survey.py`` runs the same check on the inputs of other
    seeds and holds the kernels' flows on them bit for bit against another
    tree's kernels."""
    rng = np.random.default_rng(seed)
    extra = [check_lk_level(dev, rng, pyr0, pyr1, level, radius=r,
                            T=T_RADII, timed=False) for r in RADII_EXTRA]
    row["radii_checked"] = [RADIUS, *RADII_EXTRA]
    row["radii_seed"] = seed
    row["radii"] = extra
    row["ok"] = row["ok"] and all(e["ok"] for e in extra)
    return row


def check_lk_gather1(dev, rng, pyr1) -> dict:
    """K5, the one-image gather, bit-exact against slicing on all four
    levels at every width of ``gather_widths`` with garbage starts; timed at
    level 0 with the search window, beside ``lk_gather_library`` on the
    same starts."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    WIN = 2 * RADIUS + 1 + 2 * lk.MARGIN + 3
    widths = sorted({w for pair in gather_widths(lk.MARGIN) for w in pair})
    exact = True
    for L in range(LEVELS):
        H, W = pyr1[L].shape
        for win in widths:
            st = torch.as_tensor(garbage_starts(rng, H, W, win), device=dev)
            out = lk.lk_gather(pyr1[L], st, win)
            torch.cuda.synchronize()
            exact &= bool(torch.equal(out, lk.lk_gather_plain(pyr1[L], st,
                                                              win)))
            if L == 0 and win == WIN:
                ms = time_ms(lambda: lk.lk_gather(pyr1[0], st, WIN))
                plain_ms = time_ms(lambda: lk.lk_gather_plain(pyr1[0], st,
                                                              WIN))
                sx, sy = lk._clamp_starts(st, H, W, WIN)
                library_ms = time_ms(
                    lambda: lk_gather_library(pyr1[0], sx, sy, WIN))
    # the image read once, the starts, every window written once
    H, W = pyr1[0].shape
    b_ms, b_by = bound(H * W * 4 + T_TRACKS * 8 + T_TRACKS * WIN * WIN * 4,
                       0.0)
    return {
        "name": "lk_gather", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/lk_gather_pair.cu",
        "replaces": "sfm_tpu/ops/pallas/block_gather_kernel.py:133",
        "shape": [T_TRACKS, WIN], "widths_checked": widths,
        "max_abs_err": 0.0 if exact else 1.0,
        "tol": 0.0, "ok": exact, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def ptxas_summary(log: str) -> list[dict]:
    """Registers and spilled bytes of each kernel from ``nvcc -Xptxas
    -v``'s log, the kernel named as base<template argument>."""
    import re

    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", ln)
        if m:
            # _Z[N] then length-prefixed names (namespaces, then the
            # kernel), then I...E for template arguments
            rest, name = m.group(1), ""
            while (n := re.match(r"\d+", rest)):
                k = n.end() + int(n.group())
                name, rest = rest[n.end():k], rest[k:]
            targ = re.match(r"I((?:L[a-z]-?\d+E)+)E", rest)
            args = re.findall(r"L[a-z](-?\d+)E", targ.group(1)) if targ else []
            out.append({"fn": name + (f"<{','.join(args)}>" if args else ""),
                        "registers": None, "spill_bytes": None})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and out:
            out[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def phase_kernels(dev, frame0) -> list[dict]:
    rng = np.random.default_rng(0)
    # the checks that came after rng's sequence of draws was fixed draw
    # from aux, so that K3's and K4's inputs stay those of earlier commits
    # (their errors are compared across commits to the last digit)
    aux = np.random.default_rng(1)
    pyr0, pyr1 = lk_inputs(dev, rng)
    with torch.no_grad():
        rows = [check_shi_tomasi(dev, frame0, aux),
                check_lk_gather(dev, rng, aux, pyr0, pyr1),
                check_lk_level(dev, rng, pyr0, pyr1),
                check_lk_level(dev, rng, pyr0, pyr1, level=k4_level),
                check_lk_gather1(dev, rng, pyr1)]
        # the other radii after the rows above, which keep their inputs
        for i, level in ((2, k3_level), (3, k4_level)):
            rows[i] = check_lk_level_radii(dev, pyr0, pyr1, level, rows[i])
    for r in rows:
        r["kernel_ms"] = r["ms"]
    return rows


# ---------------------------------------------------------------------------
# phase: pipeline
# ---------------------------------------------------------------------------


# ATE ratio of the same run with loop closure and the final refinement
# off, as PERF.md records it (section 6): printed beside this run's
ATE_LOOP_OFF_RECORDED = 0.0310


def smoke_config():
    """The bench configuration of the JAX package (bench.py bench_config)
    at full width: loop closure on with device-side verification, the
    synthetic ring's lowered descriptor gate, the final structure
    refinement at its default 10 iterations."""
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
        "loop.enabled": True,
        "loop.device_verify": True,
        "loop.score_thresh": 0.3,
        "loop.ransac_thresh": 2e-5,
    })


def run_pipeline(dev, K, frames, names, out_dir, cfg=None):
    from sfm_tpu_torch.models.scan_pipeline import ScanSfM

    cfg = cfg or smoke_config()
    s = ScanSfM(K, cfg, n_frames=FRAMES, chunk=32, p_cap=16384, p_ba=1024,
                device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, g in enumerate(frames):
        s.process(i, names[i], g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s.finalize()  # the tail chunk, its loop check, the refinement
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    info = s.export(out_dir)
    return s, info, dt, t1 - t0


def time_host_stages(s) -> dict:
    """Wall seconds of one pose-graph solve and of the finalize
    refinement, each run once more on the final state (both end in a pull
    to the host, so the host clock times the device work too)."""
    from sfm_tpu_torch.models import scan_pipeline as sp

    cfg = s.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s._pose_graph_solve(s._ring_poses())
    t1 = time.perf_counter()
    X, _, cost = sp._finalize_refine_core(
        s._Kt, s.carry.ring, s.carry.X, int(s.carry.n_pts), True, False,
        True, iters=cfg.ba.global_iters, rounds=1, lambda0=cfg.ba.lambda0,
        huber_delta=cfg.ba.huber_delta / float(s.K[0, 0]))
    float(cost)
    t2 = time.perf_counter()
    return {"pose_graph_solve_s": t1 - t0, "finalize_refine_s": t2 - t1}


def ring_dataset(tmp: Path):
    """The 47-frame ring rendered under ``tmp``: (dataset, frames, names)."""
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    generate_dataset(tmp / "templeRing", ring_spec(), name_prefix="templeR")
    ds = TempleRing.from_dir(tmp / "templeRing")
    return ds, [ds.load_gray(i) for i in range(FRAMES)], \
        [r.img for r in ds.records]


def ate_ratio(kfs, ds) -> float:
    """Sim(3) ATE of the keyframe centres over the trajectory's extent."""
    from sfm_tpu_torch.ops import umeyama

    est = np.stack([kf.center for kf in kfs]).astype(np.float64)
    gt = np.stack([ds.records[kf.frame_idx].center for kf in kfs])
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    return float(res["rmse"]) / extent


def reset_launches() -> None:
    from sfm_tpu_torch.ops.kernels import lk_kernels, shi_tomasi_kernel

    lk_kernels.level_launches = lk_kernels.gather_launches = 0
    lk_kernels.tmpl_launches = lk_kernels.gather1_launches = 0
    shi_tomasi_kernel.launches = 0


def read_launches() -> dict:
    from sfm_tpu_torch.ops.kernels import lk_kernels, shi_tomasi_kernel

    return {"shi_tomasi_score": shi_tomasi_kernel.launches,
            "lk_gather_pair": lk_kernels.gather_launches,
            "lk_level_fused": lk_kernels.level_launches,
            "lk_level_tmpl": lk_kernels.tmpl_launches,
            "lk_gather": lk_kernels.gather1_launches}


def phase_pipeline(dev) -> tuple[dict, dict]:
    from sfm_tpu_torch.models.scan_pipeline import carry_tensors
    from sfm_tpu_torch.utils import artifacts

    with tempfile.TemporaryDirectory(prefix="sfm_smoke_") as tmp:
        tmp = Path(tmp)
        ds, frames, names = ring_dataset(tmp)

        # warm-up run: builds nothing new, but pays every first-call cost
        run_pipeline(dev, ds.K, frames, names, tmp / "warm")

        reset_launches()
        s, info, dt, dt_frames = run_pipeline(dev, ds.K, frames, names,
                                              tmp / "out")
        counts = read_launches()
        stages = time_host_stages(s)

        # every tensor of the carry lives on the card
        on_card = all(t.is_cuda for t in carry_tensors(s.carry))

        out = tmp / "out"
        files = ["keyframes_camera_centers.csv", "posegraph_edges.csv",
                 "templeRing_sparse_points.ply"]
        have = all((out / f).exists() for f in files)
        centers = artifacts.read_csv_centers(out / files[0])
        ply = artifacts.read_ply_xyz(out / files[2])
        est = np.stack([kf.center for kf in s.kfs])
        ratio = ate_ratio(s.kfs, ds)

    n_kf, n_pts = len(s.kfs), len(s.map_xyz)
    loops = [(e.i, e.j) for e in s.edges if e.is_loop]
    # the tracker's two passes per frame, plus two per loop verification,
    # LEVELS launches each
    expect_k3 = (FRAMES - 1 + s.loop_verifications) * LEVELS * 2
    checks = {
        "carry_on_cuda": on_card,
        "k3_launches": counts["lk_level_fused"] == expect_k3,
        "k1_launches": counts["shi_tomasi_score"] >= 1,
        "artifacts": have and len(centers) == n_kf and len(ply) > 0,
        "keyframes": n_kf >= 30,
        "map_points": n_pts > 2000,
        "loop_edges": len(loops) >= 1,
        "finite": bool(np.isfinite(est).all()
                       and np.isfinite(s.map_xyz).all()),
        "ate": ratio < 0.05,
    }
    line = {
        "phase": "pipeline", "frames": FRAMES, "keyframes": n_kf,
        "map_points": n_pts, "exported_points": int(len(ply)),
        "loop_edges": loops, "loop_verifications": s.loop_verifications,
        "pose_graph_solves": s.pg_solves,
        "ate_ratio": ratio, "ate_ratio_loop_off_recorded": ATE_LOOP_OFF_RECORDED,
        "wall_s": dt, "fps": FRAMES / dt,
        "wall_s_frames": dt_frames, "wall_s_finalize": dt - dt_frames,
        **stages,
        "launches": counts, "checks": checks,
        "ok": all(checks.values()),
    }
    return line, counts


# ---------------------------------------------------------------------------
# phase: arms (K4 and K5 on their paths)
# ---------------------------------------------------------------------------


ARM_ENV = ("SFM_TPU_LK_FUSED", "SFM_TPU_LK_FUSED_TMPL")


def with_arm(fused: str, tmpl: str, fn):
    """Run ``fn()`` with the tracker's arm switches set, restoring them."""
    import os

    old = {k: os.environ.get(k) for k in ARM_ENV}
    os.environ.update(dict(zip(ARM_ENV, (fused, tmpl))))
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_arms(dev) -> tuple[dict, dict]:
    """lk_track_fb on frames 0 -> 1 of the ring through the default arm
    (a), the template-passed-in arm (b: SFM_TPU_LK_FUSED_TMPL=0), the
    unfused arm (c: SFM_TPU_LK_FUSED=0) and a pair of unequal shapes (the
    second image 8 columns narrower: arm (b) by shape); then the first 8
    frames of the ring through ScanSfM under SFM_TPU_LK_FUSED_TMPL=0, the
    path through the system that runs K4 and K5 (their launch counts are
    reset just before it and read just after).  Arm (b) is held to arm
    (a) on the interior tracks at K3's interior tolerance."""
    from sfm_tpu_torch.models.scan_pipeline import ScanSfM
    from sfm_tpu_torch.ops import features, image as im, klt
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    n_frames = 8
    cfg = smoke_config()
    kc = cfg.klt
    with tempfile.TemporaryDirectory(prefix="sfm_arms_") as tmp:
        generate_dataset(Path(tmp), short_ring_spec(n_frames),
                         name_prefix="templeR")
        ds = TempleRing.from_dir(Path(tmp))
        frames = [ds.load_gray(i) for i in range(n_frames)]

        def pyr(g):
            return [p.contiguous() for p in im.build_pyramid(
                torch.as_tensor(g, device=dev).to(torch.float32), LEVELS)]

        pyr0, pyr1 = pyr(frames[0]), pyr(frames[1])
        pyr1_cut = pyr(np.ascontiguousarray(frames[1][:, :-8]))
        xy, _, valid = features.detect_corners(
            pyr0[0], torch.zeros((1, 2), device=dev),
            torch.zeros((1,), dtype=torch.bool, device=dev),
            max_new=T_TRACKS, cell=max(int(kc.min_distance), 2),
            quality=kc.quality, device=dev)

        def track(p1):
            return klt.lk_track_fb(pyr0, p1, xy, valid, LEVELS, ITERS,
                                   RADIUS, kc.fb_thresh, device=dev)

        lk.tmpl_launches = lk.gather1_launches = 0
        fa, oka = with_arm("1", "1", lambda: track(pyr1))
        fb, okb = with_arm("1", "0", lambda: track(pyr1))
        k4_b, k5_b = lk.tmpl_launches, lk.gather1_launches
        fc, okc = with_arm("0", "1", lambda: track(pyr1))
        k5_c = lk.gather1_launches - k5_b
        lk.tmpl_launches = lk.gather1_launches = 0
        fu, oku = with_arm("1", "1", lambda: track(pyr1_cut))
        k4_u, k5_u = lk.tmpl_launches, lk.gather1_launches
        H, W = pyr0[0].shape
        WIN = 2 * RADIUS + 1 + 2 * lk.MARGIN + 3
        # interior tracks that arm (a) tracked (a track LK does not
        # converge on amplifies the last bit of every sum and ends
        # anywhere, on either arm)
        inner = (oka & (xy[:, 0] >= WIN) & (xy[:, 0] <= W - 1 - WIN)
                 & (xy[:, 1] >= WIN) & (xy[:, 1] <= H - 1 - WIN))
        d_b = float((fb - fa).abs().amax(-1)[inner].max())
        d_c = float((fc - fa).abs().amax(-1)[inner].max())

        # the path through the system under SFM_TPU_LK_FUSED_TMPL=0
        def run():
            s = ScanSfM(ds.K, cfg, n_frames=n_frames, chunk=n_frames,
                        p_cap=16384, p_ba=1024, device=dev)
            for i, g in enumerate(frames):
                s.process(i, ds.records[i].img, g)
            s.finalize()
            return s

        k3_before = lk.level_launches
        lk.tmpl_launches = lk.gather1_launches = 0
        s = with_arm("1", "0", run)
        counts = {"lk_level_tmpl": lk.tmpl_launches,
                  "lk_gather": lk.gather1_launches}
        k3_scan = lk.level_launches - k3_before
    expect_k4 = (n_frames - 1 + s.loop_verifications) * LEVELS * 2
    checks = {
        "b_launches": k4_b == 2 * LEVELS and k5_b == 4 * LEVELS,
        "c_launches": k5_c == 4 * LEVELS,
        "unequal_launches": k4_u == 2 * LEVELS and k5_u == 4 * LEVELS,
        "b_matches_a_interior": d_b <= 1e-4,
        "unequal_finite": bool(torch.isfinite(fu[oku]).all()
                               and int(oku.sum()) > 100),
        "scan_keyframes": len(s.kfs) >= 2,
        "scan_k4_launches": counts["lk_level_tmpl"] == expect_k4,
        "scan_k5_launches": counts["lk_gather"] == 2 * expect_k4,
        "scan_no_k3": k3_scan == 0,
    }
    line = {
        "phase": "arms", "tracks": int(valid.sum()),
        "n_interior": int(inner.sum()),
        "max_abs_diff_b_vs_a_interior": d_b,
        "max_abs_diff_c_vs_a_interior": d_c,
        "same_ok_interior_b_vs_a": bool(torch.equal(oka & inner,
                                                    okb & inner)),
        "ok_tracks": {"a": int(oka.sum()), "b": int(okb.sum()),
                      "c": int(okc.sum()), "unequal": int(oku.sum())},
        "lk_track_fb_launches": {"b": [k4_b, k5_b], "c": [0, k5_c],
                                 "unequal": [k4_u, k5_u]},
        "scan_frames": n_frames, "scan_keyframes": len(s.kfs),
        "scan_launches": counts, "checks": checks,
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


def phase_loop_ab(dev) -> dict:
    """What loop closure costs end to end: the 47-frame ring at the bench
    configuration with loop closure and the final refinement off and on,
    in turns off, on, on, off, on this card and in this process (after the
    pipeline phase's warm-up)."""
    import dataclasses

    on = smoke_config()
    off = dataclasses.replace(
        on, loop=dataclasses.replace(on.loop, enabled=False),
        ba=dataclasses.replace(on.ba, global_iters=0))
    walls = {"off": [], "on": []}
    with tempfile.TemporaryDirectory(prefix="sfm_ab_") as tmp:
        tmp = Path(tmp)
        ds, frames, names = ring_dataset(tmp)
        for arm in ("off", "on", "on", "off"):
            cfg = on if arm == "on" else off
            _, _, dt, _ = run_pipeline(dev, ds.K, frames, names,
                                       tmp / arm, cfg)
            walls[arm].append(dt)
    return {"phase": "loop_ab", "order": ["off", "on", "on", "off"],
            "wall_s": walls}


# ---------------------------------------------------------------------------
# phases: host, cli, orb, orb_host (the CLI's default host pipeline, the
# command line itself, the ORB loop flavor in both pipelines)
# ---------------------------------------------------------------------------


# loop edges of the JAX package's ScanSfM with loop.method="orb" on the same
# ring at smoke_config(), on the CPU (tests/test_torch_wholerun.py,
# test_torch_wholerun_scan_orb_matches_jax; PERF.md, Findings): printed
# beside this run's
ORB_LOOP_EDGES_JAX_CPU = [[0, 46]]


def run_host(dev, ds, frames, out_dir, cfg=None):
    """SfMSystem.process over the ring, then finalize and export."""
    from sfm_tpu_torch.models.system import SfMSystem

    s = SfMSystem(ds.K, cfg or smoke_config(), gt_records=ds.records,
                  device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, g in enumerate(frames):
        s.process(i, ds.records[i].img, g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s.finalize()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    info = s.export(out_dir, dataset=ds)
    return s, info, dt, t1 - t0


def phase_host(dev) -> tuple[dict, dict]:
    """The CLI's default pipeline: the 47-frame ring through
    SfMSystem.process / finalize / export at smoke_config(), after one
    warm-up run; the global BA takes the AoS path (F*P > 8192)."""
    from sfm_tpu_torch.utils import artifacts

    with tempfile.TemporaryDirectory(prefix="sfm_host_") as tmp:
        tmp = Path(tmp)
        ds, frames, _ = ring_dataset(tmp)
        run_host(dev, ds, frames, tmp / "warm")
        reset_launches()
        s, info, dt, dt_frames = run_host(dev, ds, frames, tmp / "out")
        counts = read_launches()
        out = tmp / "out"
        files = ["keyframes_camera_centers.csv", "posegraph_edges.csv",
                 "templeRing_sparse_points.ply"]
        have = all((out / f).exists() for f in files)
        kinds = [ln.split(",")[2] for ln in
                 (out / files[1]).read_text().splitlines()[1:]]
        n_ply = len(artifacts.read_ply_xyz(out / files[2]))
        ratio = ate_ratio(s.kfs, ds)
    loops = [(e.i, e.j) for e in s.edges if e.is_loop]
    F, P, M = s.global_ba_shape or (0, 0, 0)
    expect_k3 = (FRAMES - 1 + s.loop_verifications) * LEVELS * 2
    checks = {
        "k3_launches": counts["lk_level_fused"] == expect_k3,
        "k1_launches": counts["shi_tomasi_score"] >= 1,
        "global_ba_aos": F * P > 8192,
        "loop_row": kinds.count("loop") >= 1,
        "artifacts": have and n_ply > 0,
        "finite": bool(np.isfinite(np.stack([k.center for k in s.kfs])).all()
                       and np.isfinite(s.map.xyz()).all()),
        "ate": ratio < 0.05,
    }
    line = {
        "phase": "host", "frames": FRAMES, "wall_s": dt, "fps": FRAMES / dt,
        "wall_s_frames": dt_frames, "wall_s_finalize": dt - dt_frames,
        "keyframes": info["keyframes"], "map_points": info["map_points"],
        "exported_points": n_ply, "edges": info["edges"],
        "loop_edges": loops, "loop_verifications": s.loop_verifications,
        "global_ba_shape": [F, P, M], "ate_ratio": ratio,
        "stage_timers": s.timers.summary(), "launches": counts,
        "checks": checks, "ok": all(checks.values()),
    }
    return line, counts


def phase_cli(dev) -> dict:
    """``python -m sfm_tpu_torch --synthetic 8`` in a subprocess, with the
    default ``--pipeline host`` and with ``--pipeline scan``: exit code 0,
    the three artifacts and the ``=== Summary ===`` block."""
    import re

    repo = Path(__file__).resolve().parent
    runs = {}
    ok = True
    with tempfile.TemporaryDirectory(prefix="sfm_cli_") as tmp:
        for pipe in ("host", "scan"):
            out = Path(tmp) / pipe
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "sfm_tpu_torch", "--synthetic", "8",
                 "--out", str(out), "--pipeline", pipe, "--log", "warning"],
                cwd=repo, capture_output=True, text=True, timeout=600)
            lines = res.stdout.splitlines()
            summary = (lines[lines.index("=== Summary ==="):]
                       if "=== Summary ===" in lines else [])
            pats = (r"=== Summary ===", r"Keyframes: \d+", r"Map points: \d+",
                    r"Edges: \d+", r"Wall time: \d+\.\d\ds \(\d+\.\d\d "
                    r"frames/s\)", r"Outputs: .+")
            files = ["keyframes_camera_centers.csv", "posegraph_edges.csv",
                     "templeRing_sparse_points.ply"]
            checks = {
                "rc": res.returncode == 0,
                "artifacts": all((out / f).exists() for f in files),
                "summary": len(summary) == len(pats) and all(
                    re.fullmatch(p, ln) for p, ln in zip(pats, summary)),
            }
            ok &= all(checks.values())
            runs[pipe] = {"rc": res.returncode,
                          "wall_s": time.perf_counter() - t0,
                          "summary": summary, "checks": checks,
                          "stderr_tail": res.stderr[-600:]
                          if res.returncode else ""}
    return {"phase": "cli", "frames": 8, "runs": runs, "ok": ok}


def phase_orb(dev) -> tuple[dict, dict]:
    """The 47-frame ring through ScanSfM with loop.method="orb" (ORB
    candidates scored on every keyframe, verified by PnP), after the
    pipeline phase's warm-up."""
    import dataclasses

    from sfm_tpu_torch.models.scan_pipeline import ScanSfM

    base = smoke_config()
    cfg = dataclasses.replace(base, loop=dataclasses.replace(base.loop,
                                                             method="orb"))
    with tempfile.TemporaryDirectory(prefix="sfm_orb_") as tmp:
        tmp = Path(tmp)
        ds, frames, names = ring_dataset(tmp)
        reset_launches()
        s = ScanSfM(ds.K, cfg, n_frames=FRAMES, chunk=32, p_cap=16384,
                    p_ba=1024, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, g in enumerate(frames):
            s.process(i, names[i], g)
        s.finalize()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_launches()
        info = s.export(tmp / "out")
        ratio = ate_ratio(s.kfs, ds)
    loops = [(e.i, e.j) for e in s.edges if e.is_loop]
    n_kf = len(s.kfs)
    expect_k3 = (FRAMES - 1 + s.loop_verifications
                 + s.host_verifications) * LEVELS * 2
    checks = {
        "orb_every_keyframe": sorted(s._orb_ids) == list(range(n_kf)),
        "k1_launches": counts["shi_tomasi_score"] >= n_kf,
        "k3_launches": counts["lk_level_fused"] == expect_k3,
        "finite": bool(np.isfinite(np.stack([k.center for k in s.kfs])).all()),
        "ate": ratio < 0.05,
    }
    line = {
        "phase": "orb", "frames": FRAMES, "wall_s": dt, "fps": FRAMES / dt,
        "keyframes": n_kf, "map_points": info["map_points"],
        "loop_edges": loops,
        "loop_edges_jax_cpu_recorded": ORB_LOOP_EDGES_JAX_CPU,
        "orb_verifications": s.host_verifications, "ate_ratio": ratio,
        "launches": counts, "checks": checks, "ok": all(checks.values()),
    }
    return line, counts


def phase_orb_host(dev) -> tuple[dict, dict]:
    """The 47-frame ring through SfMSystem with loop.method="orb" (ORB
    features on every keyframe, candidates ranked by Hamming match count,
    verified by E-RANSAC on the matches), after the host phase's warm-up:
    the ORB branch of the CLI's default pipeline."""
    import dataclasses

    base = smoke_config()
    cfg = dataclasses.replace(base, loop=dataclasses.replace(base.loop,
                                                             method="orb"))
    with tempfile.TemporaryDirectory(prefix="sfm_orb_host_") as tmp:
        tmp = Path(tmp)
        ds, frames, _ = ring_dataset(tmp)
        reset_launches()
        s, info, dt, _ = run_host(dev, ds, frames, tmp / "out", cfg)
        counts = read_launches()
        ratio = ate_ratio(s.kfs, ds)
    loops = [(e.i, e.j) for e in s.edges if e.is_loop]
    n_kf = len(s.kfs)
    checks = {
        "orb_every_keyframe": all(k.orb is not None for k in s.kfs),
        "k1_launches": counts["shi_tomasi_score"] >= n_kf,
        # the ORB verification is E-RANSAC on matches: no LK re-track
        "k3_launches": counts["lk_level_fused"] == (FRAMES - 1) * LEVELS * 2,
        "finite": bool(np.isfinite(np.stack([k.center for k in s.kfs])).all()
                       and np.isfinite(s.map.xyz()).all()),
        "ate": ratio < 0.05,
    }
    line = {
        "phase": "orb_host", "frames": FRAMES, "wall_s": dt,
        "fps": FRAMES / dt, "keyframes": n_kf,
        "map_points": info["map_points"], "loop_edges": loops,
        "loop_inliers": [e.inliers for e in s.edges if e.is_loop],
        "ate_ratio": ratio, "stage_timers": s.timers.summary(),
        "launches": counts, "checks": checks, "ok": all(checks.values()),
    }
    return line, counts


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
                    help="add a torch.profiler breakdown of 4 frames and "
                         "a loop-off/on comparison of the 47-frame run")
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
    ptxas = ptxas_summary(build.build_log)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds,
          "spill_bytes": sum(k["spill_bytes"] or 0 for k in ptxas),
          "ptxas": ptxas})

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
    with torch.no_grad():
        line, arm_counts = phase_arms(dev)
    emit(line)
    if not line["ok"]:
        print("chip_smoke: the arms phase failed", file=sys.stderr)
        return 1
    by_path = {"pipeline": counts, "arms": arm_counts}
    for name, phase in (("host", phase_host), ("cli", phase_cli),
                        ("orb", phase_orb), ("orb_host", phase_orb_host)):
        with torch.no_grad():
            out = phase(dev)
        line, path_counts = out if isinstance(out, tuple) else (out, None)
        emit(line)
        if not line["ok"]:
            print(f"chip_smoke: the {name} phase failed", file=sys.stderr)
            return 1
        if path_counts is not None:
            by_path[name] = path_counts
    if args.profile:
        with torch.no_grad():
            emit(phase_profile(dev))
            emit(phase_loop_ab(dev))

    for r in rows:
        r["launches_by_path"] = {p: c.get(r["name"], 0)
                                 for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("ms_r2", "max_abs_err_border", "tol_border", "max_abs_err_step",
             "max_step_excess", "tol_step", "border_far", "border_far_by",
             "radii_checked", "widths_checked", "library_two_calls_ms",
             "launches_by_path")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
