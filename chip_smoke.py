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
            extent); and grades its keyframe edges against the ring's GT
            relative poses (ops.umeyama.edge_errors on the card in
            float64: median and max rotation and direction errors, the
            medians under EDGE_ROT_MEDIAN_BAR and EDGE_DIR_MEDIAN_BAR,
            the JAX package's own medians on this ring beside them);
  bf16      the same ring and configuration through ScanSfM with
            SFM_TPU_LK_BF16=1 (the LK pyramids stored in bfloat16: K3's
            bfloat16 instantiation on the main path), held to the
            pipeline phase's bars, its ATE beside the float32 run's;
  arms      the tracker's other arms, which run the template-passed-in
            kernel K4 and the one-image gather K5: lk_track_fb on one frame
            pair with SFM_TPU_LK_FUSED_TMPL=0 (held to the default arm), with
            SFM_TPU_LK_FUSED=0, and on a pair of unequal shapes; then an
            8-frame prefix of the ring through ScanSfM with
            SFM_TPU_LK_FUSED_TMPL=0 (K4 and K5 on their path through the
            system), and the same prefix with a second ring beside it
            through run_scenes_scan (one K4 and two K5 launches per level
            and direction for both scenes; scene 0 as the one-scene run);
  host      the same ring through the CLI's default pipeline,
            SfMSystem.process / finalize / export (warm-up run, then the
            measured run; the global BA on the AoS path), with its stage
            timers and the pipeline phase's edge errors and bars;
  cli       ``python -m sfm_tpu_torch --synthetic 8`` in a subprocess, with
            ``--pipeline host`` (the default), ``--pipeline scan``, and
            ``--pipeline scan --export-geometry both --debug-nans`` (every
            op checked for NaN/Inf; ``--visuals`` too where matplotlib
            imports);
  orb       the ring through ScanSfM with the ORB loop flavor;
  orb_host  the ring through SfMSystem with the ORB loop flavor;
  multiscene  four 47-frame 640x480 rings (the ring above and three more
            rings of other textures, bench.py's bench_multiscene layout)
            through parallel.multi_scan.run_scenes_scan at the bench
            configuration (loop closure verified on the host), one K3
            launch per level and direction for all four scenes; then the
            first ring alone through ScanSfM, which scene 0 must match;
  mesh      the dense stereo mesh (models.mesh.export_stereo_grid_mesh at
            the StereoMeshConfig defaults: 128 disparities, block 7, SGM)
            on a rendered 640x480 pair of the ring's texture 3 degrees
            apart with GT poses, held to the cylinder (its wall time, the
            device time, kernel launches and peak memory of one
            _disparity_sad call, and that call on the card against the
            same call on the CPU); and the sparse Delaunay mesh of the
            pipeline phase's map in its keyframe 0;
  multichip the parallel runners over one NCCL rank per card (``world``
            = the card count, ``parallel.distributed.launch``): in each
            rank a sum over the mesh's ``scene`` group,
            ``multiscene.make_scene_step`` at full width on two rendered
            frame pairs a rank, ``find_E_sharded`` over every rank,
            ``batch_runner.run_scenes`` and ``run_scenes_scan(mesh=...)``
            on 2 x world 16-frame 640x480 rings at ``smoke_config()``
            (rank 0's kernel launches counted), rank 0 also the same
            ``run_scenes_scan`` without a mesh, which must give the same
            bits; then ``dryrun.dryrun_multichip(world)``.

The kernels phase also holds the scene-batched launches of K1, K3, K4 and
K5 (four rendered frames of the ring, S = 4, the multi-scene runner's
level-0 shapes) against four single launches, bit for bit, and each scene
against the plain version (``scenes``); and K2-K5 on bfloat16 storage
(``bf16``): bit for bit their float32 launches on the images rounded to
bfloat16, and within the float32 rules against their bfloat16 plain
versions.

The next-to-last lines are the ``{"kernels": [...]}`` summary and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase ends the run with a
non-zero exit code and no result line.  ``--only kernels`` stops after the
kernel phase (a short first check of a changed kernel).  ``--profile`` adds
a ``profile`` line: frames 1..4 of the ring twice more, plain for the wall
time and under ``torch.profiler`` for the device's busy time, with the
estimated idle share and the operators that took most device and most host
time; a ``profile_scenes`` line: the same for the multi-scene runner's
frame loop at S = 1 and S = 4, with the kernel launches a frame; and a
``loop_ab`` line: the 47-frame run with loop closure off and on,
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
# the scene-batched checks of K1 and K3: S_SCENES rendered frames of the
# ring (and each one's next frame for K3), the multi-scene phase's S
S_SCENES = 4
SCENE_FRAMES = (0, 12, 24, 36)
# the bf16 checks of K2-K5 (SFM_TPU_LK_BF16=1 storage) draw their inputs
# from this seed, after every check above, which keep theirs
BF16_SEED = 10


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
    aten::index.  A stack of S images (S,H,W) with starts (S,T) indexes
    each scene's own windows.  The yardstick of ``library_ms``; the port
    never calls it."""
    d = img.dim() - 2
    views = img.unfold(d, win, 1).unfold(d + 1, win, 1)
    if d == 0:
        return views[sy, sx]
    scene = torch.arange(img.shape[0], device=img.device)[:, None]
    return views[scene, sy, sx]


def check_lk_gather(dev, rng, aux, pyr0, pyr1) -> dict:
    """K2, bit-exact against slicing on all four levels at every pair of
    ``gather_widths`` with garbage starts; timed at level 0 with the
    pipeline's widths.  The pipeline's pair draws its starts from ``rng``,
    the others from ``aux``.  On bfloat16 pyramids, also bit for bit the
    float32 kernel on the pyramids in float32 (``bit_equal_f32``)."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * RADIUS + 1
    WIN0, WIN = P + 3, P + 2 * lk.MARGIN + 3
    bf16 = pyr0[0].dtype == torch.bfloat16
    exact = same_f32 = True
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
            if bf16:
                f0, f1 = lk.lk_gather_pair(pyr0[L].float(), s0, w0,
                                           pyr1[L].float(), s1, w1)
                same_f32 &= bool(torch.equal(o0.float(), f0)
                                 and torch.equal(o1.float(), f1))
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
    es = pyr0[0].element_size()
    out_bytes = T_TRACKS * (WIN0 * WIN0 + WIN * WIN) * es
    b_ms, b_by = bound(2 * H * W * es + T_TRACKS * 16 + out_bytes, 0.0)
    extra = {"bit_equal_f32": same_f32} if bf16 else {}
    return {
        "name": "lk_gather_pair", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/lk_gather_pair.cu",
        "replaces": "sfm_tpu/ops/pallas/block_gather_kernel.py:209",
        "shape": [T_TRACKS, WIN0, WIN],
        "widths_checked": gather_widths(lk.MARGIN),
        "max_abs_err": 0.0 if exact else 1.0,
        "tol": 0.0, "ok": exact and same_f32, **extra, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
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


def k4_inputs(pyr0, pyr1, L, p, v, dtype=None, radius=RADIUS):
    """K4's inputs as the template-passed-in arm makes them: the search
    windows, the template patch and the base (window gathers by slicing,
    which K5 matches bit for bit).  The windows keep the pyramids' storage
    dtype unless ``dtype`` is given (float64 for "plain64")."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * radius + 1
    img0, img1 = pyr0[L], pyr1[L]
    if dtype is not None:
        img0, img1, p, v = (x.to(dtype) for x in (img0, img1, p, v))
    o0 = p - radius
    blk0, a0 = lk._load_blocks(img0, o0, P, 0)
    tmpl = lk.template_patch(blk0, a0, o0, P)
    blk1, a1 = lk._load_blocks(img1, p + v - radius, P, lk.MARGIN)
    return blk1, tmpl, o0 - a1, v


def k4_level(pyr0, pyr1, L, p, v, iters, which, radius=RADIUS):
    """One level of K4 ("kernel"), or of its plain version in float32
    ("plain") or float64 ("plain64"), on inputs made at (p, v)."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    dtype = torch.float64 if which == "plain64" else None
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
    es = pyr0[0].element_size()  # 4 float32, 2 bfloat16 storage
    if k4:
        # in: the search windows, the templates, base and flow; out: flow
        b_ms, b_by = bound(T * (WIN * WIN * es + n_px * 4 + 24), flops)
        ident = {"name": "lk_level_tmpl",
                 "source": "sfm_tpu_torch/csrc/lk_level_tmpl.cu",
                 "replaces": "sfm_tpu/ops/pallas/lk_iter_kernel.py:184"}
    else:
        b_ms, b_by = bound(2 * H * W * es + T * 24, flops + T * n_px * 7)
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
    same starts.  On a bfloat16 pyramid, also bit for bit the float32
    kernel on the pyramid in float32 (``bit_equal_f32``)."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    WIN = 2 * RADIUS + 1 + 2 * lk.MARGIN + 3
    widths = sorted({w for pair in gather_widths(lk.MARGIN) for w in pair})
    bf16 = pyr1[0].dtype == torch.bfloat16
    exact = same_f32 = True
    for L in range(LEVELS):
        H, W = pyr1[L].shape
        for win in widths:
            st = torch.as_tensor(garbage_starts(rng, H, W, win), device=dev)
            out = lk.lk_gather(pyr1[L], st, win)
            torch.cuda.synchronize()
            exact &= bool(torch.equal(out, lk.lk_gather_plain(pyr1[L], st,
                                                              win)))
            if bf16:
                same_f32 &= bool(torch.equal(
                    out.float(), lk.lk_gather(pyr1[L].float(), st, win)))
            if L == 0 and win == WIN:
                ms = time_ms(lambda: lk.lk_gather(pyr1[0], st, WIN))
                plain_ms = time_ms(lambda: lk.lk_gather_plain(pyr1[0], st,
                                                              WIN))
                sx, sy = lk._clamp_starts(st, H, W, WIN)
                library_ms = time_ms(
                    lambda: lk_gather_library(pyr1[0], sx, sy, WIN))
    # the image read once, the starts, every window written once
    H, W = pyr1[0].shape
    es = pyr1[0].element_size()
    b_ms, b_by = bound(H * W * es + T_TRACKS * 8 + T_TRACKS * WIN * WIN * es,
                       0.0)
    extra = {"bit_equal_f32": same_f32} if bf16 else {}
    return {
        "name": "lk_gather", "route": "cuda",
        "source": "sfm_tpu_torch/csrc/lk_gather_pair.cu",
        "replaces": "sfm_tpu/ops/pallas/block_gather_kernel.py:133",
        "shape": [T_TRACKS, WIN], "widths_checked": widths,
        "max_abs_err": 0.0 if exact else 1.0,
        "tol": 0.0, "ok": exact and same_f32, **extra, "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def bits(t):
    """The float32 tensor's bit patterns (NaNs compare equal)."""
    return t.contiguous().view(torch.int32)


def check_shi_tomasi_scenes(dev, frames_u8, row) -> dict:
    """K1 with a scene axis: one launch over the S rendered frames (the
    bootstrap and replenish shapes of the multi-scene runner, r = 3)
    against S single launches and each frame's plain version, both bit for
    bit; timed beside the S single launches.  Added to ``row`` (K1's) as
    ``scenes``."""
    from sfm_tpu_torch.ops.kernels import shi_tomasi_kernel as st

    r = 3
    imgs = torch.stack([torch.as_tensor(f, device=dev).to(torch.float32)
                        for f in frames_u8]).contiguous()
    S, H, W = imgs.shape
    out = st.shi_tomasi_score(imgs, r)
    single = torch.stack([st.shi_tomasi_score(x, r) for x in imgs])
    torch.cuda.synchronize()
    plain = st.shi_tomasi_score_plain(imgs, r)
    same = bool(torch.equal(bits(out), bits(single)))
    exact = bool(torch.equal(bits(out), bits(plain)))
    b_ms, b_by = bound(2 * S * H * W * 4, S * H * W * (4 + 3 + 3 * 4 * r + 10))
    row["scenes"] = {
        "shape": [S, H, W, r], "bit_equal_singles": same,
        "max_abs_err": float((out - plain).abs().max()), "tol": 0.0,
        "ok": same and exact,
        "ms": time_ms(lambda: st.shi_tomasi_score(imgs, r)),
        "ms_singles": time_ms(
            lambda: [st.shi_tomasi_score(x, r) for x in imgs]),
        "plain_ms": time_ms(lambda: st.shi_tomasi_score_plain(imgs, r),
                            n=3, warm=1),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row["ok"] = row["ok"] and row["scenes"]["ok"]
    return row


def scene_lk_inputs(dev, pairs):
    """The multi-scene runner's level-0 LK inputs on S rendered frame
    pairs: the stacked level-0 images (S,H,W), each scene's 2200 bootstrap
    corners of its first frame (S,T,2) and the level-0 flow from the plain
    version's pass over levels 3..1 (S,T,2)."""
    from sfm_tpu_torch.models import tracker
    from sfm_tpu_torch.ops import image as im
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    kcfg = smoke_config().klt
    pyrs = [[im.build_pyramid(torch.as_tensor(f, device=dev)
                              .to(torch.float32), LEVELS) for f in pair]
            for pair in pairs]
    img0 = torch.stack([p[0][0] for p in pyrs]).contiguous()
    img1 = torch.stack([p[1][0] for p in pyrs]).contiguous()
    p0 = torch.stack([tracker.bootstrap(x, kcfg, device=dev).pos
                      for x in img0])
    v0 = []
    for s in range(len(pairs)):
        v = torch.zeros_like(p0[s])
        for L in range(LEVELS - 1, 0, -1):
            v = 2.0 * lk.lk_level_plain(
                pyrs[s][0][L].contiguous(), pyrs[s][1][L].contiguous(),
                p0[s] / 2 ** L, v, ITERS, RADIUS, 1e-4)
        v0.append(v)
    return img0, img1, p0, torch.stack(v0)


def check_lk_level_scenes(dev, inputs, row) -> dict:
    """K3 with a scene axis: one launch over S rendered frame pairs at
    level 0 (``scene_lk_inputs``, the runner's launch) against S single
    launches, bit for bit; and each
    scene against the plain version under ``check_lk_level``'s rule for
    border tracks, applied to every track: tracks the plain version's own
    perturbations (float64, transposed, one rounding further) move by
    under 1e-4 px agree within 1e-3 px; the kernel ends more than 1e-3 px
    from the plain version on no more tracks than the perturbations move
    that far; the median is under 1e-5 px; every flow is finite.  (The
    interior bar of 1e-4 px holds on ``check_lk_level``'s textured inputs,
    where every interior track converges; on rendered frames a track far
    from the border can converge slowly or not at all, at an occluding
    edge or on weak texture, and amplify the last bit like a border track.
    ``max_abs_err_interior_stable`` and ``max_abs_err_interior_all`` print
    the interior's worst with and without the split.)  Timed beside the S
    single launches.  Added to ``row`` (K3's) as ``scenes``."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * RADIUS + 1
    WIN = P + 2 * lk.MARGIN + 3
    img0, img1, p0, v0 = inputs
    S, H, W = img0.shape

    def level(a, b, p, v, which):
        if which == "kernel":
            return lk.lk_level_fused(a, b, p, v, ITERS, RADIUS, 1e-4)
        cast = (lambda t: t.double()) if which == "plain64" else (lambda t: t)
        return lk.lk_level_plain(cast(a), cast(b), cast(p), cast(v), ITERS,
                                 RADIUS, 1e-4)

    out = level(img0, img1, p0, v0, "kernel")
    single = torch.stack([level(img0[s], img1[s], p0[s], v0[s], "kernel")
                          for s in range(S)])
    torch.cuda.synchronize()
    same = bool(torch.equal(bits(out), bits(single)))
    per_scene, ok = [], same

    def swap(a):
        return a[..., [1, 0]].contiguous()
    for s in range(S):
        a, b, p, v = img0[s], img1[s], p0[s], v0[s]
        ref = level(a, b, p, v, "plain")
        gaps = torch.stack([
            (ref - swap(level(a.T.contiguous(), b.T.contiguous(), swap(p),
                              swap(v), "plain"))).abs().amax(-1).double(),
            (ref.double() - level(a, b, p, v, "plain64")).abs().amax(-1),
            (ref - level(a, b, torch.nextafter(
                p, torch.full_like(p, float("inf"))), v,
                "plain")).abs().amax(-1).double()])
        gap = gaps.amax(0)
        d = (out[s] - ref).abs().amax(-1)
        inner = ((p[:, 0] >= WIN) & (p[:, 0] <= W - 1 - WIN)
                 & (p[:, 1] >= WIN) & (p[:, 1] <= H - 1 - WIN))
        stable = gap < 1e-4
        err_s = float(d[stable].max())
        err_i = float(d[inner & stable].max())
        far, far_plain = int((d > 1e-3).sum()), int((gap > 1e-3).sum())
        med = float(d.median())
        finite = bool(torch.isfinite(out[s]).all())
        good = (finite and err_s <= 1e-3 and far <= far_plain
                and med < 1e-5)
        ok &= good
        per_scene.append({
            "max_abs_err_stable": err_s,
            "max_abs_err_interior_stable": err_i,
            "max_abs_err_interior_all": float(d[inner].max()),
            "n_stable": int(stable.sum()), "far": [far, far_plain],
            "median_abs_err": med, "finite": finite, "ok": good})
    n_map, n_px = (P + 2) * (P + 2), P * P
    flops = S * T_TRACKS * (ITERS * (n_map * 7 + n_px * 15) + n_px * 7)
    b_ms, b_by = bound(2 * S * H * W * 4 + S * T_TRACKS * 24, flops)
    row["scenes"] = {
        "shape": [S, T_TRACKS, P, WIN, ITERS], "bit_equal_singles": same,
        "max_abs_err": max(x["max_abs_err_stable"] for x in per_scene),
        "tol": 1e-3, "per_scene": per_scene, "ok": bool(ok),
        "ms": time_ms(lambda: level(img0, img1, p0, v0, "kernel")),
        "ms_singles": time_ms(lambda: [
            level(img0[s], img1[s], p0[s], v0[s], "kernel")
            for s in range(S)]),
        "plain_ms": time_ms(lambda: level(img0, img1, p0, v0, "plain"),
                            n=3, warm=1),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row["ok"] = row["ok"] and row["scenes"]["ok"]
    return row


def check_lk_tmpl_scenes(dev, inputs, row) -> dict:
    """K4 with a scene axis: arm (b)'s level-0 launch over the S rendered
    frame pairs of ``scene_lk_inputs`` (its windows from one K5 launch a
    window set and the template built over the stack, as ops/klt does)
    against S single launches on the same inputs, bit for bit; and against
    the plain version on the stack: every flow finite and the median under
    1e-5 px (the largest difference and the tracks beyond 1e-3 px are
    printed: on rendered frames some tracks do not converge, see
    ``check_lk_level_scenes``).  Timed beside the S single launches.
    Added to ``row`` (K4's) as ``scenes``."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    P = 2 * RADIUS + 1
    WIN = P + 2 * lk.MARGIN + 3
    img0, img1, p0, v0 = inputs
    S, T = p0.shape[:2]
    o0 = p0 - RADIUS
    blk0, a0 = lk._load_blocks(img0, o0, P, 0, lk.lk_gather)
    tmpl = lk.template_patch(blk0, a0, o0, P)
    blk1, a1 = lk._load_blocks(img1, p0 + v0 - RADIUS, P, lk.MARGIN,
                               lk.lk_gather)
    base = o0 - a1

    def launch():
        return lk.lk_level_tmpl(blk1, tmpl, base, v0, ITERS, 1e-4)

    def singles():
        return [lk.lk_level_tmpl(blk1[s], tmpl[s], base[s], v0[s], ITERS,
                                 1e-4) for s in range(S)]

    def plain():
        return lk.lk_level_tmpl_plain(blk1, tmpl, base, v0, ITERS, 1e-4)
    out = launch()
    single = torch.stack(singles())
    torch.cuda.synchronize()
    same = bool(torch.equal(bits(out), bits(single)))
    d = (out - plain()).abs().amax(-1)
    finite = bool(torch.isfinite(out).all())
    med = float(d.median())
    n_map, n_px = (P + 2) * (P + 2), P * P
    b_ms, b_by = bound(S * T * ((WIN * WIN + n_px) * 4 + 24),
                       S * T * ITERS * (n_map * 7 + n_px * 15))
    row["scenes"] = {
        "shape": [S, T, P, WIN, ITERS], "bit_equal_singles": same,
        "max_abs_err": float(d.max()), "n_over_1e-3": int((d > 1e-3).sum()),
        "median_abs_err": med, "tol_median": 1e-5, "finite": finite,
        "ok": same and finite and med < 1e-5,
        "ms": time_ms(launch), "ms_singles": time_ms(singles),
        "plain_ms": time_ms(plain, n=3, warm=1),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    row["ok"] = row["ok"] and row["scenes"]["ok"]
    return row


def check_lk_gather_scenes(dev, inputs, row) -> dict:
    """K5 with a scene axis: the search windows of arm (b)'s level-0 launch
    over the S rendered frame pairs of ``scene_lk_inputs`` in one launch,
    each scene clamped against its own image, against S single launches
    and the plain version, both bit for bit; timed beside the S single
    launches and beside ``lk_gather_library`` on the stack (which must
    give the same windows).  Then arm (c) (SFM_TPU_LK_FUSED=0: these
    windows and the plain iteration loop) over the stack against each
    scene's own call, bit for bit (``arm_c_bit_equal_singles``): the
    loop's sums are PyTorch reductions, whose launch shape depends on the
    number of tracks.  Added to ``row`` (K5's) as ``scenes``."""
    from sfm_tpu_torch.ops import klt
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    WIN = 2 * RADIUS + 1 + 2 * lk.MARGIN + 3
    img0, img1, p0, v0 = inputs
    S, H, W = img1.shape
    T = p0.shape[1]
    st = lk.window_start(p0 + v0 - RADIUS, lk.MARGIN + 1, H, W,
                         WIN).to(torch.int32)
    sx, sy = lk._clamp_starts(st, H, W, WIN)

    def launch():
        return lk.lk_gather(img1, st, WIN)

    def singles():
        return [lk.lk_gather(img1[s], st[s], WIN) for s in range(S)]

    def library():
        return lk_gather_library(img1, sx, sy, WIN)
    out = launch()
    single = torch.stack(singles())
    torch.cuda.synchronize()
    same = bool(torch.equal(out, single))
    exact = bool(torch.equal(out, lk.lk_gather_plain(img1, st, WIN)))
    same_library = bool(torch.equal(out, library()))

    def arm_c(a, b, p, v):
        return klt._lk_level(a, b, p, v, ITERS, RADIUS, 1e-4)
    stacked, per = with_env({"SFM_TPU_LK_FUSED": "0"}, lambda: (
        arm_c(img0, img1, p0, v0),
        torch.stack([arm_c(img0[s], img1[s], p0[s], v0[s])
                     for s in range(S)])))
    arm_c_same = bool(torch.equal(bits(stacked), bits(per)))
    b_ms, b_by = bound(S * (H * W * 4 + T * 8 + T * WIN * WIN * 4), 0.0)
    row["scenes"] = {
        "shape": [S, T, WIN], "bit_equal_singles": same,
        "library_bit_equal": same_library,
        "arm_c_bit_equal_singles": arm_c_same,
        "max_abs_err": 0.0 if exact else 1.0, "tol": 0.0,
        "ok": same and exact and same_library and arm_c_same,
        "ms": time_ms(launch), "ms_singles": time_ms(singles),
        "plain_ms": time_ms(lambda: lk.lk_gather_plain(img1, st, WIN)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(library),
    }
    row["ok"] = row["ok"] and row["scenes"]["ok"]
    return row


# what a ``bf16`` sub-dict of a kernel row keeps of its check's result
BF16_KEYS = ("ok", "bit_equal_f32", "max_abs_err", "tol",
             "max_abs_err_border", "tol_border", "max_abs_err_step",
             "max_step_excess", "border_far", "border_far_by",
             "median_abs_err", "widths_checked", "ms", "ms_levels",
             "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_two_calls_ms")


def bf16_pyramid(pyr):
    return [p.to(torch.bfloat16) for p in pyr]


def add_bf16(row, res) -> dict:
    row["bf16"] = {k: res[k] for k in BF16_KEYS if k in res}
    row["ok"] = row["ok"] and res["ok"]
    return row


def check_lk_level_bf16(dev, pyr0, pyr1, level, row) -> dict:
    """K3 (or, with ``level=k4_level``, K4) on bfloat16 storage
    (SFM_TPU_LK_BF16=1) at the main path's shapes: ``check_lk_level``, its
    rules, tolerances and timing, on the pyramids stored in bfloat16
    against the plain version on the same storage (which upcasts at its
    bilinear reads); then on all four levels, with 40 % NaN positions, the
    bfloat16 launch against the float32 launch on the pyramids rounded to
    bfloat16, bit for bit (``bit_equal_f32``).  Inputs from BF16_SEED.
    Added to ``row`` as ``bf16``."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    rng = np.random.default_rng(BF16_SEED)
    b0, b1 = bf16_pyramid(pyr0), bf16_pyramid(pyr1)
    res = check_lk_level(dev, rng, b0, b1, level)
    r0, r1 = [p.float() for p in b0], [p.float() for p in b1]
    WIN = 2 * RADIUS + 1 + 2 * lk.MARGIN + 3
    same = True
    for L in range(LEVELS):
        H, W = pyr0[L].shape
        pts = level_points(rng, H, W, T_TRACKS, WIN)
        pts[rng.random(T_TRACKS) < 0.4] = np.nan
        v0 = (np.array(SHIFT_XY, np.float32) / 2 ** L
              + rng.uniform(-0.7, 0.7, (T_TRACKS, 2))).astype(np.float32)
        p = torch.as_tensor(pts, device=dev)
        v = torch.as_tensor(v0, device=dev)
        same &= bool(torch.equal(
            bits(level(b0, b1, L, p, v, ITERS, "kernel")),
            bits(level(r0, r1, L, p, v, ITERS, "kernel"))))
    res["bit_equal_f32"] = same
    res["ok"] = res["ok"] and same
    return add_bf16(row, res)


def template_args(rest: str) -> list[str]:
    """The template arguments of a mangled kernel name's ``I...E`` part:
    integer literals (``Li13E``), ``float`` (``f``) and named types
    (length-prefixed, ``13__nv_bfloat16``)."""
    import re

    args = []
    i = 1 if rest.startswith("I") else len(rest)
    while i < len(rest) and rest[i] != "E":
        if (m := re.match(r"L[a-z](-?\d+)E", rest[i:])):
            args.append(m.group(1))
        elif (m := re.match(r"(\d+)", rest[i:])):
            k = m.end() + int(m.group(1))
            args.append(rest[i + m.end():i + k])
            i += k
            continue
        else:
            m = re.match(r".", rest[i:])
            args.append({"f": "float"}.get(m.group(), m.group()))
        i += m.end()
    return args


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
            args = template_args(rest)
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


def phase_kernels(dev, frame0, scene_pairs) -> list[dict]:
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
        # the scene-batched launches of the multi-scene runner
        check_shi_tomasi_scenes(dev, [a for a, _ in scene_pairs], rows[0])
        scene_inputs = scene_lk_inputs(dev, scene_pairs)
        check_lk_level_scenes(dev, scene_inputs, rows[2])
        check_lk_tmpl_scenes(dev, scene_inputs, rows[3])
        check_lk_gather_scenes(dev, scene_inputs, rows[4])
        # bfloat16 storage (SFM_TPU_LK_BF16=1), inputs of their own
        check_lk_level_bf16(dev, pyr0, pyr1, k3_level, rows[2])
        check_lk_level_bf16(dev, pyr0, pyr1, k4_level, rows[3])
        g = np.random.default_rng(BF16_SEED + 1)
        b0, b1 = bf16_pyramid(pyr0), bf16_pyramid(pyr1)
        add_bf16(rows[1], check_lk_gather(dev, g, g, b0, b1))
        add_bf16(rows[4], check_lk_gather1(dev, g, b1))
    for r in rows:
        r["kernel_ms"] = r["ms"]
    return rows


# ---------------------------------------------------------------------------
# phase: pipeline
# ---------------------------------------------------------------------------


# ATE ratio of the same run with loop closure and the final refinement
# off, as PERF.md records it (section 6): printed beside this run's
ATE_LOOP_OFF_RECORDED = 0.0310


# the bench configuration of the JAX package (bench.py bench_config) at
# full width: loop closure on with device-side verification, the synthetic
# ring's lowered descriptor gate, the final structure refinement at its
# default 10 iterations
SMOKE_OVERRIDES = {
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
}


def smoke_config():
    """The port's config at SMOKE_OVERRIDES."""
    from sfm_tpu_torch.config import load_config

    return load_config(None, overrides=SMOKE_OVERRIDES)


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
    return centers_ate_ratio([kf.center for kf in kfs],
                             [kf.frame_idx for kf in kfs], ds)


def centers_ate_ratio(centers, frames, ds) -> float:
    """Sim(3) ATE of camera centres of the frames ``frames`` of ``ds``
    over the extent of their GT centres."""
    from sfm_tpu_torch.ops import umeyama

    est = np.asarray(np.stack(centers), np.float64)
    gt = np.stack([ds.records[int(f)].center for f in frames])
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    return float(res["rmse"]) / extent


# bars on the medians of the keyframe-edge errors (degrees).  Rotation:
# tests/test_system.py:88's 2.0; an edge graded against the wrong pair of
# frames is off by whole ring steps (360 / 47 = 7.66 degrees).
# Direction: tests/test_system.py:89's 4.0 holds on that test's 8-frame
# 40-degree ring, not on this one, where the JAX package's own runs reach
# 4.27 (ScanSfM) and 4.93 (SfMSystem) (tools/jax_ring47_edges.py, on the
# CPU) and the port's 4.70-5.43 (ScanSfM) and 3.59-4.67 (SfMSystem) over
# five RANSAC seeds (tools/chip_ate_spread.py, NVIDIA H100 80GB HBM3 at
# 700 W); 6.0 lies above every median either package reaches here
EDGE_ROT_MEDIAN_BAR = 2.0
EDGE_DIR_MEDIAN_BAR = 6.0
# the JAX package's medians on this ring at SMOKE_OVERRIDES, with its own
# draws, on the CPU (tools/jax_ring47_edges.py): printed beside the port's
EDGE_MEDIANS_JAX_CPU = {
    "pipeline": {"rot_deg": 1.0092696329527944, "dir_deg": 4.271774607902265},
    "host": {"rot_deg": 1.2623173967513173, "dir_deg": 4.926126676232987},
}


def edge_errors_on_card(dev, s, ds) -> dict:
    """Relative-edge errors of a run's keyframe edges (``s.edges``, loop
    edges included) against the ring's GT relative poses of the same
    keyframes' frames: the port's ``edge_errors`` on the card, float64
    (cpp/tools/gt_keyframe_edge.cpp:377-384, BASELINE.md's edge table).
    Degrees; the direction error is the min over +-GT."""
    from sfm_tpu_torch.ops import umeyama

    gt = [_rel_pose(ds, s.kfs[e.i].frame_idx, s.kfs[e.j].frame_idx)
          for e in s.edges]

    def card(xs):
        return torch.as_tensor(np.stack(xs).astype(np.float64), device=dev)

    rot, dirn = umeyama.edge_errors(
        card([e.R_ji for e in s.edges]), card([e.t_ji for e in s.edges]),
        card([g[0] for g in gt]), card([g[1] for g in gt]))
    on_card = rot.is_cuda and dirn.is_cuda
    rot, dirn = rot.cpu().numpy(), dirn.cpu().numpy()
    return {"edge_count": len(rot), "edge_errors_on_cuda": on_card,
            "edge_rot_median_deg": float(np.median(rot)),
            "edge_rot_max_deg": float(rot.max()),
            "edge_dir_median_deg": float(np.median(dirn)),
            "edge_dir_max_deg": float(dirn.max())}


def edge_checks(edges: dict) -> dict:
    """The keyframe-edge medians against EDGE_ROT_MEDIAN_BAR and
    EDGE_DIR_MEDIAN_BAR."""
    return {"edges_on_cuda": edges["edge_errors_on_cuda"],
            "edge_rot_median": edges["edge_rot_median_deg"]
            < EDGE_ROT_MEDIAN_BAR,
            "edge_dir_median": edges["edge_dir_median_deg"]
            < EDGE_DIR_MEDIAN_BAR}


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


def phase_pipeline(dev) -> tuple[dict, dict, tuple]:
    """The measured run's line and launch counts, and (K, keyframe 0, map
    points) of its ScanSfM for the mesh phase's sparse mesh."""
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
    edges = edge_errors_on_card(dev, s, ds)
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
        **edge_checks(edges),
    }
    line = {
        "phase": "pipeline", "frames": FRAMES, "keyframes": n_kf,
        "map_points": n_pts, "exported_points": int(len(ply)),
        "loop_edges": loops, "loop_verifications": s.loop_verifications,
        "pose_graph_solves": s.pg_solves,
        "ate_ratio": ratio, "ate_ratio_loop_off_recorded": ATE_LOOP_OFF_RECORDED,
        **edges, "edge_medians_jax_cpu": EDGE_MEDIANS_JAX_CPU["pipeline"],
        "wall_s": dt, "fps": FRAMES / dt,
        "wall_s_frames": dt_frames, "wall_s_finalize": dt - dt_frames,
        **stages,
        "launches": counts, "checks": checks,
        "ok": all(checks.values()),
    }
    return line, counts, (ds.K, s.kfs[0], s.map_xyz)


def phase_bf16(dev, ate_f32: float) -> tuple[dict, dict]:
    """ring47_full (the pipeline phase's ring and configuration, not cut)
    through ScanSfM with SFM_TPU_LK_BF16=1: both LK pyramids stored in
    bfloat16, so every K3 launch is its bfloat16 instantiation (counted by
    ``lk_kernels.bf16_launches``).  One run, after the pipeline phase's
    two (first-call costs paid); launch counts reset just before it and
    read just after.  Held to the pipeline phase's bars (ATE under 5 %,
    >= 30 keyframes, > 2000 map points, a loop edge, K3 launches by the
    formula); its ATE is printed beside the float32 run's."""
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    with tempfile.TemporaryDirectory(prefix="sfm_bf16_") as tmp:
        tmp = Path(tmp)
        ds, frames, names = ring_dataset(tmp)
        reset_launches()
        n16 = lk.bf16_launches
        s, info, dt, dt_frames = with_env(
            {"SFM_TPU_LK_BF16": "1"},
            lambda: run_pipeline(dev, ds.K, frames, names, tmp / "out"))
        counts = read_launches()
        n16 = lk.bf16_launches - n16
        ratio = ate_ratio(s.kfs, ds)
    n_kf, n_pts = len(s.kfs), len(s.map_xyz)
    loops = [(e.i, e.j) for e in s.edges if e.is_loop]
    expect_k3 = (FRAMES - 1 + s.loop_verifications) * LEVELS * 2
    lk_total = sum(v for k, v in counts.items() if k != "shi_tomasi_score")
    checks = {
        "k3_launches": counts["lk_level_fused"] == expect_k3,
        "lk_all_bf16": n16 == lk_total == counts["lk_level_fused"],
        "k1_launches": counts["shi_tomasi_score"] >= 1,
        "keyframes": n_kf >= 30,
        "map_points": n_pts > 2000,
        "loop_edges": len(loops) >= 1,
        "finite": bool(np.isfinite(np.stack([k.center for k in s.kfs])).all()
                       and np.isfinite(s.map_xyz).all()),
        "ate": ratio < 0.05,
    }
    line = {
        "phase": "bf16", "env": {"SFM_TPU_LK_BF16": "1"}, "frames": FRAMES,
        "keyframes": n_kf, "map_points": n_pts, "loop_edges": loops,
        "loop_verifications": s.loop_verifications,
        "ate_ratio": ratio, "ate_ratio_f32": ate_f32,
        "wall_s": dt, "fps": FRAMES / dt, "wall_s_frames": dt_frames,
        "wall_s_finalize": dt - dt_frames, "launches": counts,
        "lk_bf16_launches": n16, "checks": checks,
        "ok": all(checks.values()),
    }
    return line, counts


# ---------------------------------------------------------------------------
# phase: arms (K4 and K5 on their paths)
# ---------------------------------------------------------------------------


ARM_ENV = ("SFM_TPU_LK_FUSED", "SFM_TPU_LK_FUSED_TMPL")


def with_env(env: dict, fn):
    """Run ``fn()`` with the environment variables ``env`` set, restoring
    them (the port reads its LK switches at call time)."""
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def with_arm(fused: str, tmpl: str, fn):
    """Run ``fn()`` with the tracker's arm switches set, restoring them."""
    return with_env(dict(zip(ARM_ENV, (fused, tmpl))), fn)


def phase_arms(dev) -> tuple[dict, dict]:
    """lk_track_fb on frames 0 -> 1 of the ring through the default arm
    (a), the template-passed-in arm (b: SFM_TPU_LK_FUSED_TMPL=0), the
    unfused arm (c: SFM_TPU_LK_FUSED=0) and a pair of unequal shapes (the
    second image 8 columns narrower: arm (b) by shape); then the first 8
    frames of the ring through ScanSfM under SFM_TPU_LK_FUSED_TMPL=0, the
    path through the system that runs K4 and K5 (their launch counts are
    reset just before it and read just after).  Arm (b) is held to arm
    (a) on the interior tracks at K3's interior tolerance.  Then the
    multi-scene runner under SFM_TPU_LK_FUSED_TMPL=0 over two scenes of 8
    frames (the ring above and one of texture seed + 1, as the multiscene
    phase takes them): one K4 and two K5 launches per level and direction
    serve both scenes, so the counts are the one-scene run's, and scene 0
    must match that run (its keyframes and loop edges, centers within
    1e-5, the multiscene phase's bar)."""
    import dataclasses

    from sfm_tpu_torch.models.scan_pipeline import ScanSfM
    from sfm_tpu_torch.ops import features, image as im, klt
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk
    from sfm_tpu_torch.parallel.multi_scan import run_scenes_scan
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

        # the multi-scene runner on the same arm, two scenes
        spec1 = short_ring_spec(n_frames)
        spec1 = dataclasses.replace(spec1, seed=spec1.seed + 1)
        generate_dataset(Path(tmp) / "scene1", spec1, name_prefix="templeR")
        ds1 = TempleRing.from_dir(Path(tmp) / "scene1")
        frames1 = [ds1.load_gray(i) for i in range(n_frames)]
        k3_before = lk.level_launches
        lk.tmpl_launches = lk.gather1_launches = 0
        t0 = time.perf_counter()
        res = with_arm("1", "0", lambda: run_scenes_scan(
            [ds, ds1], cfg, frames=n_frames, chunk=n_frames,
            images=[frames, frames1], device=dev))
        dt_scenes = time.perf_counter() - t0
        scene_counts = {"lk_level_tmpl": lk.tmpl_launches,
                        "lk_gather": lk.gather1_launches}
        k3_scenes = lk.level_launches - k3_before
    expect_k4 = (n_frames - 1 + s.loop_verifications) * LEVELS * 2
    host_ver = sum(v.host_verifications for v in res["views"])
    c_one = np.stack([kf.center for kf in s.kfs])
    same_kf = (list(res["kf_frames"][0])
               == [kf.frame_idx for kf in s.kfs])
    d_centers = (float(np.abs(res["centers"][0] - c_one).max())
                 if same_kf else float("inf"))
    scene_loops = [[(e.i, e.j) for e in le] for le in res["loop_edges"]]
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
        # one launch per level and direction for both scenes
        "scenes_k4_launches": scene_counts["lk_level_tmpl"]
        == (n_frames - 1 + host_ver) * LEVELS * 2
        == counts["lk_level_tmpl"],
        "scenes_k5_launches": scene_counts["lk_gather"]
        == 2 * scene_counts["lk_level_tmpl"] == counts["lk_gather"],
        "scenes_no_k3": k3_scenes == 0,
        "scenes_scene0_keyframes_match": same_kf,
        "scenes_scene0_loop_edges_match": scene_loops[0] == [
            (e.i, e.j) for e in s.loop_edges],
        "scenes_scene0_centers_match": d_centers <= 1e-5,
        "scenes_finite": all(bool(np.isfinite(c).all())
                             for c in res["centers"]),
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
        "scan_launches": counts,
        "scenes_run": {
            "scenes": 2, "frames": n_frames, "wall_s": dt_scenes,
            "keyframes": [int(k) for k in res["n_keyframes"]],
            "map_points": [int(k) for k in res["n_points"]],
            "loop_edges": scene_loops,
            "host_verifications": [v.host_verifications
                                   for v in res["views"]],
            "scene0_centers_max_abs_diff": d_centers,
            "scene0_centers_bit_equal": same_kf and bool(
                np.array_equal(res["centers"][0], c_one)),
            "launches": scene_counts},
        "checks": checks, "ok": all(checks.values()),
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


def phase_profile_scenes(dev, n_frames: int = 5) -> dict:
    """The multi-scene runner's frame loop at S = 1 and S = 4
    (``_bootstrap_scenes``, then frames 1..``n_frames``-1 in one
    ``_run_chunk_scenes`` call; scene s is the ring with texture seed 7 +
    s), plain for the wall time and under torch.profiler for the device's
    busy time and the kernel launches a frame (all scenes together)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from sfm_tpu_torch.parallel import multi_scan as ms
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    cfg = smoke_config()
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0.0))
    out = {"phase": "profile_scenes", "frames": n_frames - 1}
    with tempfile.TemporaryDirectory(prefix="sfm_prof_ms_") as tmp:
        grays = []
        for s in range(S_SCENES):
            spec = dataclasses.replace(short_ring_spec(n_frames),
                                       seed=ring_spec().seed + s)
            generate_dataset(Path(tmp) / f"s{s}", spec,
                             name_prefix="templeR")
            ds = TempleRing.from_dir(Path(tmp) / f"s{s}")
            grays.append(torch.stack([torch.as_tensor(ds.load_gray(i))
                                      for i in range(n_frames)]).to(dev))
        Kf = torch.as_tensor(ds.K, dtype=torch.float32, device=dev)

        def run_pass(S):
            carries = ms._bootstrap_scenes(
                cfg, 64, 16384, torch.stack([g[0] for g in grays[:S]]), 0,
                [ms.scene_seed(cfg.ransac.seed, s) for s in range(S)])
            imgs = torch.stack([g[1:] for g in grays[:S]])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms._run_chunk_scenes(cfg, 1024, Kf, carries, imgs,
                                 np.arange(1, n_frames),
                                 np.ones(n_frames - 1, bool))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        for S in (1, S_SCENES):
            run_pass(S)  # first calls of this shape
            wall_ms = run_pass(S)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_pass(S)
            kernels = [e for e in prof.key_averages()
                       if e.device_type == cuda]
            n = n_frames - 1
            busy_ms = sum(dev_us(e) for e in kernels) / 1e3
            out[f"S{S}"] = {
                "wall_ms_per_frame": wall_ms / n,
                "device_busy_ms_per_frame": busy_ms / n,
                "device_idle_share_estimate": 1.0 - busy_ms / wall_ms,
                "kernel_launches_per_frame":
                    sum(e.count for e in kernels) / n,
            }
    return out


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
    edges = edge_errors_on_card(dev, s, ds)
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
        **edge_checks(edges),
    }
    line = {
        "phase": "host", "frames": FRAMES, "wall_s": dt, "fps": FRAMES / dt,
        "wall_s_frames": dt_frames, "wall_s_finalize": dt - dt_frames,
        "keyframes": info["keyframes"], "map_points": info["map_points"],
        "exported_points": n_ply, "edges": info["edges"],
        "loop_edges": loops, "loop_verifications": s.loop_verifications,
        "global_ba_shape": [F, P, M], "ate_ratio": ratio, **edges,
        "edge_medians_jax_cpu": EDGE_MEDIANS_JAX_CPU["host"],
        "stage_timers": s.timers.summary(), "launches": counts,
        "checks": checks, "ok": all(checks.values()),
    }
    return line, counts


def phase_cli(dev) -> dict:
    """``python -m sfm_tpu_torch --synthetic 8`` in a subprocess, with the
    default ``--pipeline host``, with ``--pipeline scan``, and with
    ``--pipeline scan --export-geometry both --debug-nans`` (plus
    ``--visuals`` where matplotlib imports; the renders are host work):
    exit code 0, the three artifacts and the ``=== Summary ===`` block, and
    for the third run the sparse-mesh PLY."""
    import re

    try:
        import matplotlib  # noqa: F401
        visuals = True
    except ImportError:
        visuals = False
    repo = Path(__file__).resolve().parent
    geom = ["--pipeline", "scan", "--export-geometry", "both",
            "--debug-nans"] + (["--visuals"] if visuals else [])
    runs = {}
    ok = True
    with tempfile.TemporaryDirectory(prefix="sfm_cli_") as tmp:
        for name, flags in (("host", ["--pipeline", "host"]),
                            ("scan", ["--pipeline", "scan"]),
                            ("scan_both_debug_nans", geom)):
            out = Path(tmp) / name
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "sfm_tpu_torch", "--synthetic", "8",
                 "--out", str(out), "--log", "warning", *flags],
                cwd=repo, capture_output=True, text=True, timeout=900)
            lines = res.stdout.splitlines()
            summary = (lines[lines.index("=== Summary ==="):]
                       if "=== Summary ===" in lines else [])
            pats = (r"=== Summary ===", r"Keyframes: \d+", r"Map points: \d+",
                    r"Edges: \d+", r"Wall time: \d+\.\d\ds \(\d+\.\d\d "
                    r"frames/s\)", r"Outputs: .+")
            files = ["keyframes_camera_centers.csv", "posegraph_edges.csv",
                     "templeRing_sparse_points.ply"]
            if name == "scan_both_debug_nans":
                files.append("templeRing_mesh_sparse_kf0.ply")
            checks = {
                "rc": res.returncode == 0,
                "artifacts": all((out / f).exists() for f in files),
                "summary": len(summary) == len(pats) and all(
                    re.fullmatch(p, ln) for p, ln in zip(pats, summary)),
            }
            ok &= all(checks.values())
            runs[name] = {"flags": flags, "rc": res.returncode,
                          "wall_s": time.perf_counter() - t0,
                          "summary": summary, "checks": checks,
                          "files": sorted(p.name for p in out.glob("*.*"))
                          if out.exists() else [],
                          "stderr_tail": res.stderr[-600:]
                          if res.returncode else ""}
    return {"phase": "cli", "frames": 8, "visuals": visuals, "runs": runs,
            "ok": ok}


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


def phase_multiscene(dev) -> tuple[dict, dict]:
    """bench.py's bench_multiscene layout on the card: scene 0 the ring of
    ``ring_spec()``, scenes 1-3 rings of the same spec with texture seeds
    8, 9 and 10; 47 frames each through
    ``parallel.multi_scan.run_scenes_scan`` at ``smoke_config()``, chunk
    16, loop closure verified on the host (the runner forces it, as the
    JAX package's does).  Launch counts are reset just before the run and
    read just after.  Then scene 0's ring alone through ``ScanSfM`` with
    the same configuration, host verification and chunk 16: scene 0 must
    have its keyframe frames and loop edges, and centers within 1e-5."""
    import dataclasses

    from sfm_tpu_torch.models.scan_pipeline import ScanSfM
    from sfm_tpu_torch.parallel.multi_scan import run_scenes_scan
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    cfg = smoke_config()
    with tempfile.TemporaryDirectory(prefix="sfm_ms_") as tmp:
        tmp = Path(tmp)
        dss = []
        for s in range(S_SCENES):
            spec = dataclasses.replace(ring_spec(), seed=ring_spec().seed + s)
            generate_dataset(tmp / f"scene{s}", spec, name_prefix="templeR")
            dss.append(TempleRing.from_dir(tmp / f"scene{s}"))
        images = [[d.load_gray(i) for i in range(FRAMES)] for d in dss]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_scenes_scan(dss, cfg, frames=FRAMES, chunk=16,
                              images=images, device=dev,
                              out_dirs=[tmp / f"out{s}"
                                        for s in range(S_SCENES)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_launches()
        views = res["views"]
        ratios = [ate_ratio(v.kfs, d) for v, d in zip(views, dss)]
        exported = all((tmp / f"out{s}" / "keyframes_camera_centers.csv")
                       .exists() for s in range(S_SCENES))

        cfg1 = dataclasses.replace(cfg, loop=dataclasses.replace(
            cfg.loop, device_verify=False))
        one = ScanSfM(dss[0].K, cfg1, n_frames=FRAMES, chunk=16,
                      p_cap=16384, p_ba=1024, device=dev)
        t1 = time.perf_counter()
        for i in range(FRAMES):
            one.process(i, dss[0].records[i].img, images[0][i])
        one.finalize()
        dt_one = time.perf_counter() - t1
    loops = [[(e.i, e.j) for e in le] for le in res["loop_edges"]]
    host_ver = sum(v.host_verifications for v in views)
    c_one = np.stack([kf.center for kf in one.kfs])
    same_kf = (list(res["kf_frames"][0])
               == [kf.frame_idx for kf in one.kfs])
    d_centers = (float(np.abs(res["centers"][0] - c_one).max())
                 if same_kf else float("inf"))
    checks = {
        "ate": all(r < 0.05 for r in ratios),
        "keyframes": all(int(k) >= 30 for k in res["n_keyframes"]),
        "map_points": all(int(k) > 2000 for k in res["n_points"]),
        "scene0_loop_edges": len(loops[0]) >= 1,
        # the tracker's two passes per frame for ALL scenes at once, plus
        # each host loop verification's LK pass: launches not times S
        "k3_launches": counts["lk_level_fused"]
        == (FRAMES - 1 + host_ver) * LEVELS * 2,
        "k1_launches": counts["shi_tomasi_score"] >= 1,
        "exported": exported,
        "finite": all(bool(np.isfinite(c).all()) for c in res["centers"]),
        "scene0_keyframes_match": same_kf,
        "scene0_loop_edges_match": loops[0] == [(e.i, e.j)
                                                for e in one.loop_edges],
        "scene0_centers_match": d_centers <= 1e-5,
    }
    line = {
        "phase": "multiscene", "scenes": S_SCENES, "frames": FRAMES,
        "wall_s": dt, "scene_frames_per_sec": S_SCENES * FRAMES / dt,
        "keyframes": [int(k) for k in res["n_keyframes"]],
        "map_points": [int(k) for k in res["n_points"]],
        "loop_edges": loops, "ate_ratio": ratios,
        "host_verifications": [v.host_verifications for v in views],
        "timers": res["timers"], "launches": counts,
        "single_scene0": {
            "wall_s": dt_one, "keyframes": len(one.kfs),
            "map_points": len(one.map_xyz),
            "centers_max_abs_diff": d_centers,
            "centers_bit_equal": same_kf and bool(
                np.array_equal(res["centers"][0], c_one)),
            "map_bit_equal": bool(np.array_equal(views[0].map_xyz,
                                                 one.map_xyz))},
        "checks": checks, "ok": all(checks.values()),
    }
    return line, counts


# ---------------------------------------------------------------------------
# phase: mesh (dense stereo on the card, sparse Delaunay on the host)
# ---------------------------------------------------------------------------

STEREO_STEP_DEG = 3.0  # angle between the two cameras of the stereo pair


def disparity_shares(disp_a, ok_a, disp_b, ok_b) -> dict:
    """The bars two disparity maps are held to: lr_ok equal on >= 99 % of
    the pixels, the integer disparity equal (the same rounding, or the
    same value to 1e-3 px) on >= 99 % of the pixels both keep,
    |delta disp| <= 0.05 px at the 99th percentile."""
    both = ok_a & ok_b
    same = (np.rint(disp_a) == np.rint(disp_b)) | (
        np.abs(disp_a - disp_b) <= 1e-3)
    out = {"lr_ok_equal": float((ok_a == ok_b).mean()),
           "int_equal": float(same[both].mean()),
           "p99_abs_diff_px": float(np.percentile(
               np.abs(disp_a - disp_b)[both], 99))}
    out["ok"] = (out["lr_ok_equal"] >= 0.99 and out["int_equal"] >= 0.99
                 and out["p99_abs_diff_px"] <= 0.05)
    return out


def phase_mesh(dev, sparse_inputs) -> dict:
    """The dense stereo mesh at full width on the card: two 640x480 frames
    of the ring's camera circle (fx 1520, the ring's texture)
    ``STEREO_STEP_DEG`` apart, GT poses, ``export_stereo_grid_mesh`` at
    the ``StereoMeshConfig`` defaults; vertices held to the cylinder
    (median |r - 0.10| < 0.02, >= 50 % within 0.02).  The nearest and
    farthest visible cylinder depths give the expected disparity range,
    which must lie inside the 128 disparities.  ``_disparity_sad`` alone on
    the rectified pair: device ms (CUDA events), kernel launches of one
    call (torch.profiler), peak memory, and the same call on the CPU held
    to ``disparity_shares``.  Then the sparse mesh of the pipeline phase's
    map in its keyframe 0 at the ``SparseMeshConfig`` defaults."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from sfm_tpu_torch.config import SparseMeshConfig, StereoMeshConfig
    from sfm_tpu_torch.models import mesh
    from sfm_tpu_torch.models.mapstate import Keyframe
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    cfg = StereoMeshConfig()
    # frame i of an n-frame spec sits at arc_deg * i / n
    spec = dataclasses.replace(ring_spec(), n_frames=2,
                               arc_deg=2 * STEREO_STEP_DEG)
    with tempfile.TemporaryDirectory(prefix="sfm_mesh_") as tmp:
        generate_dataset(Path(tmp), spec, name_prefix="templeR")
        ds = TempleRing.from_dir(Path(tmp))
        g0, g1 = ds.load_gray(0), ds.load_gray(1)
    kfs = [Keyframe(kf_id=i, frame_idx=i, img_name=r.img, R_cw=r.pose_cw[0],
                    t_cw=r.pose_cw[1], ids=np.zeros(1, np.int32),
                    uv=np.zeros((1, 2)), valid=np.zeros(1, bool))
           for i, r in enumerate(ds.records)]
    baseline = float(np.linalg.norm(kfs[0].center - kfs[1].center))
    z_near = spec.ring_radius - spec.cylinder_radius
    z_far = float(np.sqrt(spec.ring_radius ** 2 - spec.cylinder_radius ** 2))
    d_expect = [spec.fx * baseline / z_far, spec.fx * baseline / z_near]

    def export():
        return mesh.export_stereo_grid_mesh(ds.K, kfs[0], kfs[1], g0, g1,
                                            cfg, device=dev)

    export()  # warm-up: first calls of every op at these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    verts, faces = export()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_export = torch.cuda.max_memory_allocated(dev)
    rad_err = np.abs(np.hypot(verts[:, 0], verts[:, 1])
                     - spec.cylinder_radius)

    # _disparity_sad alone, on the pair export() rectified
    rect1, rect2, _, _ = mesh.rectified_pair(ds.K, kfs[0], kfs[1], g0, g1,
                                             dev)
    num_disp = int(np.ceil(cfg.num_disparities / 16.0) * 16)
    block_r = max(int(cfg.block_size) // 2, 1)

    def sad(a, b):
        return mesh._disparity_sad(a, b, num_disp, block_r, sgm=cfg.sgm)

    ms = time_ms(lambda: sad(rect1, rect2), n=5, warm=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    disp, ok = sad(rect1, rect2)
    torch.cuda.synchronize()
    peak_sad = torch.cuda.max_memory_allocated(dev) - base_mem
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sad(rect1, rect2)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == cuda)
    t1 = time.perf_counter()
    disp_cpu, ok_cpu = sad(rect1.cpu(), rect2.cpu())
    cpu_s = time.perf_counter() - t1
    disp, ok = disp.cpu().numpy(), ok.cpu().numpy()
    shares = disparity_shares(disp, ok, disp_cpu.numpy(), ok_cpu.numpy())
    kept = disp[ok & (disp >= cfg.disp_min)]

    K_s, kf0, map_xyz = sparse_inputs
    scfg = SparseMeshConfig()
    sv, sf = mesh.build_sparse_mesh(
        K_s, kf0, map_xyz, max_points=scfg.max_points, grid_px=scfg.grid_px,
        max_edge_px=scfg.max_edge_px)

    checks = {
        "disparities_inside": d_expect[1] < num_disp,
        "stereo_faces": len(faces) > 200 and len(verts) > 300
        and int(faces.max()) < len(verts),
        "finite": bool(np.isfinite(verts).all() and np.isfinite(disp).all()),
        "cylinder_median": float(np.median(rad_err)) < 0.02,
        "cylinder_within": float(np.mean(rad_err < 0.02)) >= 0.5,
        "card_vs_cpu": shares["ok"],
        "sparse_faces": len(sf) > 0 and int(sf.max()) < len(sv)
        and int(sf.min()) >= 0,
    }
    return {
        "phase": "mesh", "size": [spec.height, spec.width], "fx": spec.fx,
        "step_deg": STEREO_STEP_DEG, "baseline": baseline,
        "num_disp": num_disp, "block": 2 * block_r + 1, "sgm": cfg.sgm,
        "disparity_expected_px": d_expect,
        "disparity_kept_px_p1_p50_p99": [
            float(v) for v in np.percentile(kept, [1, 50, 99])]
        if kept.size else [],
        "vertices": int(len(verts)), "faces": int(len(faces)),
        "median_radius_err": float(np.median(rad_err)),
        "within_0.02": float(np.mean(rad_err < 0.02)),
        "export_wall_s": wall_s, "export_peak_bytes": int(peak_export),
        "disparity_ms": ms, "disparity_launches": int(launches),
        "disparity_peak_bytes": int(peak_sad),
        "disparity_cpu_s": cpu_s, "card_vs_cpu": shares,
        "sparse": {"kf": 0, "map_points": int(len(map_xyz)),
                   "vertices": int(len(sv)), "faces": int(len(sf))},
        "checks": checks, "ok": all(checks.values()),
    }


# ---------------------------------------------------------------------------
# phase: multichip (the parallel runners, one NCCL rank per card)
# ---------------------------------------------------------------------------

MC_FRAMES = 16       # frames of each ring: cut in depth, full width
MC_SCENES_PER_RANK = 2
MC_STEP_TRACKS = T_TRACKS
MC_HYPOTHESES = 1024
# the scene step's LO-RANSAC rotations against the rendered ones (max abs
# entry; ~0.3 degrees)
MC_ROT_TOL = 5e-3
# find_E_sharded keeps the best raw 8-point hypothesis (no local
# optimisation): it has recovered the rendered pose when it explains the
# pair nearly as the rendered pose's E does, its truncated Sampson cost
# within MC_E_COST_RATIO of that E's and its inliers at least
# MC_E_INLIER_SHARE of that E's
MC_E_COST_RATIO = 3.0
MC_E_INLIER_SHARE = 0.9


def mc_ring_datasets(root: Path, n_scenes: int):
    """The phase's rings under ``root``: the first ``MC_FRAMES`` cameras of
    the ring (texture seed 7) and more rings of the same spec with texture
    seeds 8, 9, ..., as the multiscene phase lays them out."""
    import dataclasses

    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import generate_dataset

    dss = []
    for s in range(n_scenes):
        spec = dataclasses.replace(short_ring_spec(MC_FRAMES),
                                   seed=ring_spec().seed + s)
        if not (root / f"scene{s}").exists():
            generate_dataset(root / f"scene{s}", spec, name_prefix="templeR")
        dss.append(TempleRing.from_dir(root / f"scene{s}"))
    return dss


def _rel_pose(ds, i: int, j: int):
    """The relative pose i -> j of a ring's GT cameras (x_j = R x_i + t)."""
    a, b = ds.records[i], ds.records[j]  # R, t: world -> camera
    R = b.R @ a.R.T
    return R, b.t - R @ a.t


def multichip_rank(root: str, frames: int, device: str) -> dict:
    """One rank of the multichip phase (``distributed.launch`` started it
    and joined it to the group): collectives, ``make_scene_step`` at full
    width, ``find_E_sharded`` over every rank, ``batch_runner.run_scenes``
    and ``run_scenes_scan(mesh=...)`` on 2 rings a rank, rank 0 also the
    same ``run_scenes_scan`` without a mesh, which must match it."""
    import torch.distributed as dist

    from sfm_tpu_torch.models import tracker
    from sfm_tpu_torch.ops import ba, epipolar, image as im, lie
    from sfm_tpu_torch.parallel import (batch_runner, mesh as mesh_lib,
                                        multiscene)
    from sfm_tpu_torch.parallel.multi_scan import run_scenes_scan, scene_seed

    world, rank = dist.get_world_size(), dist.get_rank()
    n_scenes = MC_SCENES_PER_RANK * world
    dss = mc_ring_datasets(Path(root), n_scenes)
    cfg = smoke_config()
    kcfg = cfg.klt
    sec, checks = {}, {}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    # 1. collectives: the sum of scene coordinates over the scene group
    t0 = time.perf_counter()
    m = mesh_lib.make_mesh(world, device=device)
    dev = mesh_lib.rank_device(m, device)
    idx = torch.tensor(m.get_local_rank("scene"), device=dev)
    dist.all_reduce(idx, group=m.get_group("scene"))
    n = m.size(0)
    checks["collectives"] = int(idx) == n * (n - 1) // 2
    sec["collectives"] = time.perf_counter() - t0

    # 2. make_scene_step at full width on this rank's two scenes: scene s
    # is frames (s, s + 1) of ring 0, tracks from a K1 bootstrap
    t0 = time.perf_counter()
    K = torch.as_tensor(dss[0].K, dtype=torch.float32, device=dev)
    scenes = list(mesh_lib.local_scenes(m, n_scenes))

    def pyr(frames_):
        """The stacked pyramids of ring 0's frames ``frames_``."""
        levels = [im.build_pyramid(torch.as_tensor(
            np.array(dss[0].load_gray(f)), dtype=torch.float32, device=dev),
            kcfg.pyr_levels) for f in frames_]
        return tuple(torch.stack(lv).contiguous() for lv in zip(*levels))

    pyr0, pyr1 = pyr(scenes), pyr([s + 1 for s in scenes])
    states = tracker.bootstrap_scenes(pyr0[0], kcfg)
    state = tracker.TrackerState(*(torch.stack(f) for f in zip(*states)))
    n_boot = torch.sum(state.valid)
    dist.all_reduce(n_boot, group=m.get_group("scene"))
    S_loc, P_, M_ = len(scenes), 16, 64
    g = np.random.default_rng(0)
    t_wc = torch.zeros((S_loc, 2, 3), device=dev)
    t_wc[:, 1, 0] = 0.5
    prob = ba.BAProblem(
        R_wc=torch.eye(3, device=dev).repeat(S_loc, 2, 1, 1), t_wc=t_wc,
        X=torch.as_tensor(g.standard_normal((S_loc, P_, 3)) * 0.3
                          + [0, 0, 4.0], dtype=torch.float32, device=dev),
        cam_idx=(torch.arange(M_, device=dev) % 2).int().repeat(S_loc, 1),
        pid_idx=(torch.arange(M_, device=dev) % P_).int().repeat(S_loc, 1),
        obs=torch.zeros((S_loc, M_, 2), device=dev),
        obs_valid=torch.ones((S_loc, M_), dtype=torch.bool, device=dev),
        point_valid=torch.ones((S_loc, P_), dtype=torch.bool, device=dev))
    gens = []
    for s in scenes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(scene_seed(cfg.ransac.seed, s))
        gens.append(gen)
    step = multiscene.make_scene_step(m, kcfg, num_hypotheses=MC_HYPOTHESES,
                                      ba_iters=2)
    with torch.no_grad():
        new_state, rp, ba_out, metrics = step(gens, K, pyr0, pyr1, state,
                                              prob)
    sync()
    sec["scene_step"] = time.perf_counter() - t0
    rot_err = [float(np.abs(rp.R[k].cpu().numpy()
                            - _rel_pose(dss[0], s, s + 1)[0]).max())
               for k, s in enumerate(scenes)]
    checks["scene_step"] = (
        tuple(new_state.pos.shape) == (S_loc, kcfg.max_tracks, 2)
        and bool(rp.ok.all()) and max(rot_err) < MC_ROT_TOL
        and int(metrics["tracks_alive"]) > int(n_boot) // 4
        and bool(torch.isfinite(ba_out[2]).all()))

    # 3. find_E_sharded: MC_HYPOTHESES over every rank (hyp = world) on
    # the tracks of frames 0 -> 1 (every rank tracks the same pair)
    t0 = time.perf_counter()
    mh = mesh_lib.make_mesh(world, hyp_axis=world, device=device)
    p0, p1 = pyr([0]), pyr([1])
    trk = tracker.bootstrap_scenes(p0[0], kcfg)[0]
    with torch.no_grad():
        new, ok = multiscene.batched_lk(
            p0, p1, trk.pos[None], trk.valid[None], kcfg.pyr_levels,
            kcfg.iters, kcfg.win_radius, kcfg.fb_thresh, device=dev)
        matched = trk.valid & ok[0]
        E, cost = multiscene.find_E_sharded(
            cfg.ransac.seed, epipolar.normalize_by_K(K, trk.pos),
            epipolar.normalize_by_K(K, new[0]), matched, mh,
            num_hypotheses_total=MC_HYPOTHESES,
            sampson_thresh=cfg.ransac.sampson_thresh)
    sync()
    sec["find_E_sharded"] = time.perf_counter() - t0
    R01, t01 = _rel_pose(dss[0], 0, 1)
    E_gt = lie.hat(torch.as_tensor(t01)).numpy() @ R01
    xi0 = epipolar.normalize_by_K(K, trk.pos)
    xj0 = epipolar.normalize_by_K(K, new[0])
    thr = torch.tensor(cfg.ransac.sampson_thresh, device=dev)
    fit = []  # (truncated cost, inliers) of the found E, then of E_gt
    for E_ in (E, torch.as_tensor(E_gt, dtype=torch.float32, device=dev)):
        err = epipolar.sampson_error(E_[None], xi0[None], xj0[None])[0]
        fit.append((float(torch.where(matched, torch.minimum(err, thr),
                                      torch.zeros_like(err)).sum()),
                    int(((err < thr) & matched).sum())))
    E_n = E.cpu().numpy() / np.linalg.norm(E.cpu().numpy())
    E_g = E_gt / np.linalg.norm(E_gt)
    e_err = float(min(np.abs(E_n - E_g).max(), np.abs(E_n + E_g).max()))
    checks["find_E_sharded"] = (
        abs(float(cost) - fit[0][0]) <= 1e-3 * fit[0][0]
        and fit[0][0] <= MC_E_COST_RATIO * fit[1][0]
        and fit[0][1] >= MC_E_INLIER_SHARE * fit[1][1])

    # 4. the lockstep batch runner on every ring
    t0 = time.perf_counter()
    rs = batch_runner.run_scenes(dss, m, kcfg=kcfg, rcfg=cfg.ransac,
                                 frames=frames, seed=cfg.ransac.seed,
                                 device=device)
    sync()
    sec["run_scenes"] = time.perf_counter() - t0
    ate_rs = [centers_ate_ratio(rs["centers"][s], range(frames), ds)
              for s, ds in enumerate(dss)]
    checks["run_scenes_ate"] = all(a < 0.2 for a in ate_rs)

    # 5. run_scenes_scan sharded over the scene axis; rank 0 then runs the
    # same call without a mesh, which must give the same bits
    kw = dict(frames=frames, chunk=16, device=device)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        res = run_scenes_scan(dss, cfg, mesh=m, **kw)
    sync()
    sec["run_scenes_scan"] = time.perf_counter() - t0
    counts = read_launches()
    host_ver = sum(v.host_verifications for v in res["views"] if v)
    ate_scan = [centers_ate_ratio(res["centers"][s], res["kf_frames"][s],
                                  dss[s]) for s in range(n_scenes)]
    checks["run_scenes_scan_ate"] = all(a < 0.05 for a in ate_scan)
    checks["run_scenes_scan_keyframes"] = all(
        int(k) >= 8 for k in res["n_keyframes"])
    checks["k3_launches"] = counts["lk_level_fused"] == (
        (frames - 1) + host_ver) * LEVELS * 2
    checks["k1_launches"] = counts["shi_tomasi_score"] >= 1
    out = {"rank": rank, "backend": dist.get_backend(),
           "mesh": dict(zip(m.mesh_dim_names, m.shape)),
           "scenes": scenes, "launches": counts,
           "host_verifications": host_ver,
           "rot_err_scene_step": rot_err,
           "tracks": int(n_boot),
           "tracks_alive": int(metrics["tracks_alive"]),
           "inliers": int(metrics["inliers"]),
           "E_err": e_err, "E_cost": float(cost),
           "E_fit_vs_rendered": fit,
           "ate_run_scenes": ate_rs, "ate": ate_scan,
           "keyframes": [int(k) for k in res["n_keyframes"]],
           "map_points": [int(k) for k in res["n_points"]],
           "loop_edges": [[(e.i, e.j) for e in le]
                          for le in res["loop_edges"]]}
    if rank == 0:
        t0 = time.perf_counter()
        with torch.no_grad():
            one = run_scenes_scan(dss, cfg, **kw)
        sync()
        sec["run_scenes_scan_unsharded"] = time.perf_counter() - t0
        same = {
            "keyframes": all(np.array_equal(a, b) for a, b in
                             zip(res["kf_frames"], one["kf_frames"])),
            "centers": all(np.array_equal(a, b) for a, b in
                           zip(res["centers"], one["centers"])),
            "map_points": np.array_equal(res["n_points"], one["n_points"]),
            "loop_edges": out["loop_edges"] == [
                [(e.i, e.j) for e in le] for le in one["loop_edges"]],
            "metrics": np.array_equal(res["metrics"], one["metrics"])}
        out["bit_equal_unsharded"] = same
        checks["sharded_equals_unsharded"] = all(same.values())
    out["seconds"] = sec
    out["checks"] = checks
    return out


def phase_multichip(dev) -> tuple[dict, dict]:
    """The parallel runners on one NCCL rank per card
    (``world = torch.cuda.device_count()``, the ``spawn`` start method;
    the ranks load the kernels the build phase compiled): see
    ``multichip_rank``.  Then ``dryrun.dryrun_multichip(world)`` from this
    process (it starts its own ranks, one per card).  Returns the line
    and rank 0's launch counts of its sharded ``run_scenes_scan``."""
    from sfm_tpu_torch.parallel import distributed, dryrun

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="sfm_mc_") as tmp:
        t0 = time.perf_counter()
        mc_ring_datasets(Path(tmp), MC_SCENES_PER_RANK * world)
        render_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = distributed.launch(multichip_rank, world,
                                  args=(tmp, MC_FRAMES, "cuda"),
                                  device="cuda", timeout_s=600.0)
        job_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(world, device="cuda")
    dry_s = time.perf_counter() - t0
    r0 = outs[0]
    checks = {f"rank{o['rank']}.{k}": v for o in outs
              for k, v in o["checks"].items()}
    checks["backend_nccl"] = all(o["backend"] == "nccl" for o in outs)
    checks["dryrun"] = dry["backend"] == "nccl"
    line = {
        "phase": "multichip", "world": world, "backend": r0["backend"],
        "mesh": r0["mesh"], "frames": MC_FRAMES,
        "scenes": MC_SCENES_PER_RANK * world,
        "wall_s": {"render": render_s, "ranks": job_s, "dryrun": dry_s,
                   **{f"rank0.{k}": v for k, v in r0["seconds"].items()}},
        "ate_run_scenes": r0["ate_run_scenes"], "ate_ratio": r0["ate"],
        "keyframes": r0["keyframes"], "map_points": r0["map_points"],
        "loop_edges": r0["loop_edges"],
        "scene_step": {"tracks": r0["tracks"],
                       "tracks_alive": r0["tracks_alive"],
                       "inliers": r0["inliers"],
                       "rot_err": r0["rot_err_scene_step"]},
        "find_E_sharded": {"E_err": r0["E_err"], "cost": r0["E_cost"],
                           "cost_inliers_found_rendered":
                           r0["E_fit_vs_rendered"]},
        "bit_equal_unsharded": r0["bit_equal_unsharded"],
        "launches_rank0": r0["launches"],
        "host_verifications_rank0": r0["host_verifications"],
        "expect_k3_rank0": (MC_FRAMES - 1 + r0["host_verifications"])
        * LEVELS * 2,
        "dryrun": dry, "checks": checks, "ok": all(checks.values()),
    }
    return line, r0["launches"]


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
    tex = _make_texture(spec)
    frame0 = render_frame(spec, K, Rs[0], ts[0], tex)
    scene_pairs = [tuple(render_frame(spec, K, Rs[i], ts[i], tex)
                         for i in (f, f + 1)) for f in SCENE_FRAMES]
    rows = phase_kernels(dev, frame0, scene_pairs)
    emit({"phase": "kernels", "kernels": rows})
    if not all(r["ok"] for r in rows):
        print("chip_smoke: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    if args.only == "kernels":
        return 0

    with torch.no_grad():
        line, counts, sparse_inputs = phase_pipeline(dev)
    emit(line)
    if not line["ok"]:
        print("chip_smoke: the pipeline phase failed", file=sys.stderr)
        return 1
    ate_f32 = line["ate_ratio"]
    with torch.no_grad():
        line, bf16_counts = phase_bf16(dev, ate_f32)
    emit(line)
    if not line["ok"]:
        print("chip_smoke: the bf16 phase failed", file=sys.stderr)
        return 1
    with torch.no_grad():
        line, arm_counts = phase_arms(dev)
    emit(line)
    if not line["ok"]:
        print("chip_smoke: the arms phase failed", file=sys.stderr)
        return 1
    by_path = {"pipeline": counts, "bf16": bf16_counts, "arms": arm_counts,
               "arms_scenes": line["scenes_run"]["launches"]}
    for name, phase in (("host", phase_host), ("cli", phase_cli),
                        ("orb", phase_orb), ("orb_host", phase_orb_host),
                        ("multiscene", phase_multiscene)):
        with torch.no_grad():
            out = phase(dev)
        line, path_counts = out if isinstance(out, tuple) else (out, None)
        emit(line)
        if not line["ok"]:
            print(f"chip_smoke: the {name} phase failed", file=sys.stderr)
            return 1
        if path_counts is not None:
            by_path[name] = path_counts
    with torch.no_grad():
        line = phase_mesh(dev, sparse_inputs)
    emit(line)
    if not line["ok"]:
        print("chip_smoke: the mesh phase failed", file=sys.stderr)
        return 1
    line, by_path["multichip"] = phase_multichip(dev)
    emit(line)
    if not line["ok"]:
        print("chip_smoke: the multichip phase failed", file=sys.stderr)
        return 1
    if args.profile:
        with torch.no_grad():
            emit(phase_profile(dev))
            emit(phase_profile_scenes(dev))
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
             "launches_by_path", "scenes", "bf16")
    emit({"kernels": [{k: r[k] for k in keys + extra if k in r}
                      for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
