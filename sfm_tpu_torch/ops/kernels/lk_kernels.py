"""K2/K3/K4/K5 — LK window gathers and LK levels: CUDA wrappers + plain versions.

Counterpart of sfm_tpu/ops/pallas/block_gather_kernel.py
(``load_blocks_pair_pallas``, ``load_blocks_pallas``) and
sfm_tpu/ops/pallas/lk_iter_kernel.py (``lk_iter_tmpl_pallas``,
``lk_iter_pallas``); CUDA sources: csrc/lk_gather_pair.cu (K2 and its
one-image mode K5), csrc/lk_level_fused.cu (K3), csrc/lk_level_tmpl.cu (K4);
shared window addressing in csrc/lk_common.cuh, the shared iteration loop of
K3 and K4 in csrc/lk_iterate.cuh.

The plain versions are the port of the XLA ``fori_loop`` path of
sfm_tpu/ops/klt._lk_level: ``_load_blocks`` (here a direct window gather
by index), ``_qf``, ``_bil_t`` and the loop body (``_lk_iterate_plain``,
shared by the plain versions of K3 and K4).  A wrapper launches its kernel
for CUDA tensors (or raises) and takes the plain version only for CPU
tensors; under the numeric checks (``utils.debug``) it checks what its
kernel wrote for NaN/Inf.

Storage (SFM_TPU_LK_BF16, read by ops/klt.lk_dtype): images and windows
are float32 or bfloat16; positions, flows, templates and every sum are
float32.  Each wrapper takes either storage type (both images of one) and
launches the kernel instantiated for it, and raises ``TypeError`` for any
other (float16, float64).  The gathers copy bfloat16 windows as they are;
the plain versions upcast at the four bilinear reads (``_bil_t``), as the
JAX twin does, and the kernels as they stage a window, so on bfloat16
images every function gives the bits of its float32 run on the images
rounded to bfloat16.

Layout: tracks lead — blocks are (T, WIN, WIN), patches (T, P, P).  (The
JAX twin keeps tracks on the last axis for the TPU's lanes.)

Scene axis: K3 (``lk_level_fused``, and its plain version), K5
(``lk_gather``) and K4 (``lk_level_tmpl``) also take a stack of scenes,
images (S,H,W) with positions and flows (S,T,2) (K4: windows and templates
(S,T,...)), the axis the JAX twin gets under ``jax.vmap``
(sfm_tpu/parallel/multi_scan.py).  Each kernel serves the whole stack in
one launch; K3's plain version runs scene by scene, the other plain
versions take the stack at once (every track's arithmetic is its own).
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops.kernels import build
from sfm_tpu_torch.utils import debug

MARGIN = 6  # per-level search margin in px beyond the patch

gather_launches = 0  # launches of the K2 pair gather kernel (plain int)
level_launches = 0   # launches of the K3 fused level kernel (plain int)
gather1_launches = 0  # launches of the K5 one-image gather kernel
tmpl_launches = 0    # launches of the K4 template-passed-in level kernel
bf16_launches = 0    # of those four, the launches on bfloat16 storage

STORAGE = (torch.float32, torch.bfloat16)  # dtypes of images and windows


def _storage_flag(name: str, *imgs) -> int:
    """The C entry points' storage argument for images (or windows) of one
    storage dtype: 0 float32, 1 bfloat16; TypeError for anything else."""
    dt = imgs[0].dtype
    if dt not in STORAGE or any(x.dtype != dt for x in imgs):
        raise TypeError(f"{name} takes float32 or bfloat16 images of one "
                        f"dtype, got {', '.join(str(x.dtype) for x in imgs)}")
    return int(dt == torch.bfloat16)


def _count(bf16: int) -> None:
    global bf16_launches
    bf16_launches += bf16


# ---------------------------------------------------------------------------
# window addressing (shared by the plain versions and the wrappers)
# ---------------------------------------------------------------------------


def window_start(origins, back: int, H: int, W: int, win: int):
    """Float top-left start of the ``win`` window around float patch
    ``origins`` (T,2): floor(nan_to_num(o)) - back, clipped to the image.

    Dead/lost slots can carry non-finite positions; NaN survives a clip and
    casts to an undefined integer, so sanitize before anything is cast."""
    start = torch.floor(torch.nan_to_num(origins)) - float(back)
    hi = torch.tensor([W - win, H - win], dtype=origins.dtype,
                      device=origins.device)
    return torch.minimum(torch.clamp(start, min=0.0), hi)


def _clamp_starts(starts, H: int, W: int, win: int):
    sx = torch.clamp(starts[..., 0], 0, max(W - win, 0))
    sy = torch.clamp(starts[..., 1], 0, max(H - win, 0))
    return sx.to(torch.int64), sy.to(torch.int64)


def _gather_windows(img, starts, win: int):
    """(T,win,win) windows of ``img`` at integer ``starts`` (T,2) = (x,y),
    clamped to the image: plain slicing, as one advanced-index gather.  A
    stack of images (S,H,W) with starts (S,T,2) gives (S,T,win,win), each
    scene's windows of its own image."""
    H, W = img.shape[-2:]
    sx, sy = _clamp_starts(starts, H, W, win)
    ar = torch.arange(win, device=img.device)
    rows = (sy[..., None] + ar)[..., :, None]
    cols = (sx[..., None] + ar)[..., None, :]
    if img.dim() == 3:
        scene = torch.arange(img.shape[0], device=img.device)
        return img[scene.view(-1, 1, 1, 1), rows, cols]
    return img[rows, cols]


# ---------------------------------------------------------------------------
# K2: pair gather
# ---------------------------------------------------------------------------


def lk_gather_pair_plain(img0, starts0, win0: int, img1, starts1, win1: int):
    """Template windows (T,win0,win0) of img0 and search windows
    (T,win1,win1) of img1 at integer starts (T,2), clamped to the image."""
    return (_gather_windows(img0, starts0, win0),
            _gather_windows(img1, starts1, win1))


def _check_image_pair(img0, img1, win: int, name: str, dims=(2,)) -> int:
    """Checks two images for a kernel; returns ``_storage_flag``."""
    bf16 = _storage_flag(name, img0, img1)
    for im_ in (img0, img1):
        if im_.dim() not in dims:
            raise TypeError(f"{name} takes images of "
                            f"{' or '.join(map(str, dims))} dimensions, got "
                            f"{tuple(im_.shape)}")
        if not im_.is_contiguous():
            raise ValueError(f"{name} needs contiguous images")
    if img0.shape != img1.shape or img0.device != img1.device:
        raise ValueError(f"{name} needs two images of one shape on one "
                         f"device, got {tuple(img0.shape)} on {img0.device} "
                         f"and {tuple(img1.shape)} on {img1.device}")
    H, W = img1.shape[-2:]
    if H < win or W < win:
        raise ValueError(f"{name}: image {H}x{W} smaller than the "
                         f"{win}-px window")
    return bf16


def _lk_gather_pair_cuda(img0, starts0, win0, img1, starts1, win1):
    global gather_launches
    bf16 = _check_image_pair(img0, img1, max(win0, win1), "lk_gather_pair")
    T = starts0.shape[0]
    for s in (starts0, starts1):
        if (s.dtype != torch.int32 or s.shape != (T, 2)
                or s.device != img0.device or not s.is_contiguous()):
            raise TypeError("lk_gather_pair takes contiguous int32 starts "
                            "(T,2) on the images' device")
    lib = build.load()
    H, W = img0.shape
    out0 = torch.empty((T, win0, win0), dtype=img0.dtype, device=img0.device)
    out1 = torch.empty((T, win1, win1), dtype=img0.dtype, device=img0.device)
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_lk_gather_pair(
            img0.data_ptr(), img1.data_ptr(), H, W, starts0.data_ptr(),
            starts1.data_ptr(), T, int(win0), int(win1), out0.data_ptr(),
            out1.data_ptr(), bf16, stream)
    build.check_launch(code, "lk_gather_pair")
    gather_launches += 1
    _count(bf16)
    return debug.check_finite((out0, out1), "lk_gather_pair")


def lk_gather_pair(img0, starts0, win0: int, img1, starts1, win1: int):
    """K2. CUDA tensors -> kernel, CPU tensors -> plain slicing."""
    if img0.is_cuda:
        return _lk_gather_pair_cuda(img0, starts0, win0, img1, starts1, win1)
    return lk_gather_pair_plain(img0, starts0, win0, img1, starts1, win1)


# ---------------------------------------------------------------------------
# K5: one-image gather (the one-image mode of K2)
# ---------------------------------------------------------------------------


def lk_gather_plain(img, starts, win: int):
    """(T,win,win) windows of ``img`` at integer starts (T,2) = (x,y),
    clamped to the image; (S,T,win,win) for images (S,H,W) and starts
    (S,T,2)."""
    return _gather_windows(img, starts, win)


def _lk_gather_cuda(img, starts, win):
    global gather1_launches
    bf16 = _storage_flag("lk_gather", img)
    if img.dim() not in (2, 3) or not img.is_contiguous():
        raise TypeError(f"lk_gather takes one contiguous (H,W) image or an "
                        f"(S,H,W) stack, got {tuple(img.shape)}")
    H, W = img.shape[-2:]
    if H < win or W < win:
        raise ValueError(f"lk_gather: image {H}x{W} smaller than the "
                         f"{win}-px window")
    lead = tuple(img.shape[:-2])
    T = starts.shape[-2]
    if (starts.dtype != torch.int32 or starts.shape != (*lead, T, 2)
            or starts.device != img.device or not starts.is_contiguous()):
        raise TypeError("lk_gather takes contiguous int32 starts (T,2), or "
                        "(S,T,2) for images (S,H,W), on the image's device")
    S = img.shape[0] if lead else 1
    lib = build.load()
    out = torch.empty((*lead, T, win, win), dtype=img.dtype,
                      device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_lk_gather(img.data_ptr(), H, W, starts.data_ptr(),
                                 S * T, T, int(win), out.data_ptr(), bf16,
                                 stream)
    build.check_launch(code, "lk_gather")
    gather1_launches += 1
    _count(bf16)
    return debug.check_finite(out, "lk_gather")


def lk_gather(img, starts, win: int):
    """K5, for one image or an (S,H,W) stack with (S,T,2) starts (one
    launch). CUDA tensors -> kernel, CPU tensors -> plain slicing."""
    if img.is_cuda:
        return _lk_gather_cuda(img, starts, win)
    return lk_gather_plain(img, starts, win)


# ---------------------------------------------------------------------------
# K3: fused LK level
# ---------------------------------------------------------------------------


def _load_blocks(img, origins, P: int, margin: int, gather=_gather_windows):
    """One contiguous square block per track around each float patch
    origin. Returns (blocks (T,WIN,WIN), anchors (T,2) float top-left)."""
    WIN = P + 2 * margin + 3  # +1 bilinear, +2 gradient shifts
    H, W = img.shape[-2:]
    if H < WIN or W < WIN:
        raise ValueError(f"image {H}x{W} smaller than the {WIN}-px LK block")
    start = window_start(origins, margin + 1, H, W, WIN)
    return gather(img, start.to(torch.int32), WIN), start


def _qf(origins, anchors, P: int, WINx: int, WINy: int):
    """Integer sub-window origin (clipped per axis) + fractional rest.

    The fraction is NOT clamped: where the clip bites it extrapolates.  A
    NaN position keeps a NaN fraction (its flow comes out NaN) and gets
    origin 0 so that the gather below stays in range."""
    q = origins - anchors
    hi = torch.tensor([WINx - P - 2.0, WINy - P - 2.0], dtype=q.dtype,
                      device=q.device)
    qi = torch.minimum(torch.clamp(torch.floor(q), min=1.0), hi)
    qii = torch.nan_to_num(qi, nan=1.0).to(torch.int64) - 1
    return qii, q - qi


def _sub_windows(B, qii, S: int):
    """sub[t,i,j] = B[t, qii_y+i, qii_x+j] for i,j < S (per-track
    dynamic slice; selects what the JAX twin's barrel shifter selects).
    Leading axes (scenes, tracks) are any shape ``qii`` has before its
    last."""
    *lead, WINy, WINx = B.shape
    ar = torch.arange(S, device=B.device)
    q = qii.reshape(-1, 2)
    rows = (q[:, 1, None] + ar)[:, :, None]
    cols = (q[:, 0, None] + ar)[:, None, :]
    lin = (rows * WINx + cols).reshape(-1, S * S)
    return B.reshape(-1, WINy * WINx).gather(1, lin).reshape(*lead, S, S)


def _bil_t(block, fx, fy, P: int, ox: int, oy: int):
    """(T,P,P) bilinear patch from (T,S,S) sub-blocks at static pixel
    offset (ox,oy) in {-1,0,1} and per-track fractions fx/fy (any leading
    axes).  bfloat16 blocks upcast to the fractions' dtype HERE, at the
    four shifted reads, as the JAX twin's ``_bil_t`` does: the blend and
    every sum downstream run in float32."""
    y0 = 1 + oy
    x0 = 1 + ox
    w00 = block[..., y0: y0 + P, x0: x0 + P].to(fx.dtype)
    w01 = block[..., y0: y0 + P, x0 + 1: x0 + P + 1].to(fx.dtype)
    w10 = block[..., y0 + 1: y0 + P + 1, x0: x0 + P].to(fx.dtype)
    w11 = block[..., y0 + 1: y0 + P + 1, x0 + 1: x0 + P + 1].to(fx.dtype)
    fx = fx[..., None, None]
    fy = fy[..., None, None]
    return (
        w00 * (1.0 - fx) * (1.0 - fy)
        + w01 * fx * (1.0 - fy)
        + w10 * (1.0 - fx) * fy
        + w11 * fx * fy
    )


def template_patch(blk0, a0, o0, P: int):
    """(T,P,P) bilinear template at float origins ``o0`` = p0 - radius from
    the (T,P+3,P+3) template windows ``blk0`` gathered at float starts
    ``a0`` (the margin-0 ``_qf``: the sub-window is the whole window); any
    leading axes (S,T,...)."""
    qii0, f0 = _qf(o0, a0, P, blk0.shape[-1], blk0.shape[-2])
    return _bil_t(_sub_windows(blk0, qii0, P + 3), f0[..., 0], f0[..., 1],
                  P, 0, 0)


def lk_level_plain(img0, img1, p0_l, v, iters: int, radius: int,
                   min_det: float, margin: int = MARGIN):
    """``iters`` LK updates at one pyramid level for all tracks, in plain
    PyTorch (port of the XLA path of sfm_tpu/ops/klt._lk_level; K3's plain
    version).  With a scene axis (images (S,H,W), p0_l and v (S,T,2)) it
    runs scene by scene."""
    if img1.dim() == 3:
        return torch.stack([
            lk_level_plain(a, b, p, w, iters, radius, min_det, margin)
            for a, b, p, w in zip(img0, img1, p0_l, v)])
    P = 2 * radius + 1
    # template: fixed patch from img0 (no search margin)
    blk0, a0 = _load_blocks(img0, p0_l - radius, P, 0)
    # target: one block per track with the search margin, loaded once
    blk1, a1 = _load_blocks(img1, p0_l + v - radius, P, margin)
    tmpl = template_patch(blk0, a0, p0_l - radius, P)
    return _lk_iterate_plain(blk1, tmpl, lambda v: p0_l + v - radius - a1, v,
                             iters, min_det)


def _lk_iterate_plain(blk1, tmpl, q_of, v, iters: int, min_det: float):
    """The LK iteration loop shared by the plain versions of K3 and K4:
    ``iters`` updates of the flow ``v`` (T,2) against the (T,P,P) template
    on the (T,WIN,WIN) search windows; ``q_of(v)`` is the float position of
    the patch origin inside the window (K3's plain version forms it as
    ``p0 + v - radius - start`` like the XLA path, K4's as ``base + v`` like
    the TPU kernel).  Any leading axes (S,T,...): every track's arithmetic
    is its own."""
    P = tmpl.shape[-1]
    S = P + 3
    WINy1, WINx1 = blk1.shape[-2:]
    for _ in range(iters):
        qii, f = _qf(q_of(v), 0.0, P, WINx1, WINy1)
        sub = _sub_windows(blk1, qii, S)
        fx, fy = f[..., 0], f[..., 1]
        cur = _bil_t(sub, fx, fy, P, 0, 0)
        gx = 0.5 * (_bil_t(sub, fx, fy, P, 1, 0)
                    - _bil_t(sub, fx, fy, P, -1, 0))
        gy = 0.5 * (_bil_t(sub, fx, fy, P, 0, 1)
                    - _bil_t(sub, fx, fy, P, 0, -1))
        r = tmpl - cur
        gxx = torch.sum(gx * gx, dim=(-2, -1))
        gxy = torch.sum(gx * gy, dim=(-2, -1))
        gyy = torch.sum(gy * gy, dim=(-2, -1))
        bx = torch.sum(gx * r, dim=(-2, -1))
        by = torch.sum(gy * r, dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        inv_det = torch.where(det.abs() > min_det, 1.0 / det,
                              torch.zeros_like(det))
        dvx = (gyy * bx - gxy * by) * inv_det
        dvy = (gxx * by - gxy * bx) * inv_det
        v = v + torch.stack([dvx, dvy], dim=-1)
    return v


def _lk_level_fused_cuda(img0, img1, p0_l, v, iters, radius, min_det,
                         margin):
    global level_launches
    P = 2 * radius + 1
    WIN = P + 2 * margin + 3
    bf16 = _check_image_pair(img0, img1, WIN, "lk_level_fused", dims=(2, 3))
    if margin <= 0:
        raise ValueError("lk_level_fused needs a positive search margin")
    # a single pair is the one-scene case of the stack
    lead = tuple(img0.shape[:-2])
    T = p0_l.shape[-2]
    for a in (p0_l, v):
        if (a.dtype != torch.float32 or a.shape != (*lead, T, 2)
                or a.device != img0.device):
            raise TypeError("lk_level_fused takes float32 positions and "
                            "flows (T,2), or (S,T,2) for images (S,H,W), "
                            "on the images' device")
    p0_l = p0_l.contiguous()
    v = v.contiguous()
    lib = build.load()
    H, W = img0.shape[-2:]
    S = img0.shape[0] if lead else 1
    out = torch.empty_like(p0_l)
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_lk_level_fused(
            img0.data_ptr(), img1.data_ptr(), H, W, p0_l.data_ptr(),
            v.data_ptr(), S * T, T, int(radius), int(margin), int(iters),
            float(min_det), out.data_ptr(), bf16, stream)
    build.check_launch(code, "lk_level_fused")
    level_launches += 1
    _count(bf16)
    return debug.check_finite(out, "lk_level_fused")


def lk_level_fused(img0, img1, p0_l, v, iters: int, radius: int,
                   min_det: float, margin: int = MARGIN):
    """K3. CUDA tensors -> the fused kernel (gather + template + all
    iterations in one launch, for one scene or an (S,H,W) / (S,T,2) stack
    of scenes), CPU tensors -> ``lk_level_plain``."""
    if img1.is_cuda:
        return _lk_level_fused_cuda(img0, img1, p0_l, v, iters, radius,
                                    min_det, margin)
    return lk_level_plain(img0, img1, p0_l, v, iters, radius, min_det,
                          margin)


# ---------------------------------------------------------------------------
# K4: LK level with the template passed in
# ---------------------------------------------------------------------------


def lk_level_tmpl_plain(blocks, tmpl, base, v, iters: int, min_det: float):
    """``iters`` LK updates for all tracks on search windows ``blocks``
    (T,WIN,WIN) gathered at float starts ``start``, against the template
    ``tmpl`` (T,P,P); ``base`` (T,2) = (p0 - radius) - start.  Returns v.
    Any leading axes: (S,T,...) for a stack of scenes."""
    return _lk_iterate_plain(blocks, tmpl, lambda v: base + v, v, iters,
                             min_det)


def _lk_level_tmpl_cuda(blocks, tmpl, base, v, iters, min_det):
    global tmpl_launches
    bf16 = _storage_flag("lk_level_tmpl", blocks)
    lead = tuple(blocks.shape[:-3])
    T, WIN = blocks.shape[-3], blocks.shape[-1]
    P = tmpl.shape[-1]
    if (len(lead) > 1 or blocks.shape[-2] != WIN
            or not blocks.is_contiguous()):
        raise TypeError("lk_level_tmpl takes contiguous windows (T,WIN,WIN) "
                        f"or (S,T,WIN,WIN), got {tuple(blocks.shape)}")
    if WIN < P + 5:
        raise ValueError(f"lk_level_tmpl: window {WIN} leaves no search "
                         f"margin around a {P}-px patch")
    for a, shape in ((tmpl, (*lead, T, P, P)), (base, (*lead, T, 2)),
                     (v, (*lead, T, 2))):
        if (a.dtype != torch.float32 or a.shape != shape
                or a.device != blocks.device):
            raise TypeError("lk_level_tmpl takes a float32 template (T,P,P) "
                            "and float32 (T,2) bases and flows, with the "
                            "windows' leading axes, on the windows' device")
    tmpl, base, v = tmpl.contiguous(), base.contiguous(), v.contiguous()
    n = blocks.numel() // (WIN * WIN)  # the scenes' tracks, one table
    lib = build.load()
    out = torch.empty((*lead, T, 2), dtype=torch.float32,
                      device=blocks.device)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_lk_level_tmpl(
            blocks.data_ptr(), tmpl.data_ptr(), base.data_ptr(),
            v.data_ptr(), n, int(P), int(WIN), int(iters), float(min_det),
            out.data_ptr(), bf16, stream)
    build.check_launch(code, "lk_level_tmpl")
    tmpl_launches += 1
    _count(bf16)
    return debug.check_finite(out, "lk_level_tmpl")


def lk_level_tmpl(blocks, tmpl, base, v, iters: int, min_det: float):
    """K4, for one scene or an (S,T,...) stack (one launch). CUDA tensors
    -> the kernel (all iterations in one launch), CPU tensors ->
    ``lk_level_tmpl_plain``."""
    if blocks.is_cuda:
        return _lk_level_tmpl_cuda(blocks, tmpl, base, v, iters, min_det)
    return lk_level_tmpl_plain(blocks, tmpl, base, v, iters, min_det)
