"""K3's roofline counts follow from a launch's shapes alone: the shapes the
harness records at the program's launches are those of the call, the same
whether the kernel or its plain version computes the level, and the
counts read nothing of the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import capture, reference, roofline
from portbench.roofline import LkLevelShape


def _pyramids(S, H=96, W=128, levels=3, seed=0):
    """Two pyramids of random frames, one frame apart; (S,H_L,W_L) levels
    for S scenes, (H_L,W_L) for S = 0."""
    g = np.random.default_rng(seed)
    out = []
    for shift in (0, 1):
        frames = [np.roll(g.integers(0, 256, (H, W)).astype(np.uint8), shift,
                          axis=-1) for _ in range(max(S, 1))]
        pyrs = [reference.pyramid(f, levels, "cpu") for f in frames]
        out.append([torch.stack(lv) if S else lv[0] for lv in zip(*pyrs)])
    return out


@pytest.mark.parametrize("S", [0, 3])
def test_recorded_shapes_are_the_calls(S):
    from sfm_tpu_torch.ops import klt

    pyr0, pyr1 = _pyramids(S)
    T = 40
    lead = (S,) if S else ()
    pts = torch.rand(*lead, T, 2) * torch.tensor([100.0, 70.0]) + 14.0
    valid = torch.ones(*lead, T, dtype=torch.bool)
    hooks = capture.Hooks(seed=1, p=0.0)
    hooks.install()
    try:
        hooks.trace_on()
        klt.lk_track_fb(pyr0, pyr1, pts, valid, levels=3, iters=5, radius=3,
                        device="cpu")
    finally:
        hooks.uninstall()
    n = max(S, 1)
    want = [LkLevelShape(tracks=T * n, height=96 >> L, width=128 >> L,
                         radius=3, margin=reference.MARGIN, iters=5,
                         img_bytes=4, images=2 * n)
            for _ in range(2) for L in (2, 1, 0)]
    assert hooks.k3_shapes == want
    assert klt.lk_track_fb.__module__ == "sfm_tpu_torch.ops.klt"  # restored


def test_counts_are_the_algorithms():
    s = LkLevelShape(tracks=2200, height=480, width=640, radius=6, margin=6,
                     iters=16, img_bytes=4, images=2)
    P = 13
    per_iter = 7 * 15 ** 2 + 15 * P * P + 18
    assert roofline.lk_level_flops(s) == 2200 * (7 * P * P + 14
                                                 + 16 * per_iter)
    # windows: template 16^2 and search 28^2 px a track, under one image
    win_px = min(480 * 640, 2200 * 16 ** 2) + min(480 * 640, 2200 * 28 ** 2)
    assert roofline.lk_level_bytes(s) == win_px * 4 + 3 * 2200 * 2 * 4
    # bfloat16 storage halves the image bytes and leaves the operations
    h = s._replace(img_bytes=2)
    assert roofline.lk_level_flops(h) == roofline.lk_level_flops(s)
    assert roofline.lk_level_bytes(h) == win_px * 2 + 3 * 2200 * 2 * 4
    # four scenes in one launch: four times the work of one
    s4 = s._replace(tracks=4 * 2200, images=8)
    assert roofline.lk_level_flops(s4) == 4 * roofline.lk_level_flops(s)
    assert roofline.lk_level_bytes(s4) == 4 * roofline.lk_level_bytes(s)
    t, by = roofline.least_seconds(roofline.lk_level_flops(s),
                                   roofline.lk_level_bytes(s))
    assert by == "operations" and t == roofline.lk_level_flops(s) / 67e12


def test_yardstick_imports_no_program():
    code = ("import sys; sys.path.insert(0, '.'); import portbench.roofline;"
            " import portbench.reference;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('sfm_tpu_torch', 'sfm_tpu', 'jax', 'jaxlib')];"
            " print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr
