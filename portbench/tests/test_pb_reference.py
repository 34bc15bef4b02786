"""The plain reference as the benchmark was written: its pyramid and its
forward-backward tracker give the program's plain CPU path bit for bit,
and its grading of an exported sequence reads the program's files."""

import numpy as np
import pytest
import torch

from portbench import reference


def _frames(seed=3, H=120, W=160):
    g = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter

    a = gaussian_filter(g.standard_normal((H, W + 8)), 2.0)
    a = np.clip(128 + 60 * a / a.std(), 0, 255)
    return a[:, :W].astype(np.uint8), a[:, 3:W + 3].astype(np.uint8)


def test_pyramid_is_programs():
    from sfm_tpu_torch.ops.image import build_pyramid

    f, _ = _frames()
    ours = reference.pyramid(f, 4, "cpu")
    theirs = build_pyramid(torch.as_tensor(f).float(), 4)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("radius, iters", [(3, 8), (6, 16)])
def test_track_fb_is_programs_plain_path(radius, iters):
    from sfm_tpu_torch.ops import klt

    f0, f1 = _frames()
    p0, p1 = (reference.pyramid(f, 3, "cpu") for f in (f0, f1))
    g = torch.Generator().manual_seed(5)
    pts = torch.rand(300, 2, generator=g) * torch.tensor([150.0, 110.0])
    valid = torch.rand(300, generator=g) > 0.1
    ours = reference.track_fb(p0, p1, pts, valid, 3, iters, radius, 1.0)
    theirs = klt.lk_track_fb(p0, p1, pts, valid, 3, iters, radius, 1.0,
                             device="cpu")
    assert torch.equal(ours[0], theirs[0])
    assert torch.equal(ours[1], theirs[1])
    assert int(ours[1].sum()) > 100


def test_sim3_ate_recovers_similarity():
    g = np.random.default_rng(0)
    gt = g.standard_normal((20, 3))
    ang = 0.7
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                  0], [0, 0, 1]])
    est = (gt - 0.3) @ R / 2.5
    assert reference.ate_ratio(est, gt) < 1e-12
    noisy = est + 1e-3 * g.standard_normal(est.shape)
    assert 1e-4 < reference.ate_ratio(noisy, gt) < 1e-2
