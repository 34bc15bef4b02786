"""Diagnostic renders (ref: python/src/templering_sfm.py:1277-1338):
input montage (PIL), inlier-match canvas, 3-D sparse cloud scatter and
camera trajectory (matplotlib Agg).

Counterpart of sfm_tpu/utils/visuals.py: host-only, on numpy arrays (the
map points and keyframe poses the port's pipelines hand back are numpy
already), so it never touches the device.  matplotlib is the optional
``viz`` extra."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def render_input_montage(images: list[np.ndarray], path: str | Path,
                         cols: int = 4, thumb: int = 160) -> None:
    """Grid montage of input frames (ref py:1277-1293)."""
    from PIL import Image

    if not images:
        return
    rows = (len(images) + cols - 1) // cols
    h0, w0 = images[0].shape[:2]
    tw = thumb
    th = int(round(h0 * tw / w0))
    canvas = Image.new("L", (cols * tw, rows * th), 30)
    for k, img in enumerate(images):
        im = Image.fromarray(img).resize((tw, th))
        canvas.paste(im, ((k % cols) * tw, (k // cols) * th))
    canvas.save(path)


def render_inlier_matches(img_i: np.ndarray, img_j: np.ndarray,
                          pts_i: np.ndarray, pts_j: np.ndarray,
                          mask: np.ndarray, path: str | Path,
                          max_draw: int = 300) -> None:
    """Side-by-side match canvas with circles+lines (ref py:1296-1309)."""
    from PIL import Image, ImageDraw

    H = max(img_i.shape[0], img_j.shape[0])
    W = img_i.shape[1] + img_j.shape[1]
    canvas = Image.new("RGB", (W, H), (0, 0, 0))
    canvas.paste(Image.fromarray(img_i).convert("RGB"), (0, 0))
    canvas.paste(Image.fromarray(img_j).convert("RGB"), (img_i.shape[1], 0))
    draw = ImageDraw.Draw(canvas)
    off = img_i.shape[1]
    idx = np.nonzero(mask)[0][:max_draw]
    for k in idx:
        x1, y1 = float(pts_i[k, 0]), float(pts_i[k, 1])
        x2, y2 = float(pts_j[k, 0]) + off, float(pts_j[k, 1])
        draw.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=(0, 255, 0))
        draw.ellipse([x2 - 2, y2 - 2, x2 + 2, y2 + 2], outline=(0, 255, 0))
        draw.line([x1, y1, x2, y2], fill=(255, 180, 0), width=1)
    canvas.save(path)


def render_sparse_cloud(points: np.ndarray, path: str | Path,
                        max_points: int = 8000) -> None:
    """3-D scatter of the sparse map (ref py:1312-1326)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.0, c=pts[:, 2], cmap="viridis")
    ax.set_title("sparse point cloud")
    fig.savefig(path, dpi=110)
    plt.close(fig)


def render_trajectory(centers: np.ndarray, path: str | Path) -> None:
    """3-D camera-center polyline (ref py:1329-1338)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    C = np.asarray(centers)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    if len(C):
        ax.plot(C[:, 0], C[:, 1], C[:, 2], "-o", ms=3)
        ax.scatter(C[0, 0], C[0, 1], C[0, 2], c="g", s=40, label="start")
        ax.legend()
    ax.set_title("camera trajectory")
    fig.savefig(path, dpi=110)
    plt.close(fig)
