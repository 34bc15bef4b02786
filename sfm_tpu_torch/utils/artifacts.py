"""Artifact writers: ASCII PLY (points & meshes), keyframe-centers CSV,
pose-graph-edges CSV — byte-level schema compatible with the reference so
its eval tools consume our outputs unmodified.

ref: py:1069-1096 (``write_ply_xyz``/``write_ply_mesh``),
py:1267-1274 + cpp:1199-1243 (edges CSV), py:1567-1576 + cpp:1463-1475
(centers CSV). We unify the edge schema to include the ``kind`` column
that ``gt_keyframe_edge`` requires (SURVEY §4: the reference's current
exporters dropped it — a latent defect we fix rather than replicate).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_ply_xyz(path: str | Path, points: np.ndarray) -> None:
    """ASCII PLY point cloud (ref: py:1069-1077 / cpp:1215-1224)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def write_ply_mesh(path: str | Path, vertices: np.ndarray, faces: np.ndarray) -> None:
    """ASCII PLY triangle mesh (ref: py:1082-1096 / cpp:1226-1243)."""
    vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for p in vertices:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def read_ply_xyz(path: str | Path) -> np.ndarray:
    """Read back an ASCII PLY point cloud (for tests / parity checks)."""
    lines = Path(path).read_text().splitlines()
    n = 0
    start = 0
    for i, line in enumerate(lines):
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        if line.strip() == "end_header":
            start = i + 1
            break
    return np.array(
        [[float(x) for x in line.split()[:3]] for line in lines[start : start + n]]
    )


def write_csv_centers(path: str | Path, rows: list[dict]) -> None:
    """Keyframe camera-centers CSV: ``kf_id,frame_idx,image,x,y,z,lat,lon``
    (ref: py:1567-1576 / cpp:1463-1475; schema checked by
    ate_keyframes.cpp:120-150 which needs image,x,y,z)."""
    with open(path, "w") as f:
        f.write("kf_id,frame_idx,image,x,y,z,lat,lon\n")
        for r in rows:
            f.write(
                f"{r['kf_id']},{r['frame_idx']},{r['image']},"
                f"{float(r['x'])!r},{float(r['y'])!r},{float(r['z'])!r},"
                f"{float(r['lat']):.6f},{float(r['lon']):.6f}\n"
            )


def write_posegraph_edges(path: str | Path, edges: list[dict]) -> None:
    """Pose-graph edges CSV with the unified schema
    ``i,j,kind,rvec_x,rvec_y,rvec_z,t_x,t_y,t_z`` — the samples' schema
    (samples/python/posegraph_edges.csv header) that gt_keyframe_edge
    (cpp/tools/gt_keyframe_edge.cpp:217,225) requires."""
    with open(path, "w") as f:
        f.write("i,j,kind,rvec_x,rvec_y,rvec_z,t_x,t_y,t_z\n")
        for e in edges:
            rv = [float(v) for v in e["rvec"]]
            t = [float(v) for v in e["t"]]
            kind = e.get("kind", "loop" if e.get("is_loop") else "odom")
            f.write(
                f"{e['i']},{e['j']},{kind},"
                f"{rv[0]!r},{rv[1]!r},{rv[2]!r},{t[0]!r},{t[1]!r},{t[2]!r}\n"
            )


def read_csv_centers(path: str | Path) -> list[dict]:
    lines = Path(path).read_text().splitlines()
    hdr = lines[0].split(",")
    out = []
    for line in lines[1:]:
        if not line.strip():
            continue
        vals = line.split(",")
        row = dict(zip(hdr, vals))
        for k in ("x", "y", "z", "lat", "lon"):
            if k in row:
                row[k] = float(row[k])
        for k in ("kf_id", "frame_idx"):
            if k in row:
                row[k] = int(row[k])
        out.append(row)
    return out
