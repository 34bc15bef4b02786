"""The port's command line with the options that export geometry, render
visuals or check every op for NaN/Inf, on the CPU, against the JAX
package's CLI (sfm_tpu/cli.py).

One module-scoped JAX run (``--synthetic 6 --export-geometry both
--visuals``) gives the reference file names.  The port's CLI runs as
subprocesses (``--synthetic 6 --device cpu``), a few at a time while the JAX
run goes on, once for each flag set: ``--visuals`` through the host
pipeline, the three geometry exports through the scan pipeline (which the
JAX CLI serves the same way), ``--debug-nans`` through both, each against a
run without the flag that writes the same artifacts (the ``--visuals`` run
and the ``--export-geometry both`` run: rendering and mesh export read the
results and change none of them).
"""

import concurrent.futures
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sfm_tpu import cli as jcli

REPO = Path(__file__).resolve().parents[1]
BASE = ("keyframes_camera_centers.csv", "posegraph_edges.csv",
        "templeRing_sparse_points.ply")
PNGS = ("camera_trajectory.png", "inlier_matches.png", "input_montage.png",
        "sparse_pointcloud.png")
FLAGS = {
    "visuals": ["--visuals"],
    "debug_nans": ["--debug-nans"],
    "mesh": ["--export-geometry", "mesh"],
    "mesh_stereo": ["--export-geometry", "mesh_stereo"],
    "both": ["--export-geometry", "both"],
}
SCAN = ("mesh", "mesh_stereo", "both")  # the cases run by ScanSfM
# the port runs: name -> extra flags (the five flag sets, plus the scan
# pipeline with --debug-nans)
RUNS = {**{name: (["--pipeline", "scan"] if name in SCAN else []) + flags
           for name, flags in FLAGS.items()},
        "scan_debug_nans": ["--pipeline", "scan", "--debug-nans"]}


def _port_cli(out: Path, extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "sfm_tpu_torch", "--synthetic", "6",
         "--device", "cpu", "--out", str(out), "--log", "warning", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX output dir, {run name: (port output dir, CompletedProcess)}):
    the port runs, four at a time, overlap the in-process JAX run."""
    root = tmp_path_factory.mktemp("cli_geometry")
    jout = root / "jax"
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        futs = {name: pool.submit(_port_cli, root / name, extra)
                for name, extra in RUNS.items()}
        with contextlib.redirect_stdout(io.StringIO()):
            rc = jcli.main(["--synthetic", "6", "--out", str(jout), "--log",
                            "warning", "--export-geometry", "both",
                            "--visuals"])
        done = {name: (root / name, f.result()) for name, f in futs.items()}
    assert rc == 0
    return jout, done


def _read_ply_mesh(path: Path):
    """(vertices (V,3), faces (F,3)) of an ASCII PLY triangle mesh."""
    lines = path.read_text().splitlines()
    nv = nf = 0
    for i, line in enumerate(lines):
        if line.startswith("element vertex"):
            nv = int(line.split()[-1])
        elif line.startswith("element face"):
            nf = int(line.split()[-1])
        elif line == "end_header":
            body = lines[i + 1:]
            break
    verts = np.array([[float(x) for x in ln.split()] for ln in body[:nv]])
    faces = np.array([[int(x) for x in ln.split()] for ln in body[nv:]])
    assert len(body) == nv + nf and (faces[:, 0] == 3).all()
    return verts.reshape(-1, 3), faces[:, 1:]


def _expected(flags, jax_names):
    """The files the JAX CLI writes for ``flags``: the two CSVs, the point
    cloud for pointcloud and both, the sparse mesh for every mesh mode, the
    stereo mesh for mesh_stereo and both, the four renders for --visuals."""
    geom = flags[1] if "--export-geometry" in flags else "pointcloud"
    want = set(BASE if geom in ("pointcloud", "both") else BASE[:2])
    if geom != "pointcloud":
        want |= {n for n in jax_names if "_mesh_sparse_" in n}
    if geom in ("mesh_stereo", "both"):
        want |= {n for n in jax_names if "_mesh_stereo_" in n}
    if "--visuals" in flags:
        want |= set(PNGS)
    return want


def _files(out: Path):
    return {p.name for p in out.iterdir() if p.name != "_synthetic"}


def _artifacts_equal(a: Path, b: Path):
    """The CSVs and the point cloud, byte for byte."""
    for f in BASE:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("name", list(FLAGS))
def test_torch_cli_options_run(runs, name):
    """Exit code 0, the files the JAX CLI writes for the flags (its names,
    meshes included), mesh PLYs whose faces index their vertices, PNGs that
    open; ``--debug-nans`` leaves both pipelines' artifacts bit-identical to
    a run without it."""
    jout, done = runs
    flags = FLAGS[name]
    jax_names = _files(jout)
    assert {"templeRing_mesh_sparse_kf0.ply",
            "templeRing_mesh_stereo_kf0_kf1.ply", *PNGS} <= jax_names
    pipelines = [(name, None)]
    if name == "debug_nans":  # each against its run without the flag
        pipelines = [(name, "visuals"), ("scan_debug_nans", "both")]
    for run, ref in pipelines:
        out, res = done[run]
        assert res.returncode == 0, res.stderr[-3000:]
        assert _files(out) == _expected(flags, jax_names), _files(out)
        for f in sorted(out.glob("templeRing_mesh_*.ply")):
            verts, faces = _read_ply_mesh(f)
            assert len(faces) > 0 and np.isfinite(verts).all(), f.name
            assert faces.min() >= 0 and faces.max() < len(verts), f.name
        for f in sorted(out.glob("*.png")):
            with Image.open(f) as im:
                im.verify()
        if ref is not None:
            ref_out, ref_res = done[ref]
            assert ref_res.returncode == 0, ref_res.stderr[-3000:]
            _artifacts_equal(out, ref_out)
