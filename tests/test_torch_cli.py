"""The port's command line (``python -m sfm_tpu_torch``) on the CPU, against
the JAX package's (sfm_tpu/cli.py).

One module-scoped run of the JAX CLI (``--synthetic 6``, its default host
pipeline) gives the reference set of files, CSV columns and printed lines;
the port's CLI runs as a subprocess with ``--device cpu --synthetic 6``
through both pipelines, and once more through the host pipeline with the
ORB loop flavor from a config file.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sfm_tpu import cli as jcli

from sfm_tpu_torch import cli
from sfm_tpu_torch.utils import artifacts

REPO = Path(__file__).resolve().parents[1]
FILES = ("keyframes_camera_centers.csv", "posegraph_edges.csv",
         "templeRing_sparse_points.ply")
# the summary block of sfm_tpu/cli.py, line by line
SUMMARY = (r"=== Summary ===", r"Keyframes: \d+", r"Map points: \d+",
           r"Edges: \d+", r"Wall time: \d+\.\d\ds \(\d+\.\d\d frames/s\)",
           r"Outputs: .+")
HOST_LINE = r"frame \d+/6 \| keyframes=\d+ \| map_points=\d+ \| edges=\d+"
SCAN_LINE = r"frame \d+/6 \| kf=(True|False) \| tracks=\d+ \| map_points=\d+"


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_cli")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jcli.main(["--synthetic", "6", "--out", str(out),
                        "--log", "warning"])
    assert rc == 0
    return out, buf.getvalue().splitlines()


def _port_cli(out: Path, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "sfm_tpu_torch", "--synthetic", "6",
         "--device", "cpu", "--out", str(out), "--log", "warning", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def _summary(lines):
    i = lines.index("=== Summary ===")
    return lines[i:i + len(SUMMARY)]


def _check_outputs(out: Path, lines, jax_out: Path, jax_lines,
                   frame_line: str):
    assert _summary(lines)[-1] == f"Outputs: {out}"
    for pat, got, ref in zip(SUMMARY, _summary(lines), _summary(jax_lines)):
        assert re.fullmatch(pat, got), (pat, got)
        assert re.fullmatch(pat, ref), (pat, ref)
    frames = [ln for ln in lines if ln.startswith("frame ")]
    assert len(frames) == 6 and all(re.fullmatch(frame_line, ln)
                                    for ln in frames), frames
    assert sorted(p.name for p in out.iterdir()) == \
        sorted(p.name for p in jax_out.iterdir())
    for f in FILES[:2]:
        head = (out / f).read_text().splitlines()[0]
        assert head == (jax_out / f).read_text().splitlines()[0], f
    n_kf = int(re.search(r"\d+", _summary(lines)[1]).group())
    rows = artifacts.read_csv_centers(out / FILES[0])
    assert len(rows) == n_kf >= 3
    pts = artifacts.read_ply_xyz(out / FILES[2])
    assert len(pts) > 100 and np.isfinite(pts).all()


def test_torch_cli_host_pipeline(jax_cli, tmp_path):
    """The default pipeline (host, ``SfMSystem``): exit code 0, the JAX
    CLI's files and CSV columns, its per-frame line and summary formats,
    and one metrics line per frame."""
    out = tmp_path / "host"
    res = _port_cli(out, "--metrics-jsonl", str(tmp_path / "m.jsonl"))
    assert res.returncode == 0, res.stderr[-3000:]
    _check_outputs(out, res.stdout.splitlines(), *jax_cli, HOST_LINE)
    mets = [json.loads(ln) for ln in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [m["frame"] for m in mets] == list(range(6))


def test_torch_cli_scan_pipeline(jax_cli, tmp_path):
    """``--pipeline scan`` (``ScanSfM``): exit code 0, the same files and
    columns, the scan pipeline's per-frame line and the summary."""
    out = tmp_path / "scan"
    res = _port_cli(out, "--pipeline", "scan")
    assert res.returncode == 0, res.stderr[-3000:]
    _check_outputs(out, res.stdout.splitlines(), *jax_cli, SCAN_LINE)


def test_torch_cli_host_orb_from_config(jax_cli, tmp_path):
    """The host pipeline with the ORB loop flavor set in a config file
    (``loop.method="orb"``, candidates 3 keyframes back): it runs ORB on
    every keyframe and exits 0 with the same artifacts."""
    cfg = tmp_path / "orb.json"
    cfg.write_text(json.dumps({"loop": {"method": "orb", "min_kf_gap": 3}}))
    out = tmp_path / "orb"
    res = _port_cli(out, "--config", str(cfg))
    assert res.returncode == 0, res.stderr[-3000:]
    _check_outputs(out, res.stdout.splitlines(), *jax_cli, HOST_LINE)


@pytest.mark.parametrize("flags", [["--visuals"], ["--debug-nans"],
                                   ["--export-geometry", "mesh"],
                                   ["--export-geometry", "mesh_stereo"],
                                   ["--export-geometry", "both"]])
def test_torch_cli_unported_options_raise(flags, tmp_path):
    """What is not ported yet raises, pointing at ROADMAP.md, before any
    work is done."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["--synthetic", "2", "--device", "cpu",
                  "--out", str(tmp_path), *flags])
    assert not (tmp_path / "_synthetic").exists()


def test_torch_cli_defaults_to_the_card(tmp_path):
    """The JAX CLI's flags with its defaults (``--pipeline host`` among
    them), plus ``--device`` with default ``cuda``; without a card the CLI
    raises instead of running on the CPU."""
    args = cli.parse_args([])
    assert (args.pipeline, args.device) == ("host", "cuda")
    ref = vars(jcli.parse_args([]))
    assert {k: v for k, v in vars(args).items() if k != "device"} == ref
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "2", "--out", str(tmp_path)])
