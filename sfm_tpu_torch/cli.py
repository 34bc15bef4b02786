"""Command-line entry point of the PyTorch/CUDA port, flag-compatible with
sfm_tpu/cli.py (reference: python/src/templering_sfm.py:1344-1599
``parse_args``/``main`` and the C++ argv parser cpp:1518-1676). Usage:

    python -m sfm_tpu_torch --dir <dataset_dir> --frames 12 --out out/run
    python -m sfm_tpu_torch --zip temple.zip --extract-to /tmp/x --out out/run
    python -m sfm_tpu_torch --synthetic 12 --out out/run   (built-in data)
    python -m sfm_tpu_torch --synthetic 6 --device cpu     (no card)

It runs on the card (``--device cuda``, the default) and on the CPU only
when asked (``--device cpu``).  The mesh exports, the visuals and
``--debug-nans`` are not ported yet and raise (see ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

_NOT_PORTED = ("is not ported to sfm_tpu_torch yet (see ROADMAP.md, "
               "Queue 1); run it with the JAX package (python -m sfm_tpu)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "sfm_tpu_torch",
        description="TempleRing SfM pipeline (PyTorch/CUDA port)")
    # ref py:1344-1378 flag set
    ap.add_argument("--config", type=str, default="config.json")
    ap.add_argument("--zip", type=str, default=None)
    ap.add_argument("--extract-to", type=str, default="out/_extracted")
    ap.add_argument("--dir", type=str, default=None)
    ap.add_argument("--synthetic", type=int, default=None, metavar="N",
                    help="render an N-frame synthetic ring instead of "
                         "loading a dataset (extra over the reference)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", type=str, default="out/run")
    ap.add_argument("--use-gt-scale", action="store_true", default=None)
    ap.add_argument("--translation-mode", type=str, default=None,
                    choices=["full", "dir", "rot"])
    ap.add_argument("--visuals", action="store_true", default=None)
    ap.add_argument("--K-yaml", dest="k_yaml", type=str, default=None)
    ap.add_argument("--log", type=str, default="info")
    ap.add_argument("--export-geometry", type=str, default=None,
                    choices=["none", "pointcloud", "mesh", "mesh_stereo",
                             "both"])
    ap.add_argument("--mesh-kf", type=int, default=None)
    ap.add_argument("--mesh-max-points", type=int, default=None)
    ap.add_argument("--mesh-grid-px", type=int, default=None)
    ap.add_argument("--mesh-max-edge-px", type=float, default=None)
    ap.add_argument("--metrics-jsonl", type=str, default=None,
                    help="write per-frame metrics as JSON lines")
    ap.add_argument("--debug-nans", action="store_true",
                    help="NaN/Inf checks inside the device stages (not "
                         "ported yet: raises)")
    ap.add_argument("--pipeline", type=str, default="host",
                    choices=["host", "scan"],
                    help="host = host-driven loop over device stages "
                         "(full feature set incl. --use-gt-scale); "
                         "scan = device-resident frame loop")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the plain versions of the kernels)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log.upper(), logging.INFO),
        format="%(levelname)s %(name)s: %(message)s",
    )
    from sfm_tpu_torch.config import ExportGeometry, load_config
    from sfm_tpu_torch.models.system import SfMSystem
    from sfm_tpu_torch.utils.dataset import TempleRing, load_K_yaml
    from sfm_tpu_torch.utils.device import resolve

    if args.debug_nans:
        raise NotImplementedError("--debug-nans " + _NOT_PORTED)
    device = resolve(args.device)

    overrides = {
        k: v
        for k, v in {
            "frames": args.frames,
            "use_gt_scale": args.use_gt_scale,
            "translation_mode": args.translation_mode,
            "visuals": args.visuals,
            "export_geometry": args.export_geometry,
            "mesh_sparse.kf": args.mesh_kf,
            "mesh_sparse.max_points": args.mesh_max_points,
            "mesh_sparse.grid_px": args.mesh_grid_px,
            "mesh_sparse.max_edge_px": args.mesh_max_edge_px,
        }.items()
        if v is not None
    }
    if args.synthetic is not None:
        # the synthetic ring's noise texture needs the stronger tracker
        # settings the bench uses (what a dataset's config.json carries)
        for k, v in (("klt.pyr_levels", 4), ("klt.win_radius", 6),
                     ("klt.iters", 16)):
            overrides.setdefault(k, v)
    cfg = load_config(args.config, overrides)
    if cfg.visuals:
        raise NotImplementedError("--visuals " + _NOT_PORTED)
    if cfg.export_geometry in (ExportGeometry.MESH, ExportGeometry.MESH_STEREO,
                               ExportGeometry.BOTH):
        raise NotImplementedError(
            f"--export-geometry {cfg.export_geometry.value} " + _NOT_PORTED)

    # dataset selection (ref py:1388-1396 match/case)
    if args.synthetic is not None:
        from sfm_tpu_torch.utils.synthetic import (SyntheticRingSpec,
                                                   generate_dataset)

        out_ds = Path(args.out) / "_synthetic"
        # scale the camera arc with the frame count: ~7.7°/frame is the
        # bench/TempleRing regime (~22px median flow)
        arc = min(360.0, args.synthetic * 7.7)
        generate_dataset(out_ds, SyntheticRingSpec(
            n_frames=args.synthetic, arc_deg=arc))
        ds = TempleRing.from_dir(out_ds)
    elif args.zip:
        ds = TempleRing.from_zip(args.zip, args.extract_to)
    elif args.dir:
        ds = TempleRing.from_dir(args.dir)
    else:
        print("one of --dir / --zip / --synthetic is required",
              file=sys.stderr)
        return 2

    K = load_K_yaml(args.k_yaml) if args.k_yaml else ds.K
    n_frames = min(cfg.frames, len(ds))
    use_scan = args.pipeline == "scan"
    if use_scan:
        from sfm_tpu_torch.models.scan_pipeline import ScanSfM

        sys_ = ScanSfM(K, cfg, n_frames=n_frames, gt_records=ds.records,
                       device=device)
    else:
        sys_ = SfMSystem(K, cfg, gt_records=ds.records, device=device)

    t0 = time.perf_counter()
    for i in range(n_frames):
        gray = ds.load_gray(i)
        sys_.process(i, ds.records[i].img, gray)
        if not use_scan:
            print(
                f"frame {i + 1}/{n_frames} | keyframes={len(sys_.kfs)} | "
                f"map_points={sys_.map.num_points} | edges={len(sys_.edges)}"
            )
    sys_.finalize()
    dt = time.perf_counter() - t0
    if use_scan:
        # per-frame lines (reference format) from the drained chunk metrics
        for m in sys_.metrics:
            print(
                f"frame {m['frame'] + 1}/{n_frames} | "
                f"kf={m.get('keyframe', False)} | "
                f"tracks={m.get('tracks', 0)} | "
                f"map_points={m.get('map_points', 0)}"
            )

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    info = sys_.export(out, dataset=ds)

    if args.metrics_jsonl:
        with open(args.metrics_jsonl, "w") as f:
            for m in sys_.metrics:
                f.write(json.dumps(m) + "\n")

    # summary (ref py:1590-1595 / cpp:1908-1911)
    print("\n=== Summary ===")
    print(f"Keyframes: {info['keyframes']}")
    print(f"Map points: {info['map_points']}")
    print(f"Edges: {info['edges']}")
    print(f"Wall time: {dt:.2f}s ({n_frames / dt:.2f} frames/s)")
    print(f"Outputs: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
