"""One run of one cell: data, set-up, the measured window, the traced part,
the comparison that decides ``correct``, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is read from its own file, found by the names in
``BENCHMARK.json``:

- ``portbench/configs/<config>.json``: the entry, the port's overrides,
  the camera and object (``render``), chunk and capacities, the limits the
  configuration states (``guarantees``) and the part the traced run
  profiles (``trace``);
- ``portbench/traffic/<traffic>.json``: scenes, the camera path, the
  frames used, the warm-up path, the tracker sampling rate of the check
  and, where it differs from the configuration's, the traced part;
- ``portbench/cells/<workload>.json``: the limits set from readings;
- ``portbench/metrics/<metric>.py``: one reader a per-layer metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_tpu")  # top-level module names


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # rehearsal and readings only; the benchmark's own runs pass none
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the kernels' plain versions at the tiny "
                         "sizes of the files' 'tiny' blocks (rehearsal)")
    ap.add_argument("--control", default="", choices=("", "lk_bf16"),
                    help="lk_bf16: the program's bfloat16 LK storage "
                         "switched on (the control of the comparison)")
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def merged(d: dict, tiny: bool) -> dict:
    """``d`` with its ``tiny`` block merged in (one level deep) when
    ``tiny``."""
    if not tiny or "tiny" not in d:
        return d
    out = dict(d)
    for k, v in d["tiny"].items():
        out[k] = ({**d[k], **v} if isinstance(v, dict) and isinstance(
            d.get(k), dict) and k != "path" else v)
    return out


class Cell:
    """The files of one workload of the manifest."""

    def __init__(self, manifest: Path, workload: str, tiny: bool):
        self.root = manifest.parent
        m = load_json(manifest)
        ws = {w["name"]: w for w in m["workloads"]}
        if workload not in ws:
            raise SystemExit(f"no workload {workload!r} in {manifest}")
        self.workload = ws[workload]
        cfgs = {c["name"]: c for c in m["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = merged(load_json(self.root / self.config_entry["file"]),
                             tiny)
        self.traffic = merged(load_json(
            HERE / "traffic" / f"{self.workload['traffic']}.json"), tiny)
        cell_file = HERE / "cells" / f"{workload}.json"
        self.limits = (load_json(cell_file).get("limits", {})
                       if cell_file.exists() else {})
        self.end_to_end = [e for e in m["end_to_end"]
                           if workload in e.get("workloads", [workload])]
        self.per_layer = [e for e in m["per_layer"]
                          if workload in e.get("workloads", [workload])]


def reader(name: str):
    """The ``read(run)`` function of per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Ctx:
    cfg: object
    entry: str
    chunk: int
    p_cap: int
    p_ba: int
    device: str


def derive_seeds(seed: int, n: int, salt: int) -> list[int]:
    """``n`` seeds under 2**31 drawn from ``seed`` (any size) and
    ``salt``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(salt)])
    return [int(x) % (2 ** 31) for x in ss.generate_state(n, np.uint64)]


def make_scenes(cell: Cell, seed: int, tmp: Path,
                tiny: bool = False) -> list[dict]:
    """Render the traffic's rings (texture seeds from ``seed``) into
    ``tmp`` and read them back through the port's loader."""
    from portbench import ringdata
    from sfm_tpu_torch.utils.dataset import TempleRing

    tr, cf = cell.traffic, cell.config
    S = int(tr["scenes"])
    n_used = int(tr["frames_used"])
    specs = [ringdata.ring_spec(cf["render"], tr["path"], ts)
             for ts in derive_seeds(seed, S, 1)]
    rings = [(tmp / f"ring{s}", spec, list(range(n_used)))
             for s, spec in enumerate(specs)]
    # rehearsal sizes render in this process; a card's run in a pool of
    # spawned processes, one a core up to 8
    ringdata.write_rings(rings, processes=1 if tiny else min(
        8, os.cpu_count() or 1))
    scenes = []
    for (d, spec, frames) in rings:
        ds = TempleRing.from_dir(d)
        _, R, _, C, _ = ringdata.ring_cameras(spec)
        scenes.append({"K": ds.K, "dataset": ds, "frames": frames,
                       "names": [r.img for r in ds.records],
                       "images": [ds.load_gray(i) for i in range(len(frames))],
                       "gt_R": R, "gt_C": C, "spec": spec})
    return scenes


def warm_scenes(scenes: list[dict], k: int) -> list[dict]:
    """The out-and-back path 0..k..0 over each scene's frames."""
    idx = list(range(k + 1)) + list(range(k - 1, -1, -1))
    return [{**sc, "frames": [sc["frames"][i] for i in idx],
             "names": [sc["names"][i] for i in idx],
             "images": [sc["images"][i] for i in idx]} for sc in scenes]


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def load_cell(args) -> Cell:
    """The cell that ``args`` names in the checkout's ``BENCHMARK.json``;
    rehearsal sizes on the CPU."""
    return Cell(HERE.parent / "BENCHMARK.json", args.workload,
                args.device == "cpu")


def run_cell(args, cell: Cell, t_start: float) -> tuple[dict, list[str]]:
    """One run; returns (result object, check lines for standard error)."""
    import torch

    from portbench import capture, judge, trace
    from portbench.entries import loop_work, make_sequence, out_dirs
    from sfm_tpu_torch.config import load_config

    tiny = args.device == "cpu"
    if args.control == "lk_bf16":
        os.environ["SFM_TPU_LK_BF16"] = "1"
    cf, tr = cell.config, cell.traffic
    cfg = load_config(None, overrides=cf["overrides"])
    ctx = Ctx(cfg=cfg, entry=cf["entry"], chunk=int(tr.get("chunk",
                                                           cf["chunk"])),
              p_cap=int(cf["p_cap"]), p_ba=int(cf["p_ba"]),
              device=args.device)
    tmp = Path(tempfile.mkdtemp(prefix="portbench_"))
    try:
        t_render = time.perf_counter()
        scenes = make_scenes(cell, args.seed, tmp, tiny)
        t_render = time.perf_counter() - t_render
        hooks = capture.Hooks(derive_seeds(args.seed, 1, 3)[0],
                              float(tr["track_sample_p"]))
        hooks.install()
        try:
            # warm-up: every stage the window calls, once, at its shapes
            t_warm = time.perf_counter()
            warm = make_sequence(ctx, warm_scenes(
                scenes, int(tr["warmup"]["out_and_back"])), 1, tmp / "warm")
            for k in range(len(warm.plan)):
                warm.run(k)
            warm_loops = loop_work(warm)
            del warm
            gc.collect()
            sync(args.device)
            if args.device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            setup_s = time.perf_counter() - t_start
            t_warm = time.perf_counter() - t_warm
            win = window(args, cell, ctx, scenes, tmp, hooks, trace)
        finally:
            hooks.uninstall()
        mem_peak = (int(torch.cuda.max_memory_allocated())
                    if args.device == "cuda" else 0)
        # the answers due: every sequence of the window, each ended
        answers = [(d, sc) for seq in win["finished"]
                   for d, sc in zip(out_dirs(seq), seq_scenes(seq, scenes))]
        samples = hooks.samples
        del win["finished"]
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        checks = judge.judge(answers, samples, scenes, cell, ctx)
        result = {
            "correct": checks["correct"],
            "attempted": checks["attempted"],
            "failed": checks["failed"],
            "metrics": {},
            "device": device_info(args.device, mem_peak),
        }
        frames_per_s = win["frames"] / win["seconds"]
        if args.trace:
            run = win["run"]
            for m in cell.per_layer:
                v = reader(m["name"])(run)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": float(v),
                                                    "unit": m["unit"]}
            tsum = run.trace
            result["device"]["busy_s"] = tsum["busy_s"] if tsum else 0.0
            result["device"]["window_s"] = tsum["wall_s"] if tsum else 0.0
            if tsum:
                result["breakdown"] = tsum["breakdown"]
        else:
            values = {"frames_per_s": frames_per_s, "setup_s": setup_s}
            for m in cell.end_to_end:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        result["window"] = {"seconds": win["seconds"],
                            "frames": win["frames"],
                            "frames_per_s": frames_per_s,
                            "sequences": len(answers),
                            "units": win["units"], "setup_s": setup_s,
                            "render_s": t_render, "warmup_s": t_warm,
                            "loop_work": {"warmup": warm_loops,
                                          "window": win["loop_work"]},
                            "control": args.control or None,
                            "trace": args.trace}
        if args.trace and win["run"].trace:
            result["window"]["traced_part"] = {
                "frames": win["run"].traced_frames,
                "seconds": win["run"].trace["wall_s"]}
        result["checks"] = checks["numbers"]
        return result, checks["lines"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def seq_scenes(seq, scenes):
    return scenes if len(getattr(seq, "scenes", [])) > 1 else scenes[:1]


def window(args, cell: Cell, ctx: Ctx, scenes, tmp: Path, hooks, trace):
    """Whole sequences back to back, each a new instance of the entry with
    its next RANSAC seed, until the first sequence boundary after
    ``args.seconds``.  With ``--trace 1`` one more sequence follows the
    window with the profiler on over the part that the files state (see
    ``traced``); every host-clock metric is read from the window, where
    the profiler never ran."""
    from types import SimpleNamespace

    from portbench.entries import HostSequence, loop_work, make_sequence

    ransac_seeds = iter(derive_seeds(args.seed, 1000, 2))
    finished, units = [], []
    frames = 0
    loops = [0, 0]
    stage_all: dict = {}
    hooks.window_on()
    sync(args.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        seq = make_sequence(ctx, scenes, next(ransac_seeds),
                            tmp / f"seq{len(finished)}")
        for k, (kind, fr) in enumerate(seq.plan):
            nfr = len(fr) * len(seq_scenes(seq, scenes))
            u0 = time.perf_counter()
            seq.run(k)
            sync(args.device)
            units.append({"kind": kind, "seconds": time.perf_counter() - u0,
                          "frames": nfr})
            frames += nfr
        if isinstance(seq, HostSequence):
            for st, (s, c) in seq.stage_totals().items():
                a = stage_all.setdefault(st, [0.0, 0])
                a[0] += s
                a[1] += c
        loops = [a + b for a, b in zip(loops, loop_work(seq))]
        seq.obj = None  # the answer is in its files; free its state
        finished.append(seq)
    seconds = time.perf_counter() - t0
    tsum, traced_frames = None, 0
    if args.trace:
        seq = make_sequence(ctx, scenes, next(ransac_seeds), tmp / "traced")
        tsum, traced_frames, whole = traced(args, cell, seq, scenes, hooks,
                                            trace)
        seq.obj = None
        if whole:
            finished.append(seq)
    hooks.window_off()
    run = SimpleNamespace(
        trace=tsum, traced_frames=traced_frames, k3_shapes=hooks.k3_shapes,
        units=units, stage_timers={k: tuple(v) for k, v in stage_all.items()},
        workload=args.workload)
    return {"seconds": seconds, "frames": frames, "finished": finished,
            "units": [[u["kind"], u["seconds"]] for u in units],
            "loop_work": loops, "run": run}


def traced(args, cell: Cell, seq, scenes, hooks, trace):
    """Run ``seq`` with the profiler on over the part the files state:
    ``trace`` in the configuration, or in the traffic where it differs
    there, is ``{"steps": [a, b]}``, from the sequence's a-th frame-tracker
    step to its b-th (inside a unit or across units).  The sequence stops
    at the end of the unit in which the part ends.  Returns (the reduced
    trace, the frames stepped in the part, whether the sequence ran to its
    end)."""
    a, b = map(int, cell.traffic.get("trace", cell.config["trace"])["steps"])
    prof = trace.Profiler(args.device == "cuda")
    base = hooks.steps
    state = {"done": False}

    def at_step(k):
        if k - base == a:
            hooks.trace_on()
            prof.start()
        elif k - base == b:
            prof.stop(f"frame steps {a}-{b}")
            hooks.trace_off()
            state["done"] = True

    hooks.on_step = at_step
    try:
        for k in range(len(seq.plan)):
            seq.run(k)
            if state["done"]:
                break
    finally:
        hooks.on_step = None
    sync(args.device)
    return (trace.summarize(prof), (b - a) * len(seq_scenes(seq, scenes)),
            k == len(seq.plan) - 1)


def device_info(device: str, mem_peak: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": mem_peak}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
