"""The entries of the port that a window drives, cut into units.

A sequence is one new instance of the entry, from its construction through
the last frame to ``finalize()`` and ``export()`` into the run's
temporary directory.  Its ``plan`` lists its units in order, each a kind
and the frames it steps; ``run(k)`` runs unit ``k``.  A unit ends where
the entry hands the host a result it has pulled from the card, so the host
clock at a unit's end holds the device work of the unit:

- ``ScanSfM``: one ``chunk`` per ``chunk`` frames (``process`` of the
  frame that fills the chunk runs it and pulls its metrics), the first
  with the bootstrap frame; then ``finalize`` (the tail chunk, the drain
  and the refinement, then ``export``);
- ``SfMSystem``: one ``frame`` per ``process`` (each stage synchronises),
  then ``finalize`` (the global BA, then ``export``);
- the multi-scene runner: one ``batch``, a whole ``run_scenes_scan``
  call over every scene, finalize and export included.

The program is imported here and only here, through these entry points.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


def with_seed(cfg, seed: int):
    """``cfg`` with the RANSAC seed ``seed``."""
    return dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, seed=int(seed)))


class ScanSequence:
    def __init__(self, ctx, scene: dict, seed: int, out_dir: Path):
        self.ctx, self.scene, self.seed, self.out = ctx, scene, seed, out_dir
        n, c = len(scene["frames"]), ctx.chunk
        cuts = list(range(c, n, c))  # the frames whose process() flushes
        plan, a = [], 0
        for b in cuts:
            plan.append(("chunk", list(range(a, b + 1))))
            a = b + 1
        plan.append(("finalize", list(range(a, n))))
        self.plan = plan
        self.obj = None

    def run(self, k: int) -> None:
        from sfm_tpu_torch.models.scan_pipeline import ScanSfM

        ctx, sc = self.ctx, self.scene
        if self.obj is None:
            self.obj = ScanSfM(sc["K"], with_seed(ctx.cfg, self.seed),
                               n_frames=len(sc["frames"]), chunk=ctx.chunk,
                               p_cap=ctx.p_cap, p_ba=ctx.p_ba,
                               device=ctx.device)
        kind, frames = self.plan[k]
        for i in frames:
            self.obj.process(i, sc["names"][i], sc["images"][i])
        if kind == "finalize":
            self.obj.finalize()
            self.obj.export(self.out)


class HostSequence:
    def __init__(self, ctx, scene: dict, seed: int, out_dir: Path):
        self.ctx, self.scene, self.seed, self.out = ctx, scene, seed, out_dir
        n = len(scene["frames"])
        self.plan = [("frame", [i]) for i in range(n)] + [("finalize", [])]
        self.obj = None

    def run(self, k: int) -> None:
        from sfm_tpu_torch.models.system import SfMSystem

        ctx, sc = self.ctx, self.scene
        if self.obj is None:
            self.obj = SfMSystem(sc["K"], with_seed(ctx.cfg, self.seed),
                                 device=ctx.device)
        kind, frames = self.plan[k]
        for i in frames:
            self.obj.process(i, sc["names"][i], sc["images"][i])
        if kind == "finalize":
            self.obj.finalize()
            self.obj.export(self.out)

    def stage_totals(self) -> dict:
        """{stage: (seconds, calls)} of the instance's stage timers."""
        if self.obj is None:
            return {}
        t = self.obj.timers
        return {k: (t.totals[k], t.counts[k]) for k in t.totals}


class ScenesBatch:
    """All scenes through ``run_scenes_scan`` in one call."""

    def __init__(self, ctx, scenes: list, seed: int, out_dir: Path):
        self.ctx, self.scenes, self.seed, self.out = ctx, scenes, seed, out_dir
        n = len(scenes[0]["frames"])
        self.plan = [("batch", list(range(n)))]
        self.obj = None

    def run(self, k: int) -> None:
        from sfm_tpu_torch.parallel.multi_scan import run_scenes_scan

        ctx = self.ctx
        self.obj = run_scenes_scan(
            [s["dataset"] for s in self.scenes], ctx.cfg,
            frames=len(self.scenes[0]["frames"]), chunk=ctx.chunk,
            p_cap=ctx.p_cap, p_ba=ctx.p_ba, seed=int(self.seed),
            images=[s["images"] for s in self.scenes], device=ctx.device,
            out_dirs=[self.out / f"scene{s}" for s in range(len(self.scenes))])

    def out_dirs(self) -> list[Path]:
        return [self.out / f"scene{s}" for s in range(len(self.scenes))]


ENTRIES = {"ScanSfM": ScanSequence, "SfMSystem": HostSequence}


def make_sequence(ctx, scenes: list, seed: int, out_dir: Path):
    """One sequence of the configuration's entry over ``scenes``: the
    multi-scene runner for more than one scene (its entry is ``ScanSfM``),
    else the entry itself over scene 0."""
    if len(scenes) > 1:
        if ctx.entry != "ScanSfM":
            raise ValueError("the multi-scene runner takes ScanSfM's "
                             f"configuration, not {ctx.entry}'s")
        return ScenesBatch(ctx, scenes, seed, out_dir)
    return ENTRIES[ctx.entry](ctx, scenes[0], seed, out_dir)


def loop_work(seq) -> list[int]:
    """[host loop verifications, loop edges] of a sequence that has run,
    summed over its scenes: whether its loop stages had work."""
    obj = seq.obj
    views = obj["views"] if isinstance(seq, ScenesBatch) else [obj]
    return [sum(getattr(v, "host_verifications", 0) for v in views),
            sum(len(getattr(v, "loop_edges", [])) for v in views)]


def out_dirs(seq) -> list[Path]:
    """The export directory of each scene of a finished sequence."""
    return seq.out_dirs() if isinstance(seq, ScenesBatch) else [seq.out]
