"""What the harness reads from the program's timed path besides its files.

Wrappers around module attributes of the port, installed for a run
and removed after it; each calls the program's own function and keeps a
copy of what it needs, nothing more:

- ``sfm_tpu_torch.ops.klt.lk_track_fb`` (every tracker pass: the frame
  loop's and the loop verifications'): during the window a sample of the
  calls, drawn from the run's seed, keeps the first level of both
  pyramids, the tracks and mask handed in and the positions and gate
  handed back (device copies, taken without a pull), for the reference to
  track again from the raw frames once the window has closed;
- ``sfm_tpu_torch.ops.kernels.lk_kernels.lk_level_fused`` (K3): during
  the traced part each launch's shapes, for its roofline share;
- ``sfm_tpu_torch.models.tracker.step`` and ``step_scenes`` (the frame
  loop's tracker step, one a frame for all scenes): counted in the
  window, and each count handed to ``on_step`` before the step runs, so
  that a traced part can start and end at a stated frame step inside a
  unit.  Only the outermost of the two counts: ``step`` is the one-scene
  case of ``step_scenes`` and calls it through the module.
"""

from __future__ import annotations

import random

from portbench.roofline import LkLevelShape


class Hooks:
    def __init__(self, seed: int, p: float):
        self.rng = random.Random(seed)
        self.p = p
        self.samples: list[dict] = []
        self.k3_shapes: list[LkLevelShape] = []
        self._window = False
        self._trace = False
        self._calls = 0
        self.steps = 0  # frame-tracker steps counted in the window
        self.on_step = None
        self._depth = 0  # tracker steps in progress: ``step`` nests one
        self._saved = []

    def install(self) -> None:
        from sfm_tpu_torch.models import tracker
        from sfm_tpu_torch.ops import klt
        from sfm_tpu_torch.ops.kernels import lk_kernels

        track, level = klt.lk_track_fb, lk_kernels.lk_level_fused
        self._saved = [(klt, "lk_track_fb", track),
                       (lk_kernels, "lk_level_fused", level),
                       (tracker, "step", tracker.step),
                       (tracker, "step_scenes", tracker.step_scenes)]

        def counted(fn):
            def step(*a, **kw):
                if self._window and self._depth == 0:
                    self.steps += 1
                    if self.on_step is not None:
                        self.on_step(self.steps)
                self._depth += 1
                try:
                    return fn(*a, **kw)
                finally:
                    self._depth -= 1
            return step

        def lk_track_fb(pyr0, pyr1, pts, valid, *a, **kw):
            out = track(pyr0, pyr1, pts, valid, *a, **kw)
            if self._window:
                self._calls += 1
                if self._calls == 1 or self.rng.random() < self.p:
                    self.samples.append(_sample(pyr0, pyr1, pts, valid, out,
                                                a, kw))
            return out

        def lk_level_fused(img0, img1, p0_l, v, iters, radius, min_det,
                           margin=lk_kernels.MARGIN):
            if self._trace:
                S = img0.shape[0] if img0.dim() == 3 else 1
                self.k3_shapes.append(LkLevelShape(
                    tracks=p0_l.numel() // 2, height=img0.shape[-2],
                    width=img0.shape[-1], radius=int(radius),
                    margin=int(margin), iters=int(iters),
                    img_bytes=img0.element_size(), images=2 * S))
            return level(img0, img1, p0_l, v, iters, radius, min_det, margin)

        klt.lk_track_fb = lk_track_fb
        lk_kernels.lk_level_fused = lk_level_fused
        tracker.step = counted(tracker.step)
        tracker.step_scenes = counted(tracker.step_scenes)

    def uninstall(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    def window_on(self) -> None:
        self._window = True

    def window_off(self) -> None:
        self._window = False

    def trace_on(self) -> None:
        self._trace = True

    def trace_off(self) -> None:
        self._trace = False


def _arg(a, kw, i: int, name: str, default=None):
    return a[i] if len(a) > i else kw.get(name, default)


def _sample(pyr0, pyr1, pts, valid, out, a, kw) -> dict:
    import torch

    def copy(x):
        return torch.as_tensor(x).detach().clone()

    return {"img0": copy(pyr0[0]), "img1": copy(pyr1[0]), "pts": copy(pts),
            "valid": copy(valid), "fwd": copy(out[0]), "ok": copy(out[1]),
            "levels": int(_arg(a, kw, 0, "levels")),
            "iters": int(_arg(a, kw, 1, "iters")),
            "radius": int(_arg(a, kw, 2, "radius")),
            "fb_thresh": float(_arg(a, kw, 3, "fb_thresh", 1.0))}
