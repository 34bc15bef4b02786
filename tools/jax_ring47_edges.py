"""The JAX package's own keyframe-edge errors on ``chip_smoke.py``'s ring, on
the CPU: the reference figures beside which ``chip_smoke.py`` grades the
port's edges.

Renders ``chip_smoke.ring_spec()`` (the 47-frame 640x480 360-degree ring)
with the JAX package's ``generate_dataset``, runs it through the JAX
package's ``ScanSfM`` and ``SfMSystem`` at ``chip_smoke.SMOKE_OVERRIDES``
(process, finalize), and prints one JSON line per pipeline: keyframes,
loop edges, Sim(3) ATE over the trajectory's extent, and the median and
max rotation and direction errors (degrees) of every keyframe edge
against the ring's GT relative poses, by the JAX package's
``umeyama.edge_errors`` in float64.  The draws are the JAX package's own,
so a run of the port does not repeat them (tools/chip_ate_spread.py
measures the spread that the draws alone give on the card).

    JAX_PLATFORMS=cpu python tools/jax_ring47_edges.py [scan|host]

About 6 min (``scan``) and 9 min (``host``) on an 8-core CPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sfm_tpu import config as jconfig  # noqa: E402
from sfm_tpu.models import scan_pipeline as jsp, system as jsystem  # noqa: E402
from sfm_tpu.ops import umeyama  # noqa: E402
from sfm_tpu.utils.dataset import TempleRing  # noqa: E402
from sfm_tpu.utils.synthetic import (SyntheticRingSpec,  # noqa: E402
                                     generate_dataset)


def run(which: str, ds) -> dict:
    cfg = jconfig.load_config(None, overrides=cs.SMOKE_OVERRIDES)
    n = len(ds.records)
    t0 = time.perf_counter()
    if which == "scan":
        s = jsp.ScanSfM(ds.K, cfg, n_frames=n, chunk=32, p_cap=16384,
                        p_ba=1024)
    else:
        s = jsystem.SfMSystem(ds.K, cfg, gt_records=ds.records)
    for i in range(n):
        s.process(i, ds.records[i].img, ds.load_gray(i))
    s.finalize()
    gt = [cs._rel_pose(ds, s.kfs[e.i].frame_idx, s.kfs[e.j].frame_idx)
          for e in s.edges]

    def f64(xs):
        return jnp.asarray(np.stack(xs).astype(np.float64))

    rot, dirn = (np.asarray(a) for a in umeyama.edge_errors(
        f64([e.R_ji for e in s.edges]), f64([e.t_ji for e in s.edges]),
        f64([g[0] for g in gt]), f64([g[1] for g in gt])))
    est = np.stack([k.center for k in s.kfs]).astype(np.float64)
    gtc = np.stack([ds.records[k.frame_idx].center for k in s.kfs])
    res = umeyama.ate(jnp.asarray(est), jnp.asarray(gtc), with_scale=True)
    extent = float(np.linalg.norm(gtc - gtc.mean(0), axis=1).max())
    return {"pipeline": which, "keyframes": len(s.kfs),
            "loop_edges": [(e.i, e.j) for e in s.edges if e.is_loop],
            "ate_ratio": float(res["rmse"]) / extent,
            "edge_count": len(rot),
            "edge_rot_median_deg": float(np.median(rot)),
            "edge_rot_max_deg": float(rot.max()),
            "edge_dir_median_deg": float(np.median(dirn)),
            "edge_dir_max_deg": float(dirn.max()),
            "wall_s": time.perf_counter() - t0}


def main() -> int:
    which = sys.argv[1:] or ["scan", "host"]
    spec = SyntheticRingSpec(**dataclasses.asdict(cs.ring_spec()))
    with tempfile.TemporaryDirectory(prefix="jax_ring47_") as tmp:
        generate_dataset(Path(tmp), spec, name_prefix="templeR")
        ds = TempleRing.from_dir(Path(tmp))
        for w in which:
            print(json.dumps(run(w, ds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
