"""Host-side keyframe / pose-graph-edge records.

Counterpart of the ``Keyframe`` and ``Edge`` records of
sfm_tpu/models/mapstate.py (reference: python/src/templering_sfm.py:
476-526, 601-608).  Plain numpy dataclasses: what ``ScanSfM.finalize``
hands to export and evaluation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

@dataclasses.dataclass
class Keyframe:
    """One keyframe: pose + a snapshot of the track table.

    ``ids/uv/valid`` are the (T,)-shaped tracker snapshot — a track alive
    in two keyframes occupies the same slot in both, so correspondence
    between keyframes is a slot-aligned mask (no matching pass needed).
    """

    kf_id: int
    frame_idx: int
    img_name: str
    R_cw: np.ndarray  # (3,3)
    t_cw: np.ndarray  # (3,)
    ids: np.ndarray  # (T,) i32
    uv: np.ndarray  # (T,2) f32
    valid: np.ndarray  # (T,) bool
    desc: np.ndarray | None = None  # (D,) global descriptor for loop closure
    orb: tuple | None = None  # (xy, desc, valid) oriented binary features

    @property
    def pose_wc(self):
        Rwc = self.R_cw.T
        return Rwc, -Rwc @ self.t_cw

    @property
    def center(self):
        return self.t_cw


@dataclasses.dataclass
class Edge:
    """Pose-graph edge i->j (x_j = R_ji x_i + t_ji). ref py:601-608 /
    cpp PGEdge:819-826."""

    i: int
    j: int
    R_ji: np.ndarray
    t_ji: np.ndarray
    inliers: int = 0
    is_loop: bool = False
    w_rot: float = 1.0
    w_trans: float = 1.0
    # measured relative scale s_i/s_j for Sim(3) pose-graph mode
    # (1.0 = scale-consistent; loop closures may reveal monocular drift)
    s_rel: float = 1.0
