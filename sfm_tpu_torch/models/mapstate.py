"""Host-side map / keyframe bookkeeping.

Counterpart of sfm_tpu/models/mapstate.py (reference: python/src/
templering_sfm.py:476-526 ``Keyframe``/``MapPoint``/``MapState``,
601-608 edges; cpp/src/templering_sfm.cpp:766-798).  Plain numpy: the
``Keyframe`` and ``Edge`` records that ``ScanSfM.finalize`` hands to
export and evaluation, and the ``MapState`` of the host-driven
``SfMSystem``, whose index bookkeeping lives in amortized-growth numpy
buffers (every numeric batch goes to the device as padded fixed-shape
tensors).
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
    pyr: tuple | None = None  # device image pyramid kept for loop verify
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


def _grow(arr: np.ndarray, n_needed: int) -> np.ndarray:
    n = len(arr)
    if n_needed <= n:
        return arr
    while n < n_needed:
        n *= 2
    out = np.zeros((n, *arr.shape[1:]), arr.dtype)
    out[: len(arr)] = arr
    return out


class MapState:
    """Sparse map: track-id -> point index, world points, observations.

    ref: py:497-526 / cpp:781-798. Observations live in flat amortized
    arrays (kf_id, pid, uv) — the natural layout for the batched BA
    linearization (SURVEY §2.6 'obs table').
    """

    def __init__(self):
        self.tid2pid: dict[int, int] = {}
        self._X = np.zeros((1024, 3))
        self._point_tid = np.zeros(1024, np.int64)
        self._n_points = 0
        self._obs_kf = np.zeros(4096, np.int32)
        self._obs_pid = np.zeros(4096, np.int32)
        self._obs_uv = np.zeros((4096, 2))
        self._n_obs = 0
        # vectorized tid -> pid lookup
        self._pid_of_tid = np.full(4096, -1, np.int64)

    # -- tid -> pid -----------------------------------------------------
    def _ensure_tid(self, tid: int) -> None:
        if tid >= len(self._pid_of_tid):
            n = len(self._pid_of_tid)
            while n <= tid:
                n *= 2
            grown = np.full(n, -1, np.int64)
            grown[: len(self._pid_of_tid)] = self._pid_of_tid
            self._pid_of_tid = grown

    def pids_for(self, tids: np.ndarray) -> np.ndarray:
        """Vectorized tid -> pid (-1 when unmapped / invalid tid)."""
        tids = np.asarray(tids, np.int64)
        safe = np.clip(tids, 0, len(self._pid_of_tid) - 1)
        out = self._pid_of_tid[safe]
        out[(tids < 0) | (tids >= len(self._pid_of_tid))] = -1
        return out

    def rebuild_lookup(self) -> None:
        """Recompute the vectorized tid->pid table from point tids (used
        by checkpoint restore)."""
        self._pid_of_tid = np.full(4096, -1, np.int64)
        for pid in range(self._n_points):
            tid = int(self._point_tid[pid])
            self._ensure_tid(tid)
            self._pid_of_tid[tid] = pid

    # -- points ----------------------------------------------------------
    def add_point(self, tid: int, Xw: np.ndarray) -> int:
        pid = self._n_points
        self._X = _grow(self._X, pid + 1)
        self._point_tid = _grow(self._point_tid, pid + 1)
        self._X[pid] = Xw
        self._point_tid[pid] = tid
        self._n_points += 1
        self.tid2pid[tid] = pid
        self._ensure_tid(tid)
        self._pid_of_tid[tid] = pid
        return pid

    def xyz(self) -> np.ndarray:
        """(N,3) view of the live points (treat as read-only; use
        set_xyz to write back)."""
        return self._X[: self._n_points]

    def set_xyz(self, X: np.ndarray) -> None:
        self._X[: self._n_points] = X

    @property
    def num_points(self) -> int:
        return self._n_points

    @property
    def point_tid(self) -> list[int]:
        return [int(t) for t in self._point_tid[: self._n_points]]

    # -- observations -----------------------------------------------------
    def add_obs(self, kf_id: int, pid: int, uv: np.ndarray) -> None:
        n = self._n_obs
        self._obs_kf = _grow(self._obs_kf, n + 1)
        self._obs_pid = _grow(self._obs_pid, n + 1)
        self._obs_uv = _grow(self._obs_uv, n + 1)
        self._obs_kf[n] = kf_id
        self._obs_pid[n] = pid
        self._obs_uv[n] = uv
        self._n_obs = n + 1

    def add_obs_batch(self, kf_id: int, pids: np.ndarray,
                      uvs: np.ndarray) -> None:
        k = len(pids)
        if k == 0:
            return
        n = self._n_obs
        self._obs_kf = _grow(self._obs_kf, n + k)
        self._obs_pid = _grow(self._obs_pid, n + k)
        self._obs_uv = _grow(self._obs_uv, n + k)
        self._obs_kf[n : n + k] = kf_id
        self._obs_pid[n : n + k] = pids
        self._obs_uv[n : n + k] = uvs
        self._n_obs = n + k

    @property
    def num_obs(self) -> int:
        return self._n_obs

    def obs_arrays(self):
        """(M,) kf ids, (M,) pids, (M,2) uv — live views, no copying."""
        n = self._n_obs
        return self._obs_kf[:n], self._obs_pid[:n], self._obs_uv[:n]
