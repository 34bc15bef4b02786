"""Config system: dataclass tree + JSON loader compatible with the
reference's ``config.json`` schema.

The reference merges a ``common`` section with a per-implementation
section (``python`` or ``cpp``) and then applies CLI precedence
(reference: python/src/templering_sfm.py:341-390 ``_deep_merge``/
``_cfg_get``/``_first_not_none`` and py:1401-1531; cpp:57-106 ``jpick``
typed getters, cpp:1631-1676). We keep that contract: a reference
``config.json`` loads unmodified; precedence is
CLI > ``tpu`` section > ``cpp`` > ``python`` > ``common`` > defaults.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from pathlib import Path
from typing import Any, Mapping, Sequence


class TranslationMode(str, enum.Enum):
    """ref: py:250-254."""

    FULL = "full"
    DIR = "dir"
    ROT = "rot"


class ExportGeometry(str, enum.Enum):
    """ref: py:257-261, cpp:42-51 (``mesh_stereo`` aliases to MESH)."""

    NONE = "none"
    POINTCLOUD = "pointcloud"
    MESH = "mesh"
    MESH_STEREO = "mesh_stereo"
    BOTH = "both"


@dataclasses.dataclass(frozen=True)
class KLTConfig:
    """ref: py:275-284 / cpp LKConfig:307-316 / config.json "klt"."""

    max_tracks: int = 2200
    min_tracks: int = 900
    quality: float = 0.01
    min_distance: int = 8
    block_size: int = 7
    pyr_levels: int = 3
    win_radius: int = 5
    iters: int = 10
    fb_thresh: float = 1.0


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """ref: config.json "keyframe", py:315-334."""

    min_inliers: int = 200
    min_gap: int = 1
    parallax_px: float = 18.0


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """E-matrix RANSAC. The reference hard-codes (2500 iters, 1e-3, 60)
    at cpp:1739; we expose it and default to a TPU-friendly batched
    hypothesis count (BASELINE config 4 scales this to 4096)."""

    num_hypotheses: int = 1024
    sampson_thresh: float = 1e-3  # in K-normalized coordinates, cpp:672
    min_inliers: int = 60
    seed: int = 12345  # determinism, mirrors mt19937(12345) cpp:657


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """ref: py:287-294 (window 5/200/6) and cpp:811-817 (window 6/600/5).
    Default = the C++ (Schur, analytic-Jacobian) flavor per SURVEY §7."""

    window: int = 6
    iters: int = 5
    max_points: int = 600
    huber_delta: float = 3.0
    lambda0: float = 1e-3
    update_points: bool = True  # cpp never back-substitutes (cpp:1059-1060)
    # final full-problem BA after the frame loop (all keyframes+points);
    # 0 disables. The reference has no global refinement — this is where
    # the batched TPU Schur solver pays off on accuracy.
    global_iters: int = 10


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """ref: py:297-303 (ORB flavor) + cpp:1822-1866 (descriptor flavor)."""

    enabled: bool = True
    # "descriptor": cpp semantics (32x32 global descriptor + LK verify)
    # "orb": python semantics (oriented binary features + ratio matching)
    method: str = "descriptor"
    # verify candidates INSIDE the device chunk program (descriptor
    # method only): a cond-gated LK-retrack + PnP in the keyframe branch
    # keeps chunks autonomous — no per-candidate host round-trips
    # (~0.1 s each on the relay). Ignored by the host pipeline; forced
    # off in the vmapped multi-scene runner, where lax.cond becomes a
    # select and every scene would pay the verification every keyframe.
    device_verify: bool = True
    min_kf_gap: int = 6
    score_thresh: float = 0.94  # cpp:1831
    min_tracked: int = 120  # cpp:1856
    ransac_iters: int = 4096  # cpp uses 4000 at cpp:1857
    ransac_thresh: float = 2e-3
    min_inliers: int = 100  # cpp:1858
    every_kf: int = 1
    # ORB-flavor knobs (ref py:297-303)
    top_k: int = 5
    min_matches: int = 80
    max_keypoints: int = 512


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """ref: py:305-313 full-SE(3) LM; cpp:1131-1197 center-only linear."""

    # "se3" (python reference semantics), "centers" (cpp reference
    # semantics), or "sim3" (7-dof with per-keyframe scale — monocular
    # scale-drift correction over long loops; beyond the reference)
    mode: str = "se3"
    iters: int = 10
    lambda0: float = 0.01
    eps: float = 1e-6
    w_rot: float = 1.0
    w_trans: float = 1.0
    loop_weight: float = 2.0  # cpp:1160
    every_kf: int = 1


@dataclasses.dataclass(frozen=True)
class StereoMeshConfig:
    """ref: py:264-273 / config.json python.mesh_stereo."""

    kf_pair: tuple = (0, 1)
    step: int = 4
    num_disparities: int = 128
    block_size: int = 7
    disp_min: float = 1.0
    disp_jump: float = 3.0
    z_max_percentile: float = 98.0
    # semi-global cost aggregation (StereoSGBM semantics, ref py:1168);
    # False = plain block matcher
    sgm: bool = True


@dataclasses.dataclass(frozen=True)
class SparseMeshConfig:
    """ref: config.json cpp.mesh_sparse (Delaunay mesher cpp:1384-1461)."""

    kf: int = 0
    max_points: int = 2500
    grid_px: int = 4
    max_edge_px: float = 80.0


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Top-level config; ref: py:315-334 SystemConfig + config.json."""

    frames: int = 12
    use_gt_scale: bool = False
    translation_mode: TranslationMode = TranslationMode.DIR
    loop_every_kf: int = 1
    posegraph_every_kf: int = 1
    export_geometry: ExportGeometry = ExportGeometry.POINTCLOUD
    visuals: bool = False
    dtype: str = "float32"
    klt: KLTConfig = dataclasses.field(default_factory=KLTConfig)
    keyframe: KeyframeConfig = dataclasses.field(default_factory=KeyframeConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    pose_graph: PoseGraphConfig = dataclasses.field(default_factory=PoseGraphConfig)
    mesh_stereo: StereoMeshConfig = dataclasses.field(default_factory=StereoMeshConfig)
    mesh_sparse: SparseMeshConfig = dataclasses.field(default_factory=SparseMeshConfig)


# ---------------------------------------------------------------------------
# JSON loading with the reference's section precedence.
# ---------------------------------------------------------------------------


def _deep_merge(base: Mapping, over: Mapping) -> dict:
    """ref: py:341-350."""
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _merged_view(raw: Mapping) -> dict:
    """Merge sections: common <- python <- cpp <- tpu (later wins)."""
    merged: dict = {}
    for section in ("common", "python", "cpp", "tpu"):
        if section in raw and isinstance(raw[section], Mapping):
            merged = _deep_merge(merged, raw[section])
    # also allow a flat (sectionless) config
    flat = {k: v for k, v in raw.items() if k not in ("common", "python", "cpp", "tpu")}
    return _deep_merge(merged, flat)


def _get(d: Mapping, path: str, default=None):
    """Dotted-path getter, ref: py:377-383."""
    cur: Any = d
    for part in path.split("."):
        if not isinstance(cur, Mapping) or part not in cur:
            return default
        cur = cur[part]
    return cur


_KNOB_ALIASES = {
    # ref py:1431-1438 knob aliasing
    "klt.win_radius": ("klt.win_radius", "klt.win_size"),
    "klt.pyr_levels": ("klt.pyr_levels", "klt.max_level"),
    "loop": ("loop", "loop_closure"),
    "pose_graph": ("pose_graph", "pg"),
}


def _first_not_none(*vals):
    for v in vals:
        if v is not None:
            return v
    return None


def _sub(cfg_cls, merged: Mapping, section_names: Sequence[str], extra: Mapping | None = None):
    section = None
    for name in section_names:
        if isinstance(_get(merged, name), Mapping):
            section = _get(merged, name)
            break
    section = dict(section or {})
    if extra:
        section.update({k: v for k, v in extra.items() if v is not None})
    fields = {f.name: f for f in dataclasses.dataclass_fields(cfg_cls)} if hasattr(
        dataclasses, "dataclass_fields"
    ) else {f.name: f for f in dataclasses.fields(cfg_cls)}
    kwargs = {}
    for name in fields:
        if name in section and section[name] is not None:
            kwargs[name] = section[name]
    # aliases
    if cfg_cls is KLTConfig:
        if "win_radius" not in kwargs and "win_size" in section:
            ws = section["win_size"]
            if isinstance(ws, Sequence):
                ws = ws[0]
            # invert the reference's win_size = 2r+1 relation (ref py:1433)
            kwargs["win_radius"] = (int(ws) - 1) // 2
        if "pyr_levels" not in kwargs and "max_level" in section:
            kwargs["pyr_levels"] = int(section["max_level"])
    if cfg_cls is LoopConfig and "min_inliers" in section:
        kwargs["min_inliers"] = section["min_inliers"]
    if cfg_cls is BAConfig and "lambda" in section:
        kwargs["lambda0"] = section["lambda"]
    if cfg_cls is StereoMeshConfig and "kf_pair" in kwargs:
        kwargs["kf_pair"] = tuple(kwargs["kf_pair"])
    return cfg_cls(**kwargs)


def load_config(path: str | Path | None = None, overrides: Mapping | None = None) -> SystemConfig:
    """Load a SystemConfig from a reference-schema config.json.

    ``overrides`` is a flat mapping of dotted paths (e.g. from CLI flags)
    that takes precedence over every file section; missing file is fine
    (ref tolerates it too, py:364-367 / cpp:1613-1619).
    """
    raw: dict = {}
    if path is not None and Path(path).exists():
        raw = json.loads(Path(path).read_text())
    merged = _merged_view(raw)
    ov = dict(overrides or {})

    def top(name, alias=None, cast=None):
        v = _first_not_none(
            ov.get(name),
            _get(merged, f"system.{name}"),
            _get(merged, f"outputs.{name}"),
            _get(merged, name),
            _get(merged, f"system.{alias}") if alias else None,
        )
        if v is not None and cast is not None:
            v = cast(v)
        return v

    kwargs: dict = {}
    for name, cast in (
        ("frames", int),
        ("use_gt_scale", bool),
        ("loop_every_kf", int),
        ("posegraph_every_kf", int),
        ("visuals", bool),
        ("dtype", str),
    ):
        v = top(name, cast=cast)
        if v is not None:
            kwargs[name] = v
    tm = top("translation_mode")
    if tm is not None:
        kwargs["translation_mode"] = TranslationMode(tm)
    eg = top("export_geometry")
    if eg is not None:
        kwargs["export_geometry"] = ExportGeometry(eg)

    def sec_overrides(prefix):
        plen = len(prefix) + 1
        return {k[plen:]: v for k, v in ov.items() if k.startswith(prefix + ".")}

    kwargs["klt"] = _sub(KLTConfig, merged, ("klt",), sec_overrides("klt"))
    kwargs["keyframe"] = _sub(KeyframeConfig, merged, ("keyframe",), sec_overrides("keyframe"))
    kwargs["ransac"] = _sub(RansacConfig, merged, ("ransac",), sec_overrides("ransac"))
    kwargs["ba"] = _sub(BAConfig, merged, ("ba",), sec_overrides("ba"))
    kwargs["loop"] = _sub(LoopConfig, merged, ("loop", "loop_closure"), sec_overrides("loop"))
    kwargs["pose_graph"] = _sub(
        PoseGraphConfig, merged, ("pose_graph", "pg"), sec_overrides("pose_graph")
    )
    kwargs["mesh_stereo"] = _sub(
        StereoMeshConfig, merged, ("mesh_stereo",), sec_overrides("mesh_stereo")
    )
    kwargs["mesh_sparse"] = _sub(
        SparseMeshConfig, merged, ("mesh_sparse",), sec_overrides("mesh_sparse")
    )
    return SystemConfig(**kwargs)
