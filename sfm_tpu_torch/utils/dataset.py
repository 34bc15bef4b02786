"""Middlebury TempleRing dataset loading (par/ang parsing, PNG/PGM images,
zip ingestion, K-from-YAML).

ref: python/src/templering_sfm.py:153-244 (``MiddleburyRecord``,
``TempleRing._read_par/_read_ang/from_zip/from_dir``, ``load_K_yaml``),
cpp/src/templering_sfm.cpp:111-152 (``read_par``/``read_ang``),
cpp/include/pgm_io.hpp:36-54 (binary P5 reader),
cpp/tools/convert_templering_png_to_pgm.py (PNG→PGM).

Par-file line format: ``imgname k11..k33 r11..r33 t1 t2 t3`` where
(R, t) are world→camera so that x ~ K (R X + t); the camera-to-world
pose is (Rᵀ, −Rᵀt) (ref py:164-166).
"""

from __future__ import annotations

import dataclasses
import re
import zipfile
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class MiddleburyRecord:
    """One calibrated image. ref: py:153-166."""

    img: str
    K: np.ndarray  # (3,3)
    R: np.ndarray  # (3,3) world->camera
    t: np.ndarray  # (3,)

    @property
    def pose_cw(self):
        """Camera-to-world (R_cw, t_cw) = (Rᵀ, −Rᵀt)."""
        Rcw = self.R.T
        return Rcw, -Rcw @ self.t

    @property
    def center(self):
        """Camera center in world coords C = −Rᵀt (ate_keyframes.cpp:193-196)."""
        return -self.R.T @ self.t


@dataclasses.dataclass(frozen=True)
class MiddleburyAngles:
    """ref: py:169-172; ang file line: ``lat lon imgname``."""

    img: str
    lat: float
    lon: float


def read_par(path: str | Path) -> list[MiddleburyRecord]:
    """Parse templeR_par.txt: first line count, then per-image 21 doubles.
    ref: py:196-209 / cpp:120-140."""
    lines = Path(path).read_text().split("\n")
    n = int(lines[0].split()[0])
    recs = []
    for line in lines[1 : n + 1]:
        parts = line.split()
        if len(parts) < 22:
            continue
        img = parts[0]
        vals = np.array([float(x) for x in parts[1:22]], dtype=np.float64)
        K = vals[0:9].reshape(3, 3)
        R = vals[9:18].reshape(3, 3)
        t = vals[18:21]
        recs.append(MiddleburyRecord(img=img, K=K, R=R, t=t))
    return recs


def read_ang(path: str | Path) -> list[MiddleburyAngles]:
    """Parse templeR_ang.txt: ``lat lon imgname`` per line. ref: py:211-218 /
    cpp:142-152."""
    out = []
    for line in Path(path).read_text().split("\n"):
        parts = line.split()
        if len(parts) >= 3:
            out.append(MiddleburyAngles(img=parts[2], lat=float(parts[0]), lon=float(parts[1])))
    return out


def read_pgm(path: str | Path) -> np.ndarray:
    """Binary P5 PGM reader with comment skipping (ref: pgm_io.hpp:36-54)."""
    data = Path(path).read_bytes()
    # header tokens: magic, width, height, maxval; comments start with '#'
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P5":
        raise ValueError(f"not a binary PGM: {path}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    if maxval > 255:
        raise ValueError("16-bit PGM not supported")
    img = np.frombuffer(data[i : i + w * h], dtype=np.uint8).reshape(h, w)
    return img.copy()


def write_pgm(path: str | Path, img: np.ndarray) -> None:
    """Binary P5 PGM writer (ref: convert_templering_png_to_pgm.py:12-26)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def write_ppm(path: str | Path, rgb: np.ndarray) -> None:
    """Binary P6 PPM writer (ref: pgm_io.hpp:56-61)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())


def gray_to_rgb(gray: np.ndarray) -> np.ndarray:
    """Grayscale -> RGB expansion (ref: pgm_io.hpp:63-74)."""
    return np.repeat(np.asarray(gray)[..., None], 3, axis=-1)


def load_image_gray(path: str | Path) -> np.ndarray:
    """Load PNG/PGM as uint8 grayscale (BT.601 luma for RGB, matching
    cv2.cvtColor BGR2GRAY semantics at py:1023)."""
    path = Path(path)
    if path.suffix.lower() == ".pgm":
        return read_pgm(path)
    from PIL import Image

    im = Image.open(path)
    if im.mode != "L":
        im = im.convert("L")
    return np.asarray(im, dtype=np.uint8)


def load_K_yaml(path: str | Path) -> np.ndarray:
    """Parse a 3x3 camera matrix from an OpenCV-style YAML (ref: py:234-244,
    cv2.FileStorage). Minimal parser: finds the first ``data:`` list."""
    text = Path(path).read_text()
    m = re.search(r"data\s*:\s*\[([^\]]+)\]", text)
    if not m:
        raise ValueError(f"no 'data: [...]' matrix in {path}")
    vals = [float(x) for x in m.group(1).replace("\n", " ").split(",")]
    return np.array(vals[:9], dtype=np.float64).reshape(3, 3)


@dataclasses.dataclass
class TempleRing:
    """Dataset handle. ref: py:175-231."""

    root: Path
    records: list[MiddleburyRecord]
    angles: list[MiddleburyAngles]

    @classmethod
    def from_dir(cls, root: str | Path) -> "TempleRing":
        """ref: py:228-231. Accepts the dataset dir containing
        templeR_par.txt / templeR_ang.txt and the PNG (or PGM) images."""
        root = Path(root)
        par = _find_one(root, "*_par.txt")
        ang = _find_one(root, "*_ang.txt", required=False)
        return cls(
            root=root,
            records=read_par(par),
            angles=read_ang(ang) if ang else [],
        )

    @classmethod
    def from_zip(cls, zip_path: str | Path, extract_to: str | Path) -> "TempleRing":
        """ref: py:220-226."""
        extract_to = Path(extract_to)
        extract_to.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(extract_to)
        # dataset may be nested one level down
        par_candidates = sorted(extract_to.rglob("*_par.txt"))
        if not par_candidates:
            raise FileNotFoundError(f"no *_par.txt inside {zip_path}")
        return cls.from_dir(par_candidates[0].parent)

    def image_path(self, img_name: str) -> Path:
        p = self.root / img_name
        if p.exists():
            return p
        pgm = self.root / "templeRing_pgm" / (Path(img_name).stem + ".pgm")
        if pgm.exists():
            return pgm
        raise FileNotFoundError(img_name)

    def load_gray(self, idx: int) -> np.ndarray:
        return load_image_gray(self.image_path(self.records[idx].img))

    @property
    def K(self) -> np.ndarray:
        return self.records[0].K

    def angles_for(self, img_name: str) -> tuple[float, float]:
        for a in self.angles:
            if a.img == img_name:
                return a.lat, a.lon
        return float("nan"), float("nan")

    def __len__(self) -> int:
        return len(self.records)


def _find_one(root: Path, pattern: str, required: bool = True) -> Path | None:
    hits = sorted(root.glob(pattern))
    if not hits:
        if required:
            raise FileNotFoundError(f"{pattern} not found in {root}")
        return None
    return hits[0]
