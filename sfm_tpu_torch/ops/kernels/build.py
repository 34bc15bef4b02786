"""Build and load the hand-written CUDA kernels.

The sources under ``sfm_tpu_torch/csrc/`` have a plain C interface and
include no PyTorch header, so ``nvcc`` compiles each in a few seconds.
At first use every ``.cu`` file is compiled to an object file (one ``nvcc``
process per source, all started together), the objects are linked into one
shared library under ``sfm_tpu_torch/_build/``, and the library is loaded
with ``ctypes``.  The library's name carries a hash of all sources and of
the compile flags, so a changed source builds a new library and an
unchanged one is reused.

Nothing here runs at import: the CPU tests import every module of the
package on machines that have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the library's entry points: every pointer and the stream
# are c_void_p (a bare Python int would be passed as a 32-bit int and cut).
# The LK entry points take the storage type of their images or windows as
# the int before the stream: 0 float32, 1 bfloat16.
_SIGNATURES = {
    "sfm_shi_tomasi": [_P, _I, _I, _I, _I, _P, _P],
    "sfm_lk_gather_pair": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _I,
                           _P],
    "sfm_lk_level_fused": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _F,
                           _P, _I, _P],
    "sfm_lk_gather": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    "sfm_lk_level_tmpl": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I, _P],
}

_lib = None
build_seconds: float | None = None  # wall time of the last real build
build_log: str = ""                 # what nvcc printed (ptxas -v included)


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:  # the toolkit's conventional home, when not on PATH
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
        exe = str(cand) if cand.exists() else None
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of sfm_tpu_torch are built "
            "from source at first use and need the CUDA toolkit")
    return exe


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path, verbose: bool) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    objs = []
    tag = f"{lib_path.stem}.{os.getpid()}"
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, p in procs:  # wait for all, so no compiler outlives the call
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log += f"\n== link\n{link.stdout}"
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{build_log}")
    os.replace(tmp, lib_path)  # atomic: a concurrent builder loses nothing
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load(verbose: bool = False):
    """The kernels' shared library as a ``ctypes.CDLL`` with ``argtypes``
    set, building it first when no library of the sources' hash exists."""
    global _lib
    if _lib is not None:
        return _lib
    lib_path = BUILD_DIR / f"libsfm_kernels_{_digest()}.so"
    if not lib_path.exists():
        _build(lib_path, verbose)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check_launch(code: int, name: str) -> None:
    """Raise when a launch was refused: the C entry points return
    ``cudaGetLastError()`` taken right after the launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
