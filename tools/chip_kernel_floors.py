"""What the card takes for the least work around the port's small kernels,
and what the kernels issue: the yardsticks beside ``chip_smoke.py``'s
``bound_ms`` for kernels of a few microseconds.

* ``floors``: with ``chip_smoke.time_ms`` (the same timing as the kernel
  rows): one launch of the least kernel (``add_`` on one element), a pure
  write of K5's output (``fill_`` of T=2200 windows of 28^2 floats, 6.9
  MB) and of K1's (``fill_`` of a 640x480 map), and a copy of K1's input
  to its output.
* ``sass``: for each kernel instantiation the main path launches (K1 at
  radius 2 and 3; K3, K4 at P=13; K5 at widths 16 and 28), the count of
  SASS instructions in the built library (``cuobjdump -sass``) and the
  most frequent opcodes.

    python3 tools/chip_kernel_floors.py

Needs one CUDA card, ``nvcc`` and ``cuobjdump``; prints one JSON line per
part and the card's name and power limit.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

# mangled-name pieces (the whole template-argument list) of the
# instantiations the main path launches, on float32 storage and on
# bfloat16 (SFM_TPU_LK_BF16=1)
MAIN_PATH = {
    "shi_tomasi_kernel<2>": ("shi_tomasi_kernel", "ILi2EE"),
    "shi_tomasi_kernel<3>": ("shi_tomasi_kernel", "ILi3EE"),
    "lk_level_fused_kernel<13, float>": ("lk_level_fused_kernel",
                                         "ILi13EfE"),
    "lk_level_fused_kernel<13, bf16>": ("lk_level_fused_kernel",
                                        "ILi13E13__nv_bfloat16E"),
    "lk_level_tmpl_kernel<13, float>": ("lk_level_tmpl_kernel", "ILi13EfE"),
    "lk_level_tmpl_kernel<13, bf16>": ("lk_level_tmpl_kernel",
                                       "ILi13E13__nv_bfloat16E"),
    "lk_gather_kernel<false, 16, 0, float>": ("lk_gather_kernel",
                                              "ILb0ELi16ELi0EfE"),
    "lk_gather_kernel<false, 28, 0, float>": ("lk_gather_kernel",
                                              "ILb0ELi28ELi0EfE"),
    "lk_gather_kernel<false, 28, 0, bf16>": ("lk_gather_kernel",
                                             "ILb0ELi28ELi0E13__nv_bfloat16E"),
}


def floors(cs) -> dict:
    dev = torch.device("cuda", 0)
    one = torch.zeros(1, device=dev)
    k5_out = torch.empty(cs.T_TRACKS * 28 * 28, device=dev)
    k1_out = torch.empty(480 * 640, device=dev)
    k1_in = torch.rand(480 * 640, device=dev)
    return {"part": "floors",
            "launch_ms": cs.time_ms(lambda: one.add_(1.0)),
            "fill_k5_output_ms": cs.time_ms(lambda: k5_out.fill_(1.0)),
            "fill_k1_output_ms": cs.time_ms(lambda: k1_out.fill_(1.0)),
            "copy_k1_input_ms": cs.time_ms(lambda: k1_out.copy_(k1_in))}


def sass(lib: str) -> dict:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    counts: dict[str, collections.Counter] = {}
    fn = None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", ln)
        if m and fn:
            counts[fn][m.group(1)] += 1
    out = {}
    for name, (base, targ) in MAIN_PATH.items():
        hits = [c for f, c in counts.items() if base in f and targ in f]
        if hits:
            out[name] = {"instructions": sum(hits[0].values()),
                         "top": dict(hits[0].most_common(8))}
    return {"part": "sass", "kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_floors: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from sfm_tpu_torch.ops.kernels import build

    build.load()
    print(json.dumps(floors(cs)), flush=True)
    lib = build.BUILD_DIR / f"libsfm_kernels_{build._digest()}.so"
    print(json.dumps(sass(str(lib))), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
