#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Renders the cell's data from ``--seed``, warms up, measures for
``--seconds`` (to the first unit boundary after it), checks what the timed
path produced against the plain reference, and prints one JSON object as
the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from one
traced part of the window.  The numbers compared, each beside its limit,
are the last lines of standard error and the last key (``checks``) of the
result.  Exits non-zero and prints no result without a CUDA device, when
the program cannot be imported, or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    from portbench import harness

    args = harness.parse(argv)
    import torch

    cell = harness.load_cell(args)
    if args.device == "cuda":
        chips = int(cell.workload["chips"])
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            print(f"portbench: needs {chips} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    import sfm_tpu_torch  # noqa: F401  (the program must be there)

    result, lines = harness.run_cell(args, cell, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
