"""sfm_tpu_torch — the PyTorch/CUDA port of the ``sfm_tpu``
Structure-from-Motion pipeline (pyramidal KLT tracking, essential-matrix
LO-RANSAC, PnP, DLT triangulation, sliding-window Schur-LM bundle
adjustment, CSV/PLY export).

Same sub-package layout and function names as the JAX package, so each
counterpart is found by path: ``ops/`` (tensor functions), ``ops/kernels/``
(wrappers of the hand-written CUDA kernels, sources under ``csrc/``),
``models/`` (tracker, scan pipeline), ``utils/`` (numpy/stdlib host code).

Rules of the port:
  * imports ``torch``, ``numpy`` and the standard library only;
  * entry points take an explicit ``device`` and default to ``"cuda"``;
    without a card they raise (tests pass ``device="cpu"``);
  * a kernel wrapper launches its CUDA kernel for a CUDA tensor or raises;
    the plain PyTorch version is taken only for a CPU tensor.

Precision policy (the twin of ``jax_default_matmul_precision="highest"``):
the geometric linear algebra here (8-point systems, Jacobi rotations,
Schur complements) needs true float32 products, so TF32 is switched off
for matmuls and for cuDNN, process-wide, at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from sfm_tpu_torch.config import SystemConfig, load_config  # noqa: E402,F401
