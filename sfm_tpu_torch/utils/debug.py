"""Numeric-failure detection (SURVEY §5 "sanitizers" analogue).

Counterpart of sfm_tpu/utils/debug.py, with the same API and the same
switches:

  * env var:   ``SFM_TPU_DEBUG_NANS=1 python -m sfm_tpu_torch ...``
    (read at import)
  * CLI flag:  ``python -m sfm_tpu_torch --debug-nans ...``
  * API:       ``sfm_tpu_torch.utils.debug.enable_numeric_checks()``

Where the JAX twin sets ``jax_debug_nans``/``jax_debug_infs``, this module
pushes a ``TorchDispatchMode`` that inspects every floating-point output of
every aten op and raises ``FloatingPointError`` naming the op that produced
a NaN/Inf.  Each check pulls one bool to the host, so on a card it syncs
after every op: an opt-in de-optimisation, off by default.

Stricter than the JAX twin: JAX checks the outputs of a jitted stage, the
port (which has no jit) checks every op, so masked-lane sentinels that
never leave a JAX jit surface here.  Those sites (NaN for ``nanmedian``
over invalid lanes, ±inf fills before a min/top-k) route through
:func:`nan_ok`, which suspends the checks locally.  The hand-written CUDA
kernels are called outside the dispatcher (the mode sees only the
allocation of their outputs), so their wrappers call :func:`check_finite`
on what the kernel wrote.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ENABLED = False
_MODE = None  # the pushed mode while the checks are active, else None

# allocations whose outputs are uninitialised memory: never inspected
_UNINITIALISED = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}


def _bad(t) -> bool:
    """True for a floating tensor holding a NaN/Inf.  First one reduction
    in the tensor's own dtype (a NaN/Inf element makes the sum non-finite;
    several times cheaper than ``isfinite(t).all()``), and only when the
    sum is non-finite, which a finite tensor's sum can also be by
    overflowing, the exact test."""
    return (isinstance(t, torch.Tensor) and t.layout == torch.strided
            and t.is_floating_point()
            and not math.isfinite(t.sum().item())
            and not bool(torch.isfinite(t).all()))


class _NumericCheckMode(TorchDispatchMode):
    """Raises on the first aten op with a NaN/Inf in a floating output.
    Views are skipped: they compute nothing, so a NaN they show was
    produced (and reported) by an earlier op."""

    @classmethod
    def _should_skip_dynamo(cls):
        # the port never compiles, and the default dynamo-disabling
        # wrapper around ``__torch_dispatch__`` costs ~100 us a call on
        # the host, more than the check itself
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in _UNINITIALISED):
            if any(_bad(t) for t in tree_leaves(out)):
                raise FloatingPointError(
                    f"NaN/Inf in the output of {func} (numeric checks are "
                    "on; see sfm_tpu_torch/utils/debug.py)")
        return out


def _push() -> None:
    global _MODE
    if _MODE is None:
        _MODE = _NumericCheckMode()
        _MODE.__enter__()


def _pop() -> None:
    global _MODE
    if _MODE is not None:
        mode, _MODE = _MODE, None
        mode.__exit__(None, None, None)


def enable_numeric_checks(enabled: bool = True) -> None:
    """Globally enable (or disable) NaN/Inf detection in every op."""
    global _ENABLED
    _ENABLED = enabled
    if enabled:
        _push()
    else:
        _pop()


def numeric_checks_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def nan_ok():
    """Context manager for code that uses NaN/±inf as a masked-lane
    sentinel: temporarily suspends the global checks (no-op when they are
    off; re-entrant, and the previous state is restored exactly)."""
    was_active = _MODE is not None
    _pop()
    try:
        yield
    finally:
        if was_active and _ENABLED:
            _push()


def check_finite(out, name: str):
    """Under the checks, raise if ``out`` (a tensor or a tuple of them,
    written by a kernel outside the dispatcher) holds a NaN/Inf; returns
    ``out``."""
    if not _ENABLED:
        return out
    with nan_ok():  # the check's own reduction sees the NaN
        bad = any(_bad(t) for t in tree_leaves(out))
    if bad:
        raise FloatingPointError(
            f"NaN/Inf in the output of the {name} kernel (numeric checks "
            "are on)")
    return out


if os.environ.get("SFM_TPU_DEBUG_NANS", "") == "1":
    enable_numeric_checks(True)
