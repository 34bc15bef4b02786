"""The port's numeric-failure detection (sfm_tpu_torch/utils/debug.py), case
for case with tests/test_debug.py, and the BA gather plan's overflow check
that it gates (tests/test_ba.py ``test_refine_points_structure_only``):
under the checks an undersized ``max_obs_per_point`` raises, without them
the rows past the cap are dropped, to the JAX package's result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ops import ba as jba

from sfm_tpu_torch.ops import ba, lie, linalg
from sfm_tpu_torch.utils import debug


@pytest.fixture
def checks():
    """Enable checks for the test, always restore global state after."""
    debug.enable_numeric_checks(True)
    try:
        yield
    finally:
        debug.enable_numeric_checks(False)


def test_torch_nan_raises(checks):
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(torch.tensor(1.0) - 2.0)  # log of a negative -> NaN


def test_torch_inf_raises(checks):
    with pytest.raises(FloatingPointError, match="aten.reciprocal"):
        1.0 / torch.tensor(0.0)


def test_torch_clean_pipeline_stage_passes(checks):
    # a representative masked-state computation must not false-positive
    w = torch.tensor([0.1, -0.2, 0.3])
    R = lie.so3_exp(w)
    np.testing.assert_allclose(lie.so3_log(R).numpy(), w.numpy(), atol=1e-6)


def test_torch_nan_ok_suspends(checks):
    with debug.nan_ok():
        with debug.nan_ok():  # re-entrant
            pass
        x = torch.tensor([1.0, float("nan"), 3.0])
        med = linalg.nanmedian(x)  # deliberate sentinel use
        assert float(med) == 2.0
    # checks are restored afterwards, and catch the next NaN
    assert debug.numeric_checks_enabled()
    with pytest.raises(FloatingPointError):
        torch.log(torch.tensor(-1.0))


def test_torch_disabled_is_noop():
    assert not debug.numeric_checks_enabled()
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_torch_check_finite(checks):
    """What a kernel wrapper calls on its kernel's output (the dispatch
    mode does not see a kernel launched outside the dispatcher)."""
    ok = (torch.ones(3), torch.zeros(2, 2))
    assert debug.check_finite(ok, "k") is ok
    with pytest.raises(FloatingPointError, match="k kernel"):
        debug.check_finite((torch.ones(3), torch.tensor([float("inf")])),
                           "k")
    debug.enable_numeric_checks(False)
    debug.check_finite(torch.tensor([float("nan")]), "k")


def _overflow_problem(rng):
    """tests/test_ba.py's structure-only problem: F=4 identity-rotation
    cameras on a baseline, P=64 points seen by every camera (4 observations
    each), noisy initial points; float32 as in the pipeline, and 1e-3 of
    noise on the observations (as in test_torch_refine_points_matches_jax)
    so that the converged cost stands above float32 rounding."""
    F, P = 4, 64
    M = 4 * P
    Xgt = rng.standard_normal((P, 3)) * 0.4 + np.array([0, 0, 5.0])
    R_wc = np.stack([np.eye(3)] * F)
    t_wc = np.zeros((F, 3))
    t_wc[:, 0] = np.linspace(0, 1.0, F)
    cam = (np.arange(M) % F).astype(np.int32)
    pid = (np.arange(M) // F).astype(np.int32)
    Xc = np.einsum("mij,mj->mi", R_wc[cam], Xgt[pid]) + t_wc[cam]
    obs = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1e-3, (M, 2))
    X0 = Xgt + rng.standard_normal((P, 3)) * 0.05
    f32 = np.float32
    return [R_wc.astype(f32), t_wc.astype(f32), X0.astype(f32), cam, pid,
            obs.astype(f32), np.ones(M, bool), np.ones(P, bool)]


def test_torch_refine_points_overflow_raises_under_checks(rng, checks):
    """Each point has 4 observations, so a cap of 2 drops two per point:
    under the checks that raises, as in the JAX twin."""
    prob = ba.BAProblem(*map(torch.as_tensor, _overflow_problem(rng)))
    with pytest.raises(FloatingPointError, match="exceed"):
        ba.refine_points(prob, iters=1, max_obs_per_point=2)


def test_torch_refine_points_overflow_drops_like_jax(rng):
    """Without the checks the plan keeps the first 2 observations of each
    point and drops the rest, on both sides: the same
    points to atol 5e-5 and costs to rtol 1e-4 (the tolerance of
    test_torch_refine_points_matches_jax)."""
    arrays = _overflow_problem(rng)
    Xj, ij = jba.refine_points(jba.BAProblem(*map(jnp.asarray, arrays)),
                               iters=5, huber_delta=1e-2,
                               max_obs_per_point=2)
    Xt, it = ba.refine_points(ba.BAProblem(*map(torch.as_tensor, arrays)),
                              iters=5, huber_delta=1e-2, max_obs_per_point=2)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5e-5)
    for k in ("cost0", "cost"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-4)
    assert float(it["cost"]) < float(it["cost0"])
