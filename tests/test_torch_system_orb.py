"""PyTorch port vs JAX package: ``SfMSystem`` with the ORB loop flavor
(``loop.method="orb"``), on the CPU.

tests/test_torch_system.py's ring 2 (tests/test_torch_loop.py's 15-frame
320x240 out-and-back ring, loop closure and the SE(3) pose graph on) with
the ORB flavor: one module-scoped JAX run, whose RANSAC calls are
counted, and one port run (``device="cpu"``) handed the JAX run's own
draws.  Its own file so that each parity file stays a few minutes long.
"""

import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import system as jsystem

from sfm_tpu_torch import config
from sfm_tpu_torch.models import system
from tests.test_torch_system import JaxDraws, _run, loop_cfg, ring2_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ring2_orb(tmp_path_factory):
    """Ring 2 with ``loop.method="orb"``: one JAX run, whose RANSAC calls
    are counted, and one port run handed the same draws."""
    ds = ring2_dataset(tmp_path_factory.mktemp("sys_ring2_orb"))
    sj = jsystem.SfMSystem(ds.K, loop_cfg(jconfig, "orb"),
                           gt_records=ds.records)
    jax_calls = [0]
    next_key = sj._next_key

    def counted():
        jax_calls[0] += 1
        return next_key()

    sj._next_key = counted
    _run(sj, ds, finalize=False)
    st = system.SfMSystem(ds.K, loop_cfg(config, "orb"),
                          gt_records=ds.records, device="cpu")
    st._pri_source = draws = JaxDraws(st.cfg.ransac.seed)
    _run(st, ds, finalize=False)
    return sj, st, draws, jax_calls[0]


def test_torch_system_orb_loop_edges_match_jax(ring2_orb):
    """``SfMSystem`` with ``loop.method="orb"``: ORB features on every
    keyframe, the same loop edges closed at the same frames as JAX, their
    E-RANSAC inlier counts within 3 % (the ORB keypoints and descriptor
    bits agree with JAX's up to corner ties and blur near-ties,
    test_torch_orb.py, so a match or two can differ), and as many RANSAC
    draws as JAX took: the same candidates were verified, in the same
    order, each on JAX's own draw."""
    sj, st, draws, jax_calls = ring2_orb
    assert len(st.kfs) == len(sj.kfs)
    assert all(k.orb is not None for k in st.kfs)
    lj = [e for e in sj.edges if e.is_loop]
    lt = [e for e in st.edges if e.is_loop]
    assert [(e.i, e.j) for e in lt] == [(e.i, e.j) for e in lj]
    assert len(lj) >= 1
    for a, b in zip(lj, lt):
        assert abs(a.inliers - b.inliers) <= 0.03 * a.inliers, (a, b)
    assert [m.get("loop") for m in st.metrics] == \
        [m.get("loop") for m in sj.metrics]
    assert draws.calls == jax_calls > (len(sj.metrics) - 1) + len(lj)
