"""The benchmark's frozen ring renderer against the program's generator:
the same rings, byte for byte, as the benchmark was written."""

import dataclasses

import numpy as np
import pytest

from portbench import ringdata
from sfm_tpu_torch.utils import synthetic


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


SMALL = dict(width=160, height=120, fx=380.0, fy=380.0, texture_size=256)


@pytest.mark.parametrize("path, extra", [
    ({"type": "arc", "frames": 5, "arc_deg": 360.0}, {}),
    ({"type": "arc", "frames": 4, "arc_deg": 60.0},
     {"texture_blur": 1.5, "texture_kind": "structured"}),
    ({"type": "alternating", "frames": 6, "small_deg": 2.4}, {}),
    ({"type": "lons", "lons_deg": [0, 3, 9, 4, 0]}, {"noise_std": 0.0}),
])
def test_rings_match_program_generator(tmp_path, path, extra):
    spec = ringdata.ring_spec({**SMALL, **extra}, path, seed=2 ** 31 + 11)
    frames = list(range(spec.n_frames if spec.path_lons_deg is None
                        else len(spec.path_lons_deg)))
    ringdata.write_rings([(tmp_path / "bench", spec, frames)], processes=2)
    synthetic.generate_dataset(
        tmp_path / "prog",
        synthetic.SyntheticRingSpec(**dataclasses.asdict(spec)),
        name_prefix="templeR")
    ours, theirs = _files(tmp_path / "bench"), _files(tmp_path / "prog")
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert ours[name] == theirs[name], name


def test_spec_fields_match_program():
    ours = {f.name: f.default for f in dataclasses.fields(ringdata.RingSpec)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(synthetic.SyntheticRingSpec)}
    assert ours == theirs


def test_cameras_match_program():
    spec = ringdata.RingSpec(n_frames=47, texture_blur=1.5)
    ours = ringdata.ring_cameras(spec)
    theirs = synthetic.make_ring_cameras(
        synthetic.SyntheticRingSpec(**dataclasses.asdict(spec)))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_dense_path_is_bench_dense_variant():
    """94 views, steps 2.4 and (360 - 47 x 2.4) / 46 degrees in turn,
    ending over frame 0."""
    lons = ringdata.alternating_lons(94, 2.4)
    steps = np.diff(lons)
    assert len(lons) == 94 and lons[0] == 0.0
    np.testing.assert_allclose(steps[0::2], 2.4)
    np.testing.assert_allclose(steps[1::2], (360.0 - 47 * 2.4) / 46)
    assert lons[-1] == pytest.approx(360.0)


def test_tmpdir_layout_is_read_by_program_loader(tmp_path):
    from sfm_tpu_torch.utils.dataset import TempleRing

    spec = ringdata.ring_spec(SMALL, {"type": "arc", "frames": 3,
                                      "arc_deg": 30.0}, seed=5)
    ringdata.write_rings([(tmp_path, spec, [0, 1, 2])])
    ds = TempleRing.from_dir(tmp_path)
    K, R, t, C, _ = ringdata.ring_cameras(spec)
    assert len(ds.records) == 3
    np.testing.assert_allclose(ds.K, K)
    np.testing.assert_allclose(ds.records[2].center, C[2], atol=1e-12)
    assert ds.load_gray(1).shape == (120, 160)
