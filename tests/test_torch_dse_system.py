"""PyTorch port, ``repro_torch.dse.execute`` against ``repro.dse.execute``
(tolerance 0) on a heterogeneous ``Composition`` (DDR5 x 2 + CXL-DDR4 x 2
at 80 cycles of link latency) with windowed telemetry: every point's
columns and curves, and every point's ``Telemetry`` windows, equal the
reference's; the windows persist to a directory as the reference's
do."""
import os

import pytest

pytest.importorskip("torch")

from repro.telemetry import load as j_load                  # noqa: E402

from torch_parity import assert_telemetry_equal, check_sweep  # noqa: E402


def spec(pkg, telemetry_dir=None):
    comp = pkg.dse.Composition((("DDR5", 2), ("DDR4", 2, 80)))
    return pkg.dse.SweepSpec(systems=(comp,), intervals=(4.0, 1.0),
                             read_ratios=(0.7,), n_cycles=600,
                             telemetry=128, telemetry_dir=telemetry_dir)


def test_composition_with_telemetry_equals_reference(tmp_path):
    d = str(tmp_path / "tm")
    j, t = check_sweep(lambda pkg: spec(pkg, d if "torch" in
                                        pkg.dse.__name__ else None))
    assert t.meta["n_groups"] == 1
    assert t.meta["groups"][0]["n_spec_groups"] == 2
    assert t.points[0].n_channels == 4
    assert len(t.telemetry) == 2
    for i, (jt, tt) in enumerate(zip(j.telemetry, t.telemetry)):
        assert_telemetry_equal(jt, tt)
        assert tt.meta["point"] == t.points[i].label
    paths = t.meta["telemetry_artifacts"]
    assert [os.path.basename(p) for p in paths] == ["point_0000.npz",
                                                    "point_0001.npz"]
    # the port's artifact loads in the reference
    assert_telemetry_equal(j.telemetry[1], j_load(paths[1]))
