"""PyTorch port, windowed telemetry of multi-channel runs and memory
systems: a 2-channel HBM3 run and a DDR5 + CXL-DDR4@40 system give the
JAX package's windows element for element (tolerance 0), one
``GroupTelemetry`` per spec group, summing to the run's ``Stats``."""
import pytest

pytest.importorskip("torch")

from torch_parity import check_telemetry_case              # noqa: E402


@pytest.mark.parametrize("case", ["hbm3_2ch", "hetero"])
def test_system_windows_equal_reference(case):
    check_telemetry_case(case, rerun=False)
