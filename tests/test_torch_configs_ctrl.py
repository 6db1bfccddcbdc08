"""PyTorch port, end-to-end parity of controller configurations no other
test runs through the engine: the FCFS scheduler, queue depths 8 and 16
and refresh off, each a DDR4 run whose ``Stats.to_dict()`` and
command-stream sha256 equal the JAX package's (tolerance 0)."""
import pytest

pytest.importorskip("torch")

from torch_parity import check_config                      # noqa: E402

DDR4 = dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
            timing_preset="DDR4_2400R")
CONTROLLERS = {"fcfs": dict(scheduler="FCFS"), "depth8": dict(queue_depth=8),
               "depth16": dict(queue_depth=16),
               "refresh_off": dict(refresh_enabled=False)}


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controller_config_equals_reference(name):
    stats = check_config(DDR4, controller=CONTROLLERS[name], interval=2.0,
                         read_ratio=0.7)
    assert stats.reads_done > 0
