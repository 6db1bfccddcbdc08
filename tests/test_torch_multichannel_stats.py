"""PyTorch port, multi-channel systems: 4-channel DDR4 and HBM3 ``Stats``
equal the reference's (the channel-vmapped path) at 1,500 cycles, interval
0.5, read ratio 0.9, with fast-forward on and off.  Tolerance 0."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import Simulator as JSim                    # noqa: E402

from repro_torch.core import Simulator                      # noqa: E402

from torch_parity import TRIO                               # noqa: E402

FOUR = [TRIO[0], TRIO[2]]            # DDR4, HBM3


@pytest.mark.parametrize("std,org,tim", FOUR)
@pytest.mark.parametrize("fast_forward", [True, False])
def test_four_channel_stats_equal_reference(std, org, tim, fast_forward):
    load = dict(interval=0.5, read_ratio=0.9, seed=0x77)
    sim = Simulator(std, org, tim, channels=4, device="cpu",
                    fast_forward=fast_forward)
    got = sim.run(1500, **load).to_dict()
    want = JSim(std, org, tim, channels=4,
                fast_forward=fast_forward).run(1500, **load).to_dict()
    assert got == want
    assert len(got["per_channel"]["reads_done"]) == 4
    assert min(got["per_channel"]["reads_done"]) > 0
