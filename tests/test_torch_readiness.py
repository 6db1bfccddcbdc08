"""PyTorch port, the timing-readiness table.

After a random legal history (replayed through the reference's
``DeviceUnderTest`` oracle and applied with the reference's ``issue``),
the port's plain version of the readiness kernel equals
``repro.core.device.earliest_ready_table`` cell by cell for all 11
default systems, agrees with the Pallas (max,+) kernel (interpret mode) at
its own (slot, cmd) points, and stays exact for timestamps above 2**24,
where the fp32 Pallas kernel no longer is.  The CUDA kernel itself is
held against the plain version on the card (``test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.core import device as JD                       # noqa: E402
from repro.kernels import ops                              # noqa: E402

from repro_torch import convert                            # noqa: E402
from repro_torch.core import compile_spec                  # noqa: E402
from repro_torch.core import device as TD                  # noqa: E402
from repro_torch.kernels import readiness as R             # noqa: E402

from torch_parity import (TRIO, assert_tree_equal,         # noqa: E402
                          default_systems, jax_history_state, tree_np)

SYSTEMS = sorted(default_systems().items())


def _port(std, org, tim, jstate, jdp):
    cspec = compile_spec(std, org, tim)
    dp = convert.dyn_params(tree_np(jdp), cspec, "cpu")
    return cspec, dp, convert.device_state(tree_np(jstate), "cpu")


@pytest.mark.parametrize("std,org_tim", SYSTEMS)
def test_plain_table_equals_reference_table(std, org_tim):
    org, tim = org_tim
    jc, jdp, jstate, _, _ = jax_history_state(std, org, tim, seed=3)
    want = np.asarray(JD.earliest_ready_table(jc, jdp, jstate))
    cspec, dp, st = _port(std, org, tim, jstate, jdp)
    got = R.readiness_table_plain(dp.tables.ready, st.last_issue,
                                  st.win_ring)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)
    # the device module's entry point routes CPU tensors to the same
    # plain version and never counts a kernel launch
    before = R.launch_count
    np.testing.assert_array_equal(
        TD.earliest_ready_table(cspec, dp, st)[0].numpy(), want)
    assert R.launch_count == before


@pytest.mark.parametrize("std,org,tim", TRIO)
def test_port_issue_replays_to_reference_state(std, org, tim):
    """The same legal history applied with the port's ``issue`` gives
    the reference's device state, field for field."""
    jc, jdp, jstate, history, _ = jax_history_state(std, org, tim, seed=5)
    cspec = compile_spec(std, org, tim)
    dp = convert.dyn_params(tree_np(jdp), cspec, "cpu")
    st = TD.init_state(cspec, 1, "cpu")
    for c, cmd, addr in history:
        st = TD.issue(
            cspec, dp, st, torch.tensor([cspec.cmd_id(cmd)], dtype=torch.int32),
            torch.tensor([[addr[lv] for lv in cspec.levels[1:]]],
                         dtype=torch.int32),
            torch.tensor([addr["row"]], dtype=torch.int32), c,
            torch.ones(1, dtype=torch.bool))
    assert_tree_equal(tree_np(jstate), st, std)


@pytest.mark.parametrize("std,org,tim", TRIO)
def test_plain_table_agrees_with_pallas_kernel(std, org, tim):
    jc, jdp, jstate, _, rng = jax_history_state(std, org, tim, seed=7)
    cspec, dp, st = _port(std, org, tim, jstate, jdp)
    table = R.readiness_table_plain(dp.tables.ready, st.last_issue,
                                    st.win_ring)[0].numpy()
    subs = np.asarray([[int(rng.integers(int(jc.level_counts[i + 1])))
                        for i in range(len(jc.levels) - 1)]
                       for _ in range(9)], np.int32)
    em = np.asarray(ops.readiness_matrix(jc, ops.build_keys(jc), jdp.ct_lat,
                                         jstate, jnp.asarray(subs),
                                         use_pallas=True, interpret=True))
    banks = (subs * jc.addr_strides()[None, :]).sum(1)
    for qi, b in enumerate(banks):
        for ci in range(jc.n_cmds):
            if table[ci, b] <= R.NEG:
                # the kernel reports -inf-ish where the table says NEG
                assert em[qi, ci] <= R.NEG, (std, qi, ci)
            else:
                assert int(em[qi, ci]) == int(table[ci, b]), (std, qi, ci)


@pytest.mark.parametrize("std,org,tim", TRIO)
def test_plain_table_exact_above_fp32_range(std, org, tim):
    """Timestamps above 2**24: compared with the int32 reference table
    only (the fp32 Pallas kernel rounds there)."""
    clk0 = (1 << 24) + 12_345
    jc, jdp, jstate, _, _ = jax_history_state(std, org, tim, seed=11,
                                              clk0=clk0)
    li = np.asarray(jstate.last_issue)
    assert li.max() > (1 << 24)
    want = np.asarray(JD.earliest_ready_table(jc, jdp, jstate))
    cspec, dp, st = _port(std, org, tim, jstate, jdp)
    got = R.readiness_table_plain(dp.tables.ready, st.last_issue,
                                  st.win_ring)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > (1 << 24)).any()


def test_earliest_ready_matches_reference_per_command():
    """The per-address ``earliest_ready`` (off the main path) agrees with
    the reference's for every command at random addresses."""
    std, org, tim = TRIO[1]
    jc, jdp, jstate, _, rng = jax_history_state(std, org, tim, seed=13)
    cspec, dp, st = _port(std, org, tim, jstate, jdp)
    for _ in range(6):
        sub = [int(rng.integers(int(jc.level_counts[i + 1])))
               for i in range(len(jc.levels) - 1)]
        for c in range(jc.n_cmds):
            want = int(JD.earliest_ready(jc, jdp, jstate, jnp.int32(c),
                                         jnp.asarray(sub, jnp.int32)))
            got = TD.earliest_ready(cspec, dp, st,
                                    torch.tensor([c], dtype=torch.int32),
                                    torch.tensor([sub], dtype=torch.int32))
            assert int(got[0]) == want, (c, sub)


def test_cpu_wrapper_rejects_other_devices():
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    dp = TD.dyn_params(cspec, "cpu")
    st = TD.init_state(cspec, 1, "meta")
    with pytest.raises(NotImplementedError):
        R.readiness_table(dp.tables.ready, st.last_issue, st.win_ring)


def test_plain_table_batches_channels():
    """Three channels with three different histories: each channel's
    slice of the port's table equals the reference's table of that
    channel (the kernel grids over this leading axis)."""
    std, org, tim = TRIO[2]
    states, wants = [], []
    for seed in (21, 22, 23):
        jc, jdp, jstate, _, _ = jax_history_state(std, org, tim, seed=seed)
        states.append(convert.device_state(tree_np(jstate), "cpu"))
        wants.append(np.asarray(JD.earliest_ready_table(jc, jdp, jstate)))
    cspec = compile_spec(std, org, tim)
    dp = TD.dyn_params(cspec, "cpu", channels=3)
    st = TD.DeviceState(*(torch.cat(f) for f in zip(*states)))
    got = TD.earliest_ready_table(cspec, dp, st).numpy()
    assert got.shape[0] == 3
    for c in range(3):
        np.testing.assert_array_equal(got[c], wants[c])
