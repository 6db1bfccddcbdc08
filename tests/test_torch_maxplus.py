"""PyTorch port, the (max,+) product and its readiness wrappers.

* ``timing_check.maxplus_matmul`` equals the Pallas kernel
  ``repro.kernels.timing_check.maxplus_matmul`` (interpret mode) bit for
  bit at the reference test's shapes, for int32 and float32 inputs with
  -3e38 entries in T and A and values on both sides of 2**24, and
  ``ref.maxplus_matmul`` wherever the two references agree;
* ``ops.readiness_matrix`` and ``ops.earliest_for`` equal the reference's
  (``use_pallas=True, interpret=True``) on DDR4, LPDDR5 and HBM3 device
  states after a random legal history, carried across with
  ``convert.device_state``;
* ``maxplus_plan`` (the kernel's tile configuration) and the routing by
  device.

The kernels themselves are held against these plain versions on the card
(``test_torch_cuda.py``).  Seeded numpy sweeps; tolerance 0 throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.kernels import ops as jops                      # noqa: E402
from repro.kernels import ref                              # noqa: E402
from repro.kernels.timing_check import maxplus_matmul as pallas_maxplus  # noqa: E402,E501

from repro_torch import convert                            # noqa: E402
from repro_torch.core import compile_spec                  # noqa: E402
from repro_torch.core import device as TD                  # noqa: E402
from repro_torch.kernels import ops                        # noqa: E402
from repro_torch.kernels import readiness as R             # noqa: E402
from repro_torch.kernels.timing_check import maxplus_matmul  # noqa: E402

from torch_parity import TRIO, jax_history_state, tree_np  # noqa: E402

SHAPES = [(8, 16, 8), (32, 30, 10), (1, 1, 1), (129, 70, 12),
          (128, 128, 128), (5, 200, 3)]


def _operands(Q, K, C, dtype, seed):
    """T and A with values on both sides of 2**24 and, for float32, -3e38
    entries in both (a whole T row and a whole A column among them, so
    some outputs have every term at -inf)."""
    rng = np.random.default_rng(seed)
    hi = (1 << 25) if dtype == np.float32 else (1 << 26)
    T = rng.integers(-hi, hi, (Q, K)).astype(dtype)
    A = rng.integers(-(1 << 10), 1 << 24, (K, C)).astype(dtype)
    if dtype == np.float32:
        T[rng.random((Q, K)) < 0.2] = -3e38
        A[rng.random((K, C)) < 0.5] = -3e38
        T[0] = -3e38
        A[:, -1] = -3e38
    return T, A


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("Q,K,C", SHAPES)
def test_maxplus_matches_pallas_kernel(Q, K, C, dtype):
    T, A = _operands(Q, K, C, dtype, seed=Q * 1000 + K * 10 + C)
    want = np.asarray(pallas_maxplus(jnp.asarray(T), jnp.asarray(A),
                                     interpret=True))
    before = R.launch_count
    got = maxplus_matmul(torch.as_tensor(T), torch.as_tensor(A))
    assert R.launch_count == before
    assert got.dtype == torch.float32 and got.shape == (Q, C)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # against ref.maxplus_matmul wherever the references agree: they part
    # only where every term is -inf (Pallas keeps its -3e38 start)
    r = np.asarray(ref.maxplus_matmul(jnp.asarray(T, jnp.float32),
                                      jnp.asarray(A, jnp.float32)))
    agree = r == want
    assert (agree | (np.isneginf(r) & (want == np.float32(-3e38)))).all()
    np.testing.assert_array_equal(got.numpy()[agree], r[agree])
    if dtype == np.float32:
        assert not agree.all()          # the -inf rows are exercised


def test_maxplus_plain_int32_wraps_and_starts_at_init():
    rng = np.random.default_rng(5)
    T = rng.integers(-(1 << 31), 1 << 31, (7, 9), dtype=np.int64)
    A = rng.integers(-(1 << 31), 1 << 31, (9, 4), dtype=np.int64)
    got = R.maxplus_plain(torch.as_tensor(T.astype(np.int32)),
                          torch.as_tensor(A.astype(np.int32)),
                          R.INT32_MIN).numpy()
    wrapped = ((T[:, :, None] + A[None] + (1 << 31)) % (1 << 32)) - (1 << 31)
    np.testing.assert_array_equal(got, wrapped.max(1))
    empty = R.maxplus_plain(torch.zeros((3, 0), dtype=torch.int32),
                            torch.zeros((0, 2), dtype=torch.int32), -7)
    assert (empty == -7).all() and empty.shape == (3, 2)


@pytest.mark.parametrize("std,org,tim", TRIO)
def test_readiness_matrix_matches_reference(std, org, tim):
    jc, jdp, jstate, _, rng = jax_history_state(std, org, tim, seed=3)
    subs = np.asarray([[int(rng.integers(int(jc.level_counts[i + 1])))
                        for i in range(len(jc.levels) - 1)]
                       for _ in range(9)], np.int32)
    cand = rng.integers(0, jc.n_cmds, 9).astype(np.int32)
    jkeys = jops.build_keys(jc)
    want = np.asarray(jops.readiness_matrix(
        jc, jkeys, jdp.ct_lat, jstate, jnp.asarray(subs), use_pallas=True,
        interpret=True))
    want_for = np.asarray(jops.earliest_for(
        jc, jkeys, jdp.ct_lat, jstate, jnp.asarray(subs), jnp.asarray(cand),
        use_pallas=True, interpret=True))

    cspec = compile_spec(std, org, tim)
    keys = ops.build_keys(cspec)
    for f in jkeys._fields:
        np.testing.assert_array_equal(getattr(keys, f), getattr(jkeys, f))
    st = convert.device_state(tree_np(jstate), "cpu")
    ct_lat = np.asarray(jdp.ct_lat)
    np.testing.assert_array_equal(
        ops.build_A(cspec, keys, ct_lat).numpy(),
        np.asarray(jops.build_A(jc, jkeys, jdp.ct_lat)))
    np.testing.assert_array_equal(
        ops.gather_T(cspec, keys, st, subs)[0].numpy(),
        np.asarray(jops.gather_T(jc, jkeys, jstate, jnp.asarray(subs))))
    got = ops.readiness_matrix(cspec, keys, ct_lat, st, subs)
    assert got.shape == (1, 9, cspec.n_cmds)
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want))
    got_for = ops.earliest_for(cspec, keys, ct_lat, st, subs, cand)
    np.testing.assert_array_equal(_bits(got_for[0].numpy()), _bits(want_for))
    # two channels, per-channel slots: each channel's rows are its own
    st2 = TD.DeviceState(*(torch.cat([f, f]) for f in st))
    subs2 = np.stack([subs, subs[::-1]])
    got2 = ops.readiness_matrix(cspec, keys, ct_lat, st2, subs2)
    np.testing.assert_array_equal(got2[0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(got2[1].numpy(), got[0].numpy()[::-1])


@pytest.mark.parametrize("Q,K,C,n_sm,want", [
    (8, 16, 8, 132, R.MAXPLUS_ONE_BLOCK),
    (32, 30, 10, 132, R.MAXPLUS_ONE_BLOCK),
    (1, 1, 1, 132, R.MAXPLUS_ONE_BLOCK),
    (129, 70, 12, 132, R.MAXPLUS_ONE_BLOCK),
    (5, 200, 3, 132, R.MAXPLUS_ONE_BLOCK),
    (128, 128, 128, 132, R.MAXPLUS_TILE32),     # 1 tile of 128: 16 of 32
    (1024, 64, 1088, 132, R.MAXPLUS_TILE128),   # 72 tiles of 128
    (1024, 64, 1088, 150, R.MAXPLUS_TILE32),
    (2048, 2048, 2048, 132, R.MAXPLUS_TILE128),
    (4000, 3, 4000, 132, R.MAXPLUS_TILE128),    # too much for one block
])
def test_maxplus_plan(Q, K, C, n_sm, want):
    assert R.maxplus_plan(Q, K, C, n_sm) == want


def test_maxplus_routing_by_device():
    meta = torch.zeros((2, 3), device="meta")
    with pytest.raises(NotImplementedError):
        maxplus_matmul(meta, torch.zeros((3, 2), device="meta"))
    with pytest.raises(ValueError):
        maxplus_matmul(torch.zeros(2, 3), torch.zeros(4, 2))
