"""Local (windowed) attention and head dim 256 in the port's flash
attention (``repro_torch.kernels.flash_attention``) on the CPU, where the
wrapper runs the plain version, against the JAX package: the model's
``flash_attention_xla(window=)`` (the mask ``(row - col) < window`` on
top of the top-left causal one, in q chunks that skip blocks outside the
window) and ``ref.flash_attention`` (no window; Tq == Tk, since it aligns
the causal mask bottom-right).  Inputs are made with numpy from a seed.
Tolerances are the reference's own (tests/kernels/test_flash_attention.py):
fp32 2e-5, bf16 2e-2.  The kernels against this plain version run on the
card (``test_torch_cuda.py``, ``chip_smoke.py`` phase 4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models.layers import flash_attention_xla
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as PL
from torch_parity import rand

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(shape, seed, dtype, scale=1.0):
    a = rand(shape, seed, scale)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.tensor(a).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _counts():
    return (FA.launch_count, FA.sm90_launch_count, FA.d256_launch_count)


@pytest.mark.parametrize("T,window", [(100, 1), (100, 16), (100, 100),
                                      (200, 33)])
@pytest.mark.parametrize("D,Hq,Hkv", [(32, 4, 2), (256, 10, 1)])
def test_windowed_plain_matches_xla(T, window, D, Hq, Hkv):
    """fp32, causal: the port's entry point in the model's layout against
    the model's XLA attention with the same window, in 64-row chunks (so
    the window cuts through kv blocks and, at T 200, skips whole ones)."""
    qj, qt = _pair((2, T, Hq, D), 1, "float32")
    kj, kt = _pair((2, T, Hkv, D), 2, "float32")
    vj, vt = _pair((2, T, Hkv, D), 3, "float32")
    before = _counts()
    got = FA.flash_attention_bthd(qt, kt, vt, causal=True, window=window)
    assert _counts() == before            # CPU tensors: the plain version
    assert got.shape == (2, T, Hq, D) and got.dtype == torch.float32
    want = flash_attention_xla(qj, kj, vj, causal=True, window=window,
                               bq=64, bk=64)
    _close(got, want, "float32")


@pytest.mark.parametrize("window", [1, 7, 64])
def test_windowed_plain_bf16(window):
    """bf16 in, fp32 softmax, bf16 out, as both packages compute it."""
    qj, qt = _pair((2, 90, 4, 64), 4, "bfloat16")
    kj, kt = _pair((2, 90, 2, 64), 5, "bfloat16")
    vj, vt = _pair((2, 90, 2, 64), 6, "bfloat16")
    got = PL.flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    _close(got, flash_attention_xla(qj, kj, vj, causal=True, window=window,
                                    bq=32, bk=32), "bfloat16")


@pytest.mark.parametrize("causal", [True, False])
def test_window_on_the_bhtd_entry_points(causal):
    """``flash_attention`` and ``gqa_flash_attention`` take the window
    too; without the causal mask it bounds only the past."""
    qj, qt = _pair((1, 60, 4, 32), 7, "float32")
    kj, kt = _pair((1, 60, 2, 32), 8, "float32")
    vj, vt = _pair((1, 60, 2, 32), 9, "float32")
    want = flash_attention_xla(qj, kj, vj, causal=causal, window=20,
                               bq=16, bk=16)
    t = lambda x: x.transpose(1, 2)
    got = t(FA.gqa_flash_attention(t(qt), t(kt), t(vt), causal=causal,
                                   window=20))
    _close(got, want, "float32")
    kr, vr = (x.repeat_interleave(2, dim=2) for x in (kt, vt))
    got = t(FA.flash_attention(t(qt), t(kr), t(vr), causal=causal,
                               window=20))
    _close(got, want, "float32")


@pytest.mark.parametrize("T", [64, 100])
def test_window_wider_than_the_sequence_is_no_window(T):
    qj, qt = _pair((1, T, 2, 16), 10, "float32")
    kj, kt = _pair((1, T, 2, 16), 11, "float32")
    vj, vt = _pair((1, T, 2, 16), 12, "float32")
    full = FA.flash_attention_bthd(qt, kt, vt, causal=True)
    for window in (T, T + 1, 1 << 40):
        got = FA.flash_attention_bthd(qt, kt, vt, causal=True, window=window)
        assert torch.equal(got, full)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_256_matches_ref(dtype, causal):
    """recurrentgemma-2b's head dim with its MQA (10 q heads on one kv
    head), no window, in the (B, H, T, D) layout, against the reference's
    pure-jnp oracle (kv repeated for it) at ``sm_scale`` 1/16."""
    qj, qt = _pair((2, 10, 48, 256), 13, "float32")
    kj, kt = _pair((2, 1, 48, 256), 14, "float32")
    vj, vt = _pair((2, 1, 48, 256), 15, "float32")
    td = getattr(torch, dtype)
    got = FA.gqa_flash_attention(qt.to(td), kt.to(td), vt.to(td),
                                 causal=causal)
    jd = getattr(jnp, dtype)
    want = ref.flash_attention(qj.astype(jd), jnp.repeat(kj, 10, 1).astype(jd),
                               jnp.repeat(vj, 10, 1).astype(jd),
                               causal=causal, sm_scale=1 / 16)
    _close(got, want, dtype)


def test_route_takes_bf16_head_dim_256():
    assert 256 in FA.HEAD_DIMS and 256 not in FA.FP32_HEAD_DIMS
    assert FA.route(torch.bfloat16, 256) == "sm90"
    assert FA.route(torch.bfloat16, 128) == "sm90"
    assert FA.route(torch.bfloat16, 64) == "sm90"
    assert FA.route(torch.bfloat16, 32) == "cuda_core"
    assert FA.route(torch.float32, 256) == "cuda_core"


def test_window_below_one_raises():
    q = torch.zeros(1, 8, 2, 32)
    for fn in (FA.flash_attention, FA.gqa_flash_attention,
               FA.flash_attention_bthd):
        with pytest.raises(ValueError, match="window"):
            fn(q, q, q, window=0)
