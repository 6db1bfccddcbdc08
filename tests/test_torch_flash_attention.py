"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
the CPU, where its wrapper runs the plain version, against the JAX
package: the Pallas kernel (interpret mode, as the reference's own tests
run it), ``ref.flash_attention`` (Tq == Tk only: it aligns the causal mask
bottom-right), ``ops.gqa_flash_attention`` and the model's
``flash_attention_xla``.  Inputs are made with numpy from a seed.
Tolerances are the reference's own (tests/kernels/test_flash_attention.py):
fp32 2e-5, bf16 2e-2.  The CUDA kernel against this plain version is in
``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ops import gqa_flash_attention as jax_gqa
from repro.models.layers import flash_attention_xla
from repro_torch.kernels import flash_attention as FA
from torch_parity import rand

SHAPES = [(1, 1, 128, 64), (2, 2, 256, 64), (1, 4, 100, 32),
          (1, 1, 300, 128), (2, 1, 64, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(shapes, seed, dtype):
    jd, td, _ = DTYPES[dtype]
    arrs = [rand(s, seed + i) for i, s in enumerate(shapes)]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.tensor(a).to(td) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,H,T,D", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_ref(B, H, T, D, causal):
    (qj, kj, vj), (qt, kt, vt) = _both([(B, H, T, D)] * 3, 1, "float32")
    before = FA.launch_count
    got = FA.flash_attention(qt, kt, vt, causal=causal)
    assert FA.launch_count == before          # CPU tensors: plain version
    assert got.shape == (B, H, T, D) and got.dtype == torch.float32
    _close(got, pallas_flash(qj, kj, vj, causal=causal, bq=64, bk=64), 2e-5)
    _close(got, ref.flash_attention(qj, kj, vj, causal=causal), 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,D", [(1, 2, 128, 64), (1, 4, 100, 32)])
def test_plain_dtypes_match_pallas(dtype, B, H, T, D):
    (qj, kj, vj), (qt, kt, vt) = _both([(B, H, T, D)] * 3, 4, dtype)
    tol = DTYPES[dtype][2]
    got = FA.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, pallas_flash(qj, kj, vj, causal=True), tol)
    _close(got, ref.flash_attention(qj, kj, vj, causal=True), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_entry_matches_reference_gqa(causal):
    (qj, kj, vj), (qt, kt, vt) = _both(
        [(2, 8, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32)], 7, "float32")
    got = FA.gqa_flash_attention(qt, kt, vt, causal=causal)
    _close(got, jax_gqa(qj, kj, vj, causal=causal, use_pallas=True), 2e-5)


@pytest.mark.parametrize("Tq,Tk", [(100, 100), (600, 600), (40, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_matches_flash_attention_xla(Tq, Tk, dtype):
    """(B, T, H, D) with rep 4; 600 spans two of the XLA version's q and
    kv chunks; Tq < Tk checks the top-left causal alignment."""
    (qj, kj, vj), (qt, kt, vt) = _both(
        [(2, Tq, 8, 32), (2, Tk, 2, 32), (2, Tk, 2, 32)], 11, dtype)
    got = FA.flash_attention_bthd(qt, kt, vt, causal=True)
    assert got.shape == (2, Tq, 8, 32)
    _close(got, flash_attention_xla(qj, kj, vj, causal=True),
           DTYPES[dtype][2])


def test_layouts_agree():
    q, k, v = (torch.tensor(rand(s, 20 + i)) for i, s in enumerate(
        [(2, 4, 50, 16), (2, 2, 50, 16), (2, 2, 50, 16)]))
    t = lambda x: x.transpose(1, 2)
    a = FA.gqa_flash_attention(q, k, v, causal=True)
    b = FA.flash_attention_bthd(t(q), t(k), t(v), causal=True)
    torch.testing.assert_close(a, t(b), atol=0, rtol=0)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, torch.zeros(1, 2, 8, 16),
                           torch.zeros(1, 2, 8, 16))   # needs gqa entry
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(q, torch.zeros(1, 3, 8, 16),
                               torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(q, torch.zeros(1, 2, 8, 32),
                               torch.zeros(1, 2, 8, 32))
