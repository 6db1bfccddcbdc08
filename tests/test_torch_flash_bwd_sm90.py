"""The Python side of the port's flash-attention backward on the CPU: which
backward kernel a case goes to and which count it adds to, the sm90
backward's TMA plan and head split, the forward's log-sum-exp (lse) that
both backward kernels read, and the plain backward at the cases the card's
kernels gained (bf16 D 256 with MQA and a window; fp32) against
``jax.vjp`` of the reference model's ``flash_attention_xla``.

* ``attention_plain(..., return_lse=True)`` gives the rows' lse in the
  kernels' units, base 2 of the scaled scores: held to ``jax.numpy``'s
  ``logsumexp`` of the masked scores times log2 e within 1e-5 (fp32 sums
  in another order).
* ``attention_backward_plain`` fed that lse (P = exp2(S scale log2 e -
  lse), as the kernels recompute it) equals the version that takes the
  softmax within 1e-5 of max |dX| (fp32, the same products).
* Against ``jax.vjp``: fp32 1e-4 and bf16 2e-2, the bounds of
  ``test_torch_flash_backward.py`` (max |diff| within the bound x max
  |want|, relative L2 within half of it).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 21)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention_xla
from repro_torch.kernels import flash_attention as FA
from torch_parity import rand
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

BF16, F32 = torch.bfloat16, torch.float32
JAX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype,D,want", [
    (BF16, 64, "sm90"), (BF16, 128, "sm90"), (BF16, 256, "sm90"),
    (BF16, 16, "cuda_core"), (BF16, 32, "cuda_core"),
    (F32, 16, "cuda_core"), (F32, 32, "cuda_core"),
    (F32, 64, "cuda_core"), (F32, 128, "cuda_core"),
])
def test_backward_route_and_counter(dtype, D, want, monkeypatch):
    """The backward takes the forward's route, and a call adds one to its
    route's counter only (``bwd_sm90_launch_count`` or
    ``bwd_launch_count``): the launch is stubbed, so the wrapper's whole
    path up to the C call runs here on CPU tensors."""
    assert FA.route(dtype, D) == want
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append(name) or 0

    monkeypatch.setattr(FA, "_lib", lambda name: calls.append(name) or Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(FA, "_n_sm", lambda dev: 132)
    x = torch.zeros(1, 70, 2, D, dtype=dtype)
    lse = torch.zeros(1, 2, 70)
    before = (FA.bwd_launch_count, FA.bwd_sm90_launch_count)
    dq, dk, dv = FA.attention_backward_cuda(x, x, x, x, x, lse, causal=True,
                                            sm_scale=0.1, head_axis=2)
    after = (FA.bwd_launch_count, FA.bwd_sm90_launch_count)
    step = (int(want == "cuda_core"), int(want == "sm90"))
    assert tuple(b - a for a, b in zip(before, after)) == step
    src = ("flash_attention_bwd_sm90" if want == "sm90"
           else "flash_attention_bwd")
    assert calls[0] == src
    assert dq.shape == x.shape and dq.dtype == dtype


def test_backward_plan_refuses_what_tma_cannot_read():
    """The sm90 backward's plan (q, k, v, dO; 64-row boxes, the launcher
    picks each kernel's) raises ValueError without a card for a base off
    16 bytes, a stride off 16 bytes and a head dim off 64 columns; o is
    read in 16-byte pieces by the prep pass, so its rows start on 16
    bytes."""
    q = torch.zeros(2, 100, 4, 64, dtype=BF16)
    g = FA.sm90_bwd_plan(q, q, q, q, 2)
    assert [x.box_rows for x in g] == [64] * 4
    assert all(x.dims == (64, 100, 4, 2) for x in g)
    off_base = torch.zeros(2, 100, 4, 65, dtype=BF16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.sm90_bwd_plan(q, off_base, q, q, 2)
    off_stride = torch.zeros(2, 100, 4, 68, dtype=BF16)[..., :64]
    with pytest.raises(ValueError, match="multiple of 16"):
        FA.sm90_bwd_plan(q, q, q, off_stride, 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        FA.sm90_bwd_plan(*(torch.zeros(1, 8, 2, 96, dtype=BF16),) * 4, 2)
    # the wrapper runs the plan before anything else touches the card
    lse = torch.zeros(2, 4, 100)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.attention_backward_cuda(q, off_base, q, q, q, lse, causal=True,
                                   sm_scale=0.1, head_axis=2)
    with pytest.raises(ValueError, match="o's rows"):
        FA.attention_backward_cuda(q, q, q, off_base, q, lse, causal=True,
                                   sm_scale=0.1, head_axis=2)


@pytest.mark.parametrize("B,Hkv,T,D,rep,want", [
    (1, 1, 4096, 256, 10, 2),  # recurrentgemma-2b: 64 kv tiles, 132 SMs
    (4, 8, 1024, 64, 4, 1),    # llama3.2-1b: 256 tiles fill the card
    (1, 1, 300, 256, 10, 10),  # 5 tiles: as many groups as q heads
    (1, 1, 300, 128, 1, 1),    # one q head: nothing to split
    (1, 2, 2200, 256, 5, 2),   # 70 tiles: about one wave with 2 groups
    (1, 2, 2200, 64, 5, 4),    # 36 tiles of 128 rows
])
def test_head_split(B, Hkv, T, D, rep, want):
    assert FA.bwd_head_split(B, Hkv, T, D, rep, 132) == want


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 7), (False, 9)])
@pytest.mark.parametrize("rep", [1, 3])
def test_plain_lse_equals_jax_logsumexp(causal, window, rep):
    """The lse of the plain forward (``(B, Hq, Tq)``) against
    ``jax.numpy.logsumexp`` of the same masked, scaled scores times
    log2 e."""
    B, Hkv, T, D = 2, 2, 30, 16
    qn, kn, vn = (rand((B, h, T, D), 60 + i, 0.7)
                  for i, h in enumerate((Hkv * rep, Hkv, Hkv)))
    q, k, v = (torch.tensor(x) for x in (qn, kn, vn))
    o, lse = FA.attention_plain(q, k, v, causal=causal, sm_scale=0.3,
                                window=window, return_lse=True)
    assert lse.shape == (B, Hkv * rep, T) and lse.dtype == F32
    torch.testing.assert_close(o, FA.attention_plain(
        q, k, v, causal=causal, sm_scale=0.3, window=window), rtol=0,
        atol=0)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(qn),
                   jnp.repeat(jnp.asarray(kn), rep, axis=1)) * 0.3
    r, c = np.arange(T)[:, None], np.arange(T)[None, :]
    vis = np.ones((T, T), bool)
    if causal:
        vis &= r >= c
    if window is not None:
        vis &= r - c < window
    want = jax.nn.logsumexp(jnp.where(vis, s, -jnp.inf), axis=-1) \
        * np.log2(np.e)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,rep", [(True, None, 1),
                                               (False, 5, 3), (True, 9, 2)])
def test_backward_from_lse_equals_recompute(causal, window, rep):
    """The plain backward fed the forward's lse against the one that
    takes the softmax of the scores again: the same gradients in fp32."""
    B, Hkv, T, D = 2, 2, 40, 32
    q, k, v, do = (torch.tensor(rand((B, T, h, D), 70 + i, 0.5))
                   for i, h in enumerate((Hkv * rep, Hkv, Hkv, Hkv * rep)))
    t = lambda x: x.transpose(1, 2)
    o, lse = FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                sm_scale=0.2, window=window, return_lse=True)
    kw = dict(causal=causal, sm_scale=0.2, window=window, head_axis=2)
    a = FA.attention_backward_plain(q, k, v, t(o), do, lse, **kw)
    b = FA.attention_backward_plain(q, k, v, t(o), do, **kw)
    for x, y in zip(a, b):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


def test_function_saves_lse_only_under_grad():
    """Grad on: the Function saves q, k, v, the output and the lse (fp32
    ``(B, Hq, T)``, the plain forward's); grad off: nothing, and the same
    output."""
    q, k, v = (torch.tensor(rand((1, 20, h, 16), 80 + h, 0.5))
               .to(BF16) for h in (4, 2, 2))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x) or x, lambda x: x):
        with torch.no_grad():
            a = FA.flash_attention_bthd(q, k, v, causal=True)
        assert not saved
        qg = q.clone().requires_grad_(True)
        b = FA.flash_attention_bthd(qg, k, v, causal=True)
    assert len(saved) == 5
    lse = saved[4]
    t = lambda x: x.transpose(1, 2)
    _, want = FA.attention_plain(t(q), t(k), t(v), causal=True,
                                 sm_scale=0.25, return_lse=True)
    assert lse.dtype == F32 and lse.shape == (1, 4, 20)
    torch.testing.assert_close(lse, want, rtol=0, atol=0)
    torch.testing.assert_close(b.detach(), a, rtol=0, atol=0)


def _inputs(B, T, Hq, Hkv, D, dtype, seed):
    shapes = ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D))
    arrs = [rand(s, seed + i, 0.5) for i, s in enumerate(shapes)]
    return ([torch.tensor(a).to(getattr(torch, dtype)) for a in arrs],
            [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs])


def _assert_close(got, want, tol, what):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)
    l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert l2 <= tol / 2, (what, l2)


@pytest.mark.parametrize("dtype,D,Hq,Hkv,causal,window", [
    ("bfloat16", 256, 5, 1, True, 64),     # recurrentgemma's: MQA, window
    ("bfloat16", 256, 10, 1, False, 64),
    ("float32", 64, 4, 2, True, None),
    ("float32", 128, 3, 1, True, 64),
])
def test_backward_equals_jax_vjp(dtype, D, Hq, Hkv, causal, window):
    """The autograd route's gradient (the plain forward's lse into the
    plain backward) against ``jax.vjp`` of ``flash_attention_xla`` at T 100,
    past the window of 64."""
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(1, 100, Hq, Hkv, D, dtype,
                                               90 + D + Hq)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = FA.flash_attention_bthd(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = jax.jit(lambda a, b, c, d: jax.vjp(
        lambda x, y, z: flash_attention_xla(x, y, z, causal=causal,
                                            window=window),
        a, b, c)[1](d))(jq, jk, jv, jdo)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == q.dtype
        _assert_close(g, w, JAX_TOL[dtype], f"d{name}")
