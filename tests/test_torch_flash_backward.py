"""The gradient of the port's flash attention on the CPU: the plain
version of the backward kernel (``flash_attention.attention_backward_plain``)
and the autograd Function the entry points run through when grad is on.

* Against ``torch.autograd`` through the plain forward
  (``attention_plain``): fp32 within 1e-5 (the same fp32 products in
  another order), bf16 within 2e-2 (the Function reads the forward's
  bf16-rounded output for ``rowsum(dO * O)``, autograd the fp32 one).
* Against ``jax.vjp`` of the reference model's ``flash_attention_xla``
  on the same numpy inputs: fp32 1e-4 (its chunked online softmax sums in
  another order), bf16 2e-2 (its cotangents round to bf16 op by op),
  causal and full, window 64 and none, GQA rep 1 and 4, T 100 (a ragged
  tail for 64-row tiles) and 128.

A tolerance ``tol`` bounds each of dQ, dK, dV: max |diff| within ``tol``
x max |want| and the relative L2 error within ``tol / 2`` (measured: bf16
4.8e-3 and 2.0e-3 at most, fp32 7.7e-7 and 5.2e-7).
* With grad disabled, or with no input requiring grad, the entry points
  save nothing and return what they returned before (the serving path).

The backward kernel against this plain version runs on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 21)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention_xla
from repro_torch.kernels import flash_attention as FA
from torch_parity import rand
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

#: vs autograd through the plain forward; vs jax.vjp
AUTOGRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(B, T, Hq, Hkv, D, dtype, seed):
    """q, k, v, do in the model's (B, T, H, D) layout: numpy fp32 from
    ``seed``, then the same values in both packages' ``dtype``."""
    shapes = ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D))
    arrs = [rand(s, seed + i, 0.5) for i, s in enumerate(shapes)]
    tt = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    jj = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    return tt, jj


def _assert_close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32)) \
        if not isinstance(want, torch.Tensor) else want.float().numpy()
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)
    l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert l2 <= tol / 2, (what, l2)


def _port_grads(q, k, v, do, causal, window):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = FA.flash_attention_bthd(q, k, v, causal=causal, window=window)
    assert o.grad_fn is not None and "FlashAttentionFn" in type(
        o.grad_fn).__name__
    return torch.autograd.grad(o, (q, k, v), do)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5), (False, 7)])
@pytest.mark.parametrize("rep", [1, 3])
def test_plain_backward_equals_autograd(dtype, causal, window, rep):
    (q, k, v, do), _ = _inputs(2, 40, 2 * rep, 2, 16, dtype, 10)
    got = _port_grads(q, k, v, do, causal, window)
    qa, ka, va = (x.float().requires_grad_(True) for x in (q, k, v))
    t = lambda x: x.transpose(1, 2)
    o = t(FA.attention_plain(t(qa), t(ka), t(va), causal=causal,
                             sm_scale=16 ** -0.5, window=window))
    want = torch.autograd.grad(o, (qa, ka, va), do.float())
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == q.dtype
        _assert_close(g, w, AUTOGRAD_TOL[dtype], f"d{name}")


def test_plain_backward_layouts_agree():
    """``head_axis`` 1 and 2 give the same gradients, transposed."""
    (q, k, v, do), _ = _inputs(2, 30, 4, 2, 32, "float32", 20)
    o = FA.flash_attention_bthd(q, k, v, causal=True)
    a = FA.attention_backward_plain(q, k, v, o, do, causal=True,
                                    sm_scale=0.2, window=9, head_axis=2)
    t = lambda x: x.transpose(1, 2)
    b = FA.attention_backward_plain(t(q), t(k), t(v), t(o), t(do),
                                    causal=True, sm_scale=0.2, window=9,
                                    head_axis=1)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, t(y), rtol=0, atol=0)


#: causal and full, window 64 and none, rep 1 and 4, T 100 and 128: each
#: value of each axis twice, every pair of axes' values once
CASES = [(True, None, 1, 100), (False, None, 4, 128), (True, 64, 4, 128),
         (False, 64, 1, 100)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,rep,T", CASES)
def test_backward_equals_jax_vjp(dtype, causal, window, rep, T):
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(2, T, 2 * rep, 2, 32, dtype,
                                               30 + T + rep)
    got = _port_grads(q, k, v, do, causal, window)
    want = jax.jit(lambda a, b, c, d: jax.vjp(
        lambda x, y, z: flash_attention_xla(x, y, z, causal=causal,
                                            window=window),
        a, b, c)[1](d))(jq, jk, jv, jdo)
    for g, w, name in zip(got, want, "qkv"):
        _assert_close(g, w, JAX_TOL[dtype], f"d{name}")


def test_no_grad_saves_nothing_and_changes_nothing():
    """Grad disabled (or no input requiring grad): no graph, no saved
    tensor, the same output as the plain forward and no launch counted."""
    (q, k, v, _), _ = _inputs(1, 24, 4, 2, 16, "bfloat16", 40)
    want = FA.flash_attention_bthd(q, k, v, causal=True, window=6)
    counts = (FA.launch_count, FA.sm90_launch_count, FA.d256_launch_count,
              FA.bwd_launch_count)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x) or x, lambda x: x):
        with torch.no_grad():
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
            a = FA.flash_attention_bthd(qg, kg, vg, causal=True, window=6)
        b = FA.flash_attention_bthd(q, k, v, causal=True, window=6)
        assert not saved
        c = FA.flash_attention_bthd(qg, kg, vg, causal=True, window=6)
        assert len(saved) == 5              # q, k, v, the output, its lse
    for x in (a, b):
        assert x.grad_fn is None and not x.requires_grad
        torch.testing.assert_close(x, want, rtol=0, atol=0)
    torch.testing.assert_close(c.detach(), want, rtol=0, atol=0)
    assert counts == (FA.launch_count, FA.sm90_launch_count,
                      FA.d256_launch_count, FA.bwd_launch_count)


def test_backward_kernel_refusals_need_no_card():
    """The CUDA wrapper's refusals come before any launch, and every case
    the forward takes has a backward kernel: what is still refused raises
    ValueError: fp32 at D 256 (as the forward refuses it), Tq != Tk, and
    rows of k or o off 16 bytes on the CUDA-core route (checked here on
    CPU tensors, which never reach a launch otherwise; the sm90 route's
    TMA refusals are in ``test_torch_flash_bwd_sm90.py``)."""
    x = torch.zeros(1, 8, 2, 256)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="head_dim 256"):
        FA.attention_backward_cuda(x, x, x, x, x, lse, causal=True,
                                   sm_scale=0.1, head_axis=2)
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    y = torch.zeros(1, 9, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Tq"):
        FA.attention_backward_cuda(x, y, y, x, x, lse, causal=True,
                                   sm_scale=0.1, head_axis=2)
    # rows staged by 16-byte cp.async (o's too: every block computes
    # rowsum(dO * O) itself): one starting off 16 bytes raises
    x = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    odd = torch.zeros(1, 8, 2, 33, dtype=torch.bfloat16)[..., 1:]
    for args in ((x, odd, x, x, x), (x, x, x, odd, x)):
        with pytest.raises(ValueError, match="16 bytes"):
            FA.attention_backward_cuda(*args, lse, causal=True, sm_scale=0.1,
                                       head_axis=2)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 32),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 32)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
@pytest.mark.parametrize("B,T,Hq,Hkv", [(2, 257, 4, 2), (1, 31, 5, 1)])
def test_core_backward_plan_covers_each_tile_once_heaviest_first(
        dtype, D, causal, window, B, T, Hq, Hkv):
    """The CUDA-core backward's one launch (``bwd_core_plan``, decoded by
    ``bwd_core_block`` as its kernel decodes ``blockIdx``): every (q tile,
    q head, batch) has exactly one dQ block and every (kv tile, kv head,
    batch) one dK/dV block.  Without a window each role's blocks come in
    non-increasing order of the 64-row other-side tiles they step over
    (the kernel's loop: kv tiles up to the tile's last row under the
    causal mask, q tiles from its first), heaviest first; a window makes
    that work flat up to one step of tile alignment, so there only the
    coverage is checked."""
    rows, n = FA.bwd_core_plan(dtype, D, B, T, Hq, Hkv)
    assert rows == FA.BWD_CORE_ROWS[dtype, D]
    blocks = [FA.bwd_core_block(i, B, T, Hq, Hkv, rows, causal)
              for i in range(n)]
    n_t, other = -(-T // rows), 64

    def steps(role, t):
        r0 = t * rows
        lo, hi = ((0, min(T, r0 + rows) if causal else T) if role == "dq"
                  else (r0 if causal else 0, T))
        return -(-hi // other) - lo // other

    for role, H in (("dq", Hq), ("dkdv", Hkv)):
        mine = [blk[1:] for blk in blocks if blk[0] == role]
        assert sorted(mine) == [(t, h, b) for t in range(n_t)
                                for h in range(H) for b in range(B)]
        work = [steps(role, t) for t, _, _ in mine]
        if window is None:
            assert work == sorted(work, reverse=True), (role, work)
