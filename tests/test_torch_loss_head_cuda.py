"""The loss head on the card (``repro_torch.kernels.loss_head``): the
``xent_fwd`` and ``xent_bwd`` kernels against their plain versions, the
whole head against the eager fp32 head at the training cell's chunk
(1,024 rows of glm4-9b: D 4,096, V 151,552) and at a tied, ragged one,
its products' settings, and the launches of one glm4-9b step.  Every test
needs an NVIDIA GPU and ``nvcc`` and skips without them; on the card run

    python -m pytest -q -m cuda tests/test_torch_loss_head_cuda.py

Tolerances come from the order of the fp32 sums alone (the operands of
every product are the same bf16 values on both sides):

* a sum of ``K`` products, each exact, reordered: at most ``2 K 2^-23``
  times the sum of their magnitudes apart (two sums, each off by at most
  ``K u`` of it; ``u = 2^-23`` covers the tensor cores' truncating
  adds).  A logit (``K`` = D), an element of dX (``K`` = V) or of dW
  (``K`` = 3R) is held to that;
* a row's nll moves by at most twice its logits' largest bound, plus the
  lse's own sums: one exp per logit summed in fp32 in another order, here
  per thread over ~600 terms, then across the block (2e-5 absolute at lse
  ~12);
* after the cast to bf16 one ulp more an element.

The kernels against their plain versions on the same logits and lse:
``xent_bwd``'s three terms are the exact split of an fp32 value (the
split of their sum gives them back bit for bit), 4 fp32 ulps from the
plain one (expf against torch's exp, each within 2 ulps).
This file imports neither ``jax`` nor ``repro``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                    # noqa: E402
from repro_torch.kernels import loss_head as LH             # noqa: E402
from repro_torch.models import model as M                   # noqa: E402

pytestmark = pytest.mark.cuda

#: the training cell's chunk: 2 x 512 positions of glm4-9b
CELL = (1024, 4096, 151552)
U = 2.0 ** -23


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card: python "
                    "-m pytest -q -m cuda tests/test_torch_loss_head_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(R, D, V, tied, dev, seed=0, label_dtype=torch.int64):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(R, D, device=dev, generator=g).bfloat16()
    w = (torch.randn(D, V, device=dev, generator=g) * D ** -0.5).bfloat16()
    if tied:                            # embed (V, D); the head is embed.T
        w = w.t().contiguous().t()
    labels = torch.randint(0, V, (R,), device=dev, generator=g,
                           dtype=label_dtype)
    labels[::7] = -1
    return x, w, labels


@pytest.mark.parametrize("R,V", [(1024, 151552), (37, 997), (8, 1000),
                                 (3, 4)])
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
def test_xent_fwd_kernel_equals_plain_version(cuda, R, V, label_dtype):
    """lse and nll of the kernel against ``xent_fwd_plain`` on the same
    logits (a ragged V takes the scalar loop): within 2e-5 + 2^-21 |lse|,
    the nll 0 exactly where the label is -1; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(R + V)
    lg = torch.randn(R, V, device=cuda, generator=g) * 4
    labels = torch.randint(0, V, (R,), device=cuda, generator=g,
                           dtype=label_dtype)
    labels[::3] = -1
    before = LH.fwd_launch_count
    lse, nll = LH.xent_fwd(lg, labels)
    assert LH.fwd_launch_count == before + 1
    lse0, nll0 = LH.xent_fwd_plain(lg, labels)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse0, rtol=2.0 ** -21, atol=2e-5)
    torch.testing.assert_close(nll, nll0, rtol=2.0 ** -21, atol=2e-5)
    assert not nll[labels < 0].any()


def _exact_split(d3):
    """The fp32 values whose exact split ``d3`` is (asserted: splitting
    their sum again gives the three terms bit for bit)."""
    R = d3.shape[0] // 3
    d = d3[:R].double() + d3[R:2 * R].double() + d3[2 * R:].double()
    d32 = d.float()
    assert torch.equal(d32.double(), d)
    assert torch.equal(LH.split3(d32).view(torch.int16),
                       d3.view(torch.int16))
    return d32


@pytest.mark.parametrize("R,V", [(1024, 151552), (37, 997), (8, 1000)])
def test_xent_bwd_kernel_equals_plain_version(cuda, R, V):
    """The kernel's three terms are the exact split of fp32 values within 4
    fp32 ulps (and 2^-133) of ``xent_bwd_plain``'s on the same logits and
    lse; rows with label -1 are 0; the gradient is read through its stride
    (an expanded scalar and a column of an (R, 3) gradient)."""
    g = torch.Generator(device=cuda).manual_seed(R + V)
    lg = torch.randn(R, V, device=cuda, generator=g) * 4
    labels = torch.randint(0, V, (R,), device=cuda, generator=g)
    labels[::5] = -1
    lse, _ = LH.xent_fwd(lg, labels)
    grads = (torch.full((), 1 / 1000., device=cuda).expand(R),
             torch.rand(R, 3, device=cuda, generator=g)[:, 1])
    for gr in grads:
        before = LH.bwd_launch_count
        d3 = LH.xent_bwd(lg, lse, labels, gr)
        assert LH.bwd_launch_count == before + 1
        assert d3.shape == (3 * R, V) and d3.dtype == torch.bfloat16
        d = _exact_split(d3)
        d0 = _exact_split(LH.xent_bwd_plain(lg, lse, labels, gr))
        err = (d.double() - d0.double()).abs()
        assert (err <= 4 * 2.0 ** -24 * d0.double().abs()
                + 2.0 ** -133).all()
        assert not d3.view(3, R, V)[:, labels < 0].any()


def test_head_products_keep_fp32_sums_whatever_the_settings(cuda):
    """``head_mm`` gives the same bits with
    ``allow_bf16_reduced_precision_reduction`` on and off and with TF32
    on: its operands are bf16 and its output fp32, so neither applies; a
    long reduction (K = 151,552, cuBLAS may split it) stays within the
    fp32 bound of the fp64 product."""
    x, w, _ = _operands(64, 4096, 151552, False, cuda)
    d3 = (torch.randn(192, 151552, device=cuda) * 1e-4).bfloat16()
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32)
    outs = []
    try:
        for red, tf32 in ((True, False), (False, False), (True, True)):
            mm.allow_bf16_reduced_precision_reduction = red
            mm.allow_tf32 = tf32
            outs.append((LH.head_mm(x, w), LH.head_mm(d3, w.t())))
    finally:
        mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32 = saved
    for a, b in outs[1:]:
        assert torch.equal(a, outs[0][0]) and torch.equal(b, outs[0][1])
    lg, dx = outs[0]
    assert lg.dtype == dx.dtype == torch.float32
    ref = d3.double() @ w.t().double()
    bound = 2 * 151552 * U * (d3.double().abs() @ w.t().double().abs())
    assert ((dx.double() - ref).abs() <= bound).all()


def _eager(x, w, labels, scale):
    """The eager fp32 head (``models.model._xent_eager``'s arithmetic) and
    its fp32 gradients at ``x`` and ``w``."""
    xf = x.float().requires_grad_(True)
    wf = w.float().requires_grad_(True)
    lg = xf @ wf
    lse = torch.logsumexp(lg, -1)
    mask = labels >= 0
    true_lg = torch.gather(lg, -1, labels.clamp_min(0)[:, None])[:, 0]
    nll = torch.where(mask, lse - true_lg, torch.zeros_like(lse))
    (nll.sum() * scale).backward()
    return nll.detach(), xf.grad, wf.grad


def _ulp_bf16(t):
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _check_head(x, w, labels):
    """The whole head (autograd through ``loss_head``) against the eager
    fp32 head: nll per row, fp32 dX and dW before the cast, and the bf16
    gradients autograd hands on, at the bounds of the module notes."""
    R, D = x.shape
    V = w.shape[1]
    n = int((labels >= 0).sum())
    nll0, dx0, dw0 = _eager(x, w, labels, 1.0 / n)
    xr = x.clone().requires_grad_(True)
    wr = w.detach().clone().t().contiguous().t() if w.stride(0) == 1 \
        else w.detach().clone()
    wr.requires_grad_(True)
    counts = (LH.fwd_launch_count, LH.bwd_launch_count)
    nll = LH.loss_head(xr, wr, labels)
    (nll.sum() / n).backward()
    assert (LH.fwd_launch_count, LH.bwd_launch_count) == (
        counts[0] + 1, counts[1] + 1)
    absx, absw = x.float().abs(), w.float().abs()
    lg_bound = 2 * D * U * (absx @ absw)
    nll_bound = 2 * lg_bound.amax(1) + 2e-5 + 2.0 ** -21 * nll0.abs()
    assert ((nll - nll0).abs() <= nll_bound).all()
    del lg_bound
    lse, _ = LH.xent_fwd(LH.head_mm(x, w), labels)
    g = torch.full((R,), 1.0 / n, device=x.device)
    dx, dw = LH.head_grads(x, w, labels, lse, g)
    d3 = LH.xent_bwd(LH.head_mm(x, w), lse, labels, g).float().abs()
    a = d3[:R] + d3[R:2 * R] + d3[2 * R:]
    del d3
    bx = 2 * V * U * (a @ absw.t())
    assert ((dx - dx0).abs() <= bx).all()
    ulp = _ulp_bf16(torch.maximum(xr.grad.float().abs(), dx0.abs()))
    assert ((xr.grad.float() - dx0).abs() <= bx + ulp).all()
    del bx, dx, dx0
    bw = 2 * 3 * R * U * (absx.t() @ a)
    assert ((dw - dw0).abs() <= bw).all()
    del dw
    gw = wr.grad.float()
    assert wr.grad.stride() == wr.stride()
    assert ((gw - dw0).abs() <= bw + _ulp_bf16(torch.maximum(
        gw.abs(), dw0.abs()))).all()


def test_head_equals_eager_head_at_the_cells_chunk(cuda):
    """1,024 rows against glm4-9b's untied head (D 4,096, V 151,552),
    labels of -1 among them: loss, dX and dW against the eager fp32 head."""
    _check_head(*_operands(*CELL, False, cuda))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("V", [1000, 997])
def test_head_equals_eager_head_tied_and_ragged(cuda, V):
    """A tied head (``embed.T``: the products read the transpose) with a
    ragged vocabulary (not a multiple of 128; 997 takes the kernels'
    scalar loops) and int32 labels."""
    _check_head(*_operands(300, 256, V, True, cuda, seed=V,
                           label_dtype=torch.int32))


def _glm4_step(dev, layers=1):
    """One ``make_train_step`` of glm4-9b at full width (``layers``
    layers) on the cell's 2 x 8,192 tokens."""
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step, train_init
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=layers)
    oc = AdamWConfig()
    state = train_init(cfg, M.init_params(cfg, 0, dev), oc)
    batch = make_batch(cfg, DataConfig(seq_len=8192, global_batch=2), 0,
                       device=dev)
    return make_train_step(cfg, oc)(state, batch)


def test_glm4_step_launches_each_kernel_once_a_chunk(cuda):
    """A glm4-9b step at the cell's 2 x 8,192 tokens runs 16 chunks of 512
    positions: 16 launches of each kernel; the fp32 head (an fp32 step of
    the reduced glm4-9b) launches none."""
    before = (LH.fwd_launch_count, LH.bwd_launch_count)
    _, met = _glm4_step(cuda)
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"]).item()
    assert (LH.fwd_launch_count - before[0],
            LH.bwd_launch_count - before[1]) == (16, 16)
    torch.cuda.empty_cache()
    cfg = get_arch("glm4-9b").reduced()
    params = M.init_params(cfg, 0, cuda).to(torch.float32)
    params.requires_grad_(True)
    from repro_torch.data import DataConfig, make_batch
    batch = make_batch(cfg, DataConfig(seq_len=64, global_batch=2), 0,
                       device=cuda)
    before = (LH.fwd_launch_count, LH.bwd_launch_count)
    loss, _ = M.logits_and_loss(cfg, params, batch)
    loss.backward()
    torch.cuda.synchronize()
    assert (LH.fwd_launch_count, LH.bwd_launch_count) == before
