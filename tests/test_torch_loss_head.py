"""The loss head of ``repro_torch.kernels.loss_head`` on the CPU: its plain
version (the same arithmetic as the card's kernels and bf16 products)
against the fp32 einsum head the model ran before it
(``models.model._xent_eager``, the reference's ``_xent`` as written), and
the route ``models.model._xent`` takes.

* The three-way split of the logits' gradient is exact, bit for bit, for
  every fp32 value from 2^-110 up to the largest that bf16 does not round
  to infinity, and for +-0.  Below 2^-110 (fp32's smallest normal is
  2^-126) the lowest term is under bf16's subnormal step 2^-133 and the
  split loses at most 2^-134.
* The gradients in fp32, before their cast to bf16, differ from the eager
  head's only by the order of the fp32 sums: each element within ``2 K
  2^-24`` times the sum of the absolute products it adds (``K`` the
  length of the sum: the vocabulary for dX, three times the rows for
  dW), the bound of two recursive fp32 sums.  After the cast the bf16
  gradients differ by at most that bound plus one bf16 ulp an element,
  the loss by fp32 rounding (rtol 1e-6).
* fp32 operands and DTensors take the eager head, plain bf16 ones the new
  head, and on the CPU no kernel launches.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import loss_head as LH
from repro_torch.models import model as M
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _from_bits(sign, exp_field, mant):
    bits = (np.asarray(sign, np.uint32) << 31) | \
        (np.asarray(exp_field, np.uint32) << 23) | np.asarray(mant, np.uint32)
    return torch.from_numpy(bits.astype(np.uint32).view(np.float32))


def _terms(d):
    n = d.numel()
    s = LH.split3(d.reshape(-1))
    assert s.dtype == torch.bfloat16 and s.shape == (3 * n,)
    return s[:n], s[n:2 * n], s[2 * n:]


# the largest fp32 value that bf16 rounds to a finite value (bf16's largest
# finite plus just under half its ulp); above it hi is infinite
_LARGEST = float(np.nextafter(np.float32(2.0 ** 127 * (2 - 2 ** -8)),
                              np.float32(0)))


@pytest.mark.parametrize("lo_exp,hi_exp", [(-110, -60), (-60, -10),
                                           (-10, 10), (10, 60), (60, 127)])
def test_split3_is_exact_over_the_exponent_range(lo_exp, hi_exp):
    """``hi + mid + lo == d`` bit for bit (in fp64, and in fp32 summed
    ``hi + (mid + lo)``; for +-0, ``hi`` is ``d``) on seeded fp32 of both
    signs with every exponent of the band, random 23-bit mantissas, plus
    +-0, the band's edges and, in the top band, bf16's largest finite
    value and the largest fp32 value that still rounds below infinity."""
    rng = np.random.default_rng(lo_exp + 1000)
    n = 20_000
    d = _from_bits(rng.integers(0, 2, n), rng.integers(lo_exp, hi_exp, n)
                   + 127, rng.integers(0, 1 << 23, n))
    edges = [0.0, -0.0, 2.0 ** lo_exp, -(2.0 ** lo_exp),
             float(np.nextafter(np.float32(2.0 ** hi_exp), np.float32(0)))]
    if hi_exp == 127:
        edges += [3.3895313892515355e38, _LARGEST, -_LARGEST]
    d = torch.cat([d, torch.tensor(edges, dtype=torch.float32)])
    hi, mid, lo = _terms(d)
    assert torch.equal(hi.double() + mid.double() + lo.double(), d.double())
    got = hi.float() + (mid.float() + lo.float())
    nz = d != 0
    assert torch.equal(got[nz].view(torch.int32), d[nz].view(torch.int32))
    # +-0: hi is d itself, sign included; mid and lo are +0
    assert torch.equal(hi[~nz].float().view(torch.int32),
                       d[~nz].view(torch.int32))
    assert not mid[~nz].any() and not lo[~nz].any()


def test_split3_below_2e_minus_110_loses_at_most_2e_minus_134():
    """Near fp32's smallest normal (2^-126) and among its subnormals the
    terms keep every bit down to bf16's subnormal step 2^-133: the split is
    exact where ``d`` is a multiple of it and otherwise off by at most
    2^-134 (half that step)."""
    rng = np.random.default_rng(7)
    n = 20_000
    d = torch.cat([
        _from_bits(rng.integers(0, 2, n), rng.integers(-126, -110, n) + 127,
                   rng.integers(0, 1 << 23, n)),
        _from_bits(rng.integers(0, 2, n), 0, rng.integers(0, 1 << 23, n))])
    hi, mid, lo = _terms(d)
    err = (hi.double() + mid.double() + lo.double() - d.double()).abs()
    assert err.max().item() <= 2.0 ** -134
    step = torch.tensor(2.0 ** -133, dtype=torch.float64)
    on_step = torch.remainder(d.double(), step) == 0
    grid = torch.tensor([2.0 ** -126, 2.0 ** -126 + 2.0 ** -133,
                         1.5 * 2.0 ** -120 + 5 * 2.0 ** -133,
                         -(2.0 ** -127) - 2.0 ** -133], dtype=torch.float32)
    ghi, gmid, glo = _terms(grid)
    assert torch.equal(ghi.double() + gmid.double() + glo.double(),
                       grid.double())
    assert err[on_step].max().item() == 0 if on_step.any() else True


def _operands(R, D, V, tied, seed, masked=(3, 7)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(R, D, generator=g).bfloat16()
    w = (torch.randn(D, V, generator=g) * 0.3).bfloat16()
    if tied:                            # embed (V, D); the head is embed.T
        w = w.t().contiguous().t()
    labels = torch.randint(0, V, (R,), generator=g)
    labels[list(masked)] = -1
    return x, w, labels


def _eager_fp32(x, w, labels, scale):
    """The eager head's fp32 loss, dX and dW (autograd through ``.float()``
    leaves), for a loss of ``scale`` times the nll sum."""
    xf = x.float().requires_grad_(True)
    wf = w.float().requires_grad_(True)
    lg = xf @ wf
    lse = torch.logsumexp(lg, -1)
    mask = labels >= 0
    true_lg = torch.gather(lg, -1, labels.clamp_min(0)[:, None])[:, 0]
    nll = torch.where(mask, lse - true_lg, torch.zeros_like(lse))
    (nll.sum() * scale).backward()
    return nll.detach(), xf.grad, wf.grad


def _sum_order_bound(d3, w, x, V, R):
    """Per element, ``2 K 2^-24`` times the sum of the absolute products:
    dX over the vocabulary, dW over the 3R rows."""
    d = d3.double()
    a = d[:R].abs() + d[R:2 * R].abs() + d[2 * R:].abs()
    bx = 2 * V * 2.0 ** -24 * (a @ w.double().abs().t())
    bw = 2 * 3 * R * 2.0 ** -24 * (x.double().abs().t() @ a)
    return bx, bw


@pytest.mark.parametrize("R,D,V,tied", [(32, 64, 1000, False),
                                        (32, 64, 1000, True),
                                        (48, 32, 997, False),
                                        (16, 64, 997, True),
                                        (64, 128, 4096, False)])
def test_head_grads_match_the_eager_head_in_fp32(R, D, V, tied):
    """Loss, dX and dW of the plain version, in fp32 before the cast,
    against autograd of the eager fp32 head: untied and tied heads, labels
    of -1, a ragged vocabulary (not a multiple of 128, nor of 4), within
    the bound of the sums' order (module notes)."""
    x, w, labels = _operands(R, D, V, tied, R + V)
    scale = 1.0 / int((labels >= 0).sum())
    nll0, dx0, dw0 = _eager_fp32(x, w, labels, scale)
    lse, nll = LH.xent_fwd(LH.head_mm(x, w), labels)
    torch.testing.assert_close(nll, nll0, rtol=1e-6, atol=1e-6)
    g = torch.full((R,), scale)
    dx, dw = LH.head_grads(x, w, labels, lse, g)
    d3 = LH.xent_bwd(LH.head_mm(x, w), lse, labels, g)
    bx, bw = _sum_order_bound(d3, w, x, V, R)
    assert dx.dtype == dw.dtype == torch.float32
    assert dw.shape == w.shape and dw.stride() == w.stride()
    assert ((dx.double() - dx0.double()).abs() <= bx).all()
    assert ((dw.double() - dw0.double()).abs() <= bw).all()
    assert not dx[list((3, 7))].any()       # masked rows: no gradient


def _ulp_bf16(t):
    """One bf16 ulp of each element's magnitude (the subnormal step at 0)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _model_case(arch, vocab=None, tie=None, seed=0):
    cfg = get_arch(arch).reduced()
    kw = {k: v for k, v in (("vocab", vocab), ("tie_embeddings", tie))
          if v is not None}
    cfg = dataclasses.replace(cfg, **kw)
    params = M.init_params(cfg, seed, "cpu").requires_grad_(True)
    g = torch.Generator().manual_seed(seed + 1)
    B, C = 2, 24
    x = torch.randn(B, C, cfg.d_model, generator=g).bfloat16()
    shape = (B, C) + ((cfg.n_codebooks,) if cfg.frontend == "audio_stub"
                      else ())
    labels = torch.randint(0, cfg.vocab, shape, generator=g)
    labels[0, :3] = -1
    labels[1, -2:] = -1
    return cfg, params, x.requires_grad_(True), labels


def _abs_terms(cfg, params, x, labels, n):
    """The bounds of the sums' order for the gradients at ``x`` and at the
    head's leaf of ``nll sum / n``: per element ``2 K 2^-24`` times the sum
    of the absolute products it adds (dX sums over every codebook's
    vocabulary, dW over 3R rows)."""
    w = M._unembed(cfg, params).detach()
    xs = x.detach().reshape(-1, x.shape[-1])
    R = xs.shape[0]
    ws = w if w.dim() == 3 else w[None]
    ls = labels.reshape(R, -1)
    sx, sw = 0, []
    for k in range(ws.shape[0]):
        lg = LH.head_mm(xs, ws[k])
        lse, _ = LH.xent_fwd(lg, ls[:, k])
        d = LH.xent_bwd(lg, lse, ls[:, k],
                        torch.full((R,), 1.0 / n)).double().abs()
        a = d[:R] + d[R:2 * R] + d[2 * R:]
        sx = sx + a @ ws[k].double().abs().t()
        sw.append(xs.double().abs().t() @ a)
    sw = torch.stack(sw) if w.dim() == 3 else sw[0]
    if cfg.tie_embeddings:               # the leaf is embed: (.., V, D)
        sw = sw.transpose(-1, -2)
    kx = 2 * ws.shape[0] * ws.shape[-1] * 2.0 ** -24
    return kx * sx.reshape(x.shape), 2 * 3 * R * 2.0 ** -24 * sw


@pytest.mark.parametrize("arch,vocab,tie", [
    ("glm4-9b", None, None),                 # untied
    ("llama3.2-1b", None, None),             # tied: embed.T
    ("llama3.2-1b", 250, None),              # tied, ragged vocabulary
    ("qwen3-4b", 1000, False),               # untied, ragged vocabulary
    ("musicgen-medium", None, None),         # the audio stub's codebooks
    ("musicgen-medium", 250, True)])         # tied codebooks, ragged
def test_model_head_matches_the_eager_head(arch, vocab, tie):
    """``models.model._xent`` on bf16 CPU tensors (the new head's plain
    version, one ``LossHeadFn`` call for all codebooks) against
    ``_xent_eager`` on the same leaves: the nll sum within fp32 rounding,
    the count equal, and every bf16 gradient element (x, the head's leaf)
    within the bound of the sums' order plus one bf16 ulp (each side's
    cast rounds once)."""
    cfg, params, x, labels = _model_case(arch, vocab, tie)
    leaves = [x, params["embed" if cfg.tie_embeddings else "unembed"]]
    calls = []
    apply = LH.LossHeadFn.apply
    LH.LossHeadFn.apply = lambda *a: calls.append(1) or apply(*a)
    try:
        s, n = M._xent(cfg, M._unembed(cfg, params), x, labels, True)
    finally:
        LH.LossHeadFn.apply = apply
    assert len(calls) == 1
    s0 = M._xent_eager(cfg, M._unembed(cfg, params).float(), x, labels)
    assert int(n) == int((labels >= 0).sum())
    torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
    got = torch.autograd.grad(s / n, leaves)
    want = torch.autograd.grad(s0 / n, leaves)
    for a, b, bound in zip(got, want, _abs_terms(cfg, params, x, labels,
                                                 int(n))):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        a, b = a.double(), b.double()
        ulp = _ulp_bf16(torch.maximum(a.abs(), b.abs()))
        assert ((a - b).abs() <= bound + ulp).all()
        assert (a != 0).any()


def test_head_saves_no_fp32_weight_and_no_logits():
    """What the head keeps for its backward: ``x`` and ``w`` as they are
    (bf16, ``w`` the parameter itself), the labels and the fp32 lse, one
    per row; no fp32 copy of the weight and no logits."""
    x, w, labels = _operands(32, 64, 1000, False, 3)
    w = w.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        LH.loss_head(x.requires_grad_(True), w, labels)
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [
        (torch.bfloat16, (32, 64)), (torch.bfloat16, (64, 1000)),
        (torch.int64, (32,)), (torch.float32, (32,))]
    assert saved[1].data_ptr() == w.data_ptr()


def _reset_counts():
    LH.fwd_launch_count = LH.bwd_launch_count = 0


def test_routes_on_the_cpu():
    """fp32 parameters take the eager head (the new one never runs); bf16
    ones take the new head, once a chunk through ``logits_and_loss``,
    whose plain version launches nothing on the CPU; the head refuses fp32
    operands."""
    _reset_counts()
    calls = []
    apply = LH.LossHeadFn.apply
    LH.LossHeadFn.apply = lambda *a: calls.append(1) or apply(*a)
    try:
        cfg, params, x, labels = _model_case("glm4-9b")
        w = M._unembed(cfg, params)
        assert M._bf16_head(x, w)
        s, _ = M._xent(cfg, w, x, labels, True)
        s.backward()
        assert len(calls) == 1
        p32 = M.init_params(cfg, 0, "cpu").to(torch.float32)
        x32, w32 = x.detach().float(), M._unembed(cfg, p32)
        assert not M._bf16_head(x32, w32)
        assert not M._bf16_head(x32, w.float().bfloat16())
        M._xent(cfg, w32, x32, labels, False)
        assert len(calls) == 1
        # the route is chosen once in logits_and_loss: a sequence of three
        # 8-position chunks calls the new head three times in bf16, never
        # in fp32
        from repro_torch.data import DataConfig, make_batch
        batch = make_batch(cfg, DataConfig(seq_len=24, global_batch=2), 0,
                           device="cpu")
        M.logits_and_loss(cfg, params, batch, seq_chunk=8)
        assert len(calls) == 4
        M.logits_and_loss(cfg, p32, batch, seq_chunk=8)
        assert len(calls) == 4
    finally:
        LH.LossHeadFn.apply = apply
    assert LH.fwd_launch_count == LH.bwd_launch_count == 0
    with pytest.raises(ValueError):
        LH.loss_head(x.detach().float(), M._unembed(cfg, p32), labels[0])


_DTENSOR_ROUTE = r"""
import socket, sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=1, rank=0)
from repro_torch.configs import get_arch
from repro_torch.kernels import loss_head as LH
from repro_torch.models import model as M
cfg = get_arch("glm4-9b").reduced()
params = M.init_params(cfg, 0, "cpu")
g = torch.Generator().manual_seed(1)
x = torch.randn(2, 8, cfg.d_model, generator=g).bfloat16()
labels = torch.randint(0, cfg.vocab, (2, 8), generator=g)
want, n0 = M._xent(cfg, M._unembed(cfg, params), x, labels, True)
mesh = init_device_mesh("cpu", (1,))
w = distribute_tensor(params["unembed"], mesh, [Shard(1)])
params.unembed = torch.nn.Parameter(w, requires_grad=False)
xd = distribute_tensor(x, mesh, [Replicate()])
assert not M._bf16_head(xd, w) and not M._bf16_head(x, w)
def refuse(*a):
    raise AssertionError("the new head ran on a DTensor")
LH.LossHeadFn.apply = refuse
with implicit_replication():
    got, n = M._xent(cfg, M._unembed(cfg, params).float(), xd, labels,
                     False)
got = got.full_tensor() if hasattr(got, "full_tensor") else got
assert int(n) == int(n0)
torch.testing.assert_close(got.float(), want.float(), rtol=1e-5, atol=0)
assert LH.fwd_launch_count == LH.bwd_launch_count == 0
dist.destroy_process_group()
print("ok")
"""


def test_dtensor_head_takes_the_eager_route():
    """A vocab-sharded head (a DTensor, one gloo rank in a subprocess: a
    process holds one process group) takes the eager head and gives the
    plain tensors' nll sum within fp32 rounding."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _DTENSOR_ROUTE],
                         capture_output=True, text=True, env=env,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
