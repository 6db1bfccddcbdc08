"""Plain PyTorch reference of a dense GQA transformer: the training step
(loss, gradients, AdamW) and the prefill (last logits, KV cache).

It follows the configuration file's model (``yardstick.model.Dense``):
token embedding; per layer an RMSNorm, q/k/v products, per-head RMSNorm
of q and k where the model has qk-norm, RoPE over the whole head (the two
halves rotated, base ``rope_theta``), causal attention with grouped kv
heads and scale ``1/sqrt(head_dim)``, the output product and a residual
add, then an RMSNorm, the SwiGLU MLP (``silu(x W_gate) * (x W_up)
W_down``) and a residual add; a final RMSNorm and the vocabulary head
(the embedding's transpose when tied).  An RMSNorm's weight is held as
its offset from 1: ``x / sqrt(mean(x^2) + eps) * (1 + w)``.

Weights come in as the harness made them (bf16) and every operation runs
in float32 with TF32 off.  Memory: activations are kept at layer
boundaries only and each layer's backward recomputes its forward; the
attention works on blocks of query rows; the head on blocks of positions.

``precision="fp8"`` is the control: every product's operands are rounded
to float8 (e4m3 forward, e5m2 for the gradients flowing back) with one
scale per tensor, the step a faster program would take below bf16.
Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_FWD = (torch.float8_e4m3fn, 448.0)
FP8_BWD = (torch.float8_e5m2, 57344.0)


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize(x, fmt):
    """``x`` rounded to the float8 format ``fmt`` with a per-tensor scale
    (its largest magnitude maps to the format's largest), back in fp32."""
    dtype, top = fmt
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / top
    return (x / s).to(dtype).to(torch.float32) * s


class _QMatmul(torch.autograd.Function):
    """``a @ b`` with both operands in float8 (e4m3) and the incoming
    gradient in float8 (e5m2)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a, FP8_FWD), quantize(b, FP8_FWD)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, FP8_BWD)
        ga = qg @ qb.transpose(-1, -2)
        gb = (qa.reshape(-1, qa.shape[-1]).transpose(0, 1)
              @ qg.reshape(-1, qg.shape[-1]))
        return ga, gb


def mm(a, b, precision: str):
    """``a (..., k) @ b (k, n)`` in fp32, or the control's float8."""
    if precision == "fp8":
        return _QMatmul.apply(a, b)
    return a @ b


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (1 + w)


def rope_tables(T: int, head_dim: int, theta: float, device):
    half = head_dim // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                         device=device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * freqs
    return (torch.cos(ang).float()[None, :, None, :],
            torch.sin(ang).float()[None, :, None, :])


def rope(x, tables):
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


class _Attention(torch.autograd.Function):
    """Causal attention, q ``(B, T, H, D)`` and k, v ``(B, T, Hkv, D)``, in
    blocks of ``blk`` query rows; the backward recomputes each block's
    probabilities from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, blk, precision):
        if precision == "fp8":
            q, k, v = (quantize(t, FP8_FWD) for t in (q, k, v))
        B, T, H, D = q.shape
        Hkv = k.shape[2]
        rep = H // Hkv
        scale = 1.0 / math.sqrt(D)
        qg = q.reshape(B, T, Hkv, rep, D).permute(0, 2, 3, 1, 4)
        kt = k.permute(0, 2, 3, 1)                      # (B, Hkv, D, T)
        vg = v.permute(0, 2, 1, 3)                      # (B, Hkv, T, D)
        o = torch.empty((B, Hkv, rep, T, D), device=q.device)
        lse = torch.empty((B, Hkv, rep, T), device=q.device)
        for i0 in range(0, T, blk):
            i1 = min(T, i0 + blk)
            n = i1 - i0
            s = (qg[:, :, :, i0:i1].reshape(B, Hkv, rep * n, D)
                 @ kt[..., :i1]) * scale
            s = s.view(B, Hkv, rep, n, i1).masked_fill_(
                _future(i0, i1, q.device), float("-inf"))
            l = torch.logsumexp(s, -1)
            p = torch.exp_(s.sub_(l[..., None]))
            o[:, :, :, i0:i1] = (p.view(B, Hkv, rep * n, i1)
                                 @ vg[:, :, :i1]).view(B, Hkv, rep, n, D)
            lse[:, :, :, i0:i1] = l
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blk, ctx.precision = blk, precision
        return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.precision == "fp8":
            do = quantize(do, FP8_BWD)
        B, T, H, D = q.shape
        Hkv = k.shape[2]
        rep = H // Hkv
        scale = 1.0 / math.sqrt(D)
        qg = q.reshape(B, T, Hkv, rep, D).permute(0, 2, 3, 1, 4)
        dog = do.reshape(B, T, Hkv, rep, D).permute(0, 2, 3, 1, 4)
        delta = (dog * o).sum(-1)                        # (B, Hkv, rep, T)
        kg = k.permute(0, 2, 1, 3)                       # (B, Hkv, T, D)
        vg = v.permute(0, 2, 1, 3)
        dq = torch.empty((B, Hkv, rep, T, D), device=q.device)
        dk = torch.zeros((B, Hkv, T, D), device=q.device)
        dv = torch.zeros((B, Hkv, T, D), device=q.device)
        for i0 in range(0, T, ctx.blk):
            i1 = min(T, i0 + ctx.blk)
            n = i1 - i0
            qb = qg[:, :, :, i0:i1].reshape(B, Hkv, rep * n, D)
            dob = dog[:, :, :, i0:i1].reshape(B, Hkv, rep * n, D)
            s = (qb @ kg[:, :, :i1].transpose(-1, -2)) * scale
            s = s.view(B, Hkv, rep, n, i1).masked_fill_(
                _future(i0, i1, q.device), float("-inf"))
            p = torch.exp_(s.sub_(lse[:, :, :, i0:i1, None]))
            p2 = p.view(B, Hkv, rep * n, i1)
            dv[:, :, :i1] += p2.transpose(-1, -2) @ dob
            dp = (dob @ vg[:, :, :i1].transpose(-1, -2)).view(
                B, Hkv, rep, n, i1)
            ds = p.mul_(dp.sub_(delta[:, :, :, i0:i1, None])).view(
                B, Hkv, rep * n, i1)
            dq[:, :, :, i0:i1] = (ds @ kg[:, :, :i1]).view(
                B, Hkv, rep, n, D) * scale
            dk[:, :, :i1] += (ds.transpose(-1, -2) @ qb) * scale
        back = lambda t: t.permute(0, 2, 1, 3)
        return (dq.permute(0, 3, 1, 2, 4).reshape(B, T, H, D), back(dk),
                back(dv), None, None)


def _future(i0: int, i1: int, device):
    """The mask of keys after each query row of rows ``i0..i1``."""
    rows = torch.arange(i0, i1, device=device)[:, None]
    return torch.arange(i1, device=device)[None, :] > rows


def attention(q, k, v, precision: str, blk: int = 512):
    return _Attention.apply(q, k, v, blk, precision)


def layer(m, w: dict, x, tables, precision: str, want_kv: bool = False):
    """One block on the fp32 residual stream ``x (B, T, d)``; ``w`` holds
    the layer's fp32 weights by kind.  -> ``x'`` (and ``(k, v)`` after
    qk-norm and RoPE with ``want_kv``)."""
    B, T, _ = x.shape
    h = rmsnorm(x, w["attn_norm"], m.norm_eps)
    q = mm(h, w["wq"], precision).view(B, T, m.n_heads, m.head_dim)
    k = mm(h, w["wk"], precision).view(B, T, m.n_kv_heads, m.head_dim)
    v = mm(h, w["wv"], precision).view(B, T, m.n_kv_heads, m.head_dim)
    if m.qk_norm:
        q = rmsnorm(q, w["q_norm"], m.norm_eps)
        k = rmsnorm(k, w["k_norm"], m.norm_eps)
    q, k = rope(q, tables), rope(k, tables)
    o = attention(q, k, v, precision).reshape(B, T, m.d_q)
    x = x + mm(o, w["wo"], precision)
    h = rmsnorm(x, w["mlp_norm"], m.norm_eps)
    g = mm(h, w["w_gate"], precision)
    x = x + mm(F.silu(g) * mm(h, w["w_up"], precision), w["w_down"],
               precision)
    return (x, (k, v)) if want_kv else x


GLOBAL_KINDS = ("embed", "unembed", "final_norm")


def layer_weights(m, weights: dict, i: int, grad: bool = False) -> dict:
    """Layer ``i``'s weights in fp32 (every kind but the global ones leads
    with the layer axis)."""
    return {kind: t[i].float().requires_grad_(grad)
            for kind, t in weights.items() if kind not in GLOBAL_KINDS}


def head_weight(m, weights: dict):
    """The vocabulary head ``(d, V)``."""
    return weights["embed"].t() if m.tie_embeddings else weights["unembed"]


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(m, weights: dict, tokens, precision: str = "fp32",
            on_layer=None):
    """-> ``(last position's logits (V,), the final RMSNorm's output at
    every position (T, d))`` of one prompt ``tokens (1, T)``;
    ``on_layer(i, k, v)`` sees each layer's cache entries (fp32, after
    qk-norm and RoPE)."""
    no_tf32()
    T = tokens.shape[1]
    tables = rope_tables(T, m.head_dim, m.rope_theta, tokens.device)
    x = weights["embed"][tokens.long()].float()
    for i in range(m.n_layers):
        x, (k, v) = layer(m, layer_weights(m, weights, i), x, tables,
                          precision, want_kv=True)
        if on_layer is not None:
            on_layer(i, k, v)
        del k, v
    h = rmsnorm(x[0], weights["final_norm"].float(), m.norm_eps)
    return mm(h[-1:], head_weight(m, weights).float(), precision)[0], h


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _head_loss_backward(m, weights, x, labels, precision, grads,
                        chunk: int = 1024):
    """Mean cross entropy of ``x`` (the last layer's output) against
    ``labels``, computed ``chunk`` positions at a time with each chunk's
    backward at once.  Adds the final norm's and the head's gradients to
    ``grads``; -> ``(loss, dL/dx)``."""
    B, T, _ = x.shape
    n = B * T
    fn = weights["final_norm"].float().requires_grad_(True)
    wh = head_weight(m, weights).float().requires_grad_(True)
    xs, ls = x.reshape(n, -1), labels.reshape(n).long()
    gx = torch.empty_like(xs)
    total = torch.zeros((), device=x.device, dtype=torch.float64)
    for c0 in range(0, n, chunk):
        xc = xs[c0:c0 + chunk].detach().requires_grad_(True)
        lg = mm(rmsnorm(xc, fn, m.norm_eps), wh, precision)
        loss = F.cross_entropy(lg, ls[c0:c0 + chunk], reduction="sum")
        (loss / n).backward()
        gx[c0:c0 + chunk] = xc.grad
        total += loss.detach()
    grads["final_norm"] += fn.grad
    if m.tie_embeddings:
        grads["embed"] += wh.grad.t()
    else:
        grads["unembed"] += wh.grad
    return (total / n).float(), gx.view(B, T, -1)


def loss_and_grads(m, weights: dict, tokens, labels, precision: str):
    """-> ``(mean loss, {kind: fp32 gradient})`` of one batch."""
    no_tf32()
    B, T = tokens.shape
    tables = rope_tables(T, m.head_dim, m.rope_theta, tokens.device)
    grads = {k: torch.zeros(t.shape, device=t.device)
             for k, t in weights.items()}
    x = weights["embed"][tokens.long()].float()
    saved = []
    with torch.no_grad():
        for i in range(m.n_layers):
            saved.append(x)
            x = layer(m, layer_weights(m, weights, i), x, tables, precision)
    loss, gx = _head_loss_backward(m, weights, x, labels, precision, grads)
    del x
    for i in reversed(range(m.n_layers)):
        xi = saved.pop().requires_grad_(True)
        w = layer_weights(m, weights, i, grad=True)
        layer(m, w, xi, tables, precision).backward(gx)
        for kind, t in w.items():
            grads[kind][i] += t.grad
        gx = xi.grad
        del xi, w
    grads["embed"].index_add_(0, tokens.reshape(-1).long(),
                              gx.reshape(B * T, -1))
    return loss, grads


def cosine_lr(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay to
    0 at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * prog))


def adamw(weights: dict, grads: dict, mom: dict, opt: dict, step: int):
    """One AdamW step in place: gradients clipped to ``clip_norm`` by their
    global norm; moments and parameters stored bf16, arithmetic fp32.
    -> the clipped gradients' scale."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp_max(opt["clip_norm"] / gnorm.clamp_min(1e-9), 1.0)
    lr = cosine_lr(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for kind, p in weights.items():
        g = grads[kind] * scale
        m1, v1 = mom[kind]
        m32 = m1.float() * b1 + g * (1 - b1)
        v32 = v1.float() * b2 + g * g * (1 - b2)
        pf = p.float()
        pf -= lr * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + opt["eps"])
                    + opt["weight_decay"] * pf)
        p.copy_(pf)
        m1.copy_(m32)
        v1.copy_(v32)
    return scale


def leaf_norms(tensors: dict, leaf_names: dict):
    """Per leaf of the program's tree, the fp32 norm of ``tensors``' slice
    (``leaf_names``: ``{leaf: (kind, layer or None)}``), in that order."""
    out = []
    for kind, i in leaf_names.values():
        t = tensors[kind] if i is None else tensors[kind][i]
        out.append(t.float().norm())
    return torch.stack(out)


def train(m, make, kinds, batches, opt: dict, leaf_names: dict,
          precision: str = "fp32"):
    """Follow the first ``len(batches)`` steps from the weights ``make(kind)``
    gives for each of ``kinds`` (bf16; made again at the end to measure
    the change).  ->
    ``{"loss": [per step], "grad": per-leaf norms of the first step's
    clipped gradient, "delta": per-leaf norms of the parameters' change
    after the last step}``."""
    w = {k: make(k) for k in kinds}
    mom = {k: (torch.zeros_like(t), torch.zeros_like(t)) for k, t in w.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, 1):
        loss, grads = loss_and_grads(m, w, tokens, labels, precision)
        losses.append(float(loss))
        scale = adamw(w, grads, mom, opt, step)
        if first is None:
            first = leaf_norms(grads, leaf_names) * scale
        del grads
    del mom
    delta = []
    for kind, i in leaf_names.values():
        if i in (None, 0):
            old = make(kind)
        a, b = (w[kind], old) if i is None else (w[kind][i], old[i])
        delta.append((a.float() - b.float()).norm())
    return {"loss": losses, "grad": first.cpu(),
            "delta": torch.stack(delta).cpu()}
