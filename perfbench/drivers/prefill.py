"""Prefill: one client, closed loop, one prompt at a time through the
program's serving prefill (``serve.step.make_prefill_step``, the step
``serve_batch(..., max_new=0)`` runs, and its ``greedy_sample``), a new
seeded zipf-bigram prompt each time.

A request is done when its first token has reached the host.  Set-up
builds the weights from the seed and serves ``warmup`` prompts of the
same length.  The window keeps every request's last-position logits (a
row of the vocabulary).  Of each of the ``check`` requests drawn from
the seed among the first ``check_among`` it keeps the sketch of every
layer's KV cache (``compare.sketch``: 1 MiB a tensor, a few ms), so the
card's peak stays the program's own.  A checked request that the window
did not reach is served after the close, outside the count.  Then the
program's state is freed and the reference runs each checked prompt
again.
"""
from __future__ import annotations

import random
import sys

from yardstick import compare, flops, seeds, tokens
from yardstick import model as wm
from yardstick import trace as tr


def prompt(ctx, index: int):
    t = ctx.cell.traffic
    return tokens.prompt(ctx.seed, index, t["prompt_len"], ctx.model.vocab,
                         t["zipf_a"], ctx.device)


def setup(ctx):
    """-> ``(serve, signs)``: ``serve(index) -> (first token, last logits,
    cache)`` and the cache's sketch matrix, both warmed up (the first
    sketch loads a cuBLAS kernel: 0.1 s)."""
    import torch
    from repro_torch.models.model import Batch
    from repro_torch.serve.step import (exact_matmuls, greedy_sample,
                                        make_prefill_step)
    import program
    m, T = ctx.model, ctx.cell.traffic["prompt_len"]
    cfg = program.config(m)
    params = program.param_tree(m, wm.make_weights(m, ctx.seed, ctx.device))
    ctx.mark("weights")
    if ctx.device.type == "cuda":
        exact_matmuls()
    prefill = make_prefill_step(cfg, cache_len=T)
    pos = torch.arange(T, dtype=torch.int32, device=ctx.device)[None]

    def serve(index: int):
        logits, states = prefill(params, Batch(tokens=prompt(ctx, index),
                                               positions=pos))
        first = greedy_sample(logits[:, -1])
        return int(first.cpu()[0]), logits[0, -1], states

    signs = sketch_signs(ctx)
    for i in range(ctx.cell.traffic["warmup"]):
        serve_one(serve, -1 - i, [-1 - i], [], {}, signs)
        ctx.mark(f"warm-up prompt {i + 1}")
    return serve, signs


def picks(ctx) -> list:
    """The requests whose cache is kept and checked: ``check`` of the
    first ``check_among``, drawn from the seed."""
    own = ctx.cell.own
    rng = random.Random(seeds.derive(ctx.seed, "check"))
    return sorted(rng.sample(range(own["check_among"]), own["check"]))


def serve_one(serve, i: int, want: list, served: list, kept: dict,
              signs):
    """Serve request ``i``; keep its token and logits, and the sketch of
    its cache (``signs``: ``compare.sketch_matrix``) when it is
    checked."""
    with tr.span("request"):
        first, logits, states = serve(i)
    served.append((first, logits))
    if i in want:
        with tr.span("keep"):
            kept[i] = [(compare.sketch(signs, s.k),
                        compare.sketch(signs, s.v)) for s in states]


def widest_gap(ref, m, weights, h_ref, h_ctl, blk: int = 2048) -> float:
    """The widest gap, over every position of a prompt, by which the
    reference's logit of the token that the control puts first lies
    below the reference's best (``h_*``: each side's final hidden states,
    ``(T, d)``)."""
    import torch
    head = ref.head_weight(m, weights).float()
    worst = 0.0
    with torch.no_grad():
        for i0 in range(0, h_ref.shape[0], blk):
            lr = h_ref[i0:i0 + blk] @ head
            tok = ref.mm(h_ctl[i0:i0 + blk], head, "fp8").argmax(-1)
            gap = lr.max(-1).values - lr.gather(-1, tok[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
    return worst


def check(ctx, served: list, kept: dict, controls: bool = False) -> dict:
    """Each kept request against the reference: ``{"program": numbers}``,
    and with ``controls`` also the fp8 control's numbers (its own logits
    and cache in the program's place, its token gap read at every
    position of the prompt) and the altered-token fault's (the next token
    id served instead)."""
    ref = ctx.reference()
    m = ctx.model
    weights = wm.make_weights(m, ctx.seed, ctx.device)
    signs = sketch_signs(ctx)
    sk = lambda t: compare.sketch(signs, t)
    whats = ("program", "control_fp8", "fault_token") if controls \
        else ("program",)
    out = {w: {"token_gap": 0.0, "logit_err": 0.0, "kv_err": 0.0}
           for w in whats}
    for i, cache in kept.items():
        first, logits = served[i]
        got = {"program": (first, logits, cache)}
        if controls:
            ctl = {}
            lc, h_ctl = ref.prefill(
                m, weights, prompt(ctx, i), "fp8",
                lambda li, k, v: ctl.__setitem__(li, (sk(k), sk(v))))
            got["control_fp8"] = (int(lc.argmax()), lc, ctl)
            got["fault_token"] = ((first + 1) % m.vocab, logits, cache)

        def on_layer(li, k, v):
            k, v = sk(k), sk(v)
            for w, (_, _, c) in got.items():
                out[w]["kv_err"] = max(out[w]["kv_err"],
                                       compare.rel_err(c[li][0], k),
                                       compare.rel_err(c[li][1], v))

        lr, h_ref = ref.prefill(m, weights, prompt(ctx, i),
                                on_layer=on_layer)
        for w, (tok, lg, _) in got.items():
            out[w]["token_gap"] = max(out[w]["token_gap"],
                                      compare.token_gap(lr, tok))
            out[w]["logit_err"] = max(out[w]["logit_err"],
                                      compare.rel_err(lg, lr))
        if controls:
            out["control_fp8"]["token_gap"] = max(
                out["control_fp8"]["token_gap"],
                widest_gap(ref, m, weights, h_ref, h_ctl))
            del ctl, h_ctl
        del h_ref
    return out if kept else {w: {} for w in whats}


def sketch_signs(ctx):
    return compare.sketch_matrix(ctx.seed, ctx.cell.traffic["prompt_len"],
                                 ctx.device)


def run(ctx) -> dict:
    import time
    import torch
    serve, signs = setup(ctx)
    want = picks(ctx)
    served, kept, ends = [], {}, []
    with ctx.window() as win:
        n = 0
        while not win.over():
            serve_one(serve, n, want, served, kept, signs)
            ends.append(time.perf_counter())
            n += 1
    took = sorted(b - a for a, b in zip([win.t0] + ends, ends))
    if took:
        print(f"perfbench: request seconds min {took[0]:.4f} median "
              f"{took[len(took) // 2]:.4f} max {took[-1]:.4f}",
              file=sys.stderr)
    for i in range(n, max(want) + 1):
        serve_one(serve, i, want, served, kept, signs)
    del serve
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    m, T = ctx.model, ctx.cell.traffic["prompt_len"]
    return {
        "attempted": n, "failed": 0,
        "e2e": {"prefill_tok_s": n * T / ctx.window_s},
        "numbers": check(ctx, served, kept)["program"],
        "info": {"kind": "prefill", "requests": n,
                 "model_flops": n * flops.prefill_flops(m, T),
                 "attn_fwd": flops.attn_fwd(1, T, m.n_heads, m.n_kv_heads,
                                            m.head_dim)},
    }
