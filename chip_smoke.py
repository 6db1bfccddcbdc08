#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on any mismatch or exception:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main paths with ``nvcc`` into
   ``build/kernels/`` (all sources compiled in parallel), print
   ``ptxas``'s registers, spills and wgmma serialisation for the
   tensor-core flash kernel at each head dim and for the backward
   kernel's two passes, count ``HMMA`` in the backward kernel's SASS, and
   count the
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in the
   tensor-core flash kernel's SASS, ``HMMA`` (mma.sync) in the CUDA-core
   one's, and the (max,+) kernels' DPX add-max (``cuobjdump``);
3. hold the readiness kernel against its plain version on the card, bit
   for bit, on random device histories of every default system
   (timestamps below and above 2**24), and time kernel and plain version
   with CUDA events at the main path's shapes; hold the general (max,+)
   kernel of the same source bit for bit against its plain version at the
   reference test's shapes and 2048^3, int32 (wrapping sums) through its
   launcher and fp32 (-3e38 start, -inf rows, a NaN) through
   ``timing_check.maxplus_matmul``, and ``ops.readiness_matrix`` on the
   card against the CPU's, then time it at 128^3 and 2048^3 in both
   dtypes with its bound; then hold the fused
   controller-step kernel against ``step_and_horizon_plain`` on the same
   CUDA tensors, bit for bit in next state, every event field and the
   horizon, on random controller states of every default system (clocks
   from 0 and from 2**24 + 12345; full, half and empty queues with
   arrival ties; refresh units before, at and past the urgent margin;
   LPDDR5/6 banks activating near their ACT-2 deadline; both schedulers,
   refresh on and off, queue depths 8, 32 and 64; 3 channels in one
   launch; 4 cycles in a row, the last without the horizon), and time it
   at the DDR5 main path's shapes: back to back (CUDA events), device
   only (``torch.profiler``) and the plain version per call;
4. hold the flash-attention kernels against their plain version, fp32
   at 2e-5 and bf16 at 2e-2 (the reference's tolerances), every call
   counted on the route ``flash_attention.route`` picks (the sm90
   kernel's D-256 launches in their own count): causal and full,
   D 16/32/64/128, T 100 and 300, GQA rep 1 and 4, both layouts; for the
   tensor-core (sm90) kernel also T 1000 (ragged) and 4096 (the k/v ring
   wraps), rep 8, Tq != Tk (40, 100) and head slices of a fused qkv
   tensor, and llama4-maverick's rep 5 (Hq 10, Hkv 2) at D 128 and T
   1000; bf16 D 256 (the sm90 kernel's 64-row kv tiles) with rep 10 on
   one kv head at T 1 to 4096, Tq != Tk and a fused qkv view; and local
   attention on every route (windows 1, 64, 100 and
   2048; T 300 causal and full, T 4096 causal; D 32/64/128/256 in bf16,
   D 32/64/128 in fp32; rep 1, 4, 10 and 16); then time kernel, plain
   version and ``scaled_dot_product_attention`` (the library call, never
   on a path; under a window with the band as a boolean mask, and causal
   without a mask beside it) at the
   serving path's prefill shape (B 4, T 1000, Hq 32, Hkv 8, D 64, bf16,
   causal), at D 128, the CUDA-core kernel at phase 8's shape in bf16 and
   fp32 and at the serving shape in fp32, the sm90 kernel at
   recurrentgemma-2b's prefill (B 4, T 4096, Hq 10, Hkv 1, D 256, window
   2048) and at (4, 4096, 32, 8, 128) with and without that
   window, and the CUDA-core kernel at the reduced recurrentgemma's
   (2, 80, 2, 1, 32, window 64), each against SDPA;
5. reproduce the 11 single-spec golden command-stream hashes of
   ``tests/trace/golden_hashes.json`` on ``cuda`` (3000 cycles, interval
   2.0, read ratio 0.7, FR-FCFS, fast-forward on), each run launching the
   fused controller-step kernel once per executed step and the plain
   step never; the runs share the card from worker processes, one per
   spare CPU core, since each is bound by its host loop;
6. run the README's session — DDR5_16Gb_x8 / DDR5_4800B, 20,000 cycles,
   interval 2.0, read ratio 0.8 — through ``examples/torch/quickstart.py``
   (phase 18's first example) with every launch count set to 0 just
   before and read just after, and require its ``Stats`` to equal the
   reference fixture ``tests/torch_main_path_stats.json`` exactly, one
   fused launch per executed step and no call of the plain step; print
   steps/s, cycles/s, ms per step and launches;
7. serve the reduced GQA Llama of ``tests/torch_serve_fixture.npz`` (the
   JAX package's parameters, prompts, tokens and logits) on ``cuda``:
   prefill and teacher-forced decode logits within atol 0.2 / rtol 0.05,
   greedy tokens equal (a token may differ only at a near tie: a top-two
   margin within twice that position's logit difference);
8. serve the reduced ``llama3.2-1b`` (head dim 32: the CUDA-core flash
   kernel's path, whose kernel phase 4 also times at this session's
   attention shape) with every launch count set to 0 just before and read
   just after, prefill logits kernel vs plain version within 2e-2;
9. serve ``llama3.2-1b`` at full width (1,235,814,400 seed-made bf16
   parameters): 4 requests of 1000 prompt tokens, 32 new tokens each,
   with every launch count set to 0 just before and read just after (16
   sm90 flash launches, one per layer, and no CUDA-core one); then the
   same prefill with the kernel's plain version in its place, logits
   within 2e-2, and greedy tokens, teacher-forced with the kernel run's,
   equal wherever the top-two margin exceeds 2e-2;
10. (run right after phase 3) hold the fused controller-step kernel over
    (point x channel) lanes against ``step_lanes_plain`` on the same CUDA
    tensors, bit for bit in next state, every event field and the
    horizon: DDR4, LPDDR5 and HBM3; 1, 5 and 32 points of 1, 2 and 4
    channels; per-point clocks, every third point inactive; reset states
    at clock 0 with refresh stagger on and off, and random states; random
    states with every point active at one clock (the plain version's
    one-step branch); then
    time one launch at the batched session's 128 lanes (CUDA events back
    to back, ``torch.profiler`` for device time, the plain version);
11. (run before phase 5) the batched latency-throughput session:
    ``Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=4)``,
    ``run_batch(20_000, intervals=[1, 1.5, 2, 3, 4, 6, 8, 16],
    read_ratios=[1.0, 0.8, 0.6, 0.5])``: 32 points, 128 lanes, with every
    launch count set to 0 just before and read just after; every point's
    ``Stats`` must equal ``tests/torch_batch_stats.json``, with one fused
    launch and one host sync per loop iteration and no plain step; print
    wall seconds, loop iterations, point-cycles/s, channel-cycles/s, ms
    and launches per iteration; then 100 cycles of it under
    ``torch.profiler`` (one device-to-host copy per iteration);
12. (in a worker process beside phase 5's runs) multi-channel: reproduce
    ``GOLDEN["DDR4@2ch"]`` on ``cuda``, and run
    ``examples/torch/multichannel.py`` (phase 18's example): its 4-channel
    HBM3 session against ``tests/torch_multichannel_stats.json``;
13. (run right after phase 10) the modern-controller features: the fused
    kernel vs ``step_and_horizon_plain`` on the same CUDA tensors, bit for
    bit in next state (the BlockHammer sketch and PRAC counters included),
    every event field and the horizon, on DDR4, LPDDR5 (split activation),
    HBM3 and GDDR7 (dual command bus: the sketch halves once per pass),
    with BlockHammer (sketch counts around the threshold), PRAC (a bank at
    the threshold in about half the refresh units) and a link latency of
    80 (arrivals on both sides of the boundary), alone and together, and
    with a user predicate over every ``PredCtx`` field (its mask computed
    on the card; a dual command bus takes one launch per pass), 3
    channels in one launch, clocks from 0 and from 2**24 + 12345, stepped
    through 6 consecutive cycles and then around two ``nREFI`` multiples
    (the sketch's decay cycles); then the kernel at one DDR4 lane with
    BlockHammer off and on, timed back to back (CUDA events) and on the
    device (``torch.profiler``);
14. memory systems and predicates: (run before phase 5) 100 cycles of
    the session of ``examples/hetero_system.py`` (DDR5x2 + CXL-DDR4x2@80,
    interval 1.0, read ratio 0.7) under ``torch.profiler`` (operator
    calls, kernel launches and device-to-host copies per iteration, busy
    share); in worker processes beside phase 5's golden runs: the whole
    session, 20,000 cycles, through ``examples/torch/hetero_system.py``
    (phase 18's example) with every launch count set to 0 just before and
    read just after: its ``Stats`` and ``per_group`` leaves equal
    ``tests/torch_hetero_stats.json``, with two fused launches (one per
    spec group) and one host sync per loop iteration and no plain step;
    the hetero golden
    hash ``GOLDEN["DDR5x2+DDR4x2@80"]`` (over ``FIELDS + ("group",)``),
    ``run_batch`` over the system and the fixture's predicate sessions
    (BlockHammer on a 2-row hammer and on benign traffic, PRAC on 4 rows
    and the ``no_writes_ever`` user predicate, whose mask rides the
    kernel), each with one fused launch per step and no plain step;
15. (in worker processes beside phase 5's runs) windowed telemetry and
    trace replay, each session with every launch count set to 0 just
    before and read just after, one fused launch per spec group and one
    host sync per loop iteration, no plain step, and its ms per
    iteration printed: the README's DDR5 session at ``telemetry=1000``
    (its ``Stats`` equal ``tests/torch_main_path_stats.json``, its 20
    windows ``tests/torch_telemetry_stats.json``) and the
    ``DDR5x2+DDR4x2@80`` system, 4,000 cycles at ``telemetry=256``; a
    DDR4 source run (4,000 cycles, interval 4.0, read ratio 0.5) through
    ``capture`` and ``to_replay(deps=True)`` (the stream's fingerprint
    equal to ``tests/torch_replay_stats.json``'s) replayed 20,000 cycles
    with ``FrontendConfig(pattern="trace", probes=False)`` (``Stats`` and
    command-stream sha256 equal to the fixture's), the same for the
    hetero system with probes (4,000 cycles), and ``run_batch`` at
    intervals [8, 2] over the DDR4 stream without its arrival clocks
    (probes on).

16. the paper's Fig. 1 sweep through ``repro_torch.dse.execute``: the
    grid of ``benchmarks/bench_latency_throughput.py`` (11 standards x 6
    intervals x 3 read ratios, FR-FCFS, seed 0x1234; ``DSE_FIG1`` of
    ``tests/torch_parity.py``) cut to 5,000 cycles, 198 points in 11
    compile groups, each group one cached batched run with one fused
    launch per loop iteration over its 18 points and one host sync.  In
    the main process while phase 5's workers run: a sweep with a
    violating override (DDR4, ``nRC`` 1) raises ``SpecLintError`` before
    any launch; the sweep on a fresh ``RunCache`` (11 misses, every launch
    count set to 0 just before and read just after) equals
    ``tests/torch_dse_stats.json`` point by point exactly (every column,
    the command counts); a two-point DDR4 ``capture_traces`` sweep gives
    the fixture's sha256 per point; ``python -m repro_torch.dse.sweep
    --standards DDR4,HBM3 --intervals 16,4,1 --cycles 2000 --out
    build/dse_smoke`` exits 0 in a subprocess and its artifact loads.
    After the workers, alone: three of its systems again (DDR4, DDR5 and
    HBM3, ``WARM_SYSTEMS``: 0 misses, 3 hits, nothing built), held to
    their points of the fixture the same way, with its wall seconds per
    group and in total, point-cycles/s, ms and launches per iteration.
17. the validation workflow (``repro_torch.verify``), in worker processes
    beside phase 5's runs, each with every launch count set to 0 just
    before and read just after, held to ``tests/torch_verify_stats.json``
    (the reference's results): (a) the smoke matrix ``verify.smoke()``
    (DDR4, DDR5, HBM3 x 3 tiny configurations), one fused controller-step
    launch and one readiness-table launch per 64-lane transition and no
    plain step, with its wall seconds, edges/s and the transitions' share
    of the wall; (b) the refresh-pressure exploration and the loosened
    ACT->RD spec with and without the table check (divergence, minimised
    path, the artifact read back); (c) the differential runs against
    ``tests/verify/fixtures/*.cmdstream``; (d) ``verify_properties`` on
    DDR4 (three streams, and with refresh off), HBM3 over 2 channels and
    the DDR5 + CXL-DDR4 system; (e) the auditor's mutation matrix on the
    11 golden traces, computed inside phase 5's workers.  After the
    workers, alone: the exploration transition (queue insert, fused
    controller step, readiness table) on the card against the plain one
    on the CPU, bit for bit in next state, events and table, over 24
    transitions of 64 lanes of each of the 9 smoke specs and the loosened
    spec; then the readiness table at 64 lanes of each smoke spec against
    its plain version, timed at HBM3's 4-bank spec.
18. the eight examples of ``examples/torch/`` at their own sizes (the
    reference examples' sessions, ``EXAMPLE_RUNS`` of
    ``tests/torch_parity.py``), each through its ``main`` on ``cuda`` with
    every launch count set to 0 just before and read just after, its
    output in ``build/examples/<name>.log``: ``quickstart`` (phase 6),
    ``multichannel`` (phase 12) and ``hetero_system`` (phase 14) where the
    earlier phase runs their session, ``extend_standard``, ``dse_sweep``,
    ``visualize_trace``, ``serve_lm`` and ``memsys_aware_roofline`` (phase
    22, on phase 22 (a)'s JSON) in worker processes beside phase 5's
    runs.  Each one's results (every ``Stats`` and ``per_group`` leaf,
    sweep column and table, curve, audit, command-stream digest, replay
    fingerprint, probe and table value) equal
    ``tests/torch_examples_stats.json`` (the reference examples' own,
    tolerance 0), ``serve_lm``'s greedy tokens those of
    ``tests/torch_examples_serve.npz`` (the reference's weights; a token
    may differ only at a near tie, as in phase 7); one fused launch per
    spec group and loop iteration, no plain step; the VRR table through
    the readiness kernel, the reduced model's attention through the
    CUDA-core flash kernel.  Then ``python -m repro_torch.analysis trace``
    on the shipped tree (the host-sync lint): clean.  Each example's
    seconds and launches are printed.
19. local attention, qk-norm and RG-LRU: the reduced qwen3-4b,
    qwen3-14b, glm4-9b and recurrentgemma-2b of
    ``tests/torch_lm_families.npz`` (the JAX package's weights, prompts,
    tokens and logits; recurrentgemma's 80-token prompt wraps its 64-slot
    ring) within atol 0.2 / rtol 0.05 and greedy tokens as in phase 7;
    then ``PHASE19``'s sessions at full width on seed-made weights, each
    with every launch count set to 0 just before and read just after:
    qwen3-4b (36 sm90 launches), recurrentgemma-2b with 4096-token prompts
    (8 sm90 launches at D 256: the 2048-slot ring wraps in prefill and
    decode),
    glm4-9b and qwen3-14b cut to 4 layers (4 sm90 launches each), none on
    another route; prefill logits kernel vs plain version within 2e-2,
    greedy tokens as in phase 9.
20. MoE, xLSTM, M-RoPE with the vision and audio stubs and the int8 KV
    cache: the reduced entries of ``tests/torch_lm_families_b.npz``
    (phi3.5-moe, at capacity 1.0 too, llama4-maverick, qwen2-vl-72b with
    a ``vis_embeds`` forward, musicgen-medium, xlstm-350m and llama3.2-1b
    with the int8 cache: the JAX package's weights, prompts, tokens and
    logits) within atol 0.2 / rtol 0.05 and greedy tokens as in phase 7;
    then ``PHASE20``'s sessions at full width on seed-made weights, each
    with every launch count set to 0 just before and read just after
    and checked as phase 19's (flash launches one per attention or moe
    layer: phi3.5-moe and qwen2-vl-72b cut to 4 layers, llama4-maverick
    to 2 (GQA rep 5), 4 sm90 launches at D 128 each and 2; musicgen-medium
    with 4 x 1500 frames of 4 codebooks, 48 at D 64; xlstm-350m none;
    llama3.2-1b with the int8 cache, 16 at D 64), the MoE sessions'
    dropped (token, choice) pairs per layer printed, the int8 cache under
    0.6 of the bf16 cache's bytes and its decode logits' distance from a
    bf16-cache run printed.
21. training: (a) both flash backward kernels (``flash_attention_bwd_sm90.cu``
    for bf16 at D 64/128/256, ``flash_attention_bwd.cu`` for bf16 at D
    16/32 and fp32 at D 16-128) against ``attention_backward_plain`` on the
    same CUDA tensors and lse (bf16 D 16-128: causal and full, no window,
    window 64 and 2048, T 100 and 300, GQA rep 1, 4 and 5, both layouts;
    bf16 D 256 with MQA, rep 5 and 10, T up to 2200; fp32 on a subset;
    the CUDA-core route's tile edges, bf16 D 16/32 and fp32 D 16-128 at T
    31-257, windows 1, 31 and 33, rep 1, 2 and 5, both layouts;
    each of dQ, dK, dV within ``BWD_TOL`` of its dtype; every call counted
    once on its route's counter; two runs of each case bit-equal; the
    forward kernels' lse within 1e-3 of the plain one; fp32 at D 256, Tq
    != Tk and misaligned rows refused with ValueError); (b) timed at
    llama3.2-1b's training shape (4, 1024, 32, 8, 64) causal and
    recurrentgemma-2b's (1, 4096, 10, 1, 256) with window 2048 (bf16,
    sm90) and at llama's in fp32 (cuda_core), and the cuda_core route at
    the reduced models' (4, 256, 2, 2, 32) in bf16 and fp32, against the
    plain backward, SDPA's backward and the 5-product bound; (c) one
    training step of each
    reduced config of ``tests/torch_lm_train.npz`` on the card, held to
    the same step with the plain backward in the kernel's place (loss
    1e-5, each gradient leaf 5e-2 in relative L2, grad_norm 1%) and to the
    JAX package's loss, gradient and step at the card's tolerances, flash
    launches as remat makes them (forward twice per grouped attention
    layer, backward once); the reduced llama3.2-1b's and
    recurrentgemma-2b's fp32 gradients on the fp32 kernels, held to the
    JAX package's fp32 gradient in the fixture; (d) llama3.2-1b at full
    width (batch 4 x 1024, 3 AdamW steps, remat): 32 sm90 forward and 16
    sm90 backward launches per step, step 1 against a plain-attention step
    1 (loss within 2e-2, grad_norm 2%, every leaf's gradient cosine >=
    0.99), step ms, tokens/s, peak memory and losses printed; (e)
    ``examples/torch/train_small_lm.py`` for 120 steps (its loss
    improves), resumed from its step-100 checkpoint with the resumed
    losses equal to the uninterrupted run's bit for bit (output in
    ``build/examples/train_small_lm.log``);
    (f) recurrentgemma-2b at full width as (d) (batch 1 x 4096, its
    window of 2048 binding): 16 D-256 forward and 8 sm90 backward launches
    per step.  (b) also times the bf16 D-32 route at the reduced models'
    shape (phase 8's).
22. the multi-device layer of the LM half, with this process as the one
    rank of an NCCL process group: (a) ``python -m
    repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh
    16x16`` in a subprocess on the host (fake tensors on a ``fake`` group
    of 512 ranks), started after the build and read before phase 5's
    workers; its JSON (the reference's keys, per-device FLOPs, bytes,
    memory, collectives by kind, ``source`` the port's eager count) is
    printed; (b) the reduced llama3.2-1b's prefill and one training step
    (B 4, T 64) on plain tensors and again as DTensors on a (1, 1) mesh
    over the NCCL group (``launch.specs``' shardings), each with the
    flash counts set to 0 just before and read just after: the same
    launches on each route, the same logits bit for bit; (c)
    ``examples/torch/memsys_aware_roofline.py`` (with phase 18's
    examples) on (a)'s JSON: one row, its achieved-bandwidth memory time
    at or above the naive one.
23. the multi-device layer of the simulator: ``tests/
    torch_sharded_worker.py``'s 4-channel DDR4 session (600 cycles, the
    dense trace, 250-cycle telemetry) unsharded on the card and through
    ``make_run(..., shard=1)`` over the NCCL group (its sum and min
    collectives every iteration), equal bit for bit in stats, trace and
    telemetry with one fused launch per iteration each; the same session
    on 2 ``gloo`` ranks on the host (subprocesses started after the
    build) equal to the card's; ``dse.execute`` of a 6-point DDR4 sweep
    over ``[cuda, cuda]`` equal to one device in every column, one fused
    launch per iteration.
24. the loss head (``kernels/loss_head.py``, ``csrc/loss_head.cu``) at the
    training cell's chunk (1,024 rows of glm4-9b: D 4,096, V 151,552):
    the whole head (three bf16 products with fp32 sums, the two kernels)
    against the eager fp32 head: nll, dX and dW within the bounds of the
    sums' order, the bf16 gradients one bf16 ulp more
    (``tests/test_torch_loss_head_cuda.py``'s ``_check_head``); then
    ``xent_fwd`` and ``xent_bwd`` against their plain versions on the card
    (lse and nll within 2e-5; the backward's three bf16 terms the exact
    split of fp32 values within 4 ulps of the plain gradient's), each
    timed with CUDA events beside its bytes bound, its plain version and
    (``xent_fwd``) the library's ``F.cross_entropy`` with
    ``torch.logsumexp``; then the whole head's forward and backward a
    chunk timed beside the eager fp32 head's (``models.model._xent_eager``
    and its autograd).

The line before the last is a JSON object with one entry per kernel (its
times, bound and launches; the fused controller step's launches are those
of the batched session, of the eight examples, of phases 14, 15 and 17's
worker runs, of phase 16's two Fig. 1 sweeps and of phase 23, its times
those of one
128-lane launch; the readiness table's launches are phase 17's and the
VRR example's, its times those of 64 exploration lanes; the CUDA-core
flash kernel's those of phase 8, of ``serve_lm``, of phases 19 and
20's fixtures and of phase 22's DTensor step; the sm90 kernel's those of phases 9, 19 and 20 at D
64/128; its D-256 entry phase 19's, its times those of
recurrentgemma-2b's prefill; the sm90 backward kernel's those of phase
21's full-width and ``train_small_lm`` runs, its times those at
llama3.2-1b's training shape; the CUDA-core backward kernel's those of
phase 21's fixture steps and phase 22's DTensor step, its times those
in fp32 at llama's shape; the loss head's two kernels' those of phase
21's bf16 steps (checked run by run: once a 512-position chunk and
codebook a step, none in its fp32 steps), their times those at the
training cell's chunk;
the general (max,+) product, off every path, reports the main path's 0
launches and its 2048^3 int32 times); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN = dict(standard="DDR5", org="DDR5_16Gb_x8", timing="DDR5_4800B",
            n_cycles=20_000, interval=2.0, read_ratio=0.8, seed=0x1234)
#: the batched session's shape (``tests/torch_batch_stats.json``): 8
#: intervals x 4 read ratios over 4 DDR4 channels, 128 lanes
BATCH_POINTS, BATCH_CHANNELS = 32, 4

#: H100 SXM data sheet: HBM3 bandwidth and the non-tensor-core fp32 rate
#: (integer add/compare/max issue on the same CUDA cores)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
#: H100 SXM data sheet: dense bf16 tensor-core rate
BF16_TENSOR_OPS_PER_S = 989e12

#: the full-width serving session (phase 9) and its prefill attention
#: shape (B, T, Hq, Hkv, D)
LM = dict(arch="llama3.2-1b", params=1_235_814_400, batch=4,
          prompt_len=1000, max_new=32, seed=0)
SERVE_SHAPE = (4, 1000, 32, 8, 64)
#: recurrentgemma-2b's prefill attention in phase 19 (B, T, Hq, Hkv, D)
#: and its window: the sm90 kernel's D-256 shape
RG_SHAPE, RG_WINDOW = (4, 4096, 10, 1, 256), 2048
#: the reduced serving session (the CUDA-core flash kernel's path)
REDUCED = dict(batch=4, prompt_len=256, max_new=8)
#: flash kernel vs plain version: the reference's tolerances
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the port vs the JAX package's logits: its decode-parity tolerance
FIXTURE_TOL = dict(atol=0.2, rtol=0.05)
#: kernel vs plain version through the whole bf16 model
LM_TOL = dict(atol=2e-2, rtol=2e-2)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, timed
    with CUDA events after a warm-up."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20, sleep_cycles: int = 20_000_000):
    """Mean milliseconds per call of ``fn`` on the device with the host
    ahead of it: a sleep kernel (``sleep_cycles`` SM clocks, ~10 ms) holds
    the stream while the host enqueues ``reps`` calls between two events,
    so the events time the calls' device work back to back without host
    gaps, every kernel of a call included.  None (not measured) when the
    host took longer to enqueue them than the sleep lasted."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(sleep_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / reps


def device_us(fn, kernel: str, reps: int = 200):
    """Mean device time in µs per launch of the kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler`` (a
    mean over the launches it recorded: it may record fewer than were
    made); None when the profiler reports no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "self_device_time_total", 0) or 0 for e in hits)
    count = sum(e.count for e in hits)
    return total / count if total and count else None


def kernel_phase(device):
    """Kernel vs plain version on every default system; timings at the
    main path's (DDR5, one channel) shapes."""
    import torch
    from repro_torch.core import compile_spec
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import readiness as R
    from repro_torch.testing import random_device_state
    max_err, rows = 0, []
    for i, (std, (org, tim)) in enumerate(sorted(DEFAULT_SYSTEMS.items())):
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, device)
        tab = dp.tables.ready
        for j, clk0 in enumerate((0, (1 << 24) + 12345)):
            st, _ = random_device_state(cspec, dp, device, seed=100 * i + j,
                                        clk0=clk0)
            got = R.readiness_table_cuda(tab, st.last_issue, st.win_ring)
            want = R.readiness_table_plain(tab, st.last_issue, st.win_ring)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            if err or got.shape != want.shape:
                fail(f"readiness kernel != plain version on {std} "
                     f"(clk0={clk0}): max |diff| {err}")
        kern_ms = cuda_ms(lambda: R.readiness_table_cuda(
            tab, st.last_issue, st.win_ring), 2000)
        plain_ms = cuda_ms(lambda: R.readiness_table_plain(
            tab, st.last_issue, st.win_ring), 500)
        dev_us = device_us(lambda: R.readiness_table_cuda(
            tab, st.last_issue, st.win_ring), "readiness_table_kernel")
        K = tab.A.shape[0]
        nbytes = 4 * (st.last_issue.numel() + st.win_ring.numel()
                      + tab.keys.numel() + tab.A.numel()
                      + cspec.n_cmds * cspec.n_banks)
        # per (cmd, bank) cell and key with a constraint: compare, add, max
        ops = 3 * int(tab.present.sum()) * cspec.n_banks
        rows.append(dict(std=std, kernel_ms=kern_ms, plain_ms=plain_ms,
                         device_us=dev_us, bytes=nbytes, ops=ops, keys=K,
                         cells=cspec.n_cmds * cspec.n_banks,
                         bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         ops_ms=ops / CUDA_CORE_OPS_PER_S * 1e3))
    print("readiness kernel vs plain version (bit-exact on all systems, "
          "max |diff| 0); per launch, one channel:")
    print("  (kernel_us and plain_us: back-to-back calls timed with CUDA "
          "events; device_us: the kernel alone, torch.profiler)")
    print(f"  {'standard':<9} {'keys':>4} {'cells':>5} {'kernel_us':>10} "
          f"{'device_us':>9} {'plain_us':>9} {'bound_ns':>9}")
    for r in rows:
        dev = ("not measured" if r["device_us"] is None
               else f"{r['device_us']:.3f}")
        print(f"  {r['std']:<9} {r['keys']:>4} {r['cells']:>5} "
              f"{r['kernel_ms'] * 1e3:>10.2f} {dev:>9} "
              f"{r['plain_ms'] * 1e3:>9.2f} "
              f"{max(r['bytes_ms'], r['ops_ms']) * 1e6:>9.3f}")
    return max_err, {r["std"]: r for r in rows}


MAXPLUS_SHAPES = [(8, 16, 8), (32, 30, 10), (1, 1, 1), (129, 70, 12),
                  (128, 128, 128), (5, 200, 3), (2048, 2048, 2048)]
#: the general (max,+) product's timed shapes
MAXPLUS_TIMED = [(128, 128, 128), (2048, 2048, 2048)]


def maxplus_operands(Q, K, C, dtype, device, seed):
    """T, A on the card: int32 over the whole range (sums wrap), or fp32
    with values on both sides of 2**24, -3e38 entries (some outputs with
    every term at -inf) and, at the small shapes, a NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        T = rng.integers(-(1 << 31), 1 << 31, (Q, K), dtype=np.int64)
        A = rng.integers(-(1 << 31), 1 << 31, (K, C), dtype=np.int64)
        T, A = T.astype(np.int32), A.astype(np.int32)
    else:
        T = rng.integers(-(1 << 25), 1 << 25, (Q, K)).astype(np.float32)
        A = rng.integers(-(1 << 10), 1 << 24, (K, C)).astype(np.float32)
        T[rng.random((Q, K)) < 0.2] = -3e38
        A[rng.random((K, C)) < 0.5] = -3e38
        T[0] = -3e38
        A[:, -1] = -3e38
        if Q * K < 1 << 16 and Q > 1:
            T[Q // 2, K // 2] = np.nan
    return (torch.as_tensor(T, device=device),
            torch.as_tensor(A, device=device))


def maxplus_phase(device):
    """The general (max,+) kernel of ``csrc/readiness.cu`` vs its plain
    version, bit for bit: int32 through the launcher (start INT32_MIN) and
    fp32 through ``timing_check.maxplus_matmul`` (start -3e38), at the
    reference test's shapes and 2048^3; ``ops.readiness_matrix`` on the
    card equal to the CPU's on DDR4, LPDDR5 and HBM3; then both dtypes
    timed at 128^3 and 2048^3 (CUDA events back to back, torch.profiler
    device time, the plain version) with the bound: 2 Q K C operations (an
    add and a max) at the CUDA cores' 67 T/s, or T, A and out bytes once
    at 3.35 TB/s."""
    import numpy as np
    import torch
    from repro_torch.core import compile_spec
    from repro_torch._device import sm_count
    from repro_torch.core import device as D
    from repro_torch.kernels import ops
    from repro_torch.kernels import readiness as R
    from repro_torch.kernels.timing_check import NEG, maxplus_matmul
    from repro_torch.testing import random_device_state

    def run(dtype, T, A):
        if dtype == "int32":
            return R.maxplus_cuda(T, A, R.INT32_MIN)
        return maxplus_matmul(T, A)

    def plain(dtype, T, A):
        return R.maxplus_plain(T, A, R.INT32_MIN if dtype == "int32"
                               else NEG)

    checked, max_err = 0, 0.0
    for (Q, K, C), dtype in [(s, d) for s in MAXPLUS_SHAPES
                             for d in ("int32", "float32")]:
        T, A = maxplus_operands(Q, K, C, dtype, device, Q + K + C)
        before = R.launch_count
        got = run(dtype, T, A)
        want = plain(dtype, T, A)
        torch.cuda.synchronize()
        if R.launch_count != before + 1:
            fail(f"maxplus kernel call counted {R.launch_count - before} "
                 "launches")
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"maxplus kernel at {(Q, K, C)} {dtype}: {got.dtype} "
                 f"{tuple(got.shape)}, want {want.dtype} {tuple(want.shape)}")
        # bit for bit: int32 exactly; fp32 with NaN at the same places and
        # the same bits everywhere else
        nan = torch.isnan(got)
        if not torch.equal(nan, torch.isnan(want)):
            fail(f"maxplus kernel's NaNs != plain version's at {(Q, K, C)}")
        g, w = got[~nan], want[~nan]
        bits = (lambda x: x) if dtype == "int32" else \
            (lambda x: x.view(torch.int32))
        err = float((g.double() - w.double()).abs().max()) if g.numel() \
            else 0.0
        max_err = max(max_err, err)
        if not torch.equal(bits(g), bits(w)):
            fail(f"maxplus kernel != plain version at {(Q, K, C)} {dtype}: "
                 f"max |diff| {err}")
        checked += 1
    for std in ("DDR4", "LPDDR5", "HBM3"):
        org, tim = {"DDR4": ("DDR4_8Gb_x8", "DDR4_2400R"),
                    "LPDDR5": ("LPDDR5_8Gb_x16", "LPDDR5_6400"),
                    "HBM3": ("HBM3_16Gb", "HBM3_5200")}[std]
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, "cpu", channels=2)
        st, _ = random_device_state(cspec, dp, "cpu", seed=5, clk0=1000,
                                    channels=2)
        rng = np.random.default_rng(5)
        subs = np.stack([rng.integers(0, int(n), 64) for n in
                         cspec.level_counts[1:]], 1).astype(np.int32)
        keys = ops.build_keys(cspec)
        want = ops.readiness_matrix(cspec, keys, cspec.ct_lat, st, subs)
        got = ops.readiness_matrix(cspec, keys, cspec.ct_lat,
                                   D.DeviceState(*(f.to(device) for f in st)),
                                   subs)
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)):
            fail(f"ops.readiness_matrix on the card != on the CPU ({std})")
    print(f"maxplus kernel vs plain version: bit for bit at {checked} "
          f"(shape, dtype) cases (max |diff| {max_err}); ops.readiness_matrix "
          "on the card == on the CPU (DDR4, LPDDR5, HBM3)")
    rows = {}
    for (Q, K, C), dtype in [(s, d) for s in MAXPLUS_TIMED
                             for d in ("int32", "float32")]:
        T, A = maxplus_operands(Q, K, C, dtype, device, 1)
        big = Q * K * C > 1 << 24
        kern_ms = cuda_ms(lambda: run(dtype, T, A), 20 if big else 2000)
        dev_us = device_us(lambda: run(dtype, T, A), "maxplus::",
                           reps=10 if big else 200)
        plain_ms = cuda_ms(lambda: plain(dtype, T, A), 3 if big else 100)
        ops_ms = 2 * Q * K * C / CUDA_CORE_OPS_PER_S * 1e3
        bytes_ms = 4 * (Q * K + K * C + Q * C) / HBM_BYTES_PER_S * 1e3
        plan = R.maxplus_plan(Q, K, C, sm_count(torch.device(device)))
        rows[(Q, K, C, dtype)] = r = dict(
            ms=kern_ms, device_us=dev_us, plain_ms=plain_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        dev = ("not measured" if dev_us is None
               else f"{dev_us / 1e3:.5f} ms")
        print(f"  maxplus {(Q, K, C)} {dtype} (plan {plan}): kernel "
              f"{kern_ms:.5f} ms back to back, device {dev}, plain "
              f"{plain_ms:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}; {r['bound_ms'] / kern_ms:.1%} of it)")
    return max_err, rows


def fused_phase(device):
    """The fused controller-step kernel vs ``step_and_horizon_plain`` on
    every default system and case, each launched as a batch of one point
    at its device clock (the engine's single run); timings at the DDR5
    main path's shapes (one channel, queue depth 32, FR-FCFS, refresh
    on)."""
    import itertools
    import torch
    from repro_torch import testing as T
    from repro_torch.core import ControllerConfig, compile_spec
    from repro_torch.core import controller as C
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import controller_step as KS
    steps = max_err = 0
    for i, (std, (org, tim)) in enumerate(sorted(DEFAULT_SYSTEMS.items())):
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, device, channels=3)
        cases = itertools.product(("FRFCFS", "FCFS"), (True, False),
                                  (8, 32, 64), (0, (1 << 24) + 12345))
        for j, (sched, refresh, depth, clk0) in enumerate(cases):
            cfg = ControllerConfig(scheduler=sched, refresh_enabled=refresh)
            cs, clk = T.random_ctrl_state(cspec, dp, device, seed=100 * i + j,
                                          clk0=clk0, depth=depth)
            kcs = T.clone_ctrl(cs)
            for step in range(4):
                before = KS.launch_count
                kh = ph = None
                if step == 3:
                    kcs, kev, _ = T.step_one_point(cspec, dp, cfg, kcs, clk,
                                                   False)
                    cs, pev = C.controller_step_plain(cspec, dp, cfg, cs, clk)
                else:
                    kcs, kev, kh = T.step_one_point(cspec, dp, cfg, kcs, clk)
                    cs, pev, ph = C.step_and_horizon_plain(cspec, dp, cfg,
                                                           cs, clk)
                torch.cuda.synchronize()
                diff = {**T.ctrl_diff(kcs, cs), **T.events_diff(kev, pev)}
                if kh is not None:
                    h = int((kh.long() - ph.long()).abs().max())
                    diff.update({"horizon": h} if h else {})
                max_err = max([max_err, *(v for v in diff.values()
                                          if isinstance(v, int))])
                if diff or KS.launch_count != before + 1:
                    fail(f"fused controller step != plain version on {std} "
                         f"({sched}, refresh {refresh}, depth {depth}, clock "
                         f"{clk}, step {step}): {diff}")
                steps += 1
                clk += 1

    # timings at the DDR5 main path's shapes, on a state of its own (the
    # kernel updates its input in place)
    std = MAIN["standard"]
    cspec = compile_spec(std, MAIN["org"], MAIN["timing"])
    dp = D.dyn_params(cspec, device)
    cfg = ControllerConfig()
    cs, clk = T.random_ctrl_state(cspec, dp, device, seed=5, clk0=1000,
                                  depth=cfg.queue_depth, channels=1)
    one = T.one_point(cs, clk)      # the engine's launch: one point
    plan = C.step_plan(cspec, dp, cfg, one[0])
    kern = lambda: C.step_and_horizon(cspec, dp, cfg, *one)
    ms = cuda_ms(kern, 2000)
    dev_us = device_us(kern, "controller_step_kernel")
    pcs = T.clone_ctrl(cs)
    plain_ms = cuda_ms(lambda: C.step_and_horizon_plain(cspec, dp, cfg, pcs,
                                                        clk), 200)
    ms2 = cuda_ms(kern, 2000)
    # bytes: the plan's constants, the state in and out (valid in and out,
    # the rest of the queue in), the clock and flag, the events row out
    inout = (*cs.dev, cs.hit_streak, cs.prac_count, cs.queue.valid)
    nbytes = (plan.consts.numel() * 4
              + 2 * sum(t.numel() * t.element_size() for t in inout)
              + sum(t.numel() * t.element_size() for t in (
                  cs.queue.is_write, cs.queue.is_probe, cs.queue.sub,
                  cs.queue.row, cs.queue.arrive, *one[1:]))
              + plan.out.numel() * 4)
    # operations: the table's compare, add and max per present (key, cmd)
    # and bank, and per queue slot its prerequisite, mask and key (about
    # 40 integer operations), for one pass; the horizon's key loop per
    # valid slot and refresh unit
    present = int(dp.tables.ready.present.sum())
    keys = dp.tables.ready.A.shape[0]
    ops = (3 * present * cspec.n_banks + 40 * cfg.queue_depth
           + 3 * keys * (int(cs.queue.valid.sum()) + cspec.n_refresh_units))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"fused controller step vs plain version: {steps} steps on all "
          f"default systems (state, events, horizon: max |diff| {max_err})")
    print(f"  at {std} (1 point of 1 channel at its device clock, as the "
          f"engine launches it; queue depth {cfg.queue_depth}): kernel "
          f"{ms * 1e3:.2f} / {ms2 * 1e3:.2f} us back to back (CUDA events, "
          f"before / after the plain version), device "
          f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} "
          f"(torch.profiler); plain version {plain_ms * 1e3:.2f} us per "
          f"call; bound {max(bytes_ms, ops_ms) * 1e6:.3f} ns ({nbytes} B at "
          f"3.35 TB/s: {bytes_ms * 1e6:.3f} ns; {ops} integer operations at "
          f"67 TOP/s: {ops_ms * 1e6:.3f} ns)")
    return dict(steps=steps, max_err=max_err, ms=ms, ms2=ms2, device_us=dev_us,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def golden_run(std: str, org: str, tim: str, device: str) -> dict:
    """One run of the port at the golden configuration (run in a worker
    process): its command count and digest, executed steps, wall seconds,
    fused-kernel launches and plain-step calls."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import capture, trace_sha256
    from repro_torch.verify import mutation_matrix
    sim = Simulator(std, org, tim, device=device,
                    controller=ControllerConfig(scheduler="FRFCFS"))
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = capture(sim.cspec, dense)
    # phase 17 (e): the auditor's mutation matrix on this very trace
    rows = mutation_matrix({std: (sim.cspec, tr)})
    return dict(n=len(tr), sha256=trace_sha256(tr), steps=stats.scan_steps,
                wall=wall, launches=KS.launch_count, plain=C.plain_calls,
                mutation={"/".join(k): v for k, v in rows.items()})


def golden_phase(device: str, meanwhile=None, dryrun=None) -> tuple:
    """The golden runs and the sessions of phases 12, 14, 15, 17 and 18,
    spread over worker processes (the longest first): each run is bound by
    its host loop, so processes on separate cores share the one card.  The
    main process runs ``meanwhile()`` while they do; a thread waits for
    ``dryrun()`` (phase 22 (a)'s JSON) and then hands the roofline example
    to the workers.  Returns the fused launches of phase 14's system
    sessions and of phase 15's, phase 17's fused and table launches, the
    examples' results (checked), what ``meanwhile`` returned and what
    ``dryrun`` did."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    golden = json.loads((ROOT / "tests" / "trace" /
                         "golden_hashes.json").read_text())
    systems = sorted(DEFAULT_SYSTEMS.items())
    workers = min(len(systems), max(1, (os.cpu_count() or 2) - 2))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        # phases 14 and 18: the examples in worker processes, the longest
        # first
        examples = [pool.submit(example_run, name, device)
                    for name in ("hetero_system", "dse_sweep",
                                 "visualize_trace", "serve_lm",
                                 "extend_standard")]
        waiter = ThreadPoolExecutor(1)
        roofline = waiter.submit(lambda: (
            dryrun() if dryrun is not None else None,
            pool.submit(example_run, "memsys_aware_roofline", device)))
        p17 = pool.submit(verify_explore_run, device)
        props = [(key, pool.submit(verify_props_run, key, device))
                 for key in parity().PROPERTY_CASES]
        p15 = [(job, pool.submit(phase15_run, job, device))
               for job in PHASE15_JOBS]
        jobs = [(job, pool.submit(system_run, job, device))
                for job in SYSTEM_JOBS]
        multi = pool.submit(multichannel_run, device)
        diff = pool.submit(verify_diff_run, device)
        futures = [(std, pool.submit(golden_run, std, org, tim, device))
                   for std, (org, tim) in systems]
        extra = meanwhile() if meanwhile is not None else None
        dry, late = roofline.result()
        waiter.shutdown()
        examples.append(late)
        results = [(std, f.result()) for std, f in futures]
        system_results = [(job, f.result()) for job, f in jobs]
        p15_results = [(job, f.result()) for job, f in p15]
        multi_result = multi.result()
        example_results = [f.result() for f in examples]
        p17_results = (p17.result(), diff.result(),
                       {k: f.result() for k, f in props})
    print(f"multi-channel on {device} (phase 12, in a worker process):")
    for line in multi_result["lines"]:
        print("  " + line)
        if line.startswith("FAILED"):
            fail(line[len("FAILED "):])
    example_results.append(multi_result["example"])
    for r in example_results:
        check_example(r)
    print(f"memory systems and predicates on {device} (phase 14, in worker "
          "processes):")
    hetero_example_line(example_results[0])
    doc = hetero_fixture()
    launches = sum(check_system_run(job, r, doc)
                   for job, r in system_results)
    print(f"windowed telemetry and trace replay on {device} (phase 15, in "
          "worker processes):")
    p15_launches = sum(check_phase15(job, r) for job, r in p15_results)
    print(f"golden command-stream hashes on {device} (3000 cycles; "
          f"{workers} worker processes, {time.perf_counter() - t0:.1f} s "
          "with phases 12, 14, 15 and 17):")
    for std, r in results:
        ok = r["n"] == golden[std]["n"] and r["sha256"] == golden[std]["sha256"]
        print(f"  {std:<9} commands {r['n']:>5}  steps {r['steps']:>5}  "
              f"fused launches {r['launches']:>5}  plain steps "
              f"{r['plain']}  {r['wall']:7.2f} s  "
              f"{'match' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{std} command stream differs from its golden hash")
        if r["launches"] != r["steps"] or r["plain"]:
            fail(f"{std} run launched the fused kernel {r['launches']} times "
                 f"in {r['steps']} steps and called the plain step "
                 f"{r['plain']} times")
    print(f"validation workflow on {device} (phase 17, in worker "
          "processes):")
    p17_launches = check_verify(*p17_results, results)
    return (launches, p15_launches, p17_launches, example_results, extra,
            dry)


def telemetry_doc(telem) -> dict:
    """A ``Telemetry`` as the lists of ``tests/torch_telemetry_stats.json``."""
    fields = ("reads", "writes", "probe_lat_sum", "probe_cnt",
              "data_bus_busy", "deferred", "occ_sum", "cmd_counts",
              "lat_hist")
    return dict(t_end=telem.t_end.tolist(), groups=[
        {f: getattr(g, f).tolist() for f in fields} for g in telem.groups])


def phase15_run(job: str, device: str) -> dict:
    """One of phase 15's sessions (run in a worker process, every launch
    count set to 0 just before the measured run and read just after): the
    README DDR5 session or the hetero system with windowed telemetry, a
    captured DDR4 or hetero run replayed through ``to_replay(deps=True)``,
    or ``run_batch`` over the DDR4 stream without its arrival clocks.
    Returns what the main process checks."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import torch
    from repro_torch.core import FrontendConfig, Simulator, compile_system
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import FIELDS, capture, to_replay, trace_sha256
    tdoc = json.loads((ROOT / "tests" /
                       "torch_telemetry_stats.json").read_text())
    rdoc = json.loads((ROOT / "tests" / "torch_replay_stats.json").read_text())
    msys = compile_system(tdoc["system"])
    out = {}
    if job.startswith("telemetry"):
        r = tdoc["runs"]["session" if job == "telemetry_session" else
                         "hetero"]
        sim = (Simulator(r["standard"], r["org_preset"], r["timing_preset"],
                         device=device) if job == "telemetry_session"
               else Simulator(system=msys, device=device))
        run = lambda: sim.run(r["n_cycles"], interval=r["interval"],
                              read_ratio=r["read_ratio"], seed=r["seed"],
                              telemetry=r["window"])
    else:
        rr = rdoc["runs"]
        hetero = job == "replay_hetero"
        s = rr["hetero_source" if hetero else "source"]

        def simulator(**kw):
            if hetero:
                return Simulator(system=msys, device=device, **kw)
            return Simulator(s["standard"], s["org_preset"],
                             s["timing_preset"], device=device, **kw)
        src = simulator()
        _, dense = src.run(s["n_cycles"], interval=s["interval"],
                           read_ratio=s["read_ratio"], seed=s["seed"],
                           trace=True)
        stream = to_replay(capture(src.msys, dense), src.msys, deps=True)
        if job == "replay_batch":
            stream = dataclasses.replace(stream, arrive=None,
                                         fingerprint="")
        out["fingerprint"] = stream.fingerprint
        # the DDR4 replay without probes, the others with them
        sim = simulator(frontend=FrontendConfig(pattern="trace",
                                                probes=job != "replay"),
                        replay=stream)
        if job == "replay_batch":
            b = rr["batch"]
            run = lambda: sim.run_batch(b["n_cycles"], b["intervals"],
                                        b["read_ratios"], seed=b["seed"])
        else:
            r = rr["hetero_replay" if job == "replay_hetero" else "replay"]
            run = lambda: sim.run(r["n_cycles"], seed=r["seed"], trace=True)
    torch.cuda.synchronize()
    sim.host_syncs = 0
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    out.update(wall=time.perf_counter() - t0, launches=KS.launch_count,
               plain=C.plain_calls, syncs=sim.host_syncs,
               groups=sim.msys.n_groups)
    if job == "replay_batch":
        pts, stats = res
        out.update(points=[list(x) for x in pts],
                   stats=[stats.point(i).to_dict() for i in range(len(pts))],
                   steps=int(max(stats.scan_steps)))
        return out
    stats, extra = res
    out.update(stats=stats_doc(stats), steps=stats.scan_steps)
    if job.startswith("telemetry"):
        extra.check(stats)
        out["telemetry"] = telemetry_doc(extra)
    else:
        tr = capture(sim.msys, extra)
        fields = FIELDS + (("group",) if job == "replay_hetero" else ())
        out.update(n=len(tr), sha256=trace_sha256(tr, fields))
    return out


PHASE15_JOBS = ("telemetry_session", "replay", "replay_hetero",
                "telemetry_hetero", "replay_batch")


def check_phase15(job: str, r: dict) -> int:
    """Hold a phase-15 session to its fixture and to one fused launch per
    spec group and one host sync per loop iteration, no plain step;
    returns its fused launches."""
    tdoc = json.loads((ROOT / "tests" /
                       "torch_telemetry_stats.json").read_text())
    rdoc = json.loads((ROOT / "tests" / "torch_replay_stats.json").read_text())
    if job == "telemetry_session":
        want = tdoc["session"]
        main = json.loads((ROOT / "tests" /
                           "torch_main_path_stats.json").read_text())["stats"]
        got = {k: v for k, v in r["stats"].items() if k != "per_group"}
        ok = (r["stats"] == want["stats"] and got == main
              and r["telemetry"] == want["telemetry"])
        what = f"{len(r['telemetry']['t_end'])} windows"
    elif job == "telemetry_hetero":
        want = tdoc["hetero"]
        ok = r["stats"] == want["stats"] and r["telemetry"] == want["telemetry"]
        what = f"{len(r['telemetry']['t_end'])} windows"
    elif job == "replay_batch":
        want = rdoc["batch"]
        ok = (r["fingerprint"] == want["fingerprint"]
              and r["points"] == want["points"] and r["stats"] == want["stats"])
        what = f"{len(r['points'])} points"
    else:
        want = rdoc["hetero"] if job == "replay_hetero" else dict(
            rdoc["replay"], fingerprint=rdoc["source"]["fingerprint"])
        stats = (r["stats"] if job == "replay_hetero" else
                 {k: v for k, v in r["stats"].items() if k != "per_group"})
        ok = (r["fingerprint"] == want["fingerprint"] and stats == want["stats"]
              and (r["n"], r["sha256"]) == (want["n"], want["sha256"]))
        what = f"commands {r['n']}"
    ms = r["wall"] / max(r["syncs"], 1) * 1e3
    print(f"  {job:<17} {what:<15} steps {r['steps']:>6}  host syncs "
          f"{r['syncs']:>6}  fused launches {r['launches']:>6} "
          f"({r['groups']} per step)  plain steps {r['plain']}  "
          f"{r['wall']:6.2f} s  {ms:.3f} ms/iteration  "
          f"{'match' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{job}: differs from its fixture (tests/torch_"
             + ("telemetry" if job.startswith("telemetry") else "replay")
             + "_stats.json)")
    if (r["syncs"] != r["steps"] or r["launches"] != r["groups"] * r["steps"]
            or r["plain"]):
        fail(f"{job}: {r['syncs']} host syncs, {r['launches']} fused "
             f"launches and {r['plain']} plain steps for {r['steps']} loop "
             f"iterations ({r['groups']} spec groups)")
    return r["launches"]


def _verify_counts():
    """The three counts phase 17 reads: fused controller-step launches,
    readiness-table launches and plain steps."""
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import readiness as R
    return KS.launch_count, R.launch_count, C.plain_calls


def _verify_reset():
    import torch
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import readiness as R
    torch.cuda.synchronize()
    KS.launch_count = R.launch_count = C.plain_calls = 0


def verify_explore_run(device: str) -> dict:
    """Phase 17 (a) and (b), in a worker process, each with every launch
    count set to 0 just before and read just after: the smoke matrix
    (``verify.smoke()``: DDR4, DDR5, HBM3 x 3 configurations) with the
    seconds spent in the transition (upload, fused step, readiness table,
    copies back) apart from the oracle's; the refresh-pressure
    exploration; then the loosened ACT->RD spec with and without the
    table check, its artifacts written under ``build/verify_smoke`` and
    read back."""
    sys.path.insert(0, str(ROOT / "src"))
    import importlib
    import torch
    from repro_torch import trace, verify
    from repro_torch.core import ControllerConfig
    tp = parity()
    X = importlib.import_module("repro_torch.verify.explore")
    step_s = [0.0]
    call = X._Step.__call__

    def timed(self, *a):
        t = time.perf_counter()
        out = call(self, *a)
        step_s[0] += time.perf_counter() - t
        return out
    X._Step.__call__ = timed
    _verify_reset()
    t0 = time.perf_counter()
    res = verify.smoke(tp.VERIFY_STANDARDS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused, tables, plain = _verify_counts()
    out = dict(smoke={"/".join(k): tp.explore_doc(r) for k, r in res.items()},
               wall=wall, step_s=step_s[0], launches=fused, tables=tables,
               plain=plain)
    _verify_reset()
    out["refresh_pressure"] = tp.explore_doc(tp.refresh_pressure_run(
        verify, ControllerConfig, device=device))
    art = ROOT / "build" / "verify_smoke"
    cex = {}
    for case in tp.LOOSEN_CASES:
        d = art / case
        for f in d.glob("*.npz") if d.is_dir() else ():
            f.unlink()
        row, r = tp.loosened_run(verify, ControllerConfig, case,
                                 device=device, artifact_dir=str(d))
        cex[case] = dict(doc=tp.cex_doc(r, row), artifact=tp.trace_doc(
            trace.load(r.counterexample.artifact)))
    torch.cuda.synchronize()
    out.update(cex=cex, counts2=_verify_counts())
    return out


def verify_diff_run(device: str) -> dict:
    """Phase 17 (c), in a worker process: the canonical 1,500-cycle runs
    of DDR4, DDR5 and HBM3 on ``device`` against the pinned
    ``tests/verify/fixtures/*.cmdstream``, with every launch count set to
    0 just before and read just after."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.verify import differential as TD
    tp = parity()
    fx = ROOT / "tests" / "verify" / "fixtures"
    _verify_reset()
    t0 = time.perf_counter()
    dumps, reports = {}, []
    for std in tp.VERIFY_STANDARDS:
        text = TD.dump_cmd_stream(*TD.golden_run(std, device=device))
        dumps[std] = dict(sha=tp.sha(text), file=text == (
            fx / f"{std}.cmdstream").read_text())
        reports.append(TD.compare_streams(
            std, TD.parse_cmd_stream(str(fx / f"{std}.cmdstream")),
            TD.parse_cmd_stream(text)))
    torch.cuda.synchronize()
    return dict(dumps=dumps, reports={r.standard: tp.diff_doc(r)
                                      for r in reports},
                table=TD.accuracy_table(reports),
                wall=time.perf_counter() - t0, counts=_verify_counts())


def verify_props_run(key: str, device: str) -> dict:
    """Phase 17 (d), in a worker process: one property run of
    ``torch_parity.PROPERTY_CASES`` through the port's ``Simulator`` on
    ``device``, with every launch count set to 0 just before and read
    just after."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import verify
    from repro_torch.core import ControllerConfig
    tp = parity()
    _verify_reset()
    t0 = time.perf_counter()
    rep = tp.property_run(verify, ControllerConfig, key, device=device)
    torch.cuda.synchronize()
    return dict(doc=tp.property_doc(rep), wall=time.perf_counter() - t0,
                counts=_verify_counts())


def check_verify(explore: dict, diff: dict, props: dict,
                 golden: list) -> dict:
    """Hold phase 17's results to ``tests/torch_verify_stats.json``, with
    the kernels' launches: the exploration one fused step and one
    readiness table per transition and no plain step; every other run
    some fused launches and no plain step.  Prints what was run; returns
    the fused and table launches."""
    tp = parity()
    doc = json.loads(Path(tp.VERIFY_FIXTURE).read_text())
    r = explore
    edges = sum(d["edges"] for d in r["smoke"].values())
    ok = r["smoke"] == doc["smoke"]
    print(f"  (a) smoke matrix: {len(r['smoke'])} explorations, {edges} "
          f"edges, states "
          f"{sum(d['states_explored'] for d in r['smoke'].values())}, "
          f"commands checked "
          f"{sum(d['commands_checked'] for d in r['smoke'].values())}, "
          f"tables checked "
          f"{sum(d['tables_checked'] for d in r['smoke'].values())}, "
          f"divergences "
          f"{sum(len(d['divergences']) for d in r['smoke'].values())}; "
          f"fused launches {r['launches']}, readiness-table launches "
          f"{r['tables']}, plain steps {r['plain']}; wall {r['wall']:.2f} s, "
          f"{edges / r['wall']:.1f} edges/s, transitions "
          f"{r['step_s']:.2f} s ({r['step_s'] / r['wall'] * 100:.1f}% of the "
          f"wall; the oracle and the frontier the rest), "
          f"{r['step_s'] / max(r['launches'], 1) * 1e3:.3f} ms per "
          f"transition of 64 lanes  {'match' if ok else 'MISMATCH'}")
    if not ok:
        fail("phase 17 (a): the smoke matrix differs from "
             "tests/torch_verify_stats.json")
    if not (r["launches"] == r["tables"] > 0 and r["plain"] == 0):
        fail(f"phase 17 (a): {r['launches']} fused launches, {r['tables']} "
             f"table launches, {r['plain']} plain steps")
    fused2, tables2, plain2 = r["counts2"]
    ok = (r["refresh_pressure"] == doc["refresh_pressure"] and all(
        c["doc"] == doc[case] and c["artifact"] == doc[case]["trace"]
        for case, c in r["cex"].items()))
    cx = r["cex"]["counterexample"]["doc"]
    print(f"  (b) refresh pressure {r['refresh_pressure']['text']}; "
          f"loosened ACT->RD: {cx['divergence']}, path {cx['path']}; "
          f"table check: {r['cex']['table_divergence']['doc']['divergence']}"
          f"; artifacts read back from build/verify_smoke; fused launches "
          f"{fused2}, table launches {tables2}, plain steps {plain2}  "
          f"{'match' if ok else 'MISMATCH'}")
    if not ok:
        fail("phase 17 (b): a counterexample or the refresh-pressure "
             "exploration differs from tests/torch_verify_stats.json")
    if not (fused2 == tables2 > 0 and plain2 == 0):
        fail(f"phase 17 (b): {fused2} fused launches, {tables2} table "
             f"launches, {plain2} plain steps")
    want = doc["differential"]
    fused3, _, plain3 = diff["counts"]
    ok = (diff["reports"] == want["reports"] and diff["table"] ==
          want["table"] and all(d["file"] and d["sha"] == want["dumps"][s]
                                for s, d in diff["dumps"].items()))
    print(f"  (c) differential: "
          + "; ".join(d["text"] for d in diff["reports"].values())
          + f"; fused launches {fused3}, plain steps {plain3}, "
          f"{diff['wall']:.2f} s  {'match' if ok else 'MISMATCH'}")
    if not ok or not fused3 or plain3:
        fail("phase 17 (c): the command streams differ from "
             "tests/verify/fixtures or ran off the kernel")
    fused4 = 0
    for key, p in props.items():
        f, _, pl = p["counts"]
        fused4 += f
        ok = p["doc"] == doc["properties"][key]
        print(f"  (d) properties {key:<22} {p['doc']['checks']}  served "
              f"{p['doc']['info']['served']}  fused launches {f}, plain "
              f"steps {pl}, {p['wall']:.2f} s  {'match' if ok else 'MISMATCH'}")
        if not ok or not f or pl:
            fail(f"phase 17 (d): {key} differs from its fixture or ran off "
                 "the kernel")
    cells = {}
    for _, g in golden:
        cells.update(g["mutation"])
    from repro_torch.verify import matrix_table
    table = matrix_table({tuple(k.split("/")): v for k, v in cells.items()})
    ok = (cells == doc["mutation_matrix"]["cells"]
          and table == doc["mutation_matrix"]["table"])
    print(f"  (e) mutation matrix on the 11 golden traces captured on the "
          f"card: {sum(v == 'detected' for v in cells.values())}/"
          f"{len(cells)} detected  {'match' if ok else 'MISMATCH'}")
    if not ok or set(cells.values()) != {"detected"}:
        fail("phase 17 (e): the mutation matrix differs from "
             "tests/torch_verify_stats.json")
    return dict(fused=r["launches"] + fused2 + fused3 + fused4,
                tables=r["tables"] + tables2)


def explore_table_phase(device) -> dict:
    """Phase 17 at the exploration's shape (alone on the card, after the
    workers).  First the whole transition (``testing.explore_walk``:
    queue insert, fused controller step, readiness table) on the card
    against the plain one on the CPU, bit for bit in next state, events
    and table: 24 transitions of 64 lanes from reset over the 9 smoke
    specs and the loosened ACT->RD spec, one fused and one table launch
    each and no plain step.  Then the readiness table alone: 64 lanes of
    each smoke spec's tiny geometry (random device histories), kernel
    against its plain version bit for bit, timed at HBM3's 4-bank spec
    (the largest table of the smoke matrix) with its bound."""
    import importlib
    import torch
    from repro_torch.core import ControllerConfig
    from repro_torch.core import device as D
    from repro_torch.kernels import readiness as R
    from repro_torch.testing import explore_walk, random_device_state
    X = importlib.import_module("repro_torch.verify.explore")
    walks = parity().explore_walk_specs(X, ControllerConfig)
    n = step_err = 0
    for key, cspec, ccfg in walks:
        for d, launches, diff in explore_walk(cspec, ccfg, device,
                                              seed=len(key)):
            step_err = max([step_err, *diff.values()])
            if diff or launches != (1, 1, 0):
                fail(f"exploration transition on the card != plain one on "
                     f"{key} at depth {d}: {diff}; (fused, table, plain) "
                     f"launches {launches}")
            n += 1
    print(f"exploration transition on the card vs the plain one on the CPU: "
          f"{n} transitions of 64 lanes over {len(walks)} specs (the 9 "
          f"smoke specs and the loosened ACT->RD spec; state, events, "
          f"table: max |diff| {step_err})")
    max_err = 0
    for i, std in enumerate(parity().VERIFY_STANDARDS):
        for name, tkw, _, _ in X.SMOKE_CONFIGS:
            cspec = X.tiny_spec(std, **tkw)
            dp = D.dyn_params(cspec, device)
            tab = dp.tables.ready
            st, _ = random_device_state(cspec, dp, device, seed=7 + i,
                                        clk0=0, channels=64, steps=30)
            got = R.readiness_table_cuda(tab, st.last_issue, st.win_ring)
            want = R.readiness_table_plain(tab, st.last_issue, st.win_ring)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            if err or got.shape != want.shape:
                fail(f"readiness kernel != plain version at 64 lanes of "
                     f"{std} {name}: max |diff| {err}")
    # the last spec: HBM3 b4-q2
    run = lambda: R.readiness_table_cuda(tab, st.last_issue, st.win_ring)
    kern_ms = cuda_ms(run, 2000)
    plain_ms = cuda_ms(lambda: R.readiness_table_plain(
        tab, st.last_issue, st.win_ring), 500)
    dev_us = device_us(run, "readiness_table_kernel")
    nbytes = 4 * (st.last_issue.numel() + st.win_ring.numel()
                  + tab.keys.numel() + tab.A.numel()
                  + 64 * cspec.n_cmds * cspec.n_banks)
    ops = 3 * int(tab.present.sum()) * cspec.n_banks * 64
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"readiness table at the exploration's shape (64 lanes of each "
          f"of the 9 smoke specs, bit-exact, max |diff| {max_err}); at "
          f"{std} {name} ({cspec.n_cmds} commands x {cspec.n_banks} banks, "
          f"{tab.A.shape[0]} keys): kernel {kern_ms * 1e3:.2f} us back to "
          f"back, device "
          f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'}, "
          f"plain version {plain_ms * 1e3:.2f} us, bound "
          f"{max(bytes_ms, ops_ms) * 1e6:.3f} ns ({nbytes} B: "
          f"{bytes_ms * 1e6:.3f} ns; {ops} integer operations: "
          f"{ops_ms * 1e6:.3f} ns)")
    return dict(max_err=max_err, step_err=step_err, kernel_ms=kern_ms,
                plain_ms=plain_ms, device_us=dev_us,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def parity():
    """``tests/torch_parity.py``: the constants the fixtures were written
    from and the docs they hold (phase 16's grid ``DSE_FIG1`` and its
    ``sweep_spec``; phase 17's runs and result docs)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_parity
    return torch_parity


def dse_fig1() -> dict:
    return parity().DSE_FIG1


def dse_spec(run: dict, **kw):
    """The port's ``SweepSpec`` of a fixture run."""
    from repro_torch import dse
    return parity().sweep_spec(dse, run, **kw)


def dse_check(what: str, res, want: dict, launches: int, plain: int,
              readiness: int):
    """Hold a sweep's result to its fixture entry (every column exactly,
    NaN where NaN; the command counts) and to one fused launch per spec
    group and loop iteration, one host sync per iteration, each group's
    iterations its points' most executed cycles, and no plain step."""
    import numpy as np
    for k, col in want["columns"].items():
        got = np.asarray(getattr(res, k))
        ref = np.asarray(col, got.dtype)
        same = got == ref
        if got.dtype.kind == "f":
            same |= np.isnan(got) & np.isnan(ref)
        if not same.all():
            bad = int(np.flatnonzero(~same)[0])
            fail(f"{what}: {k} of point {want['labels'][bad]} is "
                 f"{got[bad]!r}, the reference's {col[bad]!r}")
    counts = [np.asarray(c).tolist() for c in res.cmd_counts]
    if counts != want["cmd_counts"] or res.cmd_names != want["cmd_names"]:
        fail(f"{what}: command counts differ from the reference fixture")
    if [pt.label for pt in res.points] != want["labels"]:
        fail(f"{what}: points differ from the fixture's")
    m = res.meta
    start, expect = 0, 0
    for g in m["groups"]:
        steps = res.scan_steps[start:start + g["n_points"]]
        start += g["n_points"]
        # a capturing group runs its points one at a time
        want_iters = int(sum(steps) if res.traces else max(steps))
        if g["iterations"] != want_iters:
            fail(f"{what}: group {g['system']} ran {g['iterations']} loop "
                 f"iterations for {want_iters}")
        expect += g["iterations"] * g["n_spec_groups"]
    if (m["host_syncs"] != sum(g["iterations"] for g in m["groups"])
            or launches != expect or plain or readiness):
        fail(f"{what}: {launches} fused launches for {expect} (group x "
             f"iteration), {m['host_syncs']} host syncs, {plain} plain "
             f"steps, {readiness} readiness launches")


def dse_run(what: str, spec, cache, device, want: dict):
    """One ``execute`` on the card with every launch count set to 0 just
    before and read just after, held by :func:`dse_check`; returns the
    result, its wall seconds and its fused launches."""
    import torch
    from repro_torch import dse
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import readiness as R
    torch.cuda.synchronize()
    KS.launch_count = R.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    res = dse.execute(spec, cache=cache, devices=[device])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = KS.launch_count
    dse_check(what, res, want, launches, C.plain_calls, R.launch_count)
    return res, wall, launches


def dse_phase(device) -> dict:
    """Phase 16, the cold half (run in the main process while the golden
    phase's workers share the card): the lint gate, the Fig. 1 sweep on a
    fresh cache (11 misses), the capture sweep and the CLI in a
    subprocess.  Returns the cache and the launches."""
    import torch
    from repro_torch import dse
    from repro_torch.analysis import SpecLintError
    from repro_torch.core import engine as E
    from repro_torch.kernels import controller_step as KS
    doc = json.loads((ROOT / "tests" / "torch_dse_stats.json").read_text())
    run = dse_fig1()
    if doc["fig1"]["run"] != run:
        fail("phase 16: tests/torch_dse_stats.json was written for another "
             "grid than torch_parity.DSE_FIG1")
    out = {}
    # the lint gate: a violating corner raises before anything launches
    KS.launch_count = 0
    try:
        dse.execute(dse.SweepSpec(
            systems=(("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", {"nRC": 1}),),
            intervals=(8.0,), n_cycles=400), devices=[device])
        fail("phase 16: the sweep with nRC=1 ran past the lint gate")
    except SpecLintError as e:
        if "trc-decomposition" not in e.report.rules_fired() \
                or KS.launch_count:
            fail(f"phase 16: lint gate fired {e.report.rules_fired()} "
                 f"after {KS.launch_count} launches")
    print(f"sweep lint gate on {device}: SpecLintError "
          f"(trc-decomposition) before any launch, fused launches 0")

    cache = E.RunCache()
    res, wall, launches = dse_run("Fig. 1 sweep (cold)", dse_spec(run),
                                  cache, device, doc["fig1"])
    m = res.meta
    G = doc["fig1"]["n_groups"]          # 11
    if (m["n_groups"], m["compile_cache_misses"], m["compile_cache_hits"],
            m["traces"]) != (G, G, 0, G):
        fail(f"Fig. 1 sweep (cold): groups {m['n_groups']}, misses "
             f"{m['compile_cache_misses']}, hits {m['compile_cache_hits']}, "
             f"builds {m['traces']}; want {G}, {G}, 0, {G}")
    print(f"Fig. 1 sweep (cold, beside the golden workers) on {device}: "
          f"{m['n_points']} points in {m['n_groups']} groups x "
          f"{run['n_cycles']} cycles == tests/torch_dse_stats.json; wall "
          f"{wall:.2f} s, loop iterations {m['host_syncs']}, fused launches "
          f"{launches}, plain steps 0; cache misses "
          f"{m['compile_cache_misses']}, first-call seconds "
          f"{m['cache']['first_call_s']}")
    out.update(cache=cache, cold_launches=launches, cold_wall=wall,
               cold_meta=m)

    cap = doc["capture"]
    res, wall, launches = dse_run(
        "capture sweep", dse_spec(cap["run"], capture_traces=True),
        E.RunCache(), device, cap)
    from repro_torch.trace import trace_sha256
    got = [dict(n=len(t), sha256=trace_sha256(t)) for t in res.traces]
    if got != cap["traces"]:
        fail(f"capture sweep: traces {got} != fixture {cap['traces']}")
    print(f"capture sweep on {device}: {len(got)} DDR4 points, traces "
          f"{[t['n'] for t in got]} commands, sha256 == fixture, "
          f"{res.meta['compile_cache_misses']} cache miss, fused launches "
          f"{launches} ({res.meta['host_syncs']} iterations), {wall:.2f} s")

    import os
    cmd = [sys.executable, "-m", "repro_torch.dse.sweep", "--standards",
           "DDR4,HBM3", "--intervals", "16,4,1", "--cycles", "2000",
           "--out", "build/dse_smoke"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        fail(f"sweep CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    loaded = dse.SweepResult.load(str(ROOT / "build" / "dse_smoke"))
    if len(loaded) != 6 or not (loaded.reads_done > 0).all():
        fail(f"sweep CLI artifact: {len(loaded)} points")
    print(f"sweep CLI ({' '.join(cmd[1:])}) exited 0 in "
          f"{time.perf_counter() - t0:.1f} s; artifact "
          f"build/dse_smoke.npz loads with {len(loaded)} points")
    torch.cuda.synchronize()
    return out


#: the Fig. 1 systems phase 16's warm half runs again (3 of 11: the warm
#: cache, the fixture and the per-iteration rates on a third of the work)
WARM_SYSTEMS = ("DDR4", "DDR5", "HBM3")


def fig1_subset(want: dict, systems) -> tuple:
    """The Fig. 1 run and its fixture entry cut to ``systems``."""
    run = dse_fig1()
    keep = [i for i, lab in enumerate(want["labels"])
            if lab.split()[0] in systems]
    sub = dict(run, systems=[s for s in run["systems"]
                             if s[0] in systems])
    pick = lambda xs: [xs[i] for i in keep]
    return sub, dict(want, columns={k: pick(v) for k, v in
                                    want["columns"].items()},
                     cmd_counts=pick(want["cmd_counts"]),
                     cmd_names=pick(want["cmd_names"]),
                     labels=pick(want["labels"]), n_groups=len(systems))


def dse_warm_phase(device, cold: dict) -> int:
    """Phase 16, the warm half (alone on the card): three of the Fig. 1
    sweep's systems (``WARM_SYSTEMS``) again on the cold half's cache — 0
    misses and 3 hits, nothing built — held to the fixture as before,
    with its wall seconds per group and in total, point-cycles/s, ms and
    launches per loop iteration.  Returns the fused launches of both
    sweeps."""
    doc = json.loads((ROOT / "tests" / "torch_dse_stats.json").read_text())
    run, want = fig1_subset(doc["fig1"], WARM_SYSTEMS)
    res, wall, launches = dse_run("Fig. 1 sweep (warm)", dse_spec(run),
                                  cold["cache"], device, want)
    m = res.meta
    G = want["n_groups"]                 # 3
    if (m["compile_cache_misses"], m["compile_cache_hits"],
            m["traces"]) != (0, G, 0):
        fail(f"Fig. 1 sweep (warm): misses {m['compile_cache_misses']}, "
             f"hits {m['compile_cache_hits']}, builds {m['traces']}; want "
             f"0, {G}, 0")
    iters = m["host_syncs"]
    P = m["n_points"] * run["n_cycles"]
    print(f"Fig. 1 sweep (warm, alone; {', '.join(WARM_SYSTEMS)}) on "
          f"{device}: {m['n_points']} points "
          f"== tests/torch_dse_stats.json; wall {wall:.2f} s, "
          f"{P / wall:.1f} point-cycles/s, executed point-cycles "
          f"{int(res.scan_steps.sum())}, loop iterations {iters}, "
          f"{wall / iters * 1e3:.3f} ms per iteration, fused launches per "
          f"iteration {launches / iters:.3f}, plain steps 0; cache misses 0, "
          f"hits {m['compile_cache_hits']}, first-call seconds (cold) "
          f"{cold['cold_meta']['cache']['first_call_s']}")
    cold_groups = {g["system"]: g for g in cold["cold_meta"]["groups"]}
    for g in m["groups"]:
        c = cold_groups[g["system"]]
        print(f"  {g['system']:<9} {g['n_points']} points, iterations "
              f"{g['iterations']:>5}, wall {g['wall_s']:6.2f} s warm "
              f"({g['wall_s'] / g['iterations'] * 1e3:.3f} ms/iteration), "
              f"{c['wall_s']:6.2f} s cold")
    return cold["cold_launches"] + launches


def lanes_phase(device):
    """The fused kernel over (point x channel) lanes vs
    ``step_lanes_plain`` on the same CUDA tensors, bit for bit in next
    state, every event field and the horizon: DDR4, LPDDR5 and HBM3, P in
    {1, 5, 32} points of C in {1, 2, 4} channels, per-point clocks with
    every third point inactive (a finished point), reset states at clock 0
    with refresh stagger on and off (negative ``last_ref``) and random
    states, then random states with every point active at one clock (the
    plain version's other branch: all lanes as channels of one step), 3
    cycles in a row; then one launch timed at the batched session's 128
    lanes (32 points x 4 DDR4 channels)."""
    import itertools
    import torch
    from repro_torch import testing as T
    from repro_torch.core import ControllerConfig, compile_spec
    from repro_torch.core import controller as C
    from repro_torch.core import device as D
    from repro_torch.kernels import controller_step as KS
    systems = [("DDR4", "DDR4_8Gb_x8", "DDR4_2400R"),
               ("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400"),
               ("HBM3", "HBM3_16Gb", "HBM3_5200")]
    cfg = ControllerConfig()
    steps = max_err = 0
    for i, ((std, org, tim), P, nch, case) in enumerate(itertools.product(
            systems, (1, 5, 32), (1, 2, 4),
            ("stagger", "in phase", "random", "lockstep"))):
        cspec = compile_spec(std, org, tim, channels=nch)
        dp = D.dyn_params(cspec, device, nch)
        cs, clk, active = T.lane_case(
            cspec, dp, device, i, P, nch, case in ("stagger", "in phase"),
            case == "stagger", lockstep=case == "lockstep")
        for step in range(3):
            kcs = T.clone_ctrl(cs)
            before = KS.launch_count
            kcs, kev, kh = C.step_and_horizon(cspec, dp, cfg, kcs, clk,
                                              active)
            cs, pev, ph = C.step_lanes_plain(cspec, dp, cfg, cs, clk, active)
            torch.cuda.synchronize()
            diff = {**T.ctrl_diff(kcs, cs), **T.events_diff(kev, pev)}
            h = int((kh.long() - ph.long()).abs().max())
            diff.update({"horizon": h} if h else {})
            max_err = max([max_err, *(v for v in diff.values()
                                      if isinstance(v, int))])
            if diff or KS.launch_count != before + 1:
                fail(f"fused step over lanes != plain version on {std} ({P} "
                     f"points x {nch} channels, {case}, step {step}, clocks "
                     f"{clk.tolist()}): {diff}")
            steps += 1
            clk = clk + 1

    # one launch at the batched session's 128 lanes
    P, nch = BATCH_POINTS, BATCH_CHANNELS
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=nch)
    dp = D.dyn_params(cspec, device, nch)
    cs, clk, active = T.lane_case(cspec, dp, device, 5, P, nch, False,
                                  depth=cfg.queue_depth)
    active = torch.ones_like(active)
    plan = C.step_plan(cspec, dp, cfg, cs)
    kern = lambda: C.step_and_horizon(cspec, dp, cfg, cs, clk, active)
    ms = cuda_ms(kern, 2000)
    dev_us = device_us(kern, "controller_step_kernel")
    pcs = T.clone_ctrl(cs)
    plain_ms = cuda_ms(lambda: C.step_lanes_plain(cspec, dp, cfg, pcs, clk,
                                                  active), 3)
    ms2 = cuda_ms(kern, 2000)
    lanes = P * nch
    # bytes: the plan's constants, every lane's state in and out (valid in
    # and out, the rest of the queue in), the clocks and flags, the events
    inout = (*cs.dev, cs.hit_streak, cs.prac_count, cs.queue.valid)
    nbytes = (plan.consts.numel() * 4
              + 2 * sum(t.numel() * t.element_size() for t in inout)
              + sum(t.numel() * t.element_size() for t in (
                  cs.queue.is_write, cs.queue.is_probe, cs.queue.sub,
                  cs.queue.row, cs.queue.arrive, clk, active))
              + plan.out.numel() * 4)
    # operations per lane as phase 3 counts them, over all lanes
    present = int(dp.tables.ready.present.sum())
    keys = dp.tables.ready.A.shape[0]
    ops = (lanes * (3 * present * cspec.n_banks + 40 * cfg.queue_depth
                    + 3 * keys * cspec.n_refresh_units)
           + 3 * keys * int(cs.queue.valid.sum()))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    print(f"fused controller step over lanes vs plain version: {steps} "
          f"steps (DDR4, LPDDR5, HBM3; 1/5/32 points x 1/2/4 channels; "
          f"per-point clocks and lockstep; state, events, horizon: max "
          f"|diff| {max_err})")
    print(f"  at {lanes} lanes (DDR4, {P} points x {nch} channels, queue "
          f"depth {cfg.queue_depth}): kernel {ms * 1e3:.2f} / "
          f"{ms2 * 1e3:.2f} us back to back (CUDA events, before / after "
          f"the plain version), device "
          f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} "
          f"(torch.profiler); plain version {plain_ms * 1e3:.1f} us per call "
          f"({P} points in a Python loop); bound "
          f"{max(bytes_ms, ops_ms) * 1e6:.3f} ns ({nbytes} B at 3.35 TB/s: "
          f"{bytes_ms * 1e6:.3f} ns; {ops} integer operations at 67 TOP/s: "
          f"{ops_ms * 1e6:.3f} ns)")
    return dict(steps=steps, max_err=max_err, ms=ms, ms2=ms2,
                device_us=dev_us, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def multichannel_run(device: str) -> dict:
    """Phase 12 (run in a worker process): ``GOLDEN["DDR4@2ch"]`` on
    ``cuda`` (fast-forward on), with one fused launch per executed step
    and no plain step, then ``examples/torch/multichannel.py`` (its
    4-channel HBM3 session against ``tests/torch_multichannel_stats.json``;
    phase 18's example).  Returns the report ``lines`` (a line that starts
    with "FAILED" names a mismatch) and the ``example``'s result."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import capture, trace_sha256
    lines = []
    golden = json.loads((ROOT / "tests" / "trace" /
                         "golden_hashes.json").read_text())["DDR4@2ch"]
    sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                    mapper="RoBaRaCoCh", device=device,
                    controller=ControllerConfig(refresh_stagger=False))
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = capture(sim.cspec, dense)
    if len(tr) != golden["n"] or trace_sha256(tr) != golden["sha256"]:
        lines.append("FAILED DDR4@2ch command stream differs from its "
                     "golden hash")
    if KS.launch_count != stats.scan_steps or C.plain_calls:
        lines.append(f"FAILED DDR4@2ch launched the fused kernel "
                     f"{KS.launch_count} times in {stats.scan_steps} steps, "
                     f"plain steps {C.plain_calls}")
    lines.append(f"DDR4@2ch golden hash on {device}: commands {len(tr)}, "
                 f"steps {stats.scan_steps}, fused launches "
                 f"{KS.launch_count}, plain steps 0, {wall:.2f} s: match")

    r = json.loads((ROOT / "tests" /
                    "torch_multichannel_stats.json").read_text())["run"]
    ex = example_run("multichannel", device)
    st = ex["doc"]["stats"]
    lines.append(f"4-channel {r['standard']} {r['n_cycles']} cycles and the "
                 f"2-channel DDR4 replay (examples/torch/multichannel.py) "
                 f"on {device}: 4-channel Stats "
                 f"{'==' if not ex['diff'] else '!='} reference fixture; "
                 f"wall {ex['wall']:.2f} s (in a worker process, both runs, "
                 f"capture and audit), executed steps {st['scan_steps']} + "
                 f"{ex['doc']['replay_stats']['scan_steps']}, fused launches "
                 f"{ex['counts']['fused']}, plain steps "
                 f"{ex['counts']['plain']}")
    return dict(lines=lines, example=ex)


def predicate_kernel_phase(device):
    """Phase 13: the fused kernel vs ``step_and_horizon_plain`` with the
    modern-controller features, then one DDR4 lane timed with BlockHammer
    off and on."""
    import itertools
    import torch
    from repro_torch import testing as T
    from repro_torch.core import ControllerConfig, compile_spec
    from repro_torch.core import controller as C
    from repro_torch.core import device as D
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    from repro_torch.kernels import controller_step as KS
    features = [(3, 0, 0, False), (0, 4, 0, False), (0, 0, 80, False),
                (3, 4, 80, False), (2, 3, 0, False), (0, 0, 0, True),
                (3, 4, 80, True)]
    steps = max_err = 0
    for i, (std, (bh, prac, link, user), clk0) in enumerate(
            itertools.product(("DDR4", "LPDDR5", "HBM3", "GDDR7"), features,
                              (0, (1 << 24) + 12345))):
        org, tim = DEFAULT_SYSTEMS[std]
        cspec = compile_spec(std, org, tim)
        dp = D.dyn_params(cspec, device, channels=3)
        cfg = ControllerConfig(scheduler=("FRFCFS", "FCFS")[i % 2],
                               blockhammer_threshold=bh,
                               prac_threshold=prac,
                               extra_predicates=(T.reads_every_field,)
                               if user else ())
        # user predicates on a dual bus: one launch per pass
        per_step = 2 if user and cspec.dual_command_bus else 1
        cs, clk = T.predicate_ctrl_state(cspec, dp, device, seed=300 + i,
                                         bh=bh, prac=prac, link=link,
                                         clk0=clk0)
        kcs = T.clone_ctrl(cs)
        clocks = T.predicate_clocks(clk, dp.nREFI, 6)
        for n, t in enumerate(clocks):
            last = n == len(clocks) - 1         # the step without horizon
            before = KS.launch_count
            kcs, kev, kh = T.step_one_point(cspec, dp, cfg, kcs, t,
                                            not last, link)
            if last:
                cs, pev = C.controller_step_plain(cspec, dp, cfg, cs, t,
                                                  link)
            else:
                cs, pev, ph = C.step_and_horizon_plain(cspec, dp, cfg, cs,
                                                       t, link)
            torch.cuda.synchronize()
            diff = {**T.ctrl_diff(kcs, cs), **T.events_diff(kev, pev)}
            if not last:
                h = int((kh.long() - ph.long()).abs().max())
                diff.update({"horizon": h} if h else {})
            max_err = max([max_err, *(v for v in diff.values()
                                      if isinstance(v, int))])
            if diff or KS.launch_count != before + per_step:
                fail(f"fused step != plain version on {std} (BlockHammer "
                     f"{bh}, PRAC {prac}, link {link}, user predicate "
                     f"{user}, clock {t}): {diff}")
            steps += 1

    # one DDR4 lane (the engine's launch: one point at its device clock),
    # BlockHammer off and on; the sketch costs 8 KB in and 8 KB out
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    dp = D.dyn_params(cspec, device)
    times, bound = {}, {}
    for bh in (0, 8, 0, 8):
        cfg = ControllerConfig(blockhammer_threshold=bh)
        cs, clk = T.predicate_ctrl_state(cspec, dp, device, seed=7, bh=8,
                                         clk0=1000, channels=1)
        one = T.one_point(cs, clk)
        kern = lambda: C.step_and_horizon(cspec, dp, cfg, *one)
        ms = cuda_ms(kern, 2000)
        dev_us = device_us(kern, "controller_step_kernel")
        times.setdefault(bh, []).append((ms, dev_us))
        # bytes, as phase 3 counts them, plus the sketch in and out when on
        plan = C.step_plan(cspec, dp, cfg, one[0])
        inout = (*cs.dev, cs.hit_streak, cs.prac_count, cs.queue.valid)
        nbytes = (plan.consts.numel() * 4
                  + 2 * sum(t.numel() * t.element_size() for t in inout)
                  + sum(t.numel() * t.element_size() for t in (
                      cs.queue.is_write, cs.queue.is_probe, cs.queue.sub,
                      cs.queue.row, cs.queue.arrive, *one[1:]))
                  + plan.out.numel() * 4
                  + (2 * cs.bh_sketch.numel() * 4 if bh else 0))
        bound[bh] = (nbytes, nbytes / HBM_BYTES_PER_S * 1e9)
    fmt = lambda v: "not measured" if v is None else f"{v:.3f}"
    print(f"fused controller step with BlockHammer, PRAC, link latency and a "
          f"user predicate vs plain version: {steps} steps on DDR4, LPDDR5, "
          f"HBM3, GDDR7 (state "
          f"with sketch and PRAC counters, events, horizon: max |diff| "
          f"{max_err})")
    for bh, runs in times.items():
        print(f"  DDR4, 1 lane, BlockHammer {'on (8)' if bh else 'off'}: "
              "back to back "
              + " / ".join(f"{ms * 1e3:.2f}" for ms, _ in runs)
              + " us (CUDA events, in turns off/on/off/on), device "
              + " / ".join(fmt(d) for _, d in runs) + " us (torch.profiler); "
              f"bound {bound[bh][1]:.3f} ns ({bound[bh][0]} B at 3.35 TB/s)")
    return dict(steps=steps, max_err=max_err, times=times)


def stats_doc(stats) -> dict:
    """``Stats.to_dict()`` of one run plus every ``per_group`` leaf as
    lists: the layout of ``tests/torch_hetero_stats.json``."""
    d = stats.to_dict()
    d["per_group"] = [{k: v.cpu().tolist() for k, v in ch._asdict().items()}
                      for ch in stats.per_group]
    return d


def no_writes_ever(cspec, ctx):
    """The fixture's user predicate (``tests/core/test_controllers.py``)."""
    return ctx.cand_cmd != cspec.id_WR


def hetero_fixture() -> dict:
    return json.loads((ROOT / "tests" /
                       "torch_hetero_stats.json").read_text())


def system_run(job: str, device: str) -> dict:
    """One of phase 14's worker sessions (run in a worker process, every
    launch count set to 0 just before and read just after): the hetero
    golden run, ``run_batch`` over the system, or a predicate session of
    the fixture.  Returns what the main process checks."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import (ControllerConfig, FrontendConfig,
                                  Simulator, compile_system)
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.trace import FIELDS, capture, trace_sha256
    doc = hetero_fixture()
    if job == "hetero_golden":
        msys = compile_system(doc["system"])
        sim = Simulator(system=msys, device=device,
                        controller=ControllerConfig(scheduler="FRFCFS"))
        run = lambda: sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    elif job == "batch":
        b = doc["batch"]["run"]
        sim = Simulator(system=doc["system"], device=device)
        run = lambda: sim.run_batch(b["n_cycles"], b["intervals"],
                                    b["read_ratios"], seed=b["seed"])
    else:
        p = doc["predicates"][job]["run"]
        ctrl = dict(p["controller"])
        if "extra_predicates" in ctrl:
            ctrl["extra_predicates"] = tuple(
                {"no_writes_ever": no_writes_ever}[n]
                for n in ctrl["extra_predicates"])
        sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device=device,
                        controller=ControllerConfig(**ctrl),
                        frontend=FrontendConfig(**p["frontend"]))
        if p["rows"]:
            sim.cspec.rows = p["rows"]
        run = lambda: sim.run(p["n_cycles"], interval=p["interval"],
                              read_ratio=p["read_ratio"])
    KS.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    out = dict(wall=time.perf_counter() - t0, launches=KS.launch_count,
               plain=C.plain_calls, syncs=sim.host_syncs)
    if job == "hetero_golden":
        stats, dense = res
        tr = capture(sim.msys, dense)
        out.update(n=len(tr), sha256=trace_sha256(tr, FIELDS + ("group",)),
                   steps=stats.scan_steps)
    elif job == "batch":
        pts, stats = res
        out.update(points=[list(x) for x in pts],
                   stats=[stats_doc(stats.point(i)) for i in range(len(pts))],
                   steps=int(max(stats.scan_steps)))
    else:
        out.update(stats=stats_doc(res), steps=res.scan_steps)
    return out


SYSTEM_JOBS = ("blockhammer", "blockhammer_benign", "prac", "no_writes_ever",
               "hetero_golden", "batch")


def check_system_run(job: str, r: dict, doc: dict) -> int:
    """Hold a worker's system session to the fixture ``doc`` and to its
    launch and sync counts; returns its fused launches."""
    groups = len(doc["system"]) if job in ("hetero_golden", "batch") else 1
    if job == "hetero_golden":
        golden = json.loads((ROOT / "tests" / "trace" /
                             "golden_hashes.json").read_text())[
            "DDR5x2+DDR4x2@80"]
        ok = r["n"] == golden["n"] and r["sha256"] == golden["sha256"]
        what = f"commands {r['n']}"
    elif job == "batch":
        ok = (r["points"] == doc["batch"]["points"]
              and r["stats"] == doc["batch"]["stats"])
        what = f"{len(r['points'])} points"
    else:
        want = doc["predicates"][job]["stats"]
        ok = r["stats"] == want
        what = f"deferred {r['stats']['deferred']}"
    print(f"  {job:<19} {what:<18} steps {r['steps']:>6}  host syncs "
          f"{r['syncs']:>6}  fused launches {r['launches']:>6}  plain steps "
          f"{r['plain']:>5}  {r['wall']:7.2f} s  "
          f"{'match' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{job}: differs from " + ("its golden hash"
                                        if job == "hetero_golden" else
                                        "tests/torch_hetero_stats.json"))
    if (r["syncs"] != r["steps"] or r["launches"] != groups * r["syncs"]
            or r["plain"]):
        fail(f"{job}: {r['syncs']} host syncs, {r['launches']} fused "
             f"launches and {r['plain']} plain steps for {r['steps']} loop "
             f"iterations ({groups} spec groups)")
    return r["launches"]


def hetero_session_phase(device):
    """Phase 14 in the main process: 100 cycles of
    ``examples/hetero_system.py``'s session under ``torch.profiler`` (the
    whole session runs through the example in a worker process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Simulator, compile_system
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    doc = hetero_fixture()
    r = doc["session"]["run"]
    msys = compile_system(doc["system"])
    sim = Simulator(system=msys, device=device)
    sim.run(50, interval=r["interval"], read_ratio=r["read_ratio"])
    torch.cuda.synchronize()

    window = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.host_syncs = 0
        KS.launch_count = C.plain_calls = 0
        t1 = time.perf_counter()
        sim.run(window, interval=r["interval"], read_ratio=r["read_ratio"])
        torch.cuda.synchronize()
        win_wall = time.perf_counter() - t1
    win_iters, win_fused = sim.host_syncs, KS.launch_count
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not dev:
        fail("hetero session: the profiler saw no device events, so the "
             "device-to-host reads per iteration were not measured")
    dtoh = sum(e.count for e in dev if e.key.startswith("Memcpy DtoH"))
    kernels = sum(e.count for e in dev if not e.key.startswith("Memcpy")
                  and not e.key.startswith("Memset"))
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    n_ops = sum(e.count for e in prof.events()
                if e.key.startswith("aten::") and e.cpu_parent is None)
    if dtoh != win_iters:
        fail(f"hetero session: {dtoh} device-to-host copies in {win_iters} "
             "loop iterations, want one each")
    if win_fused != 2 * win_iters or C.plain_calls:
        fail(f"hetero session: {win_fused} fused launches and "
             f"{C.plain_calls} plain steps in {win_iters} iterations")
    print(f"hetero session {msys.label} ({msys.n_channels} channels, "
          f"{msys.n_groups} spec groups) on {device}, profile of {window} "
          f"cycles ({win_iters} iterations, "
          f"{win_wall:.3f} s): operator calls per iteration "
          f"{n_ops / win_iters:.1f}, device kernel launches per iteration "
          f"{kernels / win_iters:.1f} (fused {win_fused / win_iters:.3f}), "
          f"device-to-host copies per iteration {dtoh / win_iters:.3f} "
          f"(torch.profiler), device ms per iteration "
          f"{dev_ms / win_iters:.4f}, busy share "
          f"{dev_ms / 1e3 / win_wall:.1%}")


def hetero_example_line(ex: dict):
    """Phase 14's report of the whole session, run through
    ``examples/torch/hetero_system.py`` in a worker process (checked with
    phase 18's examples)."""
    doc = ex["doc"]
    st = doc["session"]["stats"]
    sweep = doc["sweep"]["columns"]["scan_steps"]
    print(f"  hetero session {doc['session']['run']['n_cycles']} cycles "
          f"through examples/torch/hetero_system.py: Stats and per-group "
          f"leaves {'==' if not ex['diff'] else '!='} reference fixture; "
          f"loop iterations {st['scan_steps']} (+ the link sweep's "
          f"{ex['iterations'] - st['scan_steps']} over {len(sweep)} "
          f"points), fused launches {ex['counts']['fused']}, plain steps "
          f"{ex['counts']['plain']}; {ex['wall']:.2f} s with the audit and "
          f"the sweep (in a worker process)")


def batched_phase(device, lane_device_us):
    """The batched latency-throughput session: ``run_batch`` of 32 load
    points over 4 DDR4 channels (128 lanes), 20,000 cycles, with every
    launch count set to 0 just before and read just after; each point's
    ``Stats`` must equal ``tests/torch_batch_stats.json``, with one fused
    launch and one host sync per loop iteration and no plain step.  Then
    100 cycles of the same session under ``torch.profiler``: device-to-host
    copies per iteration (must be 1) and device time per iteration.
    ``lane_device_us`` is phase 10's device time of one 128-lane launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Simulator
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import readiness as R
    doc = json.loads((ROOT / "tests" / "torch_batch_stats.json").read_text())
    r = doc["run"]
    sim = Simulator(r["standard"], r["org_preset"], r["timing_preset"],
                    channels=r["channels"], device=device)
    sim.run_batch(50, r["intervals"], r["read_ratios"])      # warm-up
    torch.cuda.synchronize()
    sim.host_syncs = 0
    KS.launch_count = R.launch_count = C.plain_calls = 0
    t0 = time.perf_counter()
    pts, stats = sim.run_batch(r["n_cycles"], r["intervals"],
                               r["read_ratios"], seed=r["seed"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain, iters = KS.launch_count, C.plain_calls, sim.host_syncs
    if [list(p) for p in pts] != doc["points"]:
        fail(f"batched session points {pts} != fixture {doc['points']}")
    for i, want in enumerate(doc["stats"]):
        got = stats.point(i).to_dict()
        if got != want:
            diff = {k: (got[k], want.get(k)) for k in got
                    if got[k] != want.get(k)}
            fail(f"batched session point {pts[i]}: Stats differ from the "
                 f"reference fixture: {diff}")
    steps = [int(s) for s in stats.scan_steps]
    if iters != max(steps) or launches != iters or plain or R.launch_count:
        fail(f"batched session: {iters} host syncs and {launches} fused "
             f"launches for {max(steps)} loop iterations, plain steps "
             f"{plain}, readiness launches {R.launch_count}")
    P, nch, n = len(pts), r["channels"], r["n_cycles"]

    window = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.host_syncs = 0
        sim.run_batch(window, r["intervals"], r["read_ratios"])
        torch.cuda.synchronize()
    win_iters = sim.host_syncs
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    dtoh = sum(e.count for e in dev if e.key.startswith("Memcpy DtoH"))
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / win_iters
    n_ops = sum(e.count for e in prof.events()
                if e.key.startswith("aten::") and e.cpu_parent is None)
    if not dev:
        fail("batched session: the profiler saw no device events, so the "
             "device-to-host reads per iteration were not measured")
    if dtoh != win_iters:
        fail(f"batched session: {dtoh} device-to-host copies in "
             f"{win_iters} loop iterations, want one each")
    ms_it = wall / iters * 1e3
    lane_us = ("not measured" if lane_device_us is None
               else f"{lane_device_us:.3f} us")
    print(f"batched session {r['standard']} {P} points x {nch} channels "
          f"({P * nch} lanes), {n} cycles on {device}: Stats == reference "
          f"fixture for every point; wall {wall:.2f} s, loop iterations "
          f"{iters}, executed point-cycles {sum(steps)}, "
          f"{P * n / wall:.1f} point-cycles/s, {P * nch * n / wall:.1f} "
          f"channel-cycles/s, {ms_it:.3f} ms per iteration, fused launches "
          f"per iteration {launches / iters:.3f}, plain steps 0, fused "
          f"kernel device "
          f"{lane_us} per 128-lane launch (phase 10)")
    print(f"  profile of {window} cycles ({win_iters} iterations): "
          f"device-to-host copies per iteration {dtoh / win_iters:.3f} "
          f"(torch.profiler), device ms per iteration {dev_ms}, operator "
          f"calls per iteration {n_ops / win_iters:.1f}")
    return launches


def main_path_phase(device):
    """Phase 6: the README's session through ``examples/torch/
    quickstart.py``; returns its example result (phase 18's first)."""
    want = json.loads((ROOT / "tests" /
                       "torch_main_path_stats.json").read_text())
    if (want["run"]["n_cycles"], want["run"]["interval"],
            want["run"]["read_ratio"]) != (MAIN["n_cycles"],
                                           MAIN["interval"],
                                           MAIN["read_ratio"]):
        fail("tests/torch_main_path_stats.json holds another session")
    r = example_run("quickstart", str(device))
    check_example(r)
    wall, steps = r["wall"], r["iterations"]
    c = r["counts"]
    print(f"main path {MAIN['standard']} {MAIN['n_cycles']} cycles "
          f"(examples/torch/quickstart.py): Stats == reference fixture; "
          f"wall {wall:.2f} s, executed steps {steps}, "
          f"{steps / wall:.1f} steps/s, {MAIN['n_cycles'] / wall:.1f} "
          f"cycles/s, {wall / steps * 1e3:.3f} ms per step, host syncs "
          f"{steps}, fused controller-step launches {c['fused']}, plain "
          f"steps {c['plain']}, readiness-table launches {c['tables']}")
    print("  " + " | ".join(line.strip() for line in r["doc"]["summary"]
                             .splitlines() if "GB/s" in line
                             or "latency" in line))
    return r


#: phase 18: each example of ``examples/torch/`` and the phase that runs it
EXAMPLE_PHASES = {"quickstart": "6", "extend_standard": "18",
                  "hetero_system": "14", "multichannel": "12",
                  "dse_sweep": "18", "visualize_trace": "18",
                  "serve_lm": "18", "memsys_aware_roofline": "22"}
#: spec groups per loop iteration of each example's runs (fused launches
#: per host sync); the examples that run no simulation launch none
EXAMPLE_GROUPS = {"hetero_system": 2, "extend_standard": 0, "serve_lm": 0}


def example_iterations(name: str, res: dict) -> int:
    """Loop iterations (host syncs) of every simulation an example ran."""
    sims = dict(quickstart=("sim",), hetero_system=("sim",),
                multichannel=("quad", "ddr_replay"), dse_sweep=("sim",),
                visualize_trace=("sim",),
                memsys_aware_roofline=("sim",)).get(name, ())
    sweeps = dict(hetero_system="sweep", dse_sweep="result").get(name)
    n = sum(res[k].host_syncs for k in sims)
    return n + (res[sweeps].meta["host_syncs"] if sweeps else 0)


def example_run(name: str, device: str) -> dict:
    """Phase 18 for one example (in a worker process or the main one):
    ``examples/torch/<name>.py`` at its own size (``EXAMPLE_RUNS``) with
    every launch count set to 0 just before and read just after, its
    output in ``build/examples/<name>.log``; returns its doc, the
    fixture's keys it differs in, its counts and seconds."""
    import contextlib
    import io
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import controller as C
    from repro_torch.kernels import controller_step as KS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import readiness as R
    tp = parity()
    out = ROOT / "build" / "examples"
    out.mkdir(parents=True, exist_ok=True)
    mod = tp.load_example(name)
    argv = tp.example_argv(name, tp.EXAMPLE_RUNS[name], device,
                           str(out / name))
    if name == "memsys_aware_roofline":
        argv += ["--results", str(DRYRUN_DIR)]   # phase 22 (a)'s JSON
    log = io.StringIO()
    KS.launch_count = R.launch_count = C.plain_calls = 0
    FA.launch_count = FA.sm90_launch_count = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        res = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused=KS.launch_count, tables=R.launch_count,
                  plain=C.plain_calls, flash=FA.launch_count,
                  sm90=FA.sm90_launch_count)
    (out / f"{name}.log").write_text(log.getvalue())
    doc = tp.port_example_doc(name, res)
    want = tp.example_reference_doc(name)
    diff = sorted(k for k in want if doc.get(k) != want[k])
    tie = None
    if name == "serve_lm" and diff and set(diff) <= {"first", "tokens"}:
        # greedy tokens may part at a near tie of the reference's logits
        import numpy as np
        z = np.load(tp.EXAMPLES_SERVE)
        from repro_torch.launch.serve import load_params
        tie = greedy_check(res["cfg"], load_params(tp.EXAMPLES_SERVE,
                                                   res["cfg"], device),
                           res["prompts"], res["first"], res["tokens"], z,
                           device)
        diff = []
    return dict(name=name, wall=wall, counts=counts, doc=doc, diff=diff,
                tie=tie, iterations=example_iterations(name, res),
                layers=getattr(res.get("cfg"), "n_layers", 0),
                rows=res.get("rows"))


def check_example(r: dict):
    """Hold one example's result to ``tests/torch_examples_stats.json``
    and to its launch counts."""
    name, c = r["name"], r["counts"]
    if r["diff"]:
        fail(f"example {name}: {r['diff']} differ from "
             "tests/torch_examples_stats.json")
    groups = EXAMPLE_GROUPS.get(name, 1)
    want = dict(fused=groups * r["iterations"], plain=0,
                tables=int(name == "extend_standard"),
                flash=r["layers"] if name == "serve_lm" else 0, sm90=0)
    if c != want or (groups and not r["iterations"]):
        fail(f"example {name}: launches {c} for {r['iterations']} loop "
             f"iterations, want {want}")


def examples_phase(results: list):
    """Phase 18's report: every example's seconds, launches and verdict
    (each checked where it ran), then the host-sync lint of the shipped
    tree."""
    import contextlib
    import io
    from repro_torch.analysis.__main__ import main as analysis
    by = {r["name"]: r for r in results}
    tp = parity()
    if sorted(by) != sorted(tp.EXAMPLES):
        fail(f"phase 18 ran {sorted(by)}, want {sorted(tp.EXAMPLES)}")
    print("examples/torch at their own sizes (phase 18; == "
          "tests/torch_examples_stats.json):")
    for name in tp.EXAMPLES:
        r = by[name]
        c = r["counts"]
        extra = ""
        if r["tie"] is not None:
            extra = (f"; tokens: {r['tie']['compared']} compared, "
                     f"{r['tie']['flips']} near-tie flips")
        print(f"  {name:<16} phase {EXAMPLE_PHASES[name]:>2}  "
              f"{r['wall']:7.2f} s  loop iterations {r['iterations']:>6}  "
              f"fused launches {c['fused']:>6}  table {c['tables']}  "
              f"flash {c['flash']}  plain {c['plain']}  match{extra}")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = analysis(["trace"])
    lines = log.getvalue().splitlines()
    print(f"  analysis trace (host-sync lint, {time.perf_counter() - t0:.1f}"
          f" s): {lines[-2].strip()} -> {lines[-1].strip()}")
    if rc != 0:
        fail("python -m repro_torch.analysis trace: " + log.getvalue())
    return results


#: the flash launch counts: the CUDA-core kernel's, the sm90 kernel's at D
#: 64/128 and at D 256
FLASH_ROUTES = ("cuda_core", "sm90", "d256")


def flash_counts(FA) -> tuple:
    """The flash kernels' launch counts, in ``FLASH_ROUTES`` order."""
    return (FA.launch_count, FA.sm90_launch_count, FA.d256_launch_count)


def reset_flash_counts(FA):
    FA.launch_count = FA.sm90_launch_count = FA.d256_launch_count = 0


def flash_call(FA, q, k, v, causal: bool, head_axis: int, want,
               window=None):
    """One call of a flash entry point on the card: the route's counter
    goes up by one and the others' not at all; returns ``(route, max
    |diff|)`` against ``want`` (the plain version in ``q``'s layout)."""
    import torch
    kind = FA.counter(q.dtype, q.shape[-1])
    before = flash_counts(FA)
    if head_axis == 1:
        got = FA.gqa_flash_attention(q, k, v, causal=causal, window=window)
    else:
        got = FA.flash_attention_bthd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    step = tuple(int(r == kind) for r in FLASH_ROUTES)
    after = flash_counts(FA)
    if tuple(x - y for x, y in zip(after, before)) != step:
        fail(f"flash {kind} call counted launches {before} -> {after}")
    if got.shape != want.shape or got.dtype != q.dtype:
        fail(f"flash {kind} output {tuple(got.shape)} {got.dtype}")
    return kind, (got.float() - want.float()).abs().max().item()


def flash_phase(device):
    """Both flash kernels vs the plain version on every listed case, and
    timings per dtype and head dim."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=device).manual_seed(7)
    t = lambda x: x.transpose(1, 2)
    worst = {}                   # (route, dtype, D) -> max |diff|
    cases = 0

    def check(q, k, v, causal, head_axis, label, window=None):
        nonlocal cases
        qp, kp, vp = (q, k, v) if head_axis == 1 else (t(q), t(k), t(v))
        want = FA.attention_plain(qp, kp, vp, causal=causal,
                                  sm_scale=q.shape[-1] ** -0.5,
                                  window=window)
        if head_axis == 2:
            want = t(want)
        kind, err = flash_call(FA, q, k, v, causal, head_axis, want, window)
        dt = str(q.dtype).split(".")[-1]
        if not err <= FLASH_TOL[dt]:
            fail(f"flash {kind} kernel != plain version ({label}, {dt}, "
                 f"causal={causal}, D={q.shape[-1]}, window={window}): max "
                 f"|diff| {err}")
        key = (kind, dt, q.shape[-1], window is not None)
        worst[key] = max(worst.get(key, 0.0), err)
        cases += 1

    def rand(*shape, dtype=torch.bfloat16, scale=0.3):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(dtype)

    # both routes: fp32 and bf16, D 16-128, T 100/300, rep 1/4, layouts
    for dt, causal, D, T, rep in itertools.product(
            ("float32", "bfloat16"), (True, False), (16, 32, 64, 128),
            (100, 300), (1, 4)):
        q, k, v = (rand(2, h, T, D, dtype=getattr(torch, dt))
                   for h in (2 * rep, 2, 2))
        check(q, k, v, causal, 1, f"T={T}, rep={rep}, (B, H, T, D)")
        check(t(q).contiguous(), t(k).contiguous(), t(v).contiguous(),
              causal, 2, f"T={T}, rep={rep}, (B, T, H, D)")
    # the tensor-core kernel: ragged T 1000, T 4096 (the k/v ring wraps
    # 16 times), GQA rep 8, Tq != Tk, unscaled inputs, and head slices of
    # a fused (B, T, Hq + 2 Hkv, D) qkv tensor
    for causal, D in itertools.product((True, False), (64, 128)):
        for T, rep in itertools.product((1000, 4096), (1, 4, 8)):
            q, k, v = (rand(2, T, h, D, scale=1.0) for h in (2 * rep, 2, 2))
            check(q, k, v, causal, 2, f"T={T}, rep={rep}")
        q, k, v = rand(2, 40, 8, D), rand(2, 100, 2, D), rand(2, 100, 2, D)
        check(q, k, v, causal, 2, "Tq=40, Tk=100")
        check(t(q).contiguous(), t(k).contiguous(), t(v).contiguous(),
              causal, 1, "Tq=40, Tk=100, (B, H, T, D)")
        qkv = rand(2, 300, 8 + 2 * 2, D)
        check(*qkv.split([8, 2, 2], dim=2), causal, 2, "fused qkv view")
    # llama4-maverick's GQA rep 5 (40 q heads on 8 kv heads) at D 128
    for causal in (True, False):
        q, k, v = (rand(2, 1000, h, 128, scale=1.0) for h in (10, 2, 2))
        check(q, k, v, causal, 2, "T=1000, rep=5")
    # head dim 256 (the sm90 kernel's 64-row kv tiles): recurrentgemma-2b's
    # MQA (rep 10 on one kv head), ragged T, T 4096 (the ring wraps 32
    # times), both layouts, Tq != Tk and a fused qkv view
    for causal, T in itertools.product((True, False),
                                       (1, 100, 300, 1000, 4096)):
        q, k, v = (rand(2, T, h, 256, scale=1.0) for h in (10, 1, 1))
        check(q, k, v, causal, 2, f"T={T}, MQA rep 10")
        check(t(q).contiguous(), t(k).contiguous(), t(v).contiguous(),
              causal, 1, f"T={T}, MQA rep 10, (B, H, T, D)")
    for causal in (True, False):
        q, k, v = rand(2, 40, 10, 256), rand(2, 100, 1, 256), \
            rand(2, 100, 1, 256)
        check(q, k, v, causal, 2, "Tq=40, Tk=100, MQA rep 10")
        qkv = rand(2, 300, 10 + 2, 256)
        check(*qkv.split([10, 1, 1], dim=2), causal, 2,
              "fused qkv view, MQA rep 10")
    # local attention on every route: windows 1, 64, 100, 2048 at T 300
    # (causal and full) and 4096 (causal: the windowed tiles at the lower
    # edge, plain tiles, the diagonal; the k/v ring wraps), rep 1, 4, 10
    # and 16; fp32 at T 300 (and one 4096 case)
    for (dt, D), window, rep in itertools.product(
            [("bfloat16", D) for D in (32, 64, 128, 256)]
            + [("float32", D) for D in (32, 64, 128)],
            (1, 64, 100, 2048), (1, 4, 10, 16)):
        dtype = getattr(torch, dt)
        q, k, v = (rand(2, 300, h, D, dtype=dtype, scale=1.0)
                   for h in (2 * rep, 2, 2))
        for causal in (True, False):
            check(q, k, v, causal, 2, f"T=300, rep={rep}", window)
        if dt == "bfloat16" or (D, rep) == (64, 1):
            q, k, v = (rand(1, 4096, h, D, dtype=dtype, scale=1.0)
                       for h in (2 * rep, 2, 2))
            check(q, k, v, True, 2, f"T=4096, rep={rep}", window)
    print(f"flash kernels vs plain version, {cases} calls, each counted "
          "on its route; max |diff| by route, dtype, head dim and window:")
    for (kind, dt, D, win), e in sorted(worst.items()):
        label = "window" if win else "no window"
        print(f"  {kind:<9} {dt:<9} D {D:>3} {label:<9}: {e:.3e} "
              f"(tolerance {FLASH_TOL[dt]:g})")
    max_err = {kind: max(e for (r, *_), e in worst.items() if r == kind)
               for kind in FLASH_ROUTES}

    # per dtype and D: times at (B 2, Hq 8, Hkv 2, T 300), causal; the
    # bound counts 2 B Hq T^2 D operations at the type's peak rate (fp32
    # on CUDA cores, bf16 on tensor cores) and q, k, v, o bytes once
    print("per launch at (B 2, Hq 8, Hkv 2, T 300) causal, CUDA events "
          "back to back:")
    print(f"  {'dtype':<9} {'D':>3} {'route':<9} {'kernel_us':>10} "
          f"{'plain_us':>9} {'bound_us':>9}")
    for dt, D in [("bfloat16", D) for D in (16, 32, 64, 128, 256)] + \
            [("float32", D) for D in (16, 32, 64, 128)]:
        dtype = getattr(torch, dt)
        q, k, v = (rand(2, h, 300, D, dtype=dtype) for h in (8, 2, 2))
        kern_us = cuda_ms(lambda: FA.gqa_flash_attention(q, k, v), 50) * 1e3
        plain_us = cuda_ms(lambda: FA.attention_plain(
            q, k, v, causal=True, sm_scale=D ** -0.5), 20) * 1e3
        rate = BF16_TENSOR_OPS_PER_S if dt == "bfloat16" else \
            CUDA_CORE_OPS_PER_S
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        bound_us = max(2 * 2 * 8 * 300 * 300 * D / rate,
                       nbytes / HBM_BYTES_PER_S) * 1e6
        print(f"  {dt:<9} {D:>3} {FA.route(dtype, D):<9} {kern_us:>10.2f} "
              f"{plain_us:>9.2f} {bound_us:>9.3f}")
    return max_err


def visible_pairs(Tq: int, Tk: int, causal: bool, window=None) -> int:
    """The (q, k) pairs one (batch, head) attends to under the top-left
    causal mask and the window: row ``r`` sees cols ``max(0, r - window +
    1) .. min(r, Tk - 1)``."""
    import numpy as np
    r = np.arange(Tq, dtype=np.int64)
    hi = np.minimum(r, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(0, r - window + 1) if window else np.zeros(Tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_timing(device, B, T, Hq, Hkv, D, kernel: str,
                 dtype: str = "bfloat16", window=None):
    """One flash kernel at a path's shape, causal in the model's layout
    (with ``window``, local): back-to-back times, device time per call
    (``queued_ms``) and per launch (``torch.profiler``, the kernel whose
    name contains ``kernel``: one launch a call), the plain version's and
    ``scaled_dot_product_attention``'s (the library call, never on the
    path; under a window with the band as a boolean ``attn_mask``, and
    also causal without a mask, the most a band could save), and the
    bound: ``4 D`` operations (multiply-adds of both products) for
    every visible (q, k) pair of every (batch, q head) at 989 TFLOP/s in
    bf16 or 67 TFLOP/s in fp32 (CUDA cores), against q, k, v and o bytes
    once at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v = (torch.randn(B, T, h, D, generator=gen, device=device)
               .to(getattr(torch, dtype)) for h in (Hq, Hkv, Hkv))
    t = lambda x: x.transpose(1, 2)
    kern = lambda: FA.flash_attention_bthd(q, k, v, causal=True,
                                           window=window)
    plain = lambda: FA.attention_plain(t(q), t(k), t(v), causal=True,
                                       sm_scale=D ** -0.5, window=window)
    err = (kern().float() - t(plain()).float()).abs().max().item()
    if not err <= FLASH_TOL[dtype]:
        fail(f"flash {kernel} != plain version at "
             f"{(B, T, Hq, Hkv, D)} {dtype} window {window}: max |diff| "
             f"{err}")
    qh, kh, vh = (t(x).contiguous() for x in (q, k, v))
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
    else:
        rows = torch.arange(T, device=device)[:, None]
        cols = torch.arange(T, device=device)[None, :]
        band = (rows >= cols) & (rows - cols < window)
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=band, enable_gqa=True)
    sdpa_err = (t(kern()).float() - sdpa().float()).abs().max().item()
    fmt = lambda x, scale=1: ("not measured" if x is None
                              else f"{x * scale:.4f} ms")
    causal_note = ""
    if window is not None:
        causal = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
        causal_note = (f"; scaled_dot_product_attention causal, no mask "
                       f"{cuda_ms(causal, 50):.4f} ms back to back, device "
                       f"{fmt(queued_ms(causal))} queued")
    kern_ms = cuda_ms(kern, 50)
    dev_us = device_us(kern, kernel, reps=20)
    plain_ms = cuda_ms(plain, 10 if T * Hq <= 32_000 else 3)
    sdpa_ms = cuda_ms(sdpa, 50)
    kern_ms2 = cuda_ms(kern, 50)
    kern_q, sdpa_q = queued_ms(kern), queued_ms(sdpa)
    pairs = visible_pairs(T, T, True, window)
    flops = 4 * D * B * Hq * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    rate = BF16_TENSOR_OPS_PER_S if dtype == "bfloat16" else \
        CUDA_CORE_OPS_PER_S
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{kernel} at (B, T, Hq, Hkv, D) = {(B, T, Hq, Hkv, D)} {dtype} "
          f"causal, window {window}: max |diff| vs plain {err:.3e}, vs SDPA "
          f"{sdpa_err:.3e}; kernel {kern_ms:.4f} / {kern_ms2:.4f} ms back "
          f"to back (CUDA events, before / after SDPA), device "
          f"{fmt(kern_q)} queued, {fmt(dev_us, 1e-3)} torch.profiler; plain "
          f"{plain_ms:.4f} ms; scaled_dot_product_attention "
          f"{'(band mask) ' if window else ''}{sdpa_ms:.4f} ms back to back, "
          f"device {fmt(sdpa_q)} queued{causal_note}; bound "
          f"{max(ops_ms, bytes_ms):.6f} "
          f"ms ({pairs:,} (q, k) pairs per head: {flops / 1e9:.4f} GFLOP at "
          f"{rate / 1e12:.0f} TFLOP/s: {ops_ms:.6f} ms; {nbytes / 1e6:.2f} "
          f"MB at 3.35 TB/s: {bytes_ms:.6f} ms)")
    return dict(max_err=err, ms=kern_ms, device_us=dev_us,
                plain_ms=plain_ms, library_ms=sdpa_ms,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def op_overhead(device, B, T, Hq, Hkv, D, dtype: str = "bfloat16"):
    """What the ``torch.library`` operators cost on the host beside a
    direct call of the same body (phase 4, on a quiet host): back-to-back
    ms per call (CUDA events) of the forward through the public entry
    (which calls the body directly on plain tensors), through
    ``torch.ops.repro_torch.flash_fwd`` and through ``attention_cuda``;
    and of the backward through ``torch.ops.repro_torch.flash_bwd`` and
    through its body, on the same tensors.  Fails if the entry launches
    another kernel or count than the operator."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v, do = (torch.randn(B, T, h, D, generator=gen, device=device)
                   .to(getattr(torch, dtype)) for h in (Hq, Hkv, Hkv, Hq))
    scale = D ** -0.5
    o, lse = FA.attention_cuda(q, k, v, causal=True, sm_scale=scale,
                               head_axis=2, return_lse=True)
    calls = {
        "entry": lambda: FA.flash_attention_bthd(q, k, v, causal=True),
        "op": lambda: torch.ops.repro_torch.flash_fwd(q, k, v, 2, True,
                                                      None, scale),
        "direct": lambda: FA.attention_cuda(q, k, v, causal=True,
                                            sm_scale=scale, head_axis=2),
        "bwd op": lambda: torch.ops.repro_torch.flash_bwd(
            q, k, v, o, do, lse, 2, True, None, scale),
        "bwd direct": lambda: FA._backward(q, k, v, o, do, lse, 2, True,
                                           None, scale)}
    counts = {}
    for name in ("entry", "op"):
        reset_flash_counts(FA)
        got = calls[name]()
        counts[name] = flash_counts(FA)
        if not torch.equal(got, calls["direct"]()):
            fail(f"flash {name} call differs from attention_cuda's")
    if counts["entry"] != counts["op"] or sum(counts["op"]) != 1:
        fail(f"flash entry launches {counts['entry']}, operator "
             f"{counts['op']}: want the same one launch")
    ms = {name: cuda_ms(fn, 200) for name, fn in calls.items()}
    ms.update({f"{name} again": cuda_ms(calls[name], 200)
               for name in ("op", "direct", "bwd op", "bwd direct")})
    print(f"flash operator vs direct call at {(B, T, Hq, Hkv, D)} {dtype} "
          "causal (back to back, CUDA events, ms per call; phase 4): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return ms


def ptxas_report(log: str, entry: str) -> str:
    """``-Xptxas -v``'s registers and spills for the entry function whose
    mangled name contains ``entry``, and whether ptxas serialised its
    ``wgmma`` (warning C7512: each product then waits for the last)."""
    for chunk in log.split("Compiling entry function '")[1:]:
        if entry not in chunk.split("'", 1)[0]:
            continue
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        serial = any("C7512" in ln and entry in ln
                     for ln in log.splitlines())
        return (f"{regs.group(1) if regs else '?'} registers, "
                f"{spill.group(1) if spill else '?'} bytes spill stores, "
                f"{spill.group(2) if spill else '?'} bytes spill loads, "
                f"wgmma serialised (C7512): {'yes' if serial else 'no'}")
    return "not in the log"


def sass_counts(lib_path, required, shown=(), what="kernel",
                function: str | None = None) -> str:
    """Instructions whose SASS mnemonic starts with each of ``required``
    and ``shown`` in a built library (only in the functions whose mangled
    name contains ``function``, if given), from the toolkit's
    ``cuobjdump``; fails if one of ``required`` is missing, "not
    available" without ``cuobjdump``."""
    import shutil
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if not tool:
        return "not available (no cuobjdump)"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode:
        return f"not available (cuobjdump exited {out.returncode})"
    lines, inside = [], function is None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            inside = function is None or function in ln
        elif inside and ln.strip().startswith("/*"):
            lines.append(ln.split())
    n = {op: sum(any(tok.startswith(op) for tok in ln) for ln in lines)
         for op in (*required, *shown)}
    if not all(n[op] for op in required):
        fail(f"{what} SASS lacks one of {required}: {n}")
    return ", ".join(f"{op} {c}" for op, c in n.items())


@contextlib.contextmanager
def plain_attention():
    """Inside: the model's prefill attention runs the kernel's plain
    version (for the comparisons of phases 8 and 9 only)."""
    from repro_torch.kernels import flash_attention as FA
    kernel = FA.flash_attention_bthd

    def plain(q, k, v, *, causal=True, sm_scale=None, window=None):
        t = lambda x: x.transpose(1, 2)
        return t(FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                    sm_scale=sm_scale, window=window))

    FA.flash_attention_bthd = plain
    try:
        yield
    finally:
        FA.flash_attention_bthd = kernel


@contextlib.contextmanager
def each_call_against_plain(record: list):
    """Inside: every prefill attention call of the model runs the kernel
    and also the kernel's plain version on the same inputs (not counted:
    the plain version launches nothing); ``record`` gets ``(max |diff|,
    within LM_TOL)`` of each call."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    kernel = FA.flash_attention_bthd

    def both(q, k, v, *, causal=True, sm_scale=None, window=None):
        out = kernel(q, k, v, causal=causal, sm_scale=sm_scale,
                     window=window)
        t = lambda x: x.transpose(1, 2)
        want = t(FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                    sm_scale=sm_scale, window=window))
        record.append(((out.float() - want.float()).abs().max().item(),
                       torch.allclose(out.float(), want.float(), **LM_TOL)))
        return out

    FA.flash_attention_bthd = both
    try:
        yield
    finally:
        FA.flash_attention_bthd = kernel


def text_positions(cfg, B: int, L: int, start: int, device):
    """Positions ``start..start+L-1`` per request, (B, L), or M-RoPE's
    ``(p, p // 7, p % 7)`` (B, L, 3), as ``serve_batch`` makes them."""
    import torch
    from repro_torch.serve.step import mrope_positions
    pos = torch.arange(start, start + L, dtype=torch.int32,
                       device=device)[None].repeat(B, 1)
    return mrope_positions(pos) if cfg.rope == "mrope" else pos


def teacher_forced(cfg, params, prompts, seq, device, cache_out=None):
    """Prefill logits and the decode logits of feeding ``seq[:, i]`` at
    position T + i, each ``(B, V)`` (audio ``(B, K, V)``) fp32; with a
    ``cache_out`` list, the prefill's decode cache is appended to it."""
    from repro_torch.models import model as M
    from repro_torch.serve.step import make_prefill_step
    B, T = prompts.shape[:2]
    n = seq.shape[1]
    lg, cache = make_prefill_step(cfg, T + n)(params, M.Batch(
        tokens=prompts, positions=text_positions(cfg, B, T, 0, device)))
    if cache_out is not None:
        cache_out.append(cache)
    out = [lg[:, -1]]
    for i in range(n):
        lg, cache = M.decode_step(cfg, params, cache, M.Batch(
            tokens=seq[:, i:i + 1],
            positions=text_positions(cfg, B, 1, T + i, device),
            cache_index=T + i, cache_len=T + i + 1))
        out.append(lg[:, -1])
    return out


def margins(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def near_tie_tokens(got, want, first, toks, want_seq) -> tuple:
    """Free-running greedy tokens against the reference's: while a
    request's tokens agree, its inputs are the teacher-forced ones, so a
    token may differ only where the reference's top-two margin is within
    twice that position's max |diff| of the logits ``got`` and ``want``
    ``(B, n+1, V)``; after such a near-tie flip the request's later
    tokens are not compared.  Returns ``(compared, flips, equal)``."""
    import numpy as np
    import torch
    got_seq = np.concatenate([first.cpu().numpy()[:, None],
                              toks.cpu().numpy()], 1)
    tie = margins(torch.as_tensor(want)).numpy() \
        <= 2 * np.abs(got - want).max(-1)
    compared = flips = 0
    for b in range(got_seq.shape[0]):
        for i in range(got_seq.shape[1]):
            compared += 1
            differ = got_seq[b, i] != want_seq[b, i]    # audio: per codebook
            if not differ.any():
                continue
            if not tie[b, i][differ].all():
                fail(f"greedy token differs at request {b}, position {i}: "
                     f"{got_seq[b, i]} != {want_seq[b, i]}")
            flips += 1
            break
    return compared, flips, bool((got_seq == want_seq).all())


def greedy_check(cfg, params, prompts, first, toks, z, device) -> dict:
    """A serving run's greedy tokens against a serve fixture ``z`` (the
    reference's prompts, tokens and logits): the teacher-forced logits
    within ``FIXTURE_TOL`` of the fixture's, then :func:`near_tie_tokens`."""
    import numpy as np
    import torch
    n = z["tokens"].shape[1]
    want_seq = np.concatenate([z["first"][:, None], z["tokens"]], 1)
    got = teacher_forced(cfg, params, prompts,
                         torch.as_tensor(want_seq[:, :n], device=device),
                         device)
    got = torch.stack(got, 1).float().cpu().numpy()
    want = np.concatenate([z["prefill_logits"][:, None], z["decode_logits"]],
                          1)
    if not np.allclose(got, want, **FIXTURE_TOL):
        fail(f"serving logits differ from the reference's beyond "
             f"{FIXTURE_TOL}: max |diff| {float(np.abs(got - want).max())}")
    compared, flips, equal = near_tie_tokens(got, want, first, toks,
                                             want_seq)
    return dict(compared=compared, flips=flips, equal=equal,
                diff=float(np.abs(got - want).max()))


def fixture_phase(device):
    """The reduced GQA Llama against the JAX package's fixture."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import ModelConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve.step import serve_batch
    z = np.load(ROOT / "tests" / "torch_serve_fixture.npz")
    fields = json.loads(str(z["config"]))
    fields["block_pattern"] = tuple(fields["block_pattern"])
    cfg = ModelConfig(**fields)
    params = convert.lm_params(convert.nest(
        {k[len("param."):]: z[k] for k in z.files if k.startswith("param.")}),
        cfg, device)
    prompts = torch.as_tensor(z["prompts"], device=device)
    n = z["tokens"].shape[1]
    before = FA.sm90_launch_count
    toks, first = serve_batch(cfg, params, prompts, n, device=device)
    if FA.sm90_launch_count - before != cfg.n_layers:
        fail("fixture run: sm90 flash kernel launched "
             f"{FA.sm90_launch_count - before} times, want {cfg.n_layers}")
    want_seq = np.concatenate([z["first"][:, None], z["tokens"]], 1)
    got = teacher_forced(cfg, params, prompts,
                         torch.as_tensor(want_seq[:, :n], device=device),
                         device)
    got = torch.stack(got, 1).cpu().numpy()                 # (B, n+1, V)
    want = np.concatenate([z["prefill_logits"][:, None], z["decode_logits"]],
                          1)
    diff = float(np.abs(got - want).max())
    if not np.allclose(got, want, **FIXTURE_TOL):
        fail(f"fixture logits differ from the JAX package's beyond "
             f"{FIXTURE_TOL}: max |diff| {diff}")
    compared, flips, equal = near_tie_tokens(got, want, first, toks,
                                             want_seq)
    print(f"fixture (reduced GQA {cfg.name}, {cfg.n_heads} q heads / {cfg.n_kv_heads} kv heads, head_dim {cfg.head_dim}) on "
          f"{device}: prefill + teacher-forced decode logits within "
          f"{FIXTURE_TOL} of the JAX package's (max |diff| {diff:.3e}); "
          f"greedy tokens: {compared} of {want_seq.size} compared, "
          f"{flips} near-tie flips; whole sequences equal: {equal}")


def lm_phase(device):
    """Phase 9: the full-width llama3.2-1b serving session."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import readiness as R
    from repro_torch.models import init_params
    from repro_torch.serve.step import serve_batch
    cfg = get_arch(LM["arch"])
    t0 = time.perf_counter()
    params = init_params(cfg, LM["seed"], device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != LM["params"] or cfg.param_count() != LM["params"]:
        fail(f"{cfg.name}: {n_params} parameters, want {LM['params']}")
    rng = np.random.default_rng(LM["seed"])
    B, T, N = LM["batch"], LM["prompt_len"], LM["max_new"]
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)),
                              dtype=torch.int32, device=device)
    serve_batch(cfg, params, prompts[:, :64], 2, device=device)   # warm-up

    torch.cuda.reset_peak_memory_stats(device)
    timings: dict = {}
    reset_flash_counts(FA)
    R.launch_count = 0
    toks, first = serve_batch(cfg, params, prompts, N, device=device,
                              timings=timings)
    launches = FA.sm90_launch_count
    if launches != cfg.n_layers or FA.launch_count or R.launch_count \
            or FA.d256_launch_count:
        fail(f"serving session launched the sm90 flash kernel {launches} "
             f"times, the CUDA-core one {FA.launch_count} times and the "
             f"readiness kernels {R.launch_count} times, want "
             f"{cfg.n_layers} (one per layer), 0 and 0")
    peak = torch.cuda.max_memory_allocated(device)
    seq = torch.cat([first[:, None], toks], 1)
    if seq.shape != (B, N + 1) or int(seq.min()) < 0 \
            or int(seq.max()) >= cfg.vocab:
        fail(f"serving session tokens out of range: {tuple(seq.shape)}")

    kern = teacher_forced(cfg, params, prompts, seq[:, :N], device)
    if not all(bool(torch.isfinite(x).all()) for x in kern):
        fail("serving session: non-finite logits")
    with plain_attention():
        plain = teacher_forced(cfg, params, prompts, seq[:, :N], device)
    if FA.sm90_launch_count != 2 * cfg.n_layers or FA.launch_count:
        fail("the plain-version prefill launched a kernel")
    pre_diff = (kern[0] - plain[0]).abs().max().item()
    if not torch.allclose(kern[0], plain[0], **LM_TOL):
        fail(f"full-width prefill logits, kernel vs plain version: max "
             f"|diff| {pre_diff} beyond {LM_TOL}")
    pl = torch.stack(plain, 1)                              # (B, N+1, V)
    checked = margins(pl) > LM_TOL["atol"]
    same = pl.argmax(-1) == seq
    if not bool(same[checked].all()):
        fail("full-width greedy tokens differ between kernel and plain "
             "version where the top-two margin exceeds "
             f"{LM_TOL['atol']}")
    dec_diff = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    pre, dec = timings["prefill_s"], timings["decode_s"]
    print(f"serving session {cfg.name} on {device}: {n_params:,} bf16 "
          f"parameters (init {init_s:.2f} s), {B} requests x {T} prompt "
          f"tokens, {N} new tokens each; prefill {pre * 1e3:.2f} ms "
          f"({B * T / pre:.0f} prompt tokens/s); decode {dec * 1e3:.2f} ms = "
          f"{dec * 1e3 / N:.3f} ms per step ({B * N / dec:.1f} tokens/s); "
          f"end to end {B * N / (pre + dec):.1f} new tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; flash launches: sm90 {launches}, "
          f"CUDA-core {FA.launch_count} (readiness {R.launch_count})")
    print(f"  kernel vs plain version through the model: prefill logits max "
          f"|diff| {pre_diff:.3e}, teacher-forced decode logits max |diff| "
          f"{dec_diff:.3e}; greedy tokens equal at {int(checked.sum())} of "
          f"{checked.numel()} positions with a top-two margin above "
          f"{LM_TOL['atol']} ({int(same.sum())} equal in all)")
    return launches


def reduced_shape():
    """The prefill attention shape (B, T, Hq, Hkv, D) of phase 8."""
    from repro_torch.configs import get_arch
    cfg = get_arch(LM["arch"]).reduced()
    return (REDUCED["batch"], REDUCED["prompt_len"], cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim)


def reduced_phase(device):
    """The reduced llama3.2-1b (``launch/serve.py --reduced``: 2 heads of
    head dim 32, bf16), the path of the CUDA-core flash kernel: 4 requests
    of 256 prompt tokens, 8 new tokens each, with every launch count set to
    0 just before and read just after; then its prefill logits, kernel vs
    plain version, within 2e-2."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.serve.step import serve_batch
    cfg = get_arch(LM["arch"]).reduced()
    params = init_params(cfg, LM["seed"], device)
    rng = np.random.default_rng(LM["seed"])
    B, T, N = REDUCED["batch"], REDUCED["prompt_len"], REDUCED["max_new"]
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)),
                              dtype=torch.int32, device=device)
    reset_flash_counts(FA)
    toks, first = serve_batch(cfg, params, prompts, N, device=device)
    launches = FA.launch_count
    if launches != cfg.n_layers or FA.sm90_launch_count \
            or FA.d256_launch_count:
        fail(f"reduced session launched the CUDA-core flash kernel "
             f"{launches} times and the sm90 one {FA.sm90_launch_count} "
             f"times, want {cfg.n_layers} and 0")
    seq = torch.cat([first[:, None], toks], 1)
    kern = teacher_forced(cfg, params, prompts, seq[:, :1], device)
    with plain_attention():
        plain = teacher_forced(cfg, params, prompts, seq[:, :1], device)
    diff = (kern[0] - plain[0]).abs().max().item()
    if not (torch.isfinite(kern[0]).all()
            and torch.allclose(kern[0], plain[0], **LM_TOL)):
        fail(f"reduced prefill logits, kernel vs plain version: max |diff| "
             f"{diff} beyond {LM_TOL}")
    print(f"reduced session {cfg.name} (heads {cfg.n_heads}, head_dim "
          f"{cfg.head_dim}) on {device}: {B} x {T} prompt tokens, {N} new "
          f"each; flash launches: CUDA-core {launches}, sm90 0; prefill "
          f"logits kernel vs plain max |diff| {diff:.3e}")
    return launches


#: phase 19: the configurations of local attention, qk-norm and RG-LRU
#: at full width, served on seed-made bf16 weights with every launch
#: count set to 0 just before and read just after; glm4-9b and qwen3-14b
#: cut to 4 of their 40 layers (``n_layers``), the rest at full depth.
#: recurrentgemma-2b's prompt (4096) is longer than its window (2048): the
#: 2048-slot ring wraps in prefill and in decode.
PHASE19 = (
    dict(arch="qwen3-4b", batch=4, prompt_len=1000, max_new=32, seed=0,
         params=4_411_424_256),
    dict(arch="recurrentgemma-2b", batch=4, prompt_len=4096, max_new=32,
         seed=0, params=2_894_435_840),
    dict(arch="glm4-9b", batch=4, prompt_len=1000, max_new=32, seed=0,
         n_layers=4),
    dict(arch="qwen3-14b", batch=4, prompt_len=1000, max_new=32, seed=0,
         n_layers=4),
)


def n_attention(cfg) -> int:
    """The config's attention layers (kinds ``attn``, ``local_attn`` and
    ``moe``): one prefill flash call each."""
    from repro_torch.models import blocks as PB
    return sum(kind in PB.ATTN_KINDS for kind in cfg.pattern_layers())


@contextlib.contextmanager
def moe_kept(record: list):
    """Inside: every GShard dispatch appends
    ``(kept, placed)``: the (token, choice) pairs that found a slot (a
    device tensor) and all of them (their difference is the pairs dropped
    by capacity)."""
    from repro_torch.models import blocks as PB
    masks = PB.gshard_masks

    def counted(expert_idx, gate_vals, E, C, dtype):
        dispatch, combine = masks(expert_idx, gate_vals, E, C, dtype)
        record.append((dispatch.float().sum(), expert_idx.numel()))
        return dispatch, combine

    PB.gshard_masks = counted
    try:
        yield
    finally:
        PB.gshard_masks = masks


@contextlib.contextmanager
def moe_routing(record: list, flips: list | None = None):
    """Inside: the MoE router's top-k expert choices of every call are
    appended to ``record`` or, with ``flips``, replayed from it: each call
    takes the recorded choices, with gates from its own probabilities at
    them, and appends to ``flips`` how many choices its own top-k would
    have changed (a device count).  Routing is discrete: one rounding step
    of attention upstream can flip a near-tied choice, so the plain run of
    a kernel-vs-plain comparison replays the kernel run's routing."""
    from repro_torch.models import blocks as PB
    route = PB._route
    calls = iter(record)

    def pinned(cfg, p, x):
        probs, gates, idx = route(cfg, p, x)
        if flips is None:
            record.append(idx)
            return probs, gates, idx
        want = next(calls)
        flips.append((idx != want).sum())
        g = probs.gather(-1, want)
        return probs, g / g.sum(-1, keepdim=True), want

    PB._route = pinned
    try:
        yield
    finally:
        PB._route = route


def cache_bytes(cache) -> int:
    """The bytes of a decode cache's tensors (every layer's state)."""
    return sum(t.numel() * t.element_size() for st in cache for t in st)


def family_session(run: dict, device, phase: str = "19") -> dict:
    """One session of phase 19 or 20: ``serve_batch`` at full width with
    every flash launch count set to 0 just before and read just after (one
    launch per attention layer, kinds ``attn``/``local_attn``/``moe``, on
    the route of the config's head dim, no other); then the
    teacher-forced run again with every prefill attention call held
    against the kernel's plain version on the same inputs within
    ``LM_TOL``, and the whole model's prefill and decode logits, kernel vs
    plain version, within ``FIXTURE_TOL``: a bf16 rounding step apart in
    each attention layer (the kernel rounds P to bf16), amplified through
    26-48 random-weight layers, moves logits of magnitude ~5 (qwen3's
    untied unembedding) by up to 0.1, beyond an absolute 2e-2 (PERF.md
    §6); the greedy tokens equal the plain run's argmax except at a near
    tie (a top-two margin within twice that position's logit
    difference).  A config without attention (xLSTM) has no plain
    version to compare: its greedy tokens are held to its own
    teacher-forced argmax.  An MoE session's plain run replays the
    kernel run's expert choices (:func:`moe_routing`: a one-ulp change
    upstream flips near-tied choices, and a flipped choice moves logits
    by whole units) and prints how many its own routing would flip, and
    the (token, choice) pairs dropped by capacity per layer in prefill;
    an int8-cache session
    (``kv_quant``) checks its cache's bytes under 0.6 of the bf16 cache's
    and prints its decode logits' distance from a bf16-cache run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import init_params
    from repro_torch.serve.step import serve_batch
    cfg = get_arch(run["arch"])
    if run.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=run["n_layers"])
    if run.get("kv_quant"):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    t0 = time.perf_counter()
    params = init_params(cfg, run["seed"], device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    want_params = run.get("params", cfg.param_count())
    if n_params != want_params or cfg.param_count() != want_params:
        fail(f"{cfg.name}: {n_params} parameters, want {want_params}")
    rng = np.random.default_rng(run["seed"])
    B, T, N = run["batch"], run["prompt_len"], run["max_new"]
    K = (cfg.n_codebooks,) if cfg.frontend == "audio_stub" else ()
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, T) + K),
                              dtype=torch.int32, device=device)
    serve_batch(cfg, params, prompts[:, :64], 2, device=device)   # warm-up

    torch.cuda.reset_peak_memory_stats(device)
    timings: dict = {}
    reset_flash_counts(FA)
    kept: list = []
    with moe_kept(kept):
        toks, first = serve_batch(cfg, params, prompts, N, device=device,
                                  timings=timings)
    counts = dict(zip(FLASH_ROUTES, flash_counts(FA)))
    route = FA.counter(torch.bfloat16, cfg.head_dim)
    n_attn = n_attention(cfg)
    want = {r: n_attn if r == route else 0 for r in FLASH_ROUTES}
    if counts != want:
        fail(f"{cfg.name} session launched the flash kernels {counts}, "
             f"want {want}")
    peak = torch.cuda.max_memory_allocated(device)
    seq = torch.cat([first[:, None], toks], 1)
    if seq.shape != (B, N + 1) + K or int(seq.min()) < 0 \
            or int(seq.max()) >= cfg.vocab:
        fail(f"{cfg.name} session tokens out of range: {tuple(seq.shape)}")
    n_moe = sum(kind == "moe" for kind in cfg.pattern_layers())
    dropped = [int(placed - float(k)) for k, placed in kept[:n_moe]]
    calls, caches, routes, flips = [], [], [], []
    with each_call_against_plain(calls), moe_routing(routes):
        kern = teacher_forced(cfg, params, prompts, seq[:, :N], device,
                              cache_out=caches)
    if not all(bool(torch.isfinite(x).all()) for x in kern):
        fail(f"{cfg.name} session: non-finite logits")
    if len(calls) != n_attn or not all(ok for _, ok in calls):
        fail(f"{cfg.name}: prefill attention calls, kernel vs plain "
             f"version on the same inputs: {calls}, want {n_attn} within "
             f"{LM_TOL}")
    kl = torch.stack(kern, 1)                        # (B, N+1[, K], V)
    if n_attn:
        with plain_attention(), moe_routing(routes, flips):
            plain = teacher_forced(cfg, params, prompts, seq[:, :N], device)
        if flash_counts(FA) != tuple(2 * want[r] for r in FLASH_ROUTES):
            fail(f"{cfg.name}: the plain-version prefill launched a kernel")
        pl = torch.stack(plain, 1)
        del plain
    else:
        pl = kl
    pre_diff = (kl[:, 0] - pl[:, 0]).abs().max().item()
    if not torch.allclose(kl, pl, **FIXTURE_TOL):
        fail(f"{cfg.name} logits, kernel vs plain version: max |diff| "
             f"{(kl - pl).abs().max().item()} beyond {FIXTURE_TOL}")
    dec_diff = (kl[:, 1:] - pl[:, 1:]).abs().max().item()
    checked = margins(pl) > 2 * (kl - pl).abs().amax(-1)
    same = pl.argmax(-1) == seq
    if not bool(same[checked].all()):
        fail(f"{cfg.name} greedy tokens differ between kernel and plain "
             "version away from a near tie")
    extra = ""
    if cfg.kv_quant:
        bf16 = dataclasses.replace(cfg, kv_quant=False)
        bcache = []
        ref = teacher_forced(bf16, params, prompts, seq[:, :N], device,
                             cache_out=bcache)
        ratio = cache_bytes(caches[0]) / cache_bytes(bcache[0])
        if not ratio < 0.6:
            fail(f"{cfg.name}: the int8 cache takes {ratio:.3f} of the "
                 "bf16 cache's bytes, want < 0.6")
        q_diff = max((a - b).abs().max().item()
                     for a, b in zip(kern[1:], ref[1:]))
        extra = (f"; int8 cache {cache_bytes(caches[0]) / 2**20:.2f} MiB = "
                 f"{ratio:.4f} of the bf16 cache's; teacher-forced decode "
                 f"logits int8 vs bf16 cache max |diff| {q_diff:.3e}")
        del ref, bcache
    if n_moe:
        n_flips = [int(f) for f in flips]
        pairs = sum(int(r.numel()) for r in routes)
        extra += (f"; (token, choice) pairs dropped by capacity in prefill, "
                  f"per moe layer: {dropped} of {kept[0][1]}; the plain "
                  f"run's own routing would flip {sum(n_flips)} of {pairs} "
                  f"choices ({sum(n_flips[:n_moe])} in prefill; replayed "
                  "from the kernel run)")
    pre, dec = timings["prefill_s"], timings["decode_s"]
    full = get_arch(run["arch"])
    cut = (f", cut to {cfg.n_layers} of {full.n_layers} layers"
           if run.get("n_layers") else "")
    cut += " with the int8 KV cache" if cfg.kv_quant else ""
    tok = "frames" if K else "tokens"
    print(f"phase {phase} {cfg.name}{cut} on {device}: {n_params:,} bf16 "
          f"parameters (init {init_s:.2f} s), {B} requests x {T} prompt "
          f"{tok}, {N} new each; prefill {pre * 1e3:.2f} ms "
          f"({B * T / pre:.0f} prompt {tok}/s); decode {dec * 1e3:.2f} ms = "
          f"{dec * 1e3 / N:.3f} ms per step ({B * N / dec:.1f} {tok}/s); "
          f"peak memory {peak / 2**30:.2f} GiB; flash launches {counts}"
          f"{extra}")
    if n_attn:
        print(f"  kernel vs plain version: {n_attn} prefill attention calls "
              f"on the same inputs within {LM_TOL} (max |diff| "
              f"{max(d for d, _ in calls):.3e}); through the model: prefill "
              f"logits max |diff| {pre_diff:.3e} (max |logit| "
              f"{pl[:, 0].abs().max().item():.3f}; within {LM_TOL}: "
              f"{torch.allclose(kl[:, 0], pl[:, 0], **LM_TOL)}), "
              f"teacher-forced decode logits max |diff| {dec_diff:.3e}; "
              f"greedy tokens equal at {int(checked.sum())} of "
              f"{checked.numel()} positions away from a near tie "
              f"({int(same.sum())} equal in all)")
    else:
        print(f"  no attention layer: greedy tokens equal the "
              f"teacher-forced argmax at {int(same.sum())} of "
              f"{same.numel()} positions ({int(checked.sum())} away from a "
              "tie)")
    del params, kern, kl, pl, caches
    torch.cuda.empty_cache()
    return dict(counts=counts, prefill_ms=pre * 1e3, decode_ms=dec * 1e3 / N)


def families_fixture_run(device, fixture: str = "LM_FAMILIES_FIXTURE",
                         entries: str = "LM_FAMILIES",
                         phase: str = "19") -> dict:
    """The reduced configs of a families fixture (``tests/torch_parity``'s
    ``fixture`` and ``entries``: phase 19's qwen3-4b, qwen3-14b, glm4-9b
    and recurrentgemma-2b, or phase 20's MoE, vision, audio, xLSTM and
    int8-cache entries; the JAX package's weights, prompts, tokens and
    logits) served on the card: logits within ``FIXTURE_TOL`` and greedy
    tokens as phase 7 checks them, and a vision entry's ``vis_embeds``
    forward within ``FIXTURE_TOL``; returns the flash launch counts of
    their ``serve_batch`` runs (reset just before each)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.serve.step import serve_batch
    tp = parity()
    z = np.load(getattr(tp, fixture))
    total = dict.fromkeys(FLASH_ROUTES, 0)
    for name in getattr(tp, entries):
        cfg, params, arrs = tp.load_lm_family(z, name, device)
        prompts = torch.as_tensor(arrs["prompts"], device=device)
        n = arrs["tokens"].shape[1]
        reset_flash_counts(FA)
        toks, first = serve_batch(cfg, params, prompts, n, device=device)
        counts = dict(zip(FLASH_ROUTES, flash_counts(FA)))
        n_attn = n_attention(cfg)
        route = FA.counter(torch.bfloat16, cfg.head_dim)
        if counts != {r: n_attn if r == route else 0 for r in FLASH_ROUTES}:
            fail(f"fixture {name}: flash launches {counts}, want {n_attn} "
                 f"on {route}")
        r = greedy_check(cfg, params, prompts, first, toks, arrs, device)
        vis = ""
        if "vis_embeds" in arrs:
            B, T = prompts.shape[:2]
            x, _ = M.forward(cfg, params, M.Batch(
                tokens=prompts, positions=text_positions(cfg, B, T, 0,
                                                         device),
                vis_embeds=torch.as_tensor(arrs["vis_embeds"],
                                           device=device).bfloat16()))
            lg = (x.float() @ M._unembed(cfg, params).float()).cpu().numpy()
            d = float(np.abs(lg - arrs["vis_logits"]).max())
            if not np.allclose(lg, arrs["vis_logits"], **FIXTURE_TOL):
                fail(f"fixture {name}: the vis_embeds forward's logits "
                     f"differ from the reference's by {d}")
            vis = f"; vis_embeds forward max |diff| {d:.3e}"
        print(f"phase {phase} fixture {name} on {device}: prefill + "
              f"teacher-forced decode logits within {FIXTURE_TOL} of the JAX "
              f"package's (max |diff| {r['diff']:.3e}){vis}; greedy tokens "
              f"{r['compared']} compared, {r['flips']} near-tie flips, whole "
              f"sequences equal: {r['equal']}; flash launches {counts}")
        for k, c in counts.items():
            total[k] += c
    return total


def families_phase(device) -> dict:
    """Phase 19: the reduced families against the JAX package's fixture,
    then each full-width session; returns the launches by route."""
    total = families_fixture_run(device)
    for run in PHASE19:
        for k, c in family_session(run, device)["counts"].items():
            total[k] += c
    return total


#: phase 20: MoE, M-RoPE with the vision stub, the audio stub, xLSTM and
#: the int8 KV cache at full width, served on seed-made bf16 weights with
#: every launch count set to 0 just before and read just after.
#: phi3.5-moe cut to 4 of 32 layers and qwen2-vl-72b to 4 of 80 (each
#: fits one card whole only beside no activations or not at all);
#: llama4-maverick to 2 of 48 (one (attn, moe) group: 34.8 GiB of weights,
#: and ``init_params`` draws a (128, 5120, 8192) expert leaf in fp32
#: first, 20 GiB more); the rest at full depth.  The MoE prompts are 1024
#: tokens so that the grouped dispatch routes in groups of 256
#: (``MOE_GROUP_SIZE``); musicgen's are 1500 frames of 4 codebooks (30 s
#: of EnCodec's 50-Hz frames); llama3.2-1b with the int8 KV cache serves
#: phase 9's shape.
PHASE20 = (
    dict(arch="phi3.5-moe-42b-a6.6b", batch=4, prompt_len=1024, max_new=32,
         seed=0, n_layers=4),
    dict(arch="llama4-maverick-400b-a17b", batch=4, prompt_len=1024,
         max_new=32, seed=0, n_layers=2),
    dict(arch="qwen2-vl-72b", batch=4, prompt_len=1024, max_new=32, seed=0,
         n_layers=4),
    dict(arch="musicgen-medium", batch=4, prompt_len=1500, max_new=32,
         seed=0, params=1_837_254_144),
    dict(arch="xlstm-350m", batch=4, prompt_len=1024, max_new=32, seed=0,
         params=241_558_528),
    dict(arch="llama3.2-1b", batch=4, prompt_len=1000, max_new=32, seed=0,
         kv_quant=True, params=1_235_814_400),
)


def new_families_phase(device) -> dict:
    """Phase 20: the reduced MoE, vision, audio, xLSTM and int8-cache
    entries against the JAX package's fixture, then each full-width
    session; returns the launches by route."""
    total = families_fixture_run(device, "LM_FAMILIES_B_FIXTURE",
                                 "LM_FAMILIES_B", "20")
    for run in PHASE20:
        for k, c in family_session(run, device, "20")["counts"].items():
            total[k] += c
    return total


# ---------------------------------------------------------------------------
# Phase 21: training
# ---------------------------------------------------------------------------

#: llama3.2-1b's training shape in phase 21 (B, T, Hq, Hkv, D), causal,
#: and recurrentgemma-2b's with its window: the backward kernels' timed
#: shapes
TRAIN_SHAPE = (4, 1024, 32, 8, 64)
RG_TRAIN_SHAPE = (1, 4096, 10, 1, 256)
#: phase 21's full-width runs: llama3.2-1b and recurrentgemma-2b on seed-0
#: weights, batch x seq, this many make_train_step steps with the default
#: AdamWConfig
TRAIN = dict(arch="llama3.2-1b", params=1_235_814_400, batch=4, seq=1024,
             steps=3, seed=0)
RG_TRAIN = dict(arch="recurrentgemma-2b", params=2_894_435_840, batch=1,
                seq=4096, steps=3, seed=0)
#: step 1 with the kernels against step 1 with plain attention (forward
#: and autograd backward): loss atol, grad_norm relative, each leaf's
#: gradient cosine at least
TRAIN_TOL = dict(loss=2e-2, grad_norm=2e-2, cosine=0.99)
#: ``train_small_lm``'s run in phase 21 (e), cut from its default 300
#: steps to hold the smoke's time (its host-bound steps are most of the
#: phase): this many steps, then the run's checkpoint at the resume step
#: (the example writes one every 100) restored and the steps after it run
#: again
EXAMPLE_STEPS = 120
EXAMPLE_RESUME_STEP = 100
#: its sequence length (the example's default): one loss-head chunk a step
EXAMPLE_SEQ = 256
#: a backward kernel against ``attention_backward_plain`` on the same
#: tensors, each of dQ, dK and dV: max |diff| within ``max_rel`` x max
#: |plain| and the relative L2 error within ``l2``.  bf16: one bf16
#: rounding of each side is about 2e-3 in relative L2, a dQ off by half
#: 0.5.  fp32 (the CUDA cores' fp32 FMAs, no rounding to a narrower type):
#: the same products summed in another order, ~1e-6
BWD_TOL = {"bfloat16": dict(max_rel=2e-2, l2=1e-2),
           "float32": dict(max_rel=1e-4, l2=1e-4)}
#: the forward kernels' lse against ``attention_plain``'s (log2 units):
#: the same fp32 sums in another order and ``ex2.approx``
LSE_TOL = 1e-3
#: the backward launch counts: the CUDA-core kernel's, the sm90 kernel's
BWD_ROUTES = ("cuda_core", "sm90")


def bwd_counts(FA) -> tuple:
    """The backward kernels' launch counts, in ``BWD_ROUTES`` order."""
    return (FA.bwd_launch_count, FA.bwd_sm90_launch_count)


def reset_bwd_counts(FA):
    FA.bwd_launch_count = FA.bwd_sm90_launch_count = 0


def reset_head_counts(LH):
    LH.fwd_launch_count = LH.bwd_launch_count = 0


def head_launches(cfg, seq: int, steps: int = 1) -> int:
    """Each loss-head kernel's launches (``xent_fwd``, ``xent_bwd``) in
    ``steps`` bf16 training steps of ``cfg`` at ``seq`` positions: one a
    512-position chunk of ``logits_and_loss`` and codebook."""
    chunks = -(-seq // min(512, seq))
    books = cfg.n_codebooks if cfg.frontend == "audio_stub" else 1
    return steps * chunks * books


def check_head_counts(LH, what: str, want: int) -> int:
    """Fails unless each loss-head kernel launched ``want`` times since the
    last :func:`reset_head_counts`; returns ``want``."""
    got = (LH.fwd_launch_count, LH.bwd_launch_count)
    if got != (want, want):
        fail(f"{what}: loss-head launches (xent_fwd, xent_bwd) {got}, want "
             f"{want} each")
    return want


def bwd_call(FA, q, k, v, o, do, lse, causal: bool, head_axis: int,
             window=None):
    """One backward kernel call on the card, counted once on the counter
    of the route :func:`route` gives and nowhere else."""
    import torch
    kind = FA.route(q.dtype, q.shape[-1])
    before = (*flash_counts(FA), *bwd_counts(FA))
    got = FA.attention_backward_cuda(q, k, v, o, do, lse, causal=causal,
                                     sm_scale=q.shape[-1] ** -0.5,
                                     head_axis=head_axis, window=window)
    torch.cuda.synchronize()
    after = (*flash_counts(FA), *bwd_counts(FA))
    want = (0, 0, 0, *(int(r == kind) for r in BWD_ROUTES))
    if tuple(b - a for a, b in zip(before, after)) != want:
        fail(f"flash backward {kind} call counted launches {before} -> "
             f"{after}")
    return got


def bwd_errors(got, want) -> tuple:
    """One gradient tensor against its plain version: ``(max |got -
    want|, that over max |want|, relative L2 error)``."""
    g, w = got.float(), want.float()
    d = (g - w).abs().max().item()
    return (d, d / max(w.abs().max().item(), 1e-30),
            (g - w).norm().item() / max(w.norm().item(), 1e-30))


def bwd_within(errs: tuple, dtype: str = "bfloat16") -> bool:
    tol = BWD_TOL[dtype]
    return errs[1] <= tol["max_rel"] and errs[2] <= tol["l2"]


#: the CUDA-core backward's tile edges (32-row bf16 and 64-row fp32 own
#: tiles, 64-row other tiles, 32 at fp32 D 128): T, and (causal, window)
#: pairs.  A window of 1 under the causal mask leaves each row its own key
#: alone, so dQ = dK = 0 exactly and a bound relative to max |plain| would
#: compare rounding noise: window 1 runs without the causal mask (row r
#: sees cols c >= r)
EDGE_T = (31, 32, 33, 63, 65, 257)
EDGE_MASKS = ((True, None), (False, 1), (True, 31), (False, 33), (True, 33),
              (False, None))


def bwd_cases() -> list:
    """Phase 21 (a)'s cases ``(dtype, D, causal, window, T, rep, Hkv,
    layout)``: bf16 at D 16-128 (Hkv 2) over every combination of causal,
    window, T and rep; bf16 at D 256 with MQA (rep 5 and 10 on one kv head,
    window 64 and 2048, T past the window); fp32 at D 16-128 on a subset
    of T, rep and layout; and the CUDA-core route's tile edges, bf16 D
    16/32 and fp32 D 16-128: every ``EDGE_T`` with every ``EDGE_MASKS``
    pair, rep 1, 2 and 5 (5 on one kv head) and both layouts in turn."""
    import itertools
    cases = [("bfloat16", D, c, w, T, rep, 2, lay)
             for D, c, w, T, rep, lay in itertools.product(
                 (16, 32, 64, 128), (True, False), (None, 64, 2048),
                 (100, 300), (1, 4, 5), (1, 2))]
    cases += [("bfloat16", 256, c, w, T, rep, 1, lay)
              for c, w, (T, rep, lay) in itertools.product(
                  (True, False), (None, 64, 2048),
                  ((100, 5, 2), (300, 10, 1), (300, 5, 1), (2200, 10, 2)))]
    cases += [("float32", D, c, w, T, rep, 2, lay)
              for D, c, w, (T, rep, lay) in itertools.product(
                  (16, 32, 64, 128), (True, False), (None, 64),
                  ((100, 1, 2), (300, 4, 1), (300, 5, 2)))]
    for dt, Ds in (("bfloat16", (16, 32)), ("float32", (16, 32, 64, 128))):
        for D in Ds:
            for (t, T), (m, (c, w)) in itertools.product(
                    enumerate(EDGE_T), enumerate(EDGE_MASKS)):
                rep = (1, 2, 5)[(t + m) % 3]
                cases.append((dt, D, c, w, T, rep, 1 if rep == 5 else 2,
                              (1, 2)[(t + m // 2) % 2]))
    return cases


def train_kernel_phase(device) -> dict:
    """Phase 21 (a): both backward kernels against
    ``attention_backward_plain`` on the same CUDA tensors (``bwd_cases``:
    the forward's o and lse from ``attention_plain``): dQ, dK, dV within
    ``BWD_TOL`` of their dtype, each call counted once on its route's
    counter; two runs of a case bit-equal; the forward kernel's lse of
    each case within ``LSE_TOL`` of the plain one; and what is still
    refused raises ``ValueError``: fp32 at D 256, Tq != Tk, rows off 16
    bytes on the CUDA-core route, a base off 16 bytes on the sm90 route.
    Returns the largest max |diff| by route."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=device).manual_seed(21)
    t = lambda x: x.transpose(1, 2)
    worst, lse_worst, n = {}, 0.0, {}
    for dt, D, causal, window, T, rep, Hkv, layout in bwd_cases():
        dtype = getattr(torch, dt)
        q, k, v, do = ((torch.randn(2, T, h, D, generator=gen,
                                    device=device) * 0.5).to(dtype)
                       for h in (Hkv * rep, Hkv, Hkv, Hkv * rep))
        if layout == 1:
            q, k, v, do = (t(x).contiguous() for x in (q, k, v, do))
        tl = (lambda x: x) if layout == 1 else t
        o, lse = FA.attention_plain(tl(q), tl(k), tl(v), causal=causal,
                                    sm_scale=D ** -0.5, window=window,
                                    return_lse=True)
        o = tl(o)
        _, lse_k = FA.attention_cuda(q, k, v, causal=causal,
                                     sm_scale=D ** -0.5, head_axis=layout,
                                     window=window, return_lse=True)
        lse_d = (lse_k - lse).abs().max().item()
        if not lse_d <= LSE_TOL:
            fail(f"flash forward lse != plain ({dt}, D {D}, causal {causal}, "
                 f"window {window}, T {T}, rep {rep}): max |diff| {lse_d}")
        lse_worst = max(lse_worst, lse_d)
        want = FA.attention_backward_plain(q, k, v, o, do, lse,
                                           causal=causal, sm_scale=D ** -0.5,
                                           window=window, head_axis=layout)
        got = bwd_call(FA, q, k, v, o, do, lse, causal, layout, window)
        again = bwd_call(FA, q, k, v, o, do, lse, causal, layout, window)
        kind = FA.route(dtype, D)
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
            errs = bwd_errors(g, w)
            if not bwd_within(errs, dt) or g.dtype != dtype:
                fail(f"flash backward {kind} kernel != plain version "
                     f"({name}, {dt}, D {D}, causal {causal}, window "
                     f"{window}, T {T}, rep {rep}, Hkv {Hkv}, layout "
                     f"{layout}): max |diff| {errs[0]}, over max |plain| "
                     f"{errs[1]}, relative L2 {errs[2]}; tolerance "
                     f"{BWD_TOL[dt]}")
            if not torch.equal(g, a):
                fail(f"flash backward {kind} kernel: two runs differ "
                     f"({name}, {dt}, D {D}, causal {causal}, window "
                     f"{window}, T {T})")
            key = (dt, D)
            worst[key] = tuple(map(max, worst.get(key, (0.0,) * 3), errs))
        n[kind] = n.get(kind, 0) + 1
    refused = []
    z = lambda *shape, dtype=torch.bfloat16: torch.zeros(
        *shape, dtype=dtype, device=device)
    lse0 = z(1, 2, 64, dtype=torch.float32)
    x32 = z(1, 64, 2, 256, dtype=torch.float32)
    xb, yb = z(1, 64, 2, 64), z(1, 65, 2, 64)
    odd32 = z(1, 64, 2, 33)[..., 1:]
    odd64 = z(1, 64, 2, 65)[..., 1:]
    for what, args in (("fp32 at D 256", (x32,) * 5),
                       ("Tq != Tk", (xb, yb, yb, xb, xb)),
                       ("cuda_core rows off 16 bytes",
                        (z(1, 64, 2, 32), odd32) + (z(1, 64, 2, 32),) * 3),
                       ("sm90 base off 16 bytes", (xb, odd64, xb, xb, xb))):
        before = bwd_counts(FA)
        try:
            FA.attention_backward_cuda(*args, lse0, causal=True,
                                       sm_scale=0.1, head_axis=2)
        except ValueError:
            if bwd_counts(FA) != before:
                fail(f"flash backward: a refused call ({what}) counted")
            refused.append(what)
            continue
        fail(f"flash backward on the card took {what}")
    show = lambda e: f"({e[0]:.3e}, {e[1]:.3e}, {e[2]:.3e})"
    print(f"flash backward kernels vs plain version: {n.get('sm90', 0)} "
          f"sm90 and {n.get('cuda_core', 0)} cuda_core cases (each run "
          "twice, bit-equal), each call counted once on its route; worst of "
          "dQ, dK, dV (max |diff|, over max |plain|, relative L2): "
          + ", ".join(f"{dt} D {D} {show(e)}"
                      for (dt, D), e in sorted(worst.items()))
          + f" (tolerances {BWD_TOL}); forward lse vs plain max |diff| "
          f"{lse_worst:.3e} (bound {LSE_TOL}); refused with ValueError: "
          + ", ".join(refused))
    return {kind: max(e[0] for (dt, D), e in worst.items()
                      if FA.route(getattr(torch, dt), D) == kind)
            for kind in BWD_ROUTES}


def bwd_timing(device, shape, dtype: str = "bfloat16", window=None) -> dict:
    """Phase 21 (b): a backward kernel at ``shape`` (B, T, Hq, Hkv, D),
    causal (and ``window``) in the model's layout: device time per call
    (``queued_ms``) and back to back (CUDA events), against the plain
    backward and the backward of ``scaled_dot_product_attention`` on the
    same tensors (the library call, never on a path; under a window once
    with the band as a boolean mask and once causal without one, the most
    a band could save; "refused" where no SDPA backend takes the case),
    and the bound: 5 products (``2 D`` operations per visible (q, k) pair
    each) of every (batch, q head) at 989 TFLOP/s in bf16 or 67 TFLOP/s in
    fp32 (CUDA cores), against q, k, v, o, dO read and dq, dk, dv written
    once at 3.35 TB/s (the 7 products the backward's dQ and dK/dV work
    computes, S and dP recomputed on each side, printed beside it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    B, T, Hq, Hkv, D = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(22)
    q, k, v, do = (torch.randn(B, T, h, D, generator=gen, device=device)
                   .to(dt) for h in (Hq, Hkv, Hkv, Hq))
    o, lse = FA.attention_cuda(q, k, v, causal=True, sm_scale=D ** -0.5,
                               head_axis=2, window=window, return_lse=True)
    kw = dict(causal=True, sm_scale=D ** -0.5, head_axis=2, window=window)
    kern = lambda: FA.attention_backward_cuda(q, k, v, o, do, lse, **kw)
    plain = lambda: FA.attention_backward_plain(q, k, v, o, do, lse, **kw)
    got, want = kern(), plain()
    errs = [bwd_errors(g, w) for g, w in zip(got, want)]
    if not all(bwd_within(e, dtype) for e in errs):
        fail(f"flash backward at {shape} {dtype} window {window}: (max "
             f"|diff|, over max |plain|, relative L2) of dQ, dK, dV {errs} "
             f"beyond {BWD_TOL[dtype]}")
    del got
    t = lambda x: x.transpose(1, 2)
    qh, kh, vh = (t(x).contiguous().requires_grad_(True) for x in (q, k, v))
    doh = t(do).contiguous()
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"

    def sdpa_time(**sk):
        try:
            out = F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True,
                                                 **sk)
            fn = lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                             retain_graph=True)
            errs = [bwd_errors(g, t(w)) for g, w in zip(fn(), want)]
            # autograd's host time per call is long: a longer sleep
            return (cuda_ms(fn, 10), queued_ms(fn, sleep_cycles=100_000_000),
                    errs)
        except RuntimeError as e:
            return None, None, str(e).splitlines()[0][:80]

    kern_ms = cuda_ms(kern, 20)
    kern_q = queued_ms(kern)
    plain_ms = cuda_ms(plain, 2)
    if window is None:
        sdpa = {"causal": sdpa_time(is_causal=True)}
    else:
        rows = torch.arange(T, device=device)[:, None]
        cols = torch.arange(T, device=device)[None, :]
        band = (rows >= cols) & (rows - cols < window)
        sdpa = {"band mask": sdpa_time(attn_mask=band),
                "causal, no mask": sdpa_time(is_causal=True)}
    del want
    kern_ms2 = cuda_ms(kern, 20)
    pairs = visible_pairs(T, T, True, window)
    flops = 5 * 2 * D * B * Hq * pairs
    nbytes = q.element_size() * (4 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel())
    rate = BF16_TENSOR_OPS_PER_S if dtype == "bfloat16" else \
        CUDA_CORE_OPS_PER_S
    ops_ms = flops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    show = lambda es: ", ".join(f"({e[0]:.3e}, {e[1]:.3e}, {e[2]:.3e})"
                                for e in es)
    sdpa_txt = "; ".join(
        f"SDPA's backward ({k}) " + (f"refused ({r[2]})" if r[0] is None else
                                     f"{r[0]:.4f} ms back to back, device "
                                     f"{fmt(r[1])} queued, vs plain "
                                     f"{show(r[2])}")
        for k, r in sdpa.items())
    print(f"flash backward {FA.route(dt, D)} at (B, T, Hq, Hkv, D) = {shape} "
          f"{dtype} causal, window {window}: dQ, dK, dV (max |diff|, over "
          f"max |plain|, relative L2) vs plain {show(errs)}; kernel "
          f"{kern_ms:.4f} / {kern_ms2:.4f} ms back to back (CUDA events, "
          f"before / after SDPA), device {fmt(kern_q)} queued; plain "
          f"{plain_ms:.4f} ms; {sdpa_txt}; bound "
          f"{max(ops_ms, bytes_ms):.6f} ms ({pairs:,} (q, k) pairs per "
          f"head: 5 products {flops / 1e9:.2f} GFLOP at "
          f"{rate / 1e12:.0f} TFLOP/s: {ops_ms:.6f} ms, the 7 of the "
          f"dQ and dK/dV sides {ops_ms * 7 / 5:.6f} ms; {nbytes / 1e6:.2f} MB "
          f"at 3.35 TB/s: {bytes_ms:.6f} ms)")
    first = next(iter(sdpa.values()))
    return dict(max_err=max(e[0] for e in errs), ms=kern_ms, queued_ms=kern_q,
                plain_ms=plain_ms, library_ms=first[0],
                library_queued_ms=first[1], bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def train_launches(cfg) -> tuple:
    """The flash launches one training step of ``cfg`` makes: ``(forward
    launches, backward launches)``; an attention layer of a repeated
    group runs its forward twice (remat), a remainder layer once."""
    from repro_torch.models import blocks as PB
    n_grouped = cfg.n_groups() * len(cfg.block_pattern)
    kinds = cfg.pattern_layers()
    attn = [i for i, kind in enumerate(kinds) if kind in PB.ATTN_KINDS]
    return sum(2 if i < n_grouped else 1 for i in attn), len(attn)


@contextlib.contextmanager
def plain_backward():
    """Inside: the attention gradient on the card is
    ``attention_backward_plain`` on the same CUDA tensors, the forward
    kernels untouched (phase 21 (c)'s comparison only; counts nothing)."""
    from repro_torch.kernels import flash_attention as FA
    kernel = FA.attention_backward_cuda
    FA.attention_backward_cuda = FA.attention_backward_plain
    try:
        yield
    finally:
        FA.attention_backward_cuda = kernel


def train_fixture_run(device) -> tuple:
    """Phase 21 (c): one training step of each reduced config of
    ``tests/torch_lm_train.npz`` on the card with the kernels: the flash
    launches of the step (counts reset just before) as
    :func:`train_launches` says, on the CUDA-core route (head dim 32)
    forward and backward;
    the step against the same step with ``attention_backward_plain`` in
    the backward kernel's place at ``torch_parity.BWD_STEP_TOL`` (the
    kernel's effect
    on the model, apart from any other rounding); and the step against
    the JAX package's (``torch_parity.check_lm_train``) at
    ``LM_TRAIN_CARD_TOL``, the CPU tests' tolerances widened where the
    card's other rounding moves the gradient.  Then the fp32 gradient of
    ``torch_parity.LM_TRAIN_FP32_ARCHS`` (reduced llama3.2-1b and
    recurrentgemma-2b) on the card, every attention layer on the fp32
    CUDA-core kernels forward and backward, held to the JAX package's fp32
    gradient in the fixture at ``LM_TRAIN_FP32_CARD_TOL`` and to the same
    card gradient with plain attention at ``LM_TRAIN_FP32_STEP_TOL``.  Each
    bf16 step launches each loss-head kernel once a chunk and codebook
    (:func:`head_launches`), the fp32 gradients none.  Returns the
    backward launches and each loss-head kernel's."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import loss_head as LH
    tp = parity()
    z = np.load(tp.LM_TRAIN_FIXTURE)
    total = head = 0

    def launches(what, cfg, dtype):
        fwd, bwd = train_launches(cfg)
        route = FA.counter(dtype, cfg.head_dim)
        counts = dict(zip(FLASH_ROUTES, flash_counts(FA)))
        bwds = dict(zip(BWD_ROUTES, bwd_counts(FA)))
        if counts != {r: fwd if r == route else 0 for r in FLASH_ROUTES} \
                or bwds != {r: bwd if r == route else 0 for r in BWD_ROUTES}:
            fail(f"phase 21 fixture {what}: flash launches {counts}, "
                 f"backward {bwds}; want {fwd} forward and {bwd} backward "
                 f"on {route}")
        return counts, bwd

    for arch in tp.LM_TRAIN_ARCHS:
        reset_flash_counts(FA)
        reset_bwd_counts(FA)
        reset_head_counts(LH)
        res = tp.lm_train_step(z, arch, device)
        torch.cuda.synchronize()
        counts, bwd = launches(arch, res[0], torch.bfloat16)
        total += bwd
        heads = check_head_counts(LH, f"phase 21 fixture {arch}",
                                  head_launches(res[0],
                                                res[-1]["labels"].shape[1]))
        head += heads
        with plain_backward():
            plain = tp.lm_train_step(z, arch, device)
        torch.cuda.synchronize()
        if sum(bwd_counts(FA)) != bwd:
            fail(f"phase 21 fixture {arch}: the plain-backward step "
                 "launched a backward kernel")
        vs_plain = tp.step_vs_plain_backward(res, plain)
        if not all(vs_plain[k] <= tp.BWD_STEP_TOL[k]
                   for k in tp.BWD_STEP_TOL):
            fail(f"phase 21 fixture {arch}: the step with the backward "
                 f"kernel against the step with the plain backward "
                 f"{vs_plain}, beyond {tp.BWD_STEP_TOL}")
        card_tol = tp.LM_TRAIN_CARD_TOL[arch]
        try:
            errs = tp.check_lm_train(arch, *res, tol=card_tol)
        except AssertionError as e:
            fail(f"phase 21 fixture {arch}: the card's step misses its "
                 f"tolerance: {e}")
        print(f"phase 21 fixture {arch} on {device}: vs the plain backward "
              f"loss |diff| {vs_plain['loss']:.2e}, worst leaf rel L2 "
              f"{vs_plain['grad']:.3e}, grad_norm {vs_plain['grad_norm']:.3e}"
              f" (bounds {tp.BWD_STEP_TOL}); vs the JAX package loss |diff| "
              f"{errs['loss']:.2e}, aux {errs['aux']:.2e}, grad_norm "
              f"{errs['grad_norm']:.2%}, worst leaf rel L2 grad "
              f"{errs['grad']:.3e} m {errs['m']:.3e} v {errs['v']:.3e}, new "
              f"params > 1 ulp {errs['far']:.2%} (tolerances "
              f"{tuple(x if x is None else round(x, 4) for x in card_tol)}); "
              f"flash launches {counts}, backward {bwd}, loss head {heads} "
              "each")
    for arch in tp.LM_TRAIN_FP32_ARCHS:
        reset_flash_counts(FA)
        reset_bwd_counts(FA)
        reset_head_counts(LH)
        got, arrs = tp.lm_train_fp32_grads(z, arch, device)
        check_head_counts(LH, f"phase 21 fixture {arch} fp32", 0)
        counts, bwd = launches(f"{arch} fp32", tp.load_lm_train(
            z, arch, "cpu")[0], torch.float32)
        total += bwd
        tol = tp.LM_TRAIN_FP32_CARD_TOL[arch]
        try:
            worst = tp.check_lm_train_fp32(arch, got, arrs, tol)
        except AssertionError as e:
            fail(f"phase 21 fixture {arch} fp32: the card's gradient misses "
                 f"the JAX package's: {e}")
        with plain_attention():
            plain, _ = tp.lm_train_fp32_grads(z, arch, device)
        torch.cuda.synchronize()
        if sum(bwd_counts(FA)) != bwd:
            fail(f"phase 21 fixture {arch} fp32: the plain-attention "
                 "gradient launched a backward kernel")
        vs_plain = max(tp._rel(got[k].ravel(), plain[k].ravel())
                       for k in got)
        if not vs_plain <= tp.LM_TRAIN_FP32_STEP_TOL:
            fail(f"phase 21 fixture {arch} fp32: the kernels' gradient "
                 f"against plain attention's on the card {vs_plain}, beyond "
                 f"{tp.LM_TRAIN_FP32_STEP_TOL}")
        print(f"phase 21 fixture {arch} fp32 on {device}: worst gradient "
              f"leaf vs the JAX package's fp32 gradient {worst:.3e} "
              f"(relative L2 of its sampled elements or of its norm; bound "
              f"{tol}, the CPU's {tp.LM_TRAIN_FP32_TOL[arch]}), vs the card's "
              f"plain-attention gradient {vs_plain:.3e} (bound "
              f"{tp.LM_TRAIN_FP32_STEP_TOL}); flash launches {counts}, "
              f"backward {bwd} (cuda_core)")
    return total, head


def train_full_width(device, run: dict, phase: str) -> tuple:
    """Phase 21 (d) and (f): ``run`` (``TRAIN``: llama3.2-1b, ``RG_TRAIN``:
    recurrentgemma-2b) at full width on seed-0 weights, batch x seq
    tokens, ``run['steps']`` steps of ``make_train_step`` with the default
    AdamWConfig and remat per layer group; launch counts reset just before
    and read just after (per step the forward twice per grouped attention
    layer on the head dim's sm90 counter, the sm90 backward once, none on
    another route); then step 1 with the kernels against step 1 with
    plain attention (forward and autograd backward) on the same batch at
    ``TRAIN_TOL``.  Each loss-head kernel launches once a 512-position
    chunk a step.  Returns the backward launches and each loss-head
    kernel's."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import loss_head as LH
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_init
    cfg = get_arch(run["arch"])
    oc = AdamWConfig()
    params = init_params(cfg, run["seed"], device)
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != run["params"]:
        fail(f"{cfg.name}: {n_params} parameters, want {run['params']}")
    state0 = train_init(cfg, params, oc)
    dc = DataConfig(seq_len=run["seq"], global_batch=run["batch"],
                    seed=run["seed"])
    batches = [make_batch(cfg, dc, s, device=device)
               for s in range(run["steps"])]
    # step 1's gradient is kept; the plain step's is compared with it leaf
    # by leaf as it comes (no second copy)
    first_grads, cos, plain_step = {}, [], []

    def hook(g):
        if not first_grads:
            first_grads.update({n: x.detach().clone() for n, x in g.items()})
        elif plain_step:
            cos.extend(float(torch.nn.functional.cosine_similarity(
                first_grads[n].float().flatten(), x.float().flatten(), dim=0))
                for n, x in g.items() if float(x.float().norm()) > 0)
        return g

    step = make_train_step(cfg, oc, grad_transform=hook)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_flash_counts(FA)
    reset_bwd_counts(FA)
    reset_head_counts(LH)
    state, log = state0, []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, float(m["loss"]),
                    float(m["grad_norm"])))
        if i == 0:
            first_m = m
    n = run["steps"]
    counts = dict(zip(FLASH_ROUTES, flash_counts(FA)))
    bwds = dict(zip(BWD_ROUTES, bwd_counts(FA)))
    fwd_want, bwd_want = (x * n for x in train_launches(cfg))
    route = FA.counter(torch.bfloat16, cfg.head_dim)
    if counts != {r: fwd_want if r == route else 0 for r in FLASH_ROUTES} \
            or bwds != {"cuda_core": 0, "sm90": bwd_want}:
        fail(f"full-width training {cfg.name}: flash launches {counts}, "
             f"backward {bwds}; want {fwd_want} on {route} and {bwd_want} "
             "on sm90")
    heads = check_head_counts(LH, f"full-width training {cfg.name}",
                              head_launches(cfg, run["seq"], n))
    peak = torch.cuda.max_memory_allocated(device)
    if not all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in log):
        fail(f"full-width training {cfg.name}: non-finite loss or grad_norm "
             f"{log}")
    del state
    # step 1 again with the plain attention (nothing of the kernels)
    plain_step.append(True)
    with plain_attention():
        _, mp = step(state0, batches[0])
    torch.cuda.synchronize()
    if bwd_counts(FA) != tuple(bwds.values()) or flash_counts(FA) != tuple(
            counts.values()):
        fail("the plain-attention step launched a flash kernel")
    loss_d = abs(float(first_m["loss"]) - float(mp["loss"]))
    gn_d = abs(float(first_m["grad_norm"]) / float(mp["grad_norm"]) - 1)
    worst = min(cos)
    tokens = run["batch"] * run["seq"]
    steady = sorted(r[0] for r in log[1:]) or [log[0][0]]
    print(f"phase 21 ({phase}) full width {cfg.name} on {device}: "
          f"{n_params:,} bf16 parameters, batch {run['batch']} x "
          f"{run['seq']} tokens, {n} steps (AdamW defaults, remat per "
          f"layer group): step ms "
          + ", ".join(f"{r[0] * 1e3:.1f}" for r in log) + "; "
          f"{tokens / steady[0]:.0f} tokens/s (fastest step after the "
          f"first); loss per step " + ", ".join(f"{r[1]:.4f}" for r in log)
          + f"; grad_norm " + ", ".join(f"{r[2]:.4f}" for r in log)
          + f"; peak memory {peak / 2**30:.2f} GiB; flash launches {counts}, "
          f"backward {bwds}, loss head {heads} each")
    print(f"  step 1 kernels vs plain attention: loss |diff| {loss_d:.3e} "
          f"(bound {TRAIN_TOL['loss']}), grad_norm {gn_d:.3%} (bound "
          f"{TRAIN_TOL['grad_norm']:.0%}), smallest leaf gradient cosine "
          f"{worst:.5f} over {len(cos)} leaves (bound "
          f"{TRAIN_TOL['cosine']})")
    if not (loss_d <= TRAIN_TOL["loss"] and gn_d <= TRAIN_TOL["grad_norm"]
            and worst >= TRAIN_TOL["cosine"]):
        fail(f"full-width step 1 {cfg.name}, kernels vs plain attention, "
             f"beyond {TRAIN_TOL}: loss {loss_d}, grad_norm {gn_d}, cosine "
             f"{worst}")
    return bwd_want, heads


def train_example_run(device) -> tuple:
    """Phase 21 (e): ``examples/torch/train_small_lm.py`` for
    ``EXAMPLE_STEPS`` steps (checkpoints every 100): its loss improves;
    then its checkpoint at ``EXAMPLE_RESUME_STEP`` is restored (the later
    ones removed) and the run resumes to the end: the resumed steps'
    losses equal the first run's bit for bit.  Each loss-head kernel
    launches once a step.  Returns the backward launches of both runs and
    each loss-head kernel's."""
    import importlib.util
    import shutil
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import loss_head as LH
    path = ROOT / "examples" / "torch" / "train_small_lm.py"
    spec = importlib.util.spec_from_file_location("train_small_lm", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ckpt = ROOT / "build" / "train_small_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--device", str(device), "--ckpt-dir", str(ckpt), "--steps",
            str(EXAMPLE_STEPS), "--seq", str(EXAMPLE_SEQ)]
    log_path = ROOT / "build" / "examples" / "train_small_lm.log"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    reset_bwd_counts(FA)
    reset_head_counts(LH)
    with open(log_path, "w") as f, contextlib.redirect_stdout(f):
        t0 = time.perf_counter()
        first = ex.main(argv)
        first_s = time.perf_counter() - t0
    if not first["improved"]:
        fail(f"train_small_lm: loss NOT improved ({first['first']:.4f} -> "
             f"{first['last']:.4f})")
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt.iterdir())
    for s in steps:
        if s > EXAMPLE_RESUME_STEP:
            shutil.rmtree(ckpt / f"ckpt_{s:010d}")
    with open(log_path, "a") as f, contextlib.redirect_stdout(f):
        t0 = time.perf_counter()
        again = ex.main(argv)
        again_s = time.perf_counter() - t0
    want = [r["loss"] for r in first["log"][EXAMPLE_RESUME_STEP:]]
    got = [r["loss"] for r in again["log"]]
    if got != want:
        fail(f"train_small_lm resumed at step {EXAMPLE_RESUME_STEP}: "
             f"losses differ from the uninterrupted run's ({len(got)} vs "
             f"{len(want)} steps; first {got[:3]} vs {want[:3]})")
    n = len(first["log"])
    heads = check_head_counts(LH, "train_small_lm", head_launches(
        first["cfg"], EXAMPLE_SEQ, n + len(got)))
    dts = sorted(r["dt"] for r in first["log"])
    print(f"phase 21 train_small_lm on {device}: {first['cfg'].param_count():,}"
          f" parameters, {n} steps in {first_s:.1f} s (median step "
          f"{dts[n // 2] * 1e3:.1f} ms, with the launcher's loss readback), "
          f"loss first10 {first['first']:.4f} -> last10 {first['last']:.4f} "
          f"(improved); checkpoints {steps}; resumed from "
          f"{EXAMPLE_RESUME_STEP}: {len(got)} steps in {again_s:.1f} s, "
          f"losses equal the uninterrupted run's bit for bit; backward "
          f"launches {dict(zip(BWD_ROUTES, bwd_counts(FA)))}, loss head "
          f"{heads} each (log: {log_path.relative_to(ROOT)})")
    if FA.bwd_launch_count:
        fail("train_small_lm (head dim 64) launched the cuda_core backward")
    return FA.bwd_sm90_launch_count, heads


def training_phase(device) -> dict:
    """Phase 21: the backward kernels against their plain version and
    timed, then the training path on the card: the fixture's ten reduced
    configs and two fp32 steps, llama3.2-1b at full width,
    ``train_small_lm`` with a resume, and recurrentgemma-2b at full width.
    Returns each backward kernel's row values and the backward launches of
    the training runs, and the loss-head kernels' launches in them (each
    kernel's, checked per run: once a 512-position chunk and codebook of
    every bf16 step, none in the fp32 ones)."""
    err = train_kernel_phase(device)
    timing = {"sm90": bwd_timing(device, TRAIN_SHAPE),
              "sm90 d256": bwd_timing(device, RG_TRAIN_SHAPE,
                                      window=RG_WINDOW),
              "cuda_core": bwd_timing(device, TRAIN_SHAPE, "float32"),
              # the bf16 D 32 route at the reduced models' shape, and fp32
              # there (phase 21 (c)'s fp32 steps)
              "cuda_core bf16": bwd_timing(device, reduced_shape()),
              "cuda_core fp32 reduced": bwd_timing(device, reduced_shape(),
                                                   "float32")}
    runs = [train_fixture_run(device),
            train_full_width(device, TRAIN, "d"), train_example_run(device),
            train_full_width(device, RG_TRAIN, "f")]
    core = runs[0][0]
    sm90 = sum(r[0] for r in runs[1:])
    return dict(
        head=sum(r[1] for r in runs),
        sm90=dict(timing["sm90"], launches=sm90,
                  max_err=max(err["sm90"], timing["sm90"]["max_err"],
                              timing["sm90 d256"]["max_err"])),
        cuda_core=dict(timing["cuda_core"], launches=core,
                       max_err=max(err["cuda_core"],
                                   timing["cuda_core"]["max_err"],
                                   timing["cuda_core bf16"]["max_err"],
                                   timing["cuda_core fp32 reduced"]
                                   ["max_err"])))


# ---------------------------------------------------------------------------
# Phase 24: the loss head
# ---------------------------------------------------------------------------

#: the training cell's head chunk: 2 x 512 positions of glm4-9b, (R, D, V)
HEAD_SHAPE = (1024, 4096, 151552)


def loss_head_phase(device) -> dict:
    """Phase 24 (module notes).  Returns per kernel its max error against
    the plain version, its milliseconds, the plain version's, the
    library's (``xent_fwd``: ``F.cross_entropy`` and ``torch.logsumexp``
    on the same logits, the nll and the lse it writes) and the bytes bound
    (4 B a logit read forward; 4 B read and 6 B written backward, at 3.35
    TB/s), and the whole head's forward and backward milliseconds a chunk
    beside the eager fp32 head's.  The whole head is first held to the
    eager fp32 head at the chunk (``tests/test_torch_loss_head_cuda.py``'s
    ``_check_head``: nll, dX and dW within the bounds of the sums' order,
    the bf16 gradients one bf16 ulp more)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import loss_head as LH
    from repro_torch.models import model as M
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_loss_head_cuda import _check_head
    torch.backends.cuda.matmul.allow_tf32 = False
    R, D, V = HEAD_SHAPE
    gen = torch.Generator(device=device).manual_seed(24)
    x = torch.randn(R, D, generator=gen, device=device).bfloat16()
    w = (torch.randn(D, V, generator=gen, device=device)
         * D ** -0.5).bfloat16()
    labels = torch.randint(0, V, (R,), generator=gen, device=device)
    labels[::97] = -1
    try:
        _check_head(x, w, labels)
    except AssertionError as e:
        fail(f"phase 24: the head against the eager fp32 head at "
             f"{HEAD_SHAPE}: {e!r}")
    torch.cuda.empty_cache()
    g = torch.full((), 1.0 / R, device=device).expand(R)
    lg = LH.head_mm(x, w)
    (lse, nll), (lse0, nll0) = LH.xent_fwd(lg, labels), \
        LH.xent_fwd_plain(lg, labels)
    fwd_err = max((lse - lse0).abs().max().item(),
                  (nll - nll0).abs().max().item())
    if fwd_err > 2e-5 + 2.0 ** -21 * lse0.abs().max().item():
        fail(f"phase 24: xent_fwd against its plain version: {fwd_err}")
    sums = []
    for d3 in (LH.xent_bwd(lg, lse, labels, g),
               LH.xent_bwd_plain(lg, lse, labels, g)):
        d = d3[:R].double() + d3[R:2 * R].double() + d3[2 * R:].double()
        if not torch.equal(LH.split3(d.float()).view(torch.int16),
                           d3.view(torch.int16)):
            fail("phase 24: xent_bwd's terms are not an exact split")
        sums.append(d)
        del d3
    bwd_err = (sums[0] - sums[1]).abs().max().item()
    if not ((sums[0] - sums[1]).abs() <= 4 * 2.0 ** -24 * sums[1].abs()
            + 2.0 ** -133).all():
        fail(f"phase 24: xent_bwd against its plain version: {bwd_err}")
    del sums
    ce = lambda: F.cross_entropy(lg, labels, ignore_index=-1,
                                 reduction="none")
    ce_err = (ce() - nll0).abs().max().item()
    if ce_err > 2e-5 + 2.0 ** -21 * lse0.abs().max().item():
        fail(f"phase 24: F.cross_entropy against the plain nll: {ce_err}")
    out = {}
    for name, kern, plain, lib, nbytes in (
            ("xent_fwd", lambda: LH.xent_fwd(lg, labels),
             lambda: LH.xent_fwd_plain(lg, labels),
             lambda: (torch.logsumexp(lg, -1), ce()), 4),
            ("xent_bwd", lambda: LH.xent_bwd(lg, lse, labels, g),
             lambda: LH.xent_bwd_plain(lg, lse, labels, g), None, 10)):
        out[name] = dict(err=fwd_err if name == "xent_fwd" else bwd_err,
                         ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 5),
                         library_ms=(None if lib is None
                                     else cuda_ms(lib, 5)),
                         bound_ms=R * V * nbytes / 3.35e12 * 1e3)
    out["xent_fwd"]["cross_entropy_ms"] = cuda_ms(ce, 5)
    del lg
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)

    def head(fn):
        nll = fn()
        (nll.sum() / R).backward()
        xr.grad = wr.grad = None

    fwd = lambda: LH.loss_head(xr, wr, labels)
    cfg = get_arch("glm4-9b")
    eager = lambda: M._xent_eager(cfg, wr.float(), xr[None], labels[None])
    with torch.no_grad():
        out["head"] = dict(fwd_ms=cuda_ms(fwd, 5),
                           eager_fwd_ms=cuda_ms(eager, 3))
    out["head"]["fwd_bwd_ms"] = cuda_ms(lambda: head(fwd), 5)
    out["head"]["eager_fwd_bwd_ms"] = cuda_ms(lambda: head(eager), 3)
    for name in ("xent_fwd", "xent_bwd"):
        o = out[name]
        lib = "" if o["library_ms"] is None else (
            f", library {o['library_ms']:.4f} ms (F.cross_entropy alone "
            f"{o['cross_entropy_ms']:.4f})")
        print(f"{name} at {HEAD_SHAPE}: {o['ms']:.4f} ms (bytes bound "
              f"{o['bound_ms']:.4f} ms, {100 * o['bound_ms'] / o['ms']:.1f}% "
              f"of it), plain {o['plain_ms']:.4f} ms{lib}, max err "
              f"{o['err']:.3g}")
    print(f"loss head at {HEAD_SHAPE} against the eager fp32 head: nll, dX "
          "and dW within the bounds of the sums' order")
    print("loss head a chunk: " + json.dumps(
        {k: round(v, 4) for k, v in out["head"].items()}))
    return out


# ---------------------------------------------------------------------------
# Phases 22 and 23: the multi-device layer
# ---------------------------------------------------------------------------

#: phase 22 (a)'s dry-run cell, and where its JSON goes
DRYRUN_CELL = ("llama3.2-1b", "train_4k")
DRYRUN_DIR = ROOT / "build" / "dryrun_torch"
#: phase 22 (b)'s reduced llama3.2-1b step: (batch, tokens)
DTENSOR_STEP = (4, 64)
#: phase 23's session: ``tests/torch_sharded_worker.py``'s 4-channel DDR4
#: run (600 cycles, trace and 250-cycle telemetry windows)
SHARD_SESSION = "ddr4_4ch"
#: the subprocesses phases 22 and 23 start: ``main`` ends any still
#: running when it returns or fails
CHILDREN: list = []


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cpu_env() -> dict:
    """A subprocess's environment: the port on its path, the card hidden
    (what it runs is host work)."""
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")


def start_dryrun():
    """Phase 22 (a) in a subprocess (its own ``fake`` process group; this
    process holds the NCCL one): the dry run of ``DRYRUN_CELL`` on the
    (16, 16) mesh, JSON into ``DRYRUN_DIR``."""
    arch, shape = DRYRUN_CELL
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", "16x16", "--force", "--out",
           str(DRYRUN_DIR)]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=cpu_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    CHILDREN.append(proc)
    return proc, time.perf_counter()


def finish_dryrun(started) -> dict:
    proc, t0 = started
    out = proc.communicate(timeout=900)[0]
    if proc.returncode:
        fail(f"phase 22 dry run exited {proc.returncode}: {out[-3000:]}")
    arch, shape = DRYRUN_CELL
    rec = json.loads((DRYRUN_DIR / f"{arch}__{shape}__16x16.json")
                     .read_text())
    return dict(rec=rec, wall=time.perf_counter() - t0)


def start_gloo():
    """Phase 23 (b): ``SHARD_SESSION`` on 2 ``gloo`` ranks on the host
    (``tests/torch_sharded_worker.py``), in the background."""
    out = ROOT / "build" / "shard_gloo2.pkl"
    port = free_port()
    worker = str(ROOT / "tests" / "torch_sharded_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", str(port), str(out),
         SHARD_SESSION], cwd=ROOT, env=cpu_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    CHILDREN.extend(procs)
    return procs, out


def finish_gloo(started) -> dict:
    import pickle
    procs, out = started
    logs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        fail("phase 23 gloo ranks failed: " + "\n".join(
            log[-2000:] for log in logs))
    with open(out, "rb") as f:
        return pickle.load(f)


def init_nccl(device):
    """This process as rank 0 of a one-rank NCCL process group (phases
    22 (b) and 23 run on it)."""
    import torch
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=torch.device(
                                "cuda", torch.cuda.current_device()))


def dryrun_phase(d: dict):
    """Phase 22 (a)'s report: the dry run's JSON."""
    rec = d["rec"]
    if rec.get("source") != "repro_torch eager count" \
            or not rec["cost"]["flops"] > 0 \
            or set(rec["collectives"]["by_kind"]) != {
                "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute"}:
        fail(f"phase 22 dry run: unexpected JSON {json.dumps(rec)[:500]}")
    print(f"dry run {DRYRUN_CELL[0]} x {DRYRUN_CELL[1]} x 16x16 (phase 22, "
          f"a subprocess on the host, {d['wall']:.1f} s; fake tensors, "
          "per device):")
    print(json.dumps(rec))


def dtensor_step_phase(device) -> dict:
    """Phase 22 (b): the reduced llama3.2-1b's prefill and one training
    step on plain tensors and again as DTensors on a one-device mesh over
    the NCCL group (``launch.specs``' shardings, ``reshard_state``): the
    same kernels launched the same number of times, the same logits bit
    for bit.  Returns the DTensor runs' flash launches."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint import reshard_state
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import CELL_RULES, param_shardings
    from repro_torch.models.model import Batch, init_params
    from repro_torch.optim.adamw import AdamWConfig, OptState
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.sharding import NamedSharding, choose_spec
    from repro_torch.train.step import TrainState, make_train_step, \
        train_init
    cfg = get_arch("llama3.2-1b").reduced()
    mesh = make_host_mesh()
    B, T = DTENSOR_STEP
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                           dtype=torch.int32).to(device)
    pos = torch.arange(T, dtype=torch.int32, device=device)[None].repeat(
        B, 1)
    bsh = NamedSharding(mesh, (choose_spec((B,), ("batch",), mesh,
                                           CELL_RULES)[0], None))
    psh = param_shardings(cfg, mesh)
    prefill = make_prefill_step(cfg, cache_len=T)
    step = make_train_step(cfg, AdamWConfig())
    flash = lambda: (FA.launch_count, FA.sm90_launch_count,
                     FA.bwd_launch_count, FA.bwd_sm90_launch_count)

    def run(dtensor: bool):
        params = init_params(cfg, seed=0, device=device)
        batch = Batch(tokens=tokens, positions=pos)
        tbatch = batch._replace(labels=tokens)
        state = train_init(cfg, init_params(cfg, seed=0, device=device),
                           AdamWConfig())
        if dtensor:
            params = reshard_state(params, psh)
            batch = reshard_state(batch, Batch(bsh, bsh))
            tbatch = reshard_state(tbatch, Batch(bsh, bsh, bsh))
            state = reshard_state(state, TrainState(psh, OptState(
                NamedSharding(mesh, ()), psh, dict(psh))))
        torch.cuda.synchronize()
        FA.launch_count = FA.sm90_launch_count = 0
        FA.bwd_launch_count = FA.bwd_sm90_launch_count = 0
        t0 = time.perf_counter()
        # the model's constants (RoPE's frequencies, masks) are plain
        # tensors: DTensor takes them as replicated
        with implicit_replication():
            logits, _ = prefill(params, batch)
            new, metrics = step(state, tbatch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        whole = lambda t: t.full_tensor() if dtensor else t
        leaves = {n: whole(p.detach()) for n, p in
                  new.params.named_parameters()}
        return whole(logits), whole(metrics["loss"]), leaves, flash(), wall

    lp, loss_p, leaves_p, cp, wp = run(False)
    ld, loss_d, leaves_d, cd, wd = run(True)
    if cp != cd or not cd[0] or not cd[2]:
        fail(f"phase 22 DTensor step: flash launches (fwd, sm90, bwd, "
             f"bwd_sm90) {cd} on the mesh, {cp} on plain tensors")
    if not torch.equal(lp, ld):
        fail(f"phase 22 DTensor step: logits differ from the plain step's "
             f"by {(lp - ld).abs().max().item()}")
    same_step = torch.equal(loss_p, loss_d) and all(
        torch.equal(leaves_p[n], leaves_d[n]) for n in leaves_p)
    if not same_step:
        worst = max((leaves_p[n].float() - leaves_d[n].float()).abs().max()
                    .item() for n in leaves_p)
        fail(f"phase 22 DTensor step: loss {loss_d.item()} (plain "
             f"{loss_p.item()}), new parameters differ from the plain "
             f"step's by up to {worst}")
    print(f"DTensor step on a 1-device mesh over NCCL ({cfg.name}, B {B}, "
          f"T {T}; phase 22): prefill logits == the plain step's bit for "
          f"bit; flash launches (fwd, sm90, bwd, bwd_sm90) {cd} == plain "
          f"{cp}; train step loss {loss_d.item():.6f} == plain, new "
          f"parameters equal bit for bit; wall {wd:.2f} s (plain "
          f"{wp:.2f} s)")
    return dict(flash=cd[0], bwd=cd[2])


def roofline_line(examples: list):
    """Phase 22 (c)'s report: the roofline example (run with phase 18's
    examples, on the dry run's JSON)."""
    r = next(x for x in examples if x["name"] == "memsys_aware_roofline")
    rows = r["rows"] or []
    if len(rows) != 1 or not rows[0]["t_achieved"] >= rows[0]["t_naive"] \
            or r["diff"]:
        fail(f"phase 22 roofline example: rows {rows}, diff {r['diff']}")
    row = rows[0]
    print(f"roofline example on the card (phase 22): {row['arch']} "
          f"{row['bytes']:.3e} bytes/device, t_mem {row['t_naive']:.4f} s "
          f"at HBM_BW, {row['t_achieved']:.4f} s at the simulated HBM3 "
          f"achieved fraction {r['doc']['achieved_gbps'] / r['doc']['peak_gbps']:.3f}; "
          f"fused launches {r['counts']['fused']}, {r['wall']:.1f} s")


def shard_phase(device, gloo: dict) -> int:
    """Phase 23: ``SHARD_SESSION`` unsharded on the card and through the
    channel-sharded loop over the one-rank NCCL group (``make_run(...,
    shard=1)``: its sum and min collectives every iteration), bit for bit
    in stats, dense trace and telemetry with one fused launch per loop
    iteration each; the same session on 2 ``gloo`` ranks on the host
    equal to the card's; then ``dse.execute`` over ``[device, device]``
    against one device.  Returns the fused launches."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sharded_worker as W
    from repro_torch import dse
    from repro_torch import telemetry as T
    from repro_torch.core import ControllerConfig, FrontendConfig, Simulator
    from repro_torch.core import device as D
    from repro_torch.core import engine as E
    from repro_torch.core import frontend as F
    from repro_torch.kernels import controller_step as KS
    dev = str(device)

    def same(a: dict, b: dict) -> bool:
        keys = set(a) - {"host_syncs"}
        return keys == set(b) - {"host_syncs"} and all(
            np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
            else a[k] == b[k] for k in keys)

    KS.launch_count = 0
    single = W.session_ddr4_4ch(False, device=dev)
    la = KS.launch_count
    sim = Simulator(*W.DDR4, channels=4, device=dev)
    fn = E.make_run(sim.msys, sim.controller, sim.frontend, 600, True,
                    points=1, telemetry_window=250, shard=1)
    dps = tuple(D.dyn_params(g.cspec, device, g.channels)
                for g in sim.msys.groups)
    fp = F.stack_params([(2.0, 0.7)], sim.frontend.probe_gap, device)
    torch.cuda.synchronize()
    KS.launch_count = 0
    t0 = time.perf_counter()
    res = fn(dps, fp, 0x1234, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lb = KS.launch_count
    stats, dense, snaps = res.out
    telem = T.build(sim.msys, E._point_snaps(snaps, 0), window=250,
                    n_cycles=600)
    sharded = {"stats": stats.point(0).to_dict(), **W.flatten(dense, "trace"),
               **W.flatten(telem, "telemetry")}
    if not same(single, sharded):
        fail("phase 23: the channel-sharded loop over NCCL differs from the "
             "unsharded run")
    if la != single["host_syncs"] or lb != res.host_syncs:
        fail(f"phase 23: fused launches {la} / {lb} for "
             f"{single['host_syncs']} / {res.host_syncs} iterations")
    print(f"channel-sharded run over NCCL, world size 1 (phase 23; 4-channel "
          f"DDR4, 600 cycles, trace and telemetry): == the unsharded run bit "
          f"for bit; {res.host_syncs} iterations, fused launches {lb} (one "
          f"per iteration), 2 collectives per iteration; {wall:.2f} s")
    g2 = gloo[SHARD_SESSION]
    if not same(g2, single):
        fail("phase 23: the 2-rank gloo run differs from the card's")
    print(f"  the same session on 2 gloo ranks (host CPUs): == the card's "
          f"unsharded run bit for bit (topologies {gloo['topologies']})")

    spec = dse.SweepSpec(systems=("DDR4",), channels=(2,),
                         controllers=(ControllerConfig(scheduler="FCFS"),),
                         frontend=FrontendConfig(pattern="random"),
                         intervals=(8.0, 4.0, 2.0), read_ratios=(0.7, 1.0),
                         n_cycles=1000)
    sweep = lambda devices: dse.execute(spec, cache=E.RunCache(),
                                        devices=devices)
    KS.launch_count = 0
    t0 = time.perf_counter()
    one = sweep([dev])
    w_one = time.perf_counter() - t0
    lc = KS.launch_count
    KS.launch_count = 0
    t0 = time.perf_counter()
    two = sweep([dev, dev])
    w_two = time.perf_counter() - t0
    ld = KS.launch_count
    cols = ("throughput_gbps", "latency_ns", "reads_done", "writes_done",
            "probe_cnt", "scan_steps", "skipped_cycles")
    same_cols = lambda r: all(np.array_equal(getattr(one, k), getattr(r, k))
                              for k in cols)
    if not same_cols(two) or two.meta["n_devices"] != 2 \
            or ld != two.meta["host_syncs"] or lc != one.meta["host_syncs"]:
        fail(f"phase 23: execute over [{dev}, {dev}] differs from one "
             f"device (launches {ld}, {lc})")
    # why the executor runs shares one after another: two host loops at
    # once, a thread each (its own cache), on the one card (these
    # launches are not the path's)
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        both = list(pool.map(sweep, [[dev], [dev]]))
    w_both = time.perf_counter() - t0
    if not all(map(same_cols, both)):
        fail("phase 23: two sweeps in two threads differ from one alone")
    print(f"  dse.execute(devices=[{dev!r}, {dev!r}]): 6 points split 3 + 3, "
          f"== one device in every column; fused launches {ld} "
          f"(one device {lc}); wall {w_two:.3f} s, its shares one after "
          f"another (one device {w_one:.3f} s)")
    print(f"  two one-device sweeps in two threads at once on the card: "
          f"wall {w_both:.3f} s against {2 * w_one:.3f} s one after "
          f"another (speed-up {2 * w_one / w_both:.2f}x)")
    return la + lb + lc + ld


def main() -> int:
    try:
        return run()
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.serve.step import exact_matmuls
    exact_matmuls()        # fp32 products in full fp32, bf16 reduce in fp32
    device = torch.device("cuda")
    t_start = time.perf_counter()
    print(card_line())
    seconds = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build("readiness", "controller_step", "flash_attention",
                       "flash_attention_sm90", "flash_attention_bwd",
                       "flash_attention_bwd_sm90", "loss_head")
    print(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        # the full -Xptxas -v report goes beside the library; stdout gets
        # each entry's registers and any spill
        path = build.library_path(name).with_suffix(".nvcc.log")
        path.write_text(log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = sorted(set(re.findall(r"\d+ bytes spill stores", log))
                        - {"0 bytes spill stores"})
        print(f"nvcc {name}: {len(regs)} entries, registers "
              f"{min(map(int, regs), default=0)}-"
              f"{max(map(int, regs), default=0)}, spills "
              f"{spills or 'none'} (log: {path.relative_to(ROOT)})")
    sm90_log = build.library_path("flash_attention_sm90").with_suffix(
        ".nvcc.log")
    if sm90_log.exists():
        for D in (64, 128, 256):
            print(f"ptxas flash_fwd_sm90_kernel<{D}>: " + ptxas_report(
                sm90_log.read_text(), f"flash_fwd_sm90_kernelILi{D}E"))
    for name, entries in (
            ("flash_attention_bwd",
             [f"flash_bwd_bf16_kernelILi{D}E" for D in (16, 32)]
             + [f"flash_bwd_f32_kernelILi{D}E" for D in (16, 32, 64, 128)]),
            ("flash_attention_bwd_sm90",
             [f"flash_bwd_{kind}_kernelILi{D}E" for kind in ("dq", "dkdv")
              for D in (64, 128, 256)])):
        log = build.library_path(name).with_suffix(".nvcc.log")
        if log.exists():
            for entry in entries:
                print(f"ptxas {name} {entry}: "
                      + ptxas_report(log.read_text(), entry))
    print("CUDA-core flash backward kernel SASS: " + sass_counts(
        build.library_path("flash_attention_bwd"), ("HMMA",),
        ("LDSM", "LDGSTS"), what="CUDA-core flash backward kernel"))
    # the fp32 route's outer products: FFMAs against shared-memory loads
    # (16-byte LDS.128 vectors); SHFL only in the delta sums
    for D in (64, 128):
        print(f"CUDA-core flash backward fp32 kernel<{D}> SASS: "
              + sass_counts(build.library_path("flash_attention_bwd"),
                            ("FFMA", "LDS.128"), ("LDS", "SHFL", "MUFU.EX2",
                                                  "BAR.SYNC"),
                            what=f"fp32 flash backward kernel<{D}>",
                            function=f"flash_bwd_f32_kernelILi{D}E"))
    print("sm90 flash backward kernel SASS: " + sass_counts(
        build.library_path("flash_attention_bwd_sm90"),
        ("HGMMA", "UTMALDG", "UBLKCP"), what="sm90 flash backward kernel"))
    print("sm90 flash kernel SASS: " + sass_counts(
        build.library_path("flash_attention_sm90"), ("HGMMA", "UTMALDG"),
        what="sm90 flash kernel"))
    # mma.sync (HMMA) for bf16, ldmatrix (LDSM), cp.async (LDGSTS); the
    # (max,+) kernels' DPX add-max (VIADDMNMX) and fp32 max (FMNMX)
    print("CUDA-core flash kernel SASS: " + sass_counts(
        build.library_path("flash_attention"), ("HMMA",), ("LDSM", "LDGSTS"),
        what="CUDA-core flash kernel"))
    print("readiness / (max,+) kernels SASS: " + sass_counts(
        build.library_path("readiness"), (), ("VIADDMNMX", "FMNMX",
                                               "LDGSTS")))

    max_err, _ = timed("3 readiness", kernel_phase, device)
    mp_err, mp = timed("3 maxplus", maxplus_phase, device)
    fused = timed("3 fused", fused_phase, device)
    lanes = timed("10 lanes", lanes_phase, device)
    preds = timed("13 predicates", predicate_kernel_phase, device)
    flash_err = timed("4 flash", flash_phase, device)
    # each flash kernel at its path's shape (timed before the golden phase's
    # worker processes: after them the profiler may report no device time)
    sm90 = flash_timing(device, *SERVE_SHAPE, kernel="flash_fwd_sm90_kernel")
    flash_timing(device, *SERVE_SHAPE[:4], 128, kernel="flash_fwd_sm90_kernel")
    core = flash_timing(device, *reduced_shape(), kernel="flash_core_")
    flash_timing(device, *reduced_shape(), kernel="flash_core_",
                 dtype="float32")
    flash_timing(device, *SERVE_SHAPE, kernel="flash_core_", dtype="float32")
    # local attention: recurrentgemma-2b's prefill (the sm90 kernel at D
    # 256, on phase 19's path), the sm90 kernel at a qwen3-4b-like shape
    # and the CUDA-core one at the reduced recurrentgemma's (phase 19's
    # fixture)
    d256 = flash_timing(device, *RG_SHAPE, kernel="flash_fwd_sm90_kernel",
                        window=RG_WINDOW)
    flash_timing(device, 4, 4096, 32, 8, 128, kernel="flash_fwd_sm90_kernel",
                 window=RG_WINDOW)
    flash_timing(device, 4, 4096, 32, 8, 128, kernel="flash_fwd_sm90_kernel")
    flash_timing(device, 2, 80, 2, 1, 32, kernel="flash_core_", window=64)
    # the operators' host cost beside direct calls, where it shows most
    for shape, dtype in ((reduced_shape(), "bfloat16"),
                         (reduced_shape(), "float32"),
                         ((*SERVE_SHAPE[:4], 128), "bfloat16")):
        op_overhead(device, *shape, dtype=dtype)
    # the batched and hetero sessions' profile windows also need the
    # profiler's device time: they run before the golden phase's workers
    batch_launches = timed("11 batched", batched_phase, device,
                           lanes["device_us"])
    timed("14 hetero profile", hetero_session_phase, device)
    # phases 22 (a) and 23 (b)'s host work, in subprocesses beside the
    # golden phase's workers (the timed phases above want a quiet host);
    # the roofline example (phase 22, with phase 18's) waits for the dry
    # run.  Phase 16's cold half runs in this process beside the workers,
    # its warm half alone after them
    dry = start_dryrun()
    gloo = start_gloo()
    system_launches, p15_launches, p17, examples, dse_cold, dry = timed(
        "5, 12, 14, 15, 17, 18 in workers; 16 cold", golden_phase, "cuda",
        lambda: dse_phase(device), lambda: finish_dryrun(dry))
    dse_launches = timed("16 warm", dse_warm_phase, device, dse_cold)
    xtab = timed("17 table", explore_table_phase, device)
    main_path = timed("6 main path", main_path_phase, device)
    # the main path's readiness-table and (max,+) launches (0: checked)
    launches = main_path["counts"]["tables"]
    examples = timed("18 examples", examples_phase, examples + [main_path])
    ex = {k: sum(r["counts"][k] for r in examples)
          for k in ("fused", "tables", "flash", "sm90")}
    timed("7 fixture", fixture_phase, device)
    core_launches = timed("8 reduced", reduced_phase, device)
    sm90_launches = timed("9 serving", lm_phase, device)
    fam = timed("19 families", families_phase, device)
    fam_b = timed("20 new families", new_families_phase, device)
    train = timed("21 training", training_phase, device)
    head = timed("24 loss head", loss_head_phase, device)
    import torch.distributed as dist
    # NCCL allocates outside PyTorch's cache, which phases 21 and 24 have
    # grown to most of the card: hand the cached memory back first
    torch.cuda.empty_cache()
    init_nccl(device)
    dryrun_phase(dry)
    p22 = timed("22 DTensor step", dtensor_step_phase, device)
    roofline_line(examples)
    p23 = timed("23 sharded", shard_phase, device, finish_gloo(gloo))
    dist.destroy_process_group()

    big = mp[(*MAXPLUS_TIMED[-1], "int32")]

    def flash_row(name, source, launches, t, err):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": "src/repro/kernels/flash_attention.py:73",
                "launches": launches, "max_abs_err": max(err, t["max_err"]),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [{
        "name": "readiness_table", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/readiness.cu",
        "replaces": "src/repro/kernels/timing_check.py:51",
        "launches": launches + p17["tables"] + ex["tables"],
        "max_abs_err": max(max_err, xtab["max_err"], xtab["step_err"]),
        "ms": xtab["kernel_ms"], "plain_ms": xtab["plain_ms"],
        "bound_ms": xtab["bound_ms"], "bound_by": xtab["bound_by"],
        "library_ms": None}, {
        "name": "maxplus_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/readiness.cu",
        "replaces": "src/repro/kernels/timing_check.py:51",
        "launches": launches, "max_abs_err": mp_err,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None}, {
        "name": "controller_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/controller_step.cu",
        "replaces": "src/repro/kernels/timing_check.py:51",
        "launches": (batch_launches + ex["fused"] + system_launches
                     + p15_launches + dse_launches + p17["fused"] + p23),
        "max_abs_err": max(fused["max_err"], lanes["max_err"],
                           preds["max_err"], xtab["step_err"]),
        "ms": lanes["ms"], "plain_ms": lanes["plain_ms"],
        "bound_ms": lanes["bound_ms"], "bound_by": lanes["bound_by"],
        "library_ms": None},
        flash_row("flash_attention", "flash_attention.cu",
                  core_launches + ex["flash"] + fam["cuda_core"]
                  + fam_b["cuda_core"] + p22["flash"], core,
                  flash_err["cuda_core"]),
        flash_row("flash_attention_sm90", "flash_attention_sm90.cu",
                  sm90_launches + ex["sm90"] + fam["sm90"] + fam_b["sm90"],
                  sm90, flash_err["sm90"]),
        flash_row("flash_attention_d256", "flash_attention_sm90.cu",
                  fam["d256"] + fam_b["d256"], d256, flash_err["d256"]),
        dict(flash_row("flash_attention_bwd_sm90",
                       "flash_attention_bwd_sm90.cu",
                       train["sm90"]["launches"], train["sm90"],
                       train["sm90"]["max_err"]),
             replaces="jax.grad of src/repro/models/layers.py:130"),
        dict(flash_row("flash_attention_bwd", "flash_attention_bwd.cu",
                       train["cuda_core"]["launches"] + p22["bwd"],
                       train["cuda_core"], train["cuda_core"]["max_err"]),
             replaces="jax.grad of src/repro/models/layers.py:130")]
        + [{"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/loss_head.cu",
            "replaces": "none: the reference's _xent is XLA "
                        "(src/repro/models/model.py)",
            "launches": train["head"], "max_abs_err": head[name]["err"],
            "ms": head[name]["ms"], "plain_ms": head[name]["plain_ms"],
            "bound_ms": head[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": head[name]["library_ms"]}
           for name in ("xent_fwd", "xent_bwd")]}))
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s; phases "
          f"{json.dumps(seconds)}", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
