#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mtvaf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:

1. build every CUDA kernel of the port from ``mtvaf_tpu_torch/csrc`` (one
   nvcc per source, all started together), print each instance's ptxas
   registers, static shared memory and spills, and fail on a spill;
2. hold the prefix-attention forward kernel (K1) against its plain PyTorch
   version on the card, at the shapes the serving path gives it and at the
   span pipeline's (``span_s128``: B=32, S=T=128; ``span_s500``: S=T=500,
   a length that is not a multiple of 64; no prefix, bias (B,1,1,S)) with
   dropout 0.1 and without, and time kernel, plain version and the
   one-call PyTorch yardstick (SDPA) beside the kernel's bound (each row
   names its dtype's design: bf16 on wgmma fed by TMA, fp32 on the CUDA
   cores; its share of the bound; its time over SDPA's);
3. at the train shape: the dropout-mask entry point's masks bit-identical
   to the plain Philox masks, the kept fraction within 1% of 1 - rate, and
   K1 with dropout against the plain forward given the same masks;
4. hold the backward kernel (K2) against the plain backward in the same
   dtype and against fp32 autograd of the plain forward, at the train shape
   (bf16 and fp32), at S=512 (bf16) and at the two span shapes (bf16),
   with dropout off and on; time K2
   (and each of its two passes), the plain backward and SDPA's backward
   beside K2's bound;
5. check the whole decode forward on the card against the same forward on
   the CPU (fp32, TF32 off) at the flagship widths, on a small batch;
6. check one fp32 train step's loss and every gradient leaf on the card
   against the CPU at the flagship widths (B=2, S=32, TF32 off, no
   dropout);
7. serve 64 threaded requests (text-only and image-bearing) through
   ``BatchingServer`` → ``CrfPredictor`` at the flagship configuration
   (BERT-base, 12 layers, ResNet-152 guides, 16 prefix slots, bf16) with
   random weights from a seed, and check that K1 ran 12 times per batch;
8. time the stages of one image-bearing batch of 16;
9. train: ``create_train_state`` → ``make_crf_loss_fn`` →
   ``make_train_step`` at the flagship configuration, B=32, S=128, bf16,
   one fixed synthetic batch with cached guides (as ``bench.py``), dropout
   live: 15 untimed and 30 timed steps; check finite losses, the last 5
   below the first, 12 K1 and 12 K2 launches per timed step, and none of
   the mask entry (the kernels draw their masks themselves); print
   step time, examples/s, MFU and the forward / backward / optimizer split
   of one step;
10. trainer: the CLI (``cli.main.main``) → ``CrfTrainer.train()`` /
   ``.test()`` at the flagship configuration for 2 epochs on a synthetic
   Twitter-2015 tree in the reference layout (320/96/96 examples, the
   pixel cache seeded so that nothing is decoded); check finite losses, 12
   K1 + 12 K2 launches per train step and 12 K1 per dev/test batch, none of
   the mask entry, every parameter, moment and guide-table tensor on the
   card, no placeholder image and no all-zero guide row, and the run's
   files; reload the best model with ``load_predictor`` and tag a few
   sentences; print per-epoch time and examples/s beside phase 9's bare
   step, the guide-fill time, eval sentences/s and the checkpoint's write
   and load times; then stop a run with a real SIGTERM after epoch 1,
   resume it, and require its params and optimizer state to equal an
   uninterrupted run's bit for bit (under
   ``torch.use_deterministic_algorithms``, in a child process started with
   ``--resume-check``, so that the fixed cuBLAS workspace it needs does not
   reach the timed phases);
11. span: the span pipeline (text-only BERT-base, twitter15) with random
   weights from a seed: (a) the bare span train step
   (``make_span_loss_fn`` → ``make_train_step``, one fixed ``span_batch``,
   B=32, S=128, 20 candidates of width up to 12, bf16, dropout live; 15
   untimed and 30 timed steps; finite losses, the last 5 below the first,
   12 K1 and 12 K2 launches per step); (b) one fp32 span step on the card
   against the CPU (B=2, S=32, TF32 off, no dropout); (c) the CLI →
   ``SpanTrainer`` for 2 epochs on a synthetic Twitter-2015 span tree
   (320/96/96 sentences), 12 K1 + 12 K2 per train step and 12 K1 per eval
   batch, eval sentences/s and the host's candidate/NMS share of it; (d)
   ``load_predictor`` on that run → ``BatchingServer`` → ``SpanPredictor``,
   64 requests from 16 threads, each result equal to ``predict_many``'s,
   the serving params and a dev batch's extraction logits equal to the
   trainer's bit for bit;
12. aux heads: the span pipeline with cutoff augmentation (``span_cutoff``
   at ratio 0.1, CE and JS weights 1), DiGCN (2 layers) and DualGCN (2
   layers), BERT-base, bf16, random weights from a seed: (a) the bare aux
   train step (two encoder passes, B=32, S=128, GCN side arrays drawn from
   the seed, dropout live; 15 untimed and 30 timed steps; finite losses,
   the last 5 below the first, 24 K1 and 24 K2 launches per step); (b) one
   fp32 aux step on the card against the CPU (B=2, S=32, TF32 off, dropout
   off, the cut drawn from one host seed on both); (c) the CLI →
   ``SpanTrainer`` with images (ResNet-152 guides, the visual prefix, the
   pixel cache seeded as in phase 10) for 2 epochs, side files for train
   and dev and none for test, 24 K1 + 24 K2 per train step and 12 K1 per
   eval batch; (d) ``load_predictor`` on that run → ``SpanPredictor``
   (bf16, with images): the DiGCN classification given a dev batch's side
   arrays equal to the trainer's, the extraction with images equal to the
   trainer's fp32-prefix forward bit for bit, ``BatchingServer`` with 64
   image-bearing requests equal to ``predict_many``.  Phases 2 and 4 also
   hold K1 and K2 at ``span_s128_cut``: the span shape with the span
   cutoff's holes inside the bias row;
13. the serving tier, run after phase 16: its two exports run in child
   processes beside phases 15 and 16, which check agreement (15(a)'s
   examples/s are read with the exports running); (a) phase 10's run
   through the export CLI (``cli.export_main``) for ``cuda`` at rungs 1
   and 16 with shared
   weights (six ``torch.export`` programs: text, images, images without
   aux crops), the bundle loaded (``load_exported_predictor``), its
   emissions against the live forward's, phase 7's 64 requests through
   ``BatchingServer`` with every batch's results equal to the live
   ``load_predictor``'s on the same batch and 12 K1 launches per batch
   from the programs (K1 is the operator ``mtvaf::prefix_attention_fwd``
   inside them); (b) phase 12(c)'s run (prefix, images, DiGCN) exported
   at rung 16, 64 image-bearing requests held the same way; (c)
   ``cli.serve_main --bundle`` over (a) in a child process, 64 text-only
   POSTs from 16 threads held to the in-process bundle, /stats and
   /metrics parsed, 12 K1 per batch in the child; then ``build_app`` in
   this process: 16 base64 PNG images through the eval transform (where
   PIL is installed; else said so and held on the CPU only) and a burst
   against ``max_queue=1`` that must give both 200 and 429; (d) the host
   time of one K1 call through the wrapper, the operator and
   ``prefix_attention``;
14. the options: (a) the span step at ``--use_align``'s S=T=500
   (text-only BERT-base, B=32, bf16, dropout live) without and with
   per-layer remat: one step each from one generator, the loss bit for
   bit and every gradient leaf bitwise or within rtol 1e-4 / atol 1e-5
   (the largest difference printed with its reason), K1 12 → 24 and K2 12
   launches a step, then 10 untimed and 20 timed steps of each with
   their peak memory; (b) phase 9's step with ``--params_bf16`` (15 +
   30 steps): finite losses, the last 5 below the first, live ==
   bf16(master), kernel launches and device ms per step beside the
   fp32-param step's; (c) the CLI → ``SpanTrainer`` with ``--use_align
   --remat --params_bf16 --profile_dir`` for 2 epochs on a synthetic
   twitter15 tree with AGN files (320/96/96): 24 K1 + 12 K2 per train
   step and 12 K1 per eval batch, a trace whose kernel records name K1
   and K2, an fp32 ``best_model.npz``, then ``load_predictor`` →
   ``BatchingServer`` → ``SpanPredictor`` at S=500 (64 requests from 16
   threads, each equal to ``predict_many``'s); (d) phase 7's requests
   through a ``CrfPredictor`` with ``crf_decode_impl="parallel"``, each
   batch held to the scan predictor's (a tie that breaks otherwise is
   printed with both path scores, which must be equal), fc + Viterbi's
   device ms and launches for both decodes at the batch of 16, and one
   text decode program of each exported for ``cuda`` (nodes, seconds);
15. data parallelism, one epoch per run at the flagship width on phase
   10's tree (and phase 11's span tree with DualGCN side files), each
   process a child of this one (``--dp-child``) counting its own kernel
   launches from 0 just before its run: (a) the CLI under
   ``python -m torch.distributed.run --standalone --nproc_per_node 1``
   (NCCL, world size 1) against the same flags in one process, both under
   deterministic algorithms: loss, F1 and ``best_model.npz`` bit for bit,
   K1/K2 launches equal, both runs' examples/s; (b) two ranks in a gloo
   group sharing the card, fp32 with images, against one process on the
   same flags and global batch: the loss to 1e-4 relative, F1 equal, each
   ``best_model.npz`` element to the larger of 1e-4 of its leaf's
   magnitude and 2% of the leaf's movement in one process, or, where the
   one-process run measured its gradient at rounding level, to 2·lr over
   the run (``dp_leaf_diff``), 16 rows a step and the K1/K2
   launches of each rank; (c) the span CLI with DualGCN and
   ``--span_ac_loss_mode masked`` the same way; (d) bf16 on two gloo
   ranks: each rank's device guide table holds exactly the images of its
   rows, the two sets differ, the loss within 5% of (a)'s one process,
   K1 and K2 launched in each rank; prints the phase's seconds;
16. tensor parallelism (``--mesh_model``), on phase 15's trees and in its
   children: (k), run right after phase 4, K1 and K2 at the train shape
   with H = 6 heads keyed from head 6 (``head_offset``, a TP rank's half
   of BERT-base), with dropout 0.1 and without, against their plain
   versions and bit for bit against heads 6-11 of the 12-head call, and
   the mask entry point with ``head_offset`` 6 bit-identical to heads 6-11
   of the full mask, timed beside the bound and SDPA; (a) the CRF CLI,
   fp32 with images and dropout on, on two gloo ranks sharing the card
   with ``--mesh_model 2`` against one process: the
   loss to 1e-4 relative, F1 equal, ``best_model.npz`` by phase 15's leaf
   rule, every rank's K1/K2 launches; (b) the span CLI with RoBERTa-base
   and DualGCN the same way; (c) bf16 CRF at ``--mesh_data 2 --mesh_model
   2`` on four gloo ranks against phase 15(d)'s two ranks at
   ``--mesh_data 2`` (the same dropout draws): the loss to 1e-2 relative,
   F1 within 0.02, each ``best_model.npz`` leaf's difference within a
   quarter of how far 15(d) moved it (L2 norms); prints the phase's
   seconds.  The card is
   one: the ranks share it over gloo, so the phase proves agreement and
   launches, not TP's speed;
17. the C++ host runtime and the parity harness: (a), run right after
   phase 1, ``native: <status>`` must read ``native`` (the library built
   with g++ from ``mtvaf_tpu_torch/native``); the image op held against
   its plain numpy version (``native/reference.py``) to 1e-5 on phase
   10's first images (regenerated from its seed, equal to the rows its
   pixel cache holds) and on a 300×400 and a 400×300 gradient image at
   four crops (centre, rows past the image, columns past it, a 128
   crop), its mirror exact; the accelerated tokenizer's tokens and ids
   equal to the Python tokenizer's on every sentence of phases 10's and
   11's trees; host ms per image (native against PIL) and per 1000
   sentences (native against Python).  From here on, phases 7, 10, 12,
   13, 15 and 16 take their pixels (the seeded caches and phase 7's
   requests: random images through the image op) and their BERT tokens
   through the library; (b) ``python -m mtvaf_tpu_torch.parity.harness
   --dry_run --skip_reference`` on ``cuda`` in a child process started
   after phase 14, beside phases 15 and 16: c1-c5, six rows, from the
   harness's own 768-wide, 8-layer BERT and RoBERTa checkpoints and
   ResNet-152 ``.pth``; each row's run exits 0 with finite metrics, loads
   every checkpoint (no "random init" in its log) and launches K1 and K2;
   the table and the seconds per row; (c) 16(c)'s gap printed again
   beside its earlier readings with the same ``_row_dense``, which
   reduces a row-parallel bf16 dot as JAX does.

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device times: the
kernels' summed durations under ``torch.profiler``.  ``event_ms`` is the
kernel's time between events over back-to-back calls, which the host's
launch time sets where that is longer.

Prints the card's name and power limit, then one JSON line with the
kernels' numbers, then ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero, printing no result, without a CUDA device.

    python3 chip_smoke.py --profile

adds, after phase 9, three more train steps under ``torch.profiler``: the
device's busy and idle share of a step and the kernels that take its time.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, fp32 (non-tensor) FLOP/s.
# The device the CLI runs (``run_cli``) and phase 14's paths are given.
DEVICE = "cuda"
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel tolerances (max abs over o and lse).  Against the plain version in
# the inputs' dtype: in bf16 that version rounds the normalised
# probabilities to bf16 where the kernel rounds the unnormalised ones, so
# they differ by a bf16 ulp or two (H100 reading: o 0.0117, lse 0.0062 at
# the serving shape, when the plain version still rounded its scores to
# bf16 too, which alone moves o by up to 2 ulps).  Against the plain
# version in fp32 on the same values only the kernel's bf16 output rounding
# is left (reading: o 0.0036 at the serving shape, 0.0020 at S=512).
K1_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
K1_ATOL_VS_FP32 = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# K2 tolerances (max abs over dq, dk, dv; gradients of O(1), at most ~2.5).
# Against the plain backward in the inputs' dtype: both sum in fp32, so in
# bf16 only their output rounding differs (H100 reading: 0.0039 at the train
# shape and at S=512), in fp32 the summation order (reading: 3.2e-6).
# Against fp32 autograd of the plain forward on the same values, the bf16
# rounding of o (through delta) and of the outputs (readings: 0.0054 and
# 0.0068 on two draws of the inputs).
K2_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
K2_ATOL_VS_FP32 = {torch.float32: 1e-4, torch.bfloat16: 1.5e-2}
SEED = 0
DROPOUT_SEED = 0x0123456789ABCDEF
N_REQUESTS = 64
CLIENTS = 16
TRAIN_B, TRAIN_S = 32, 128
# 15 untimed steps, not 5: the reference's heads train at 5e-2 and, at
# BERT-base width, the loss first rises through the 10-step warmup (to 4x
# step 1's by step 17 on the card) and is back below step 1's only by ~35.
WARMUP_STEPS, TIMED_STEPS = 15, 30
# The span pipeline's attention shapes (no prefix: T = S, bias (B,1,1,S)):
# the text-only configuration's S=128, and S=500 under --use_align; the
# "_cut" shape's bias also has the holes that --do_aug's span cutoff puts
# inside each row (a contiguous tenth of the text, at a random start).
SPAN_SHAPES = {"span_s128": (TRAIN_B, 12, 128, 128, 64, torch.bfloat16),
               "span_s500": (TRAIN_B, 12, 500, 500, 64, torch.bfloat16),
               "span_s128_cut": (TRAIN_B, 12, 128, 128, 64, torch.bfloat16)}
CUT_RATIO = 0.1


def log(*a):
    print(*a, flush=True)


PROFILE_TRIES = 3
# Profiler sessions that recorded fewer kernel records than calls, and were
# profiled again or timed with CUDA events; printed with the kernels line.
profiler_misses = {"retried": 0, "event_timed": 0}


def device_profile(fn, iters=20, warmup=3):
    """Device time of one ``fn()`` by kernel: each kernel's summed durations
    under ``torch.profiler`` over ``iters`` calls, per call, in ms.  Unlike
    :func:`cuda_ms` it leaves out the host's time between launches, which
    sets the pace of a call that runs for a few microseconds on the card.

    Every call launches at least one kernel, so a session with fewer kernel
    records than calls lost some of them (CUPTI now and then delivers none);
    it is profiled again, and after ``PROFILE_TRIES`` such sessions ``fn`` is
    timed with CUDA events instead, under the key ``event_timer``."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_kernel, records = {}, 0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0):
                m = re.search(r"(\w+_kernel)\b", e.key)
                name = m.group(1) if m else e.key[:60]
                by_kernel[name] = (by_kernel.get(name, 0.0)
                                   + e.self_device_time_total / iters / 1e3)
                records += e.count
        if records >= iters:
            return by_kernel
        log(f"profiler: {records} kernel records for {iters} calls "
            f"(session {attempt + 1} of {PROFILE_TRIES})")
        profiler_misses["retried"] += 1
    profiler_misses["event_timed"] += 1
    return {"event_timer": cuda_ms(fn, iters, warmup)}


def device_ms(fn, iters=20, warmup=3):
    """Device time of one ``fn()`` in ms: :func:`device_profile` summed."""
    return sum(device_profile(fn, iters, warmup).values())


def cuda_ms(fn, iters=50, warmup=5):
    """Mean time of ``fn()`` over ``iters`` back-to-back calls, between two
    events: device time, or the host's launch time where that is longer."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 2: the prefix-attention kernel against its plain version.


def k1_bound(b, h, s, t, d, dtype):
    """Least time for the function: each input read once, each output
    written once (q, k, v, o in ``dtype``; bias (B, 1, 1, T) and lse fp32),
    against the two (S, T, D) products of every (b, h)."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h * s * d + 2 * b * h * t * d) * esize \
        + b * t * 4 + b * h * s * 4
    flops = 4 * b * h * s * t * d
    mem_ms = nbytes / HBM_BPS * 1e3
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(mem_ms, op_ms), "bytes" if mem_ms >= op_ms else "operations",
            nbytes, flops)


# Each dtype's design in the kernels: bf16 on the tensor cores (wgmma fed by
# TMA), fp32 on the CUDA cores (wgmma has no fp32 operand).
DESIGN = {torch.bfloat16: "wgmma+TMA", torch.float32: "cuda-cores"}


def shares(dtype, ms, bound_ms, lib_ms):
    """The design, the share of the bound the kernel reaches, and its time
    over the library call's, for a timing row."""
    return {"design": DESIGN[dtype], "bound_share": bound_ms / ms,
            "ms_over_library": ms / lib_ms}


def attention_inputs(g, b, h, s, t, d, dtype, cut=False):
    """q (B,H,S,D), k and v (B,H,T,D) in ``dtype``, drawn from ``g``, and an
    fp32 bias (B,1,1,T) that masks a ragged tail of each row's keys; with
    ``cut`` also the keys that the span cutoff cuts inside the text
    (``train.augment.span_cutoff`` at ``CUT_RATIO``)."""
    from mtvaf_tpu_torch.train.augment import span_cutoff
    dev = g.device
    q = torch.randn(b, h, s, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, h, t, d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, h, t, d, device=dev, generator=g).to(dtype)
    lengths = torch.randint(t // 2, t + 1, (b,), device=dev, generator=g)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).long()
    if cut:
        u = torch.rand((b,), device=dev, generator=g)
        _, mask = span_cutoff(torch.zeros(b, t, 1, device=dev), mask, u,
                              CUT_RATIO)
    return q, k, v, ((1.0 - mask.float()) * -10000.0)[:, None, None, :]


def check_prefix_attention():
    import torch.nn.functional as F

    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_factors, prefix_attention_cuda, prefix_attention_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, (b, h, s, t, d, dtype), rate in (
            ("serve_bf16", (16, 12, 128, 144, 64, torch.bfloat16), 0.0),
            ("serve_fp32", (16, 12, 128, 144, 64, torch.float32), 0.0),
            ("s512_bf16", (16, 12, 512, 528, 64, torch.bfloat16), 0.0),
            *((span, shape, r) for span, shape in SPAN_SHAPES.items()
              for r in (0.0, 0.1))):
        q, k, v, bias = attention_inputs(g, b, h, s, t, d, dtype,
                                         cut=name.endswith("_cut"))
        keep = keep_factors(DROPOUT_SEED, rate, (b, h, s, t), dev) \
            if rate else None
        o, lse = prefix_attention_cuda(q, k, v, bias, seed=DROPOUT_SEED,
                                       rate=rate)
        torch.cuda.synchronize()
        ro, _ = prefix_attention_reference(q, k, v, bias, keep)
        _, rlse = prefix_attention_reference(q, k, v, bias)  # dropout-free
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        fo, _ = prefix_attention_reference(q.float(), k.float(), v.float(),
                                           bias, keep)
        _, flse = prefix_attention_reference(q.float(), k.float(),
                                             v.float(), bias)
        err_fp32 = (o.float() - fo).abs().max().item()
        err_lse_fp32 = (lse - flse).abs().max().item()
        ok = (math.isfinite(err_o) and err_o <= K1_ATOL[dtype]
              and err_lse <= K1_ATOL[dtype]
              and err_fp32 <= K1_ATOL_VS_FP32[dtype]
              and err_lse_fp32 <= K1_ATOL_VS_FP32[dtype])
        mask_q = bias.to(dtype)
        ms = device_ms(lambda: prefix_attention_cuda(
            q, k, v, bias, seed=DROPOUT_SEED, rate=rate))
        event_ms = cuda_ms(lambda: prefix_attention_cuda(
            q, k, v, bias, seed=DROPOUT_SEED, rate=rate))
        plain_ms = device_ms(lambda: prefix_attention_reference(q, k, v,
                                                                bias, keep))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask_q, dropout_p=rate))
        bound_ms, bound_by, nbytes, flops = k1_bound(b, h, s, t, d, dtype)
        del keep
        row = {"shape": name, "B": b, "H": h, "S": s, "T": t, "D": d,
               "rate": rate,
               "dtype": str(dtype).split(".")[1], "max_abs_err_o": err_o,
               "max_abs_err_lse": err_lse, "max_abs_err_o_vs_fp32": err_fp32,
               "max_abs_err_lse_vs_fp32": err_lse_fp32,
               "atol": K1_ATOL[dtype], "atol_vs_fp32": K1_ATOL_VS_FP32[dtype],
               "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops,
               **shares(dtype, ms, bound_ms, lib_ms)}
        log("k1", json.dumps(row))
        rows.append(row)
        if not ok:
            raise AssertionError(f"prefix attention kernel disagrees with "
                                 f"its plain version at {name}: {row}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: dropout masks and K1 with dropout at the train shape.


def check_dropout(rate=0.1):
    import torch.nn.functional as F

    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_factors, keep_mask_cuda, keep_mask_reference,
        prefix_attention_cuda, prefix_attention_reference)

    dev = torch.device("cuda")
    b, h, s, t, d, dtype = TRAIN_B, 12, TRAIN_S, TRAIN_S + 16, 64, \
        torch.bfloat16
    shape = (b, h, s, t)
    got = keep_mask_cuda(DROPOUT_SEED, rate, shape, dev)
    torch.cuda.synchronize()
    want = keep_mask_reference(DROPOUT_SEED, rate, shape, dev)
    kept = got.float().mean().item()
    mismatches = int((got != want).sum().item())
    mask_ms = device_ms(lambda: keep_mask_cuda(DROPOUT_SEED, rate, shape,
                                               dev))
    mask_plain_ms = device_ms(lambda: keep_mask_reference(DROPOUT_SEED, rate,
                                                        shape, dev))
    # the entry point writes (B, H, S, T) fp32: its bound is that write
    mask_bytes = b * h * s * t * 4
    mask_row = {"shape": "train", "rate": rate, "kept": kept,
                "mismatches": mismatches, "ms": mask_ms,
                "plain_ms": mask_plain_ms,
                "bound_ms": mask_bytes / HBM_BPS * 1e3, "bound_by": "bytes",
                "bytes": mask_bytes}
    log("keep_mask", json.dumps(mask_row))
    if mismatches or abs(kept - (1.0 - rate)) > 0.01:
        raise AssertionError(f"dropout masks: {mask_row}")

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k, v, bias = attention_inputs(g, b, h, s, t, d, dtype)
    keep = keep_factors(DROPOUT_SEED, rate, shape, dev)
    o, lse = prefix_attention_cuda(q, k, v, bias, seed=DROPOUT_SEED,
                                   rate=rate)
    torch.cuda.synchronize()
    ro, rlse = prefix_attention_reference(q, k, v, bias, keep)
    fo, _ = prefix_attention_reference(q.float(), k.float(), v.float(), bias,
                                       keep)
    _, nlse = prefix_attention_reference(q, k, v, bias)
    err_o = (o.float() - ro.float()).abs().max().item()
    err_fp32 = (o.float() - fo).abs().max().item()
    err_lse = (lse - nlse).abs().max().item()      # lse stays dropout-free
    ms = device_ms(lambda: prefix_attention_cuda(q, k, v, bias,
                                                 seed=DROPOUT_SEED, rate=rate))
    event_ms = cuda_ms(lambda: prefix_attention_cuda(
        q, k, v, bias, seed=DROPOUT_SEED, rate=rate))
    plain_ms = device_ms(lambda: prefix_attention_reference(q, k, v, bias,
                                                            keep))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias.to(dtype), dropout_p=rate))
    bound_ms, bound_by, nbytes, flops = k1_bound(b, h, s, t, d, dtype)
    row = {"shape": "train_bf16_dropout", "B": b, "H": h, "S": s, "T": t,
           "D": d, "rate": rate, "max_abs_err_o": err_o,
           "max_abs_err_o_vs_fp32": err_fp32, "max_abs_err_lse": err_lse,
           "atol": K1_ATOL[dtype], "atol_vs_fp32": K1_ATOL_VS_FP32[dtype],
           "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "flops": flops, **shares(dtype, ms, bound_ms, lib_ms)}
    log("k1", json.dumps(row))
    if not (math.isfinite(err_o) and err_o <= K1_ATOL[dtype]
            and err_fp32 <= K1_ATOL_VS_FP32[dtype]
            and err_lse <= K1_ATOL[dtype]):
        raise AssertionError(f"K1 with dropout disagrees with the plain "
                             f"forward on the same masks: {row}")
    return mask_row, row


# ---------------------------------------------------------------------------
# Phase 4: the backward kernel against its plain version.


def k2_bound(b, h, s, t, d, dtype):
    """Least time for the backward: q, o, do read and dq written (S rows),
    k, v read and dk, dv written (T rows), in ``dtype``; lse (fp32) and
    bias (B, 1, 1, T) read once; against the five (S, T, D) products of
    every (b, h)."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (4 * b * h * s * d + 4 * b * h * t * d) * esize \
        + b * h * s * 4 + b * t * 4
    flops = 10 * b * h * s * t * d
    mem_ms = nbytes / HBM_BPS * 1e3
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(mem_ms, op_ms), "bytes" if mem_ms >= op_ms else "operations",
            nbytes, flops)


def check_backward():
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_factors, prefix_attention_bwd_cuda,
        prefix_attention_bwd_reference, prefix_attention_cuda,
        prefix_attention_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = []
    for name, (b, h, s, t, d, dtype) in {
            "train_bf16": (TRAIN_B, 12, TRAIN_S, TRAIN_S + 16, 64,
                           torch.bfloat16),
            "train_fp32": (TRAIN_B, 12, TRAIN_S, TRAIN_S + 16, 64,
                           torch.float32),
            "s512_bf16": (16, 12, 512, 528, 64, torch.bfloat16),
            **SPAN_SHAPES}.items():
        q, k, v, bias = attention_inputs(g, b, h, s, t, d, dtype,
                                         cut=name.endswith("_cut"))
        do = torch.randn(b, h, s, d, device=dev, generator=g).to(dtype)
        for rate in (0.0, 0.1):
            keep = keep_factors(DROPOUT_SEED, rate, (b, h, s, t), dev) \
                if rate else None
            o, lse = prefix_attention_cuda(q, k, v, bias, seed=DROPOUT_SEED,
                                           rate=rate)
            grads = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do,
                                              seed=DROPOUT_SEED, rate=rate)
            torch.cuda.synchronize()
            plain = prefix_attention_bwd_reference(q, k, v, bias, o, lse, do,
                                                   keep)
            leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
            fo, _ = prefix_attention_reference(*leaves, bias, keep)
            auto = torch.autograd.grad(fo, leaves, do.float())
            err = max((a.float() - p.float()).abs().max().item()
                      for a, p in zip(grads, plain))
            err32 = max((a.float() - p).abs().max().item()
                        for a, p in zip(grads, auto))
            del leaves, fo, auto
            passes = device_profile(lambda: prefix_attention_bwd_cuda(
                q, k, v, bias, o, lse, do, seed=DROPOUT_SEED, rate=rate))
            ms = sum(passes.values())
            event_ms = cuda_ms(lambda: prefix_attention_bwd_cuda(
                q, k, v, bias, o, lse, do, seed=DROPOUT_SEED, rate=rate),
                iters=20)
            plain_ms = device_ms(lambda: prefix_attention_bwd_reference(
                q, k, v, bias, o, lse, do, keep))
            lib_ms = sdpa_backward_ms(q, k, v, bias, do, rate)
            bound_ms, bound_by, nbytes, flops = k2_bound(b, h, s, t, d, dtype)
            row = {"shape": name, "B": b, "H": h, "S": s, "T": t, "D": d,
                   "rate": rate, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": err, "max_abs_err_vs_fp32": err32,
                   "atol": K2_ATOL[dtype],
                   "atol_vs_fp32": K2_ATOL_VS_FP32[dtype], "ms": ms,
                   "passes_ms": passes,
                   "event_ms": event_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes, "flops": flops,
                   **shares(dtype, ms, bound_ms, lib_ms)}
            log("k2", json.dumps(row))
            rows.append(row)
            if not (math.isfinite(err) and err <= K2_ATOL[dtype]
                    and err32 <= K2_ATOL_VS_FP32[dtype]):
                raise AssertionError(f"backward kernel disagrees with its "
                                     f"plain version at {name}: {row}")
    return rows


def sdpa_backward_ms(q, k, v, bias, do, rate):
    """SDPA's backward alone (forward + backward less forward), with the
    same additive mask and dropout rate: the library yardstick."""
    import torch.nn.functional as F
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    mask = bias.to(q.dtype)

    def fwd():
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                              dropout_p=rate)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, do)

    both = device_profile(fwd_bwd), device_profile(fwd)
    if any("event_timer" in t for t in both):     # one clock for both
        return cuda_ms(fwd_bwd) - cuda_ms(fwd)
    return sum(both[0].values()) - sum(both[1].values())


# ---------------------------------------------------------------------------
# The flagship model with random weights, and a vocabulary for it.

WORDS = ("the pizza was great but service slow bad battery nice view from "
         "room food cold phone screen love hate this new movie music show "
         "team game city trip hotel staff price quality apple google "
         "president concert night weather").split()


def write_vocab(path):
    pieces = ["##s", "##ing", "##ed", "##ly"]
    tokens = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
              + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
              + WORDS + pieces + list("abcdefghijklmnopqrstuvwxyz"))
    with open(path, "w") as f:
        f.write("\n".join(tokens) + "\n")


def flagship():
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                           init_resnet_params)

    cfg = Config(dataset_name="twitter2015", use_prefix=True, use_152=True,
                 vao=True, use_probe=True, prefix_len=4, bf16=True)
    bert_cfg = BertConfig.base()
    t0 = time.perf_counter()
    params = params_from_jax(init_crf_model_params(cfg, bert_cfg, seed=SEED))
    resnet = params_from_jax(init_resnet_params(cfg.resnet_depth, seed=SEED))
    log(f"params: random flagship weights (seed {SEED}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, bert_cfg, params, resnet


def raw_image(rng):
    """A decoded uint8 RGB image of 240-400 rows and columns from ``rng``:
    random 4×4-pixel blocks (16 times fewer draws than per-pixel noise)."""
    h, w = (int(x) for x in rng.integers(240, 401, 2))
    blocks = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3), np.uint8)
    return np.ascontiguousarray(
        blocks.repeat(4, axis=0).repeat(4, axis=1)[:h, :w])


def native_pixels(rng):
    """The eval transform's rows of :func:`raw_image`, through the C++
    image op (phase 17 holds it against its plain version)."""
    from mtvaf_tpu_torch.native.binding import native_preprocess
    out = native_preprocess(raw_image(rng))
    if out is None:
        raise AssertionError("the native image op is not loaded")
    return out


def requests(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sent = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 40))))
        out.append((sent, native_pixels(rng) if i % 2 == 0 else None))
    return out


# ---------------------------------------------------------------------------
# Phase 5: the decode forward on the card against the CPU.


def check_forward_against_cpu(cfg, bert_cfg, params, resnet, tok):
    from mtvaf_tpu_torch.infer import CrfPredictor

    cfg32 = cfg.replace(bf16=False)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        reqs = requests(2, seed=SEED + 1)
        sents = [s for s, _ in reqs]
        images = np.stack([requests(1, seed=SEED + 2)[0][1]] * 2)
        outs = {}
        for dev in ("cuda", "cpu"):
            pred = CrfPredictor(cfg32, bert_cfg, params, tok,
                                resnet_params=resnet, device=dev)
            host = pred._make_host_batch(sents)
            out = pred.forward(host, images)
            outs[dev] = {k: v.cpu() for k, v in out.items()}
            del pred
        torch.cuda.synchronize()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    em_gpu, em_cpu = outs["cuda"]["emissions"], outs["cpu"]["emissions"]
    scale = max(1.0, em_cpu.abs().max().item())
    err = (em_gpu - em_cpu).abs().max().item()
    valid = torch.from_numpy(host["input_mask"]).bool()
    agree = (outs["cuda"]["pred_tags"] == outs["cpu"]["pred_tags"])[valid]
    log(f"forward fp32 card vs CPU: emissions {tuple(em_gpu.shape)} "
        f"max_abs_err {err:.3e} (limit {1e-3 * scale:.3e}), tags agree "
        f"{int(agree.sum())}/{agree.numel()}")
    if not (torch.isfinite(em_gpu).all() and err <= 1e-3 * scale
            and agree.float().mean().item() >= 0.99):
        raise AssertionError("decode forward on the card disagrees with "
                             "the CPU")


# ---------------------------------------------------------------------------
# Phase 7: the serving path.


def serve(cfg, bert_cfg, params, resnet, tok):
    from mtvaf_tpu_torch.infer import CrfPredictor
    from mtvaf_tpu_torch.kernels.prefix_attention import prefix_attention
    from mtvaf_tpu_torch.serve import BatchingServer

    t0 = time.perf_counter()
    pred = CrfPredictor(cfg, bert_cfg, params, tok, resnet_params=resnet,
                        device="cuda")
    server = BatchingServer(pred, max_batch=16, max_wait_ms=5.0,
                            pipeline_depth=4)
    try:
        server.warmup()
        torch.cuda.synchronize()
        log(f"predictor + warmup: {time.perf_counter() - t0:.1f} s")

        # single-request check of the result's form and the output shape
        host = pred._make_host_batch(["the pizza was great"] * 16)
        out = pred.forward(host, np.zeros((16, 224, 224, 3), np.float32))
        em = out["emissions"]
        if em.shape != (16, cfg.max_seq, cfg.num_crf_labels) \
                or not torch.isfinite(em).all():
            raise AssertionError(f"bf16 emissions {tuple(em.shape)} are "
                                 "malformed or not finite")

        reqs = requests(N_REQUESTS, seed=SEED)
        results = [None] * len(reqs)
        errors = []

        def client(idx):
            try:
                for i in idx:
                    results[i] = server.submit(*reqs[i]).result(timeout=300)
            except BaseException as e:      # re-raised on the main thread
                errors.append(e)

        torch.cuda.synchronize()
        prefix_attention.launches.reset()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(range(c, len(reqs), CLIENTS),))
                   for c in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = prefix_attention.launches.value
        stats = server.stats()
    finally:
        server.close()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client did not finish")
    for r in results:
        if not isinstance(r, list) or not all(
                isinstance(term, str) and pol in ("POS", "NEG", "NEU")
                for term, pol in r):
            raise AssertionError(f"malformed result {r!r}")
    main = {"requests": len(reqs), "served": stats["served"],
            "batches": stats["batches"], "mean_batch": stats["mean_batch"],
            "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
            "wall_s": wall, "sentences_per_s": len(reqs) / wall,
            "k1_launches": launches,
            "entities": sum(len(r) for r in results)}
    log("main_path", json.dumps(main))
    if stats["served"] != len(reqs):
        raise AssertionError(f"served {stats['served']} of {len(reqs)}")
    if launches == 0 or launches != bert_cfg.num_hidden_layers \
            * stats["batches"]:
        raise AssertionError(f"prefix attention kernel launched {launches} "
                             f"times for {stats['batches']} batches")
    return pred, main


# ---------------------------------------------------------------------------
# Phase 8: where one served batch's device time goes.


def breakdown(pred):
    from mtvaf_tpu_torch.infer import _AUX_CROPS, _CROP
    from mtvaf_tpu_torch.nn.bert import bert_model
    from mtvaf_tpu_torch.nn.crf import crf_decode
    from mtvaf_tpu_torch.nn.layers import dense
    from mtvaf_tpu_torch.nn.models import (compute_visual_guides,
                                           prompt_attention_mask,
                                           visual_prompt)

    cfg, dev, dtype = pred.cfg, pred.device, pred.dtype
    host = pred._make_host_batch([s for s, _ in requests(16, seed=7)])
    batch = {k: torch.from_numpy(host[k]).to(dev)
             for k in ("input_ids", "input_mask", "segment_ids")}
    imgs = torch.zeros((16, _CROP, _CROP, 3), device=dev)
    aux = torch.zeros((16, _AUX_CROPS, _CROP, _CROP, 3), device=dev)
    p = pred.params
    with torch.inference_mode():
        guides = compute_visual_guides(pred.resnet_params, imgs, aux,
                                       depth=cfg.resnet_depth)
        kvs, _, _ = visual_prompt(p["prefix"], guides[0].to(dtype),
                                  guides[1].to(dtype), pred.bert_cfg)
        mask = prompt_attention_mask(batch["input_mask"], kvs.shape[-2])
        seq, _ = bert_model(p["bert"], pred.bert_cfg, batch["input_ids"],
                            mask, token_type_ids=batch["segment_ids"],
                            prefix_kvs=kvs, dtype=dtype)
        em = dense(p["fc"], seq).float()
        stages = {
            "resnet_guides_64_images": lambda: compute_visual_guides(
                pred.resnet_params, imgs, aux, depth=cfg.resnet_depth),
            "prefix_kvs": lambda: visual_prompt(
                p["prefix"], guides[0].to(dtype), guides[1].to(dtype),
                pred.bert_cfg),
            "bert_encoder": lambda: bert_model(
                p["bert"], pred.bert_cfg, batch["input_ids"], mask,
                token_type_ids=batch["segment_ids"], prefix_kvs=kvs,
                dtype=dtype),
            "fc_and_viterbi": lambda: crf_decode(
                p["crf"], dense(p["fc"], seq).float(), batch["input_mask"]),
            "whole_forward": lambda: pred.forward(host, np.zeros(
                (16, 224, 224, 3), np.float32)),
        }
        times = {k: cuda_ms(fn, iters=5, warmup=2) for k, fn in stages.items()}
    del em
    log("breakdown_b16_images", json.dumps(times))
    return times


# ---------------------------------------------------------------------------
# Phase 6: one fp32 train step on the card against the CPU.


def check_train_step_against_cpu(cfg, bert_cfg, params, device="cuda",
                                 span=False, aux=False):
    """One fp32 step's loss and gradients on the card against the CPU:
    the CRF step, or with ``span`` the span step, or with ``aux`` the span
    step with its aux heads (``cfg``'s cutoff and GCN heads, the batch
    with GCN side arrays): the base loss and the cut pass's, dropout off,
    the cut drawn on both devices from one host seed.  A leaf that no
    forward reads (``dep_embedding``) is held to 1e-6 absolute."""
    from mtvaf_tpu_torch.data.synthetic import crf_batch, span_batch
    from mtvaf_tpu_torch.nn.models import span_model_loss
    from mtvaf_tpu_torch.train.augment import add_consistency, make_cutoff_fn
    from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_crf_loss_fn,
                                             make_span_loss_fn)

    cfg32 = cfg.replace(bf16=False)
    make_loss, make_batch, pipeline = \
        (make_span_loss_fn, span_batch, "span") if span or aux \
        else (make_crf_loss_fn, crf_batch, "crf")
    loss_fn = make_loss(cfg32, bert_cfg)
    if aux:
        base_fn = loss_fn
        cutoff = make_cutoff_fn(cfg32.aug_type, cfg32.aug_cutoff_ratio)

        def loss_fn(params, batch, generator):
            base, metrics = base_fn(params, batch, None)
            out = span_model_loss(params, cfg32, bert_cfg, batch,
                                  cutoff=(cutoff, torch.Generator()
                                          .manual_seed(SEED + 7)))
            return add_consistency(cfg32, base, metrics, out)
        pipeline = "aux"
    optimizer, _ = build_optimizer(params, cfg32, total_steps=1000,
                                   pipeline="crf" if pipeline == "crf"
                                   else "span")
    batch = make_batch(cfg, bert_cfg, 2, 32, seed=SEED + 5)
    if aux:
        batch.update(gcn_side_arrays(2, 32, seed=SEED + 5))
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in (device, "cpu"):
            state = create_train_state(params, optimizer, device=dev)
            leaves = dict(tree_items(state.params))
            loss, _ = loss_fn(state.params,
                              {k: v.to(dev) for k, v in batch.items()}, None)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            out[dev] = (loss.item(), {path: None if g is None else g.cpu()
                                      for path, g in zip(leaves, grads)})
            del state, leaves, loss, grads
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = out[device], out["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst, worst_path = -1.0, None
    for path, want in g_cpu.items():
        got = g_gpu[path]
        if (got is None) != (want is None):
            raise AssertionError(f"gradient of {path} on one device only")
        if want is None:
            continue
        limit = 1e-6 if path == "dep_embedding" \
            else 1e-3 * max(1.0, want.abs().max().item())
        ratio = (got - want).abs().max().item() / limit
        if not math.isfinite(ratio) or ratio > worst:
            worst, worst_path = ratio, path
    log(f"{pipeline} train step fp32 card vs CPU (B=2, S=32): loss "
        f"{loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} (rel {rel:.2e}, limit 1e-4); worst gradient leaf "
        f"{worst_path} at {worst:.3f} of its limit 1e-3*max(1, max|g|) "
        "(dep_embedding: 1e-6)")
    if not (rel <= 1e-4 and worst <= 1.0):
        raise AssertionError(f"{pipeline} train step on the card disagrees "
                             "with the CPU")
    return {"loss_rel_err": rel, "worst_leaf": worst_path,
            "worst_share_of_limit": worst}


# ---------------------------------------------------------------------------
# Phase 9: the training path.


def train_setup(cfg, bert_cfg, params, device):
    """``bench.py``'s train step on ``device``: (optimizer, state, loss_fn,
    train_step, batch)."""
    from mtvaf_tpu_torch.data.synthetic import crf_batch
    from mtvaf_tpu_torch.train.optim import build_optimizer
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_crf_loss_fn,
                                             make_train_step)

    optimizer, _ = build_optimizer(params, cfg, total_steps=1000,
                                   pipeline="crf")
    state = create_train_state(params, optimizer, device=device)
    loss_fn = make_crf_loss_fn(cfg, bert_cfg)
    batch = {k: v.to(device) for k, v in crf_batch(
        cfg, bert_cfg, TRAIN_B, TRAIN_S, seed=SEED).items()}
    return optimizer, state, loss_fn, make_train_step(loss_fn, optimizer), \
        batch


def train(cfg, bert_cfg, params, device="cuda"):
    from mtvaf_tpu_torch.core.flops import (H100_BF16_PEAK,
                                            train_flops_per_example)
    from mtvaf_tpu_torch.core.rng import fold_in
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_mask_cuda, prefix_attention, prefix_attention_bwd_cuda)
    from mtvaf_tpu_torch.train.optim import tree_items

    t0 = time.perf_counter()
    optimizer, state, loss_fn, train_step, batch = train_setup(
        cfg, bert_cfg, params, device)
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = train_step(state, batch, SEED)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    log(f"train state + {WARMUP_STEPS} untimed steps: "
        f"{time.perf_counter() - t0:.1f} s")

    prefix_attention.launches.reset()
    prefix_attention_bwd_cuda.launches.reset()
    keep_mask_cuda.launches.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        state, metrics = train_step(state, batch, SEED)
        losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = prefix_attention.launches.value, \
        prefix_attention_bwd_cuda.launches.value
    mask_launches = keep_mask_cuda.launches.value
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    losses = [x.item() for x in losses]

    # where one step's device time goes: the step's three parts, timed
    # apart with events (the same calls make_train_step makes)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = [p for _, p in tree_items(state.params)]
    ev[0].record()
    loss, _ = loss_fn(state.params, batch, fold_in(SEED, state.step))
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    ev[2].record()
    optimizer.apply(state.params, grads, state.opt_state)
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "optimizer_ms": ev[2].elapsed_time(ev[3])}

    ex_per_s = TRAIN_B / (step_ms / 1e3)
    flops = train_flops_per_example(bert_cfg, TRAIN_S, prefix_len=16)
    main = {"batch": TRAIN_B, "seq": TRAIN_S, "steps": TIMED_STEPS,
            "step_ms": step_ms, "wall_step_ms": wall / TIMED_STEPS * 1e3,
            "examples_per_s": ex_per_s,
            "wall_examples_per_s": TRAIN_B * TIMED_STEPS / wall,
            "flops_per_example": flops,
            "mfu": flops * ex_per_s / H100_BF16_PEAK,
            "k1_launches": k1, "k2_launches": k2,
            "mask_launches": mask_launches, **split,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": losses}
    log("train_path", json.dumps(main))
    layers = bert_cfg.num_hidden_layers
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not sum(losses[-5:]) / 5 < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    if k1 != layers * TIMED_STEPS or k2 != layers * TIMED_STEPS:
        raise AssertionError(f"K1 ran {k1} and K2 {k2} times in "
                             f"{TIMED_STEPS} steps, not {layers} per step")
    if mask_launches != 0:      # K1 and K2 draw their masks in-kernel
        raise AssertionError(f"the mask entry ran {mask_launches} times in "
                             "the train steps")
    return main


def profile_train(cfg, bert_cfg, params, steps=3):
    """Device busy time of a few train steps (torch.profiler's kernel
    records) against their wall time, and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, state, _, train_step, batch = train_setup(cfg, bert_cfg, params,
                                                 "cuda")
    for _ in range(3):
        state, _ = train_step(state, batch, SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = train_step(state, batch, SEED)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    out = {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
           "top_kernels": [{"name": e.key[:80], "calls": e.count / steps,
                            "ms_per_step": e.self_device_time_total
                            / steps / 1e3} for e in top]}
    log("train_profile", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 10: the trainer, through the CLI, on a synthetic Twitter-2015 tree.

# Twitter-2015's train/dev/test sizes, and the cut the smoke trains on: at
# least 10 steps per epoch at B=32.
TWITTER2015_SIZES = {"train": 3179, "dev": 1122, "test": 1037}
TRAINER_SIZES = {"train": 320, "dev": 96, "test": 96}
TRAINER_EPOCHS = 2
TRAINER_EVAL_BATCH = 16

def trainer_tree(tmp):
    """The reference's data layout (``cli.main.data_paths``) under
    ``tmp``: the Twitter-2015 splits in the ``IMGID:`` TSV format from the
    port's ``data/synthetic.py``, the ANP JSON over 2089 classes, one image
    file per id (empty: nothing is decoded) with its normalized pixel rows
    seeded in the ``.npy`` cache, and a ``bert`` directory with a vocab."""
    import os
    from mtvaf_tpu_torch.data.synthetic import make_crf_files, make_vocab_file

    root = os.path.join(tmp, "data")
    base = os.path.join(root, "twitter2015", "twitter2015")
    img_dir = os.path.join(root, "twitter2015_images")
    pix_dir = os.path.join(tmp, "cache", "img")
    for d in (base, img_dir, pix_dir, os.path.join(root, "ANP_data"),
              os.path.join(tmp, "bert")):
        os.makedirs(d, exist_ok=True)
    anp, ids = {}, []
    rng = np.random.default_rng(SEED)
    for k, (mode, fname) in enumerate((("train", "train.txt"),
                                       ("dev", "valid.txt"),
                                       ("test", "test.txt"))):
        split_ids = [f"{700000 + 10000 * k + i}.jpg"
                     for i in range(TRAINER_SIZES[mode])]
        make_crf_files(os.path.join(base, fname),
                       os.path.join(tmp, f"anp_{mode}.json"),
                       TRAINER_SIZES[mode], seed=SEED + k, max_len=30,
                       num_anp=2089, image_ids=split_ids)
        with open(os.path.join(tmp, f"anp_{mode}.json")) as f:
            anp.update(json.load(f))
        ids += split_ids
    with open(os.path.join(root, "ANP_data", "image_output2015.json"),
              "w") as f:
        json.dump(anp, f)
    seed_pixel_cache(img_dir, pix_dir, ids, rng)
    make_vocab_file(os.path.join(tmp, "bert", "vocab.txt"))
    return root, os.path.join(tmp, "bert"), os.path.join(tmp, "cache"), ids


def seed_pixel_cache(img_dir, pix_dir, ids, rng):
    """One empty image file per id, with its normalized pixel rows in the
    ``.npy`` cache that ``ImageStore`` reads first, so that nothing is
    decoded: each a random :func:`raw_image` from ``rng`` through the
    native image op (:func:`native_pixels`), as ``ImageStore`` would have
    made them from a file."""
    for img in ids:
        open(os.path.join(img_dir, img), "wb").close()
        np.save(os.path.join(pix_dir, img + ".npy"), native_pixels(rng))


def run_cli(argv, bert_cfg, on_epoch_log=None, span=False, on_trainer=None):
    """``cli.main.main(argv)`` with the trainer it built kept (and its
    params at the end of ``train()``, before the CLI reloads the best
    model); ``on_epoch_log`` is called with each trainer log message and
    ``on_trainer`` with the trainer once it is built.  ``span``: the run
    trains the span model (``SpanTrainer``)."""
    import logging
    import mtvaf_tpu_torch.train.trainer_crf as trainer_crf
    import mtvaf_tpu_torch.train.trainer_span as trainer_span
    from mtvaf_tpu_torch.cli.main import main as cli_main
    from mtvaf_tpu_torch.train.optim import tree_items

    made = []
    module, cls_name = (trainer_span, "SpanTrainer") if span \
        else (trainer_crf, "CrfTrainer")
    base_cls = getattr(module, cls_name)

    class Kept(base_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
            if on_trainer:
                on_trainer(self)

        def train(self):
            out = super().train()
            self.trained_params = {k: v.detach().clone()
                                   for k, v in tree_items(self.state.params)}
            return out

    class Hook(logging.Handler):
        def emit(self, record):
            on_epoch_log(record.getMessage())

    log = logging.getLogger(module.__name__)
    hook = Hook() if on_epoch_log else None
    setattr(module, cls_name, Kept)
    if hook:
        log.addHandler(hook)
    try:
        metrics = cli_main(argv, bert_cfg_override=bert_cfg,
                           device=DEVICE)
    finally:
        setattr(module, cls_name, base_cls)
        if hook:
            log.removeHandler(hook)
    return metrics, made[0]


def _trainer_argv(root, bert_dir, cache, save, *extra):
    return ["--dataset_name", "twitter2015", "--bert_name", bert_dir,
            "--data_root", root, "--save_path", save, "--cache_dir", cache,
            "--use_prefix", "--use_152", "--vao", "--use_probe", "--bf16",
            "--max_seq", str(TRAIN_S), "--train_batch_size", str(TRAIN_B),
            "--eval_batch_size", str(TRAINER_EVAL_BATCH),
            "--num_epochs", str(TRAINER_EPOCHS), "--eval_begin_epoch", "1",
            "--seed", str(SEED), *extra]


def keep_run(save, bert_dir, keep, name):
    """Move a run directory (without its checkpoints) and copy its
    tokenizer directory into ``keep`` for phase 13; returns their paths."""
    import shutil
    run = shutil.move(save, os.path.join(keep, f"{name}_run"))
    shutil.rmtree(os.path.join(run, "ckpt"), ignore_errors=True)
    bert = shutil.copytree(bert_dir, os.path.join(keep, f"{name}_bert"))
    return run, bert


def trainer_phase(bare_step, keep):
    """Phase 10: train the flagship configuration through the CLI for two
    epochs, check launches, devices and files, reload the best model into
    a predictor, time eval and checkpoints; then preempt a run with a real
    SIGTERM after epoch 1, resume it, and hold the result against an
    uninterrupted run.  The run directory goes to ``keep`` (phase 13)."""
    import os
    import shutil
    from mtvaf_tpu_torch.core.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mtvaf_tpu_torch.data.readers import PLACEHOLDER
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_mask_cuda, prefix_attention, prefix_attention_bwd_cuda)
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.train.optim import tree_items

    bert_cfg = BertConfig.base()
    layers = bert_cfg.num_hidden_layers
    counters = (prefix_attention.launches, prefix_attention_bwd_cuda.launches,
                keep_mask_cuda.launches)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root, bert_dir, cache, ids = trainer_tree(tmp)
        log(f"trainer data: {TRAINER_SIZES} examples (train/dev/test) cut "
            f"from Twitter-2015's {TWITTER2015_SIZES}, {len(ids)} images "
            f"in the pixel cache, in {time.perf_counter() - t0:.1f} s")
        save = os.path.join(tmp, "run")
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        metrics, tr = run_cli(_trainer_argv(root, bert_dir, cache, save,
                                            "--do_train",
                                            "--save_checkpoints"), bert_cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2, masks = (c.value for c in counters)

        steps = sum(h["steps"] for h in tr.history)
        per_eval = sum(-(-len(d) // TRAINER_EVAL_BATCH)
                       for d in (tr.dev_dataset, tr.test_dataset))
        eval_batches = TRAINER_EPOCHS * per_eval \
            + -(-len(tr.test_dataset) // TRAINER_EVAL_BATCH)
        losses = [h["train_loss"] for h in tr.history]
        if not all(math.isfinite(x) for x in losses) or not all(
                math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite trainer result: {losses} "
                                 f"{metrics}")
        if steps != TRAINER_EPOCHS * -(-TRAINER_SIZES["train"] // TRAIN_B):
            raise AssertionError(f"{steps} train steps")
        if k2 != layers * steps or k1 != layers * (steps + eval_batches):
            raise AssertionError(
                f"K1 ran {k1} and K2 {k2} times for {steps} train steps and "
                f"{eval_batches} eval batches: not {layers} K1 + {layers} K2 "
                f"per step and {layers} K1 per eval batch")
        if masks != 0:
            raise AssertionError(f"the mask entry ran {masks} times")
        gc = tr.guide_cache
        tensors = [p for _, p in tree_items(tr.state.params)] \
            + list(tr.state.opt_state.mu) + list(tr.state.opt_state.nu) \
            + [gc._dev_main, gc._dev_aux]
        if any(t is None or not t.is_cuda for t in tensors):
            raise AssertionError("a parameter, moment or guide-table tensor "
                                 "is not on the card")
        fallbacks = sum(i == PLACEHOLDER for d in (tr.train_dataset,
                                                   tr.dev_dataset,
                                                   tr.test_dataset)
                        for i in d.image_ids)
        rows = torch.tensor(sorted(gc._dev_rows.values()),
                            device="cuda")
        zero_rows = int((gc._dev_main.index_select(0, rows).float().abs()
                         .amax(dim=(1, 2)) == 0).sum())
        if fallbacks or zero_rows or gc.computed != len(ids):
            raise AssertionError(
                f"{fallbacks} examples fell back to the placeholder image, "
                f"{zero_rows} main-guide rows are all zeros, "
                f"{gc.computed} of {len(ids)} images got guides")
        for name in ("best_model.npz", "dev_predictions.json",
                     "test_predictions.json", "final_metrics.json",
                     "run_config.json", "ckpt/step_2"):
            if not os.path.exists(os.path.join(save, name)):
                raise AssertionError(f"the run wrote no {name}")

        predictor = check_predictor(tr, save)

        # eval alone: one pass over each split, K1 counted per batch
        evals = {}
        for name, ds in (("dev", tr.dev_dataset), ("test", tr.test_dataset)):
            prefix_attention.launches.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._predict(ds)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_batches = -(-len(ds) // TRAINER_EVAL_BATCH)
            if prefix_attention.launches.value != layers * n_batches:
                raise AssertionError(
                    f"{name} eval: K1 ran {prefix_attention.launches.value} "
                    f"times in {n_batches} batches")
            evals[name] = {"sentences": len(ds), "seconds": dt,
                           "sentences_per_s": len(ds) / dt}

        # checkpoint write and load of the full train state
        ckpt = os.path.join(tmp, "ckpt_timing")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt, tr.state, step=99)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_checkpoint(ckpt, tr.state, 99)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(path)
        shutil.rmtree(ckpt)
        split = step_split(tr)
        guide = {"images": gc.computed, "seconds": gc.compute_s,
                 "ms_per_image": gc.compute_s / gc.computed * 1e3}
        out = {"epochs": tr.history, "wall_s": wall,
               "bare_step_examples_per_s": bare_step["examples_per_s"],
               "bare_step_wall_examples_per_s":
                   bare_step["wall_examples_per_s"],
               "guide_fill": guide, "eval": evals,
               "checkpoint": {"bytes": ckpt_bytes, "write_s": write_s,
                              "load_s": load_s},
               "step_split": split,
               "train_steps": steps, "eval_batches": eval_batches,
               "k1_launches": k1, "k2_launches": k2, "mask_launches": masks,
               "metrics": metrics}
        out["predictor"] = predictor
        del tr
        out["kept"] = keep_run(save, bert_dir, keep, "crf")
        torch.cuda.empty_cache()
        log("trainer_path", json.dumps(out))

        out["resume"] = resume_in_child(root, bert_dir, cache, tmp)
    return out


def check_predictor(tr, save):
    """Training feeds serving: the port's ``load_predictor`` on the run
    directory holds the trainer's best model bit for bit (the trainer's
    state is that model once the CLI's test has reloaded it), its forward
    on a dev batch gives the emissions and the tags of the trainer's
    decode step on the same batch, and it answers raw sentences."""
    from mtvaf_tpu_torch.data.datasets import iterate_batches
    from mtvaf_tpu_torch.infer import load_predictor, serving_params
    from mtvaf_tpu_torch.nn.models import crf_model_forward
    from mtvaf_tpu_torch.train.optim import tree_items
    from mtvaf_tpu_torch.train.steps import _split_guides, export_params

    pred = load_predictor(save, device="cuda")
    want = dict(tree_items(serving_params(export_params(tr.state),
                                          pred.dtype, pred.device)))
    got = dict(tree_items(pred.params))
    if got.keys() != want.keys():
        raise AssertionError(f"the predictor's params differ in keys: "
                             f"{sorted(got.keys() ^ want.keys())[:8]}")
    differ = [k for k in want if got[k].dtype != want[k].dtype
              or not torch.equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"the predictor's params differ from the "
                             f"trainer's best model in {differ[:8]}")

    ds = tr.dev_dataset
    batch = tr._attach_guides(
        next(iterate_batches(ds.arrays, TRAINER_EVAL_BATCH)), ds)
    batch.pop("batch_valid")
    dev = tr._device_batch(batch)
    trained = tr.decode_step(tr.state.params, dev)
    with torch.inference_mode():
        served = crf_model_forward(
            pred.params, pred.cfg, pred.bert_cfg, dev,
            visual_guides=_split_guides(dev), dtype=pred.dtype,
            with_loss=False, with_decode=True)
        again = crf_model_forward(
            export_params(tr.state), tr.cfg, tr.bert_cfg, dev,
            visual_guides=_split_guides(dev), dtype=pred.dtype,
            with_loss=False, with_decode=True)
    if not torch.equal(served["emissions"], again["emissions"]):
        gap = (served["emissions"] - again["emissions"]).abs().max().item()
        raise AssertionError("the predictor's emissions differ from the "
                             f"trainer's by {gap}")
    if not torch.equal(served["pred_tags"], trained["pred_tags"]):
        raise AssertionError("the predictor's tags differ from the "
                             "trainer's decode step on a dev batch")
    mask = dev["input_mask"].bool()
    outside = tr.label_map["O"]
    tagged = int(((trained["pred_tags"] != outside) & mask).sum())

    answers = pred.predict(["the pizza was great", "service slow",
                            "nice view from the room"])
    if len(answers) != 3 or not all(
            isinstance(r, list) and all(
                isinstance(term, str) and pol in ("POS", "NEG", "NEU")
                for term, pol in r) for r in answers):
        raise AssertionError(f"malformed predictions {answers!r}")
    del pred
    torch.cuda.empty_cache()
    return {"params_bitwise": len(want), "dev_rows_compared": int(len(mask)),
            "dev_tokens_tagged_not_O": tagged, "answers": answers}


def resume_in_child(root, bert_dir, cache, tmp, timeout=600):
    """:func:`check_resume` in a process of its own: deterministic mode
    needs cuBLAS's workspace fixed before cuBLAS starts, which would also
    change the timed phases of this process.  Returns its result line."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--resume-check", root,
         bert_dir, cache, tmp], env=env, capture_output=True, text=True,
        timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("trainer_resume ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stderr[-8000:])
        raise AssertionError(f"the resume check exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}")
    log(lines[-1])
    return json.loads(lines[-1].split(" ", 1)[1])


def step_split(tr, steps=10):
    """Where an epoch's time goes: the trainer's step (its forward also
    decodes the train tags) and the same step without the decode, each
    timed over ``steps`` steps on one batch (host clock, synchronised);
    the rest of a steady epoch's time per step is the host's ingest."""
    from mtvaf_tpu_torch.data.datasets import iterate_batches
    from mtvaf_tpu_torch.train.steps import make_crf_loss_fn, make_train_step

    ds = tr.train_dataset
    batch = tr._attach_guides(next(iterate_batches(ds.arrays, TRAIN_B)), ds)
    batch.pop("batch_valid")
    dev = tr._device_batch(batch)
    without = make_train_step(make_crf_loss_fn(tr.cfg, tr.bert_cfg),
                              tr.optimizer)
    out = {}
    for name, step in (("step_with_decode_ms", tr.train_step),
                       ("step_without_decode_ms", without)):
        for _ in range(3):
            tr.state, _ = step(tr.state, dev, SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.state, _ = step(tr.state, dev, SEED)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / steps * 1e3
    last = tr.history[-1]
    out["epoch_ms_per_step"] = last["seconds"] / last["steps"] * 1e3
    out["ingest_ms_per_step"] = out["epoch_ms_per_step"] \
        - out["step_with_decode_ms"]
    return out


def check_resume(root, bert_dir, cache, tmp):
    """A run stopped by a real SIGTERM after epoch 1 and resumed, against
    an uninterrupted run, under ``torch.use_deterministic_algorithms``:
    the end-of-training params and the optimizer state must be bitwise
    equal.  An op without a deterministic CUDA implementation is named
    (the mode only warns) and fails the check."""
    import signal
    import warnings
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.train import resume as resume_mod

    bert_cfg = BertConfig.base()

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, straight = run_cli(_trainer_argv(
                root, bert_dir, cache, os.path.join(tmp, "straight"),
                "--do_train"), bert_cfg)
            snap_a = (straight.trained_params, straight.state.step,
                      [m.clone() for m in straight.state.opt_state.mu],
                      [v.clone() for v in straight.state.opt_state.nu])
            del straight
            torch.cuda.empty_cache()

            def kill_after_epoch_1(msg):
                if msg.startswith("epoch 1 train loss"):
                    os.kill(os.getpid(), signal.SIGTERM)

            pre = os.path.join(tmp, "preempted")
            resume_mod.clear_stop()
            _, first = run_cli(_trainer_argv(
                root, bert_dir, cache, pre, "--do_train",
                "--save_checkpoints", "--checkpoint_every", "99"), bert_cfg,
                on_epoch_log=kill_after_epoch_1)
            stopped_at = first.state.step
            written = sorted(os.listdir(os.path.join(pre, "ckpt")))
            del first
            torch.cuda.empty_cache()
            _, rest = run_cli(_trainer_argv(
                root, bert_dir, cache, pre, "--do_train", "--resume",
                "--save_checkpoints", "--checkpoint_every", "99"), bert_cfg)
        nondeterministic = sorted({str(w.message)[:160] for w in caught
                                   if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(prev)
    steps_per_epoch = -(-TRAINER_SIZES["train"] // TRAIN_B)
    if stopped_at != steps_per_epoch or written != ["meta_1.json",
                                                    "step_1"]:
        raise AssertionError(f"the preempted run stopped at step "
                             f"{stopped_at} and wrote {written}")
    params_a, step_a, mu_a, nu_a = snap_a
    diffs = {"params": max((rest.trained_params[k].float()
                            - params_a[k].float()).abs().max().item()
                           for k in params_a),
             "mu": max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(mu_a, rest.state.opt_state.mu)),
             "nu": max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(nu_a, rest.state.opt_state.nu))}
    bitwise = all(torch.equal(rest.trained_params[k], params_a[k])
                  for k in params_a) \
        and all(torch.equal(a, b) for a, b in zip(mu_a,
                                                  rest.state.opt_state.mu)) \
        and all(torch.equal(a, b) for a, b in zip(nu_a,
                                                  rest.state.opt_state.nu))
    out = {"stopped_at_step": stopped_at, "checkpoint_files": written,
           "steps": [step_a, rest.state.step], "bitwise": bitwise,
           "max_abs_diff": diffs, "nondeterministic_ops": nondeterministic}
    del rest
    torch.cuda.empty_cache()
    log("trainer_resume", json.dumps(out))
    if nondeterministic:
        raise AssertionError("ops without a deterministic CUDA "
                             f"implementation ran: {nondeterministic}")
    if out["steps"][0] != out["steps"][1] or not bitwise:
        raise AssertionError("the resumed run differs from the "
                             f"uninterrupted one: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the span pipeline (text-only BERT-base, twitter15).

SPAN_N_BEST, SPAN_WIDTH = 20, 12    # the reference's n_best_size and
                                    # max_answer_length
TWITTER15_SIZES = {"train": 3179, "dev": 1122, "test": 1037}


def span_config():
    from mtvaf_tpu_torch.core.config import Config
    return Config(dataset_name="twitter15", bf16=True, max_seq=TRAIN_S,
                  n_best_size=SPAN_N_BEST, max_answer_length=SPAN_WIDTH)


def span_train(bert_cfg):
    """(a) The bare span train step: ``make_span_loss_fn`` →
    ``make_train_step`` on one fixed ``span_batch`` (B=32, S=128, n_best
    20, W=12), bf16, dropout live, 15 untimed and 30 timed steps."""
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.core.flops import (H100_BF16_PEAK,
                                            train_flops_per_example)
    from mtvaf_tpu_torch.data.synthetic import span_batch
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_mask_cuda, prefix_attention, prefix_attention_bwd_cuda)
    from mtvaf_tpu_torch.nn.models import init_span_model_params
    from mtvaf_tpu_torch.train.optim import build_optimizer
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_span_loss_fn,
                                             make_train_step)

    cfg = span_config()
    t0 = time.perf_counter()
    params = params_from_jax(init_span_model_params(cfg, bert_cfg,
                                                    seed=SEED))
    optimizer, _ = build_optimizer(params, cfg, total_steps=1000,
                                   pipeline="span")
    state = create_train_state(params, optimizer, device="cuda")
    step = make_train_step(make_span_loss_fn(cfg, bert_cfg), optimizer)
    batch = {k: v.cuda() for k, v in span_batch(
        cfg, bert_cfg, TRAIN_B, TRAIN_S, seed=SEED).items()}
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, batch, SEED)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counters = (prefix_attention.launches, prefix_attention_bwd_cuda.launches,
                keep_mask_cuda.launches)
    for c in counters:
        c.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        state, metrics = step(state, batch, SEED)
        losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, masks = (c.value for c in counters)
    losses = [x.item() for x in losses]
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    ex_per_s = TRAIN_B / (step_ms / 1e3)
    flops = train_flops_per_example(bert_cfg, TRAIN_S, prefix_len=0)
    out = {"batch": TRAIN_B, "seq": TRAIN_S, "n_best": SPAN_N_BEST,
           "width": SPAN_WIDTH, "steps": TIMED_STEPS,
           "setup_and_untimed_s": setup_s, "step_ms": step_ms,
           "wall_step_ms": wall / TIMED_STEPS * 1e3,
           "examples_per_s": ex_per_s,
           "wall_examples_per_s": TRAIN_B * TIMED_STEPS / wall,
           "flops_per_example": flops,
           "mfu": flops * ex_per_s / H100_BF16_PEAK,
           "k1_launches": k1, "k2_launches": k2, "mask_launches": masks,
           "losses": losses}
    log("span_train_step", json.dumps(out))
    layers = bert_cfg.num_hidden_layers
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite span train loss: {losses}")
    if not sum(losses[-5:]) / 5 < losses[0]:
        raise AssertionError(f"span train loss did not fall: {losses}")
    if k1 != layers * TIMED_STEPS or k2 != layers * TIMED_STEPS or masks:
        raise AssertionError(f"K1 ran {k1}, K2 {k2} and the mask entry "
                             f"{masks} times in {TIMED_STEPS} span steps")
    del state, params
    torch.cuda.empty_cache()
    return out


def span_tree(tmp):
    """The reference's span layout under ``tmp`` (``data/twitter2015/
    {train,valid,test}.txt``, learnable sentences from the port's
    ``data/synthetic.py``) and a ``bert`` directory with a vocab."""
    from mtvaf_tpu_torch.data.synthetic import (make_learnable_span_file,
                                                make_vocab_file)
    root = os.path.join(tmp, "span_data")
    base = os.path.join(root, "twitter2015")
    bert_dir = os.path.join(tmp, "span_bert")
    for d in (base, bert_dir):
        os.makedirs(d, exist_ok=True)
    for k, (mode, fname) in enumerate((("train", "train.txt"),
                                       ("dev", "valid.txt"),
                                       ("test", "test.txt"))):
        make_learnable_span_file(os.path.join(base, fname),
                                 TRAINER_SIZES[mode], seed=SEED + k)
    make_vocab_file(os.path.join(bert_dir, "vocab.txt"))
    return root, bert_dir


def span_requests(n, seed):
    from mtvaf_tpu_torch.data.synthetic import WORDS as SYN_WORDS
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(SYN_WORDS, size=int(rng.integers(3, 30))))
            for _ in range(n)]


def span_phase(bare_step):
    """Phase 11: (a) the bare span train step; (b) one fp32 span step on
    the card against the CPU; (c) the span trainer through the CLI for two
    epochs; (d) ``load_predictor`` on its run directory behind
    ``BatchingServer``, held to ``predict_many`` and, on a dev batch, to
    the trainer's extraction step bit for bit."""
    import mtvaf_tpu_torch.train.trainer_span as trainer_span
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.data.datasets import iterate_batches
    from mtvaf_tpu_torch.infer import (SpanPredictor, load_predictor,
                                       serving_params)
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_mask_cuda, prefix_attention, prefix_attention_bwd_cuda)
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import init_span_model_params
    from mtvaf_tpu_torch.serve import BatchingServer
    from mtvaf_tpu_torch.train.optim import tree_items
    from mtvaf_tpu_torch.train.steps import export_params

    bert_cfg = BertConfig.base()
    layers = bert_cfg.num_hidden_layers
    t_phase = time.perf_counter()
    out = {"train_step": span_train(bert_cfg)}
    out["bare_crf_step_examples_per_s"] = bare_step["examples_per_s"]

    # (b) one fp32 span step, card against CPU
    cfg = span_config()
    out["fp32_step_vs_cpu"] = check_train_step_against_cpu(
        cfg, bert_cfg, params_from_jax(init_span_model_params(
            cfg, bert_cfg, seed=SEED + 6)), span=True)
    torch.cuda.empty_cache()

    counters = (prefix_attention.launches, prefix_attention_bwd_cuda.launches,
                keep_mask_cuda.launches)
    with tempfile.TemporaryDirectory() as tmp:
        # (c) the trainer through the CLI
        root, bert_dir = span_tree(tmp)
        save = os.path.join(tmp, "span_run")
        # --logit_threshold 0: with random weights no start + end logit
        # pair reaches the reference's 8.0, so eval would pick nothing (its
        # loss the reference's NaN) and serving would answer only empty
        # lists, leaving the checks below nothing to compare
        argv = ["--dataset_name", "twitter15", "--bert_name", bert_dir,
                "--logit_threshold", "0",
                "--data_root", root, "--save_path", save, "--bf16",
                "--max_seq", str(TRAIN_S), "--train_batch_size",
                str(TRAIN_B), "--eval_batch_size", str(TRAINER_EVAL_BATCH),
                "--num_epochs", str(TRAINER_EPOCHS), "--eval_begin_epoch",
                "1", "--seed", str(SEED), "--do_train", "--save_checkpoints"]
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        metrics, tr = run_cli(argv, bert_cfg, span=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2, masks = (c.value for c in counters)
        steps = sum(h["steps"] for h in tr.history)
        eval_batches = TRAINER_EPOCHS * -(-len(tr.dev_dataset)
                                          // TRAINER_EVAL_BATCH) \
            + -(-len(tr.test_dataset) // TRAINER_EVAL_BATCH)
        losses = [h["train_loss"] for h in tr.history]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite span trainer loss: {losses}")
        if steps != TRAINER_EPOCHS * -(-TRAINER_SIZES["train"] // TRAIN_B):
            raise AssertionError(f"{steps} span train steps")
        if k2 != layers * steps or k1 != layers * (steps + eval_batches) \
                or masks:
            raise AssertionError(
                f"K1 ran {k1}, K2 {k2}, the mask entry {masks} times for "
                f"{steps} span train steps and {eval_batches} eval "
                f"batches: not {layers} K1 + {layers} K2 per step and "
                f"{layers} K1 per eval batch")
        if any(not p.is_cuda for _, p in tree_items(tr.state.params)):
            raise AssertionError("a span parameter is not on the card")
        for name in ("best_model.npz", "train_predictions.json",
                     "dev_predictions.json", "test_predictions.json",
                     "final_metrics.json", "run_config.json", "ckpt/step_2"):
            if not os.path.exists(os.path.join(save, name)):
                raise AssertionError(f"the span run wrote no {name}")

        # eval alone, with the host's candidate/NMS share of its wall time
        host = {"s": 0.0}
        picker = trainer_span.batch_eval_candidates

        def timed_picker(*a, **kw):
            t = time.perf_counter()
            try:
                return picker(*a, **kw)
            finally:
                host["s"] += time.perf_counter() - t

        evals = {}
        trainer_span.batch_eval_candidates = timed_picker
        try:
            for name, ds in (("dev", tr.dev_dataset),
                             ("test", tr.test_dataset)):
                prefix_attention.launches.reset()
                host["s"] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, loss = tr._predict(ds, compute_loss=True)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                n_batches = -(-len(ds) // TRAINER_EVAL_BATCH)
                if prefix_attention.launches.value != layers * n_batches:
                    raise AssertionError(
                        f"span {name} eval: K1 ran "
                        f"{prefix_attention.launches.value} times in "
                        f"{n_batches} batches")
                evals[name] = {"sentences": len(ds), "seconds": dt,
                               "sentences_per_s": len(ds) / dt,
                               "host_candidates_s": host["s"],
                               "host_candidates_share": host["s"] / dt,
                               "loss": loss}
        finally:
            trainer_span.batch_eval_candidates = picker
        out["trainer"] = {
            "epochs": tr.history, "wall_s": wall, "metrics": metrics,
            "sizes": TRAINER_SIZES, "cut_from": TWITTER15_SIZES,
            "bare_step_examples_per_s": out["train_step"]["examples_per_s"],
            "train_steps": steps, "eval_batches": eval_batches,
            "k1_launches": k1, "k2_launches": k2, "mask_launches": masks,
            "eval": evals}
        log("span_trainer_path", json.dumps(out["trainer"]))

        # (d) serving the run directory; every serving leaf equals the
        # trainer's (this model has no prefix: a span predictor keeps its
        # prefix generator in fp32, which phase 12 checks)
        pred = load_predictor(save, device="cuda")
        if not isinstance(pred, SpanPredictor):
            raise AssertionError(f"load_predictor built {type(pred)}")
        want = dict(tree_items(serving_params(export_params(tr.state),
                                              pred.dtype, pred.device)))
        got = dict(tree_items(pred.params))
        if got.keys() != want.keys() or any(
                got[k].dtype != want[k].dtype
                or not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("the span predictor's params differ from "
                                 "the trainer's best model")
        ds = tr.dev_dataset
        b = next(iterate_batches(ds.arrays, TRAINER_EVAL_BATCH))
        b.pop("batch_valid")
        s_tr, e_tr, _, _ = tr.extraction_step(tr.state.params,
                                              tr._device_batch(b))
        s_pr, e_pr, _, _ = pred.extract(
            {k: b[k].astype(np.int64) for k in ("input_ids", "input_mask",
                                                "segment_ids")})
        if not (torch.equal(s_tr, s_pr) and torch.equal(e_tr, e_pr)):
            gap = max((s_tr - s_pr).abs().max().item(),
                      (e_tr - e_pr).abs().max().item())
            raise AssertionError("the predictor's extraction logits differ "
                                 f"from the trainer's by {gap}")
        del tr
        torch.cuda.empty_cache()

        sents = span_requests(N_REQUESTS, seed=SEED + 11)
        server = BatchingServer(pred, max_batch=16, max_wait_ms=5.0,
                                pipeline_depth=4)
        results, errors = [None] * len(sents), []
        try:
            server.warmup()
            torch.cuda.synchronize()

            def client(idx):
                try:
                    for i in idx:
                        results[i] = server.submit(sents[i]).result(
                            timeout=300)
                except BaseException as e:    # re-raised on the main thread
                    errors.append(e)

            prefix_attention.launches.reset()
            t0 = time.perf_counter()
            threads = [threading.Thread(
                target=client, args=(range(c, len(sents), CLIENTS),))
                for c in range(CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            torch.cuda.synchronize()
            serve_wall = time.perf_counter() - t0
            serve_k1 = prefix_attention.launches.value
            stats = server.stats()
        finally:
            server.close()
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise AssertionError("a span client did not finish")
        many = pred.predict_many(sents, batch_size=16)
        if results != many:
            bad = [i for i, (r, m) in enumerate(zip(results, many)) if r != m]
            raise AssertionError(f"served span results differ from "
                                 f"predict_many at requests {bad[:8]}")
        if stats["served"] != len(sents) or serve_k1 != layers \
                * stats["batches"]:
            raise AssertionError(f"span serving: served {stats['served']}, "
                                 f"K1 ran {serve_k1} times for "
                                 f"{stats['batches']} batches")
        out["serve"] = {"requests": len(sents), "batches": stats["batches"],
                        "mean_batch": stats["mean_batch"],
                        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                        "wall_s": serve_wall,
                        "sentences_per_s": len(sents) / serve_wall,
                        "k1_launches": serve_k1,
                        "spans": sum(len(r) for r in results),
                        "extraction_bitwise_rows": TRAINER_EVAL_BATCH,
                        "params_bitwise": len(want)}
        log("span_serve_path", json.dumps(out["serve"]))
        del pred
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"span phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the span pipeline's aux heads (cutoff augmentation, DiGCN,
# DualGCN), BERT-base, twitter15, bf16.

AUX_GCN_LAYERS, AUX_DUAL_LAYERS = 2, 2


def aux_config():
    return span_config().replace(
        do_aug=True, aug_type="span_cutoff", aug_cutoff_ratio=CUT_RATIO,
        aug_ce_loss=1.0, aug_js_loss=1.0, gcn_layer_number=AUX_GCN_LAYERS,
        num_layers=AUX_DUAL_LAYERS)


def gcn_side_arrays(b, s, seed):
    """GCN side arrays for a batch of full-length rows, from ``seed``: a
    dependency adjacency (a random tree over the tokens, plus self-loops)
    as both ``adj_matrix`` and ``adjacency_matrix``, ``src_mask``, a
    two-token ``aspect_mask``, ``polaritys`` and ``valid_ids``."""
    rng = np.random.RandomState(seed)
    adj = np.zeros((b, s, s), np.float32)
    aspect = np.zeros((b, s), np.int64)
    for i in range(b):
        for t in range(1, s):
            p = rng.randint(0, t)
            adj[i, t, p] = adj[i, p, t] = 1.0
        adj[i][np.arange(s), np.arange(s)] = 1.0
        a = rng.randint(1, s - 2)
        aspect[i, a:a + 2] = 1
    valid = (rng.rand(b, s) > 0.2).astype(np.int64)
    valid[:, 0] = 1
    adj = torch.from_numpy(adj)
    return {"adj_matrix": adj, "adjacency_matrix": adj,
            "src_mask": torch.ones((b, s), dtype=torch.int64),
            "aspect_mask": torch.from_numpy(aspect),
            "polaritys": torch.from_numpy(rng.randint(0, 3, (b,))),
            "valid_ids": torch.from_numpy(valid)}


def aux_train(bert_cfg, span_step):
    """(a) The bare aux train step: ``make_span_loss_fn`` + the cutoff's
    ``augment_fn`` → ``make_train_step`` on one fixed ``span_batch`` (B=32,
    S=128) with GCN side arrays, bf16, dropout live, 15 untimed and 30
    timed steps; two encoder passes per step (the base and the cut one)."""
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.core.flops import (H100_BF16_PEAK,
                                            train_flops_per_example)
    from mtvaf_tpu_torch.data.synthetic import span_batch
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_mask_cuda, prefix_attention, prefix_attention_bwd_cuda)
    from mtvaf_tpu_torch.nn.models import init_span_model_params
    from mtvaf_tpu_torch.train.augment import make_span_augment_fn
    from mtvaf_tpu_torch.train.optim import build_optimizer
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_span_loss_fn,
                                             make_train_step)

    cfg = aux_config()
    t0 = time.perf_counter()
    params = params_from_jax(init_span_model_params(cfg, bert_cfg,
                                                    seed=SEED))
    optimizer, _ = build_optimizer(params, cfg, total_steps=1000,
                                   pipeline="span")
    state = create_train_state(params, optimizer, device="cuda")
    step = make_train_step(make_span_loss_fn(cfg, bert_cfg), optimizer,
                           augment_fn=make_span_augment_fn(cfg, bert_cfg))
    batch = span_batch(cfg, bert_cfg, TRAIN_B, TRAIN_S, seed=SEED)
    batch.update(gcn_side_arrays(TRAIN_B, TRAIN_S, seed=SEED))
    batch = {k: v.cuda() for k, v in batch.items()}
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, batch, SEED)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counters = (prefix_attention.launches, prefix_attention_bwd_cuda.launches,
                keep_mask_cuda.launches)
    for c in counters:
        c.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        state, metrics = step(state, batch, SEED)
        losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, masks = (c.value for c in counters)
    losses = [x.item() for x in losses]
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    ex_per_s = TRAIN_B / (step_ms / 1e3)
    # two encoder passes per example; the heads' FLOPs are left out
    flops = 2 * train_flops_per_example(bert_cfg, TRAIN_S, prefix_len=0)
    out = {"batch": TRAIN_B, "seq": TRAIN_S, "steps": TIMED_STEPS,
           "aug": cfg.aug_type, "ratio": cfg.aug_cutoff_ratio,
           "gcn_layer_number": cfg.gcn_layer_number,
           "num_layers": cfg.num_layers,
           "setup_and_untimed_s": setup_s, "step_ms": step_ms,
           "wall_step_ms": wall / TIMED_STEPS * 1e3,
           "examples_per_s": ex_per_s,
           "wall_examples_per_s": TRAIN_B * TIMED_STEPS / wall,
           "flops_per_example": flops,
           "mfu": flops * ex_per_s / H100_BF16_PEAK,
           "span_step_ms": span_step["step_ms"],
           "span_step_mfu": span_step["mfu"],
           "k1_launches": k1, "k2_launches": k2, "mask_launches": masks,
           "cutoff_loss": metrics["cutoff_loss"].item(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses}
    log("aux_train_step", json.dumps(out))
    per_step = 2 * bert_cfg.num_hidden_layers
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite aux train loss: {losses}")
    if not sum(losses[-5:]) / 5 < losses[0]:
        raise AssertionError(f"aux train loss did not fall: {losses}")
    if k1 != per_step * TIMED_STEPS or k2 != per_step * TIMED_STEPS \
            or masks:
        raise AssertionError(f"K1 ran {k1}, K2 {k2} and the mask entry "
                             f"{masks} times in {TIMED_STEPS} aux steps, "
                             f"not {per_step} K1 + {per_step} K2 per step")
    del state, params
    torch.cuda.empty_cache()
    return out


def write_gcn_side_file(path, dataset, seed):
    """The GCN side file of a span split: one record per example (in
    ``example_index`` order) over its tokens, as ``gcn_side_arrays``
    draws them, and every other record with its own ``valid_ids``."""
    rng = np.random.RandomState(seed)
    records = []
    for mask in dataset.arrays["input_mask"]:
        n = max(int(mask.sum()), 4)
        side = gcn_side_arrays(1, n, seed=int(rng.randint(1 << 30)))
        rec = {"adj_matrix": side["adj_matrix"][0].tolist(),
               "src_mask": [1] * n,
               "aspect_mask": side["aspect_mask"][0].tolist(),
               "polarity": int(side["polaritys"][0])}
        if len(records) % 2:
            rec["valid_ids"] = side["valid_ids"][0].tolist()
        records.append(rec)
    with open(path, "w") as f:
        json.dump(records, f)


def aux_tree(tmp):
    """Phase 11's span tree with images: each sentence its own image id
    (an empty file, its pixels seeded in the ``.npy`` cache as phase 10
    seeds them) and GCN side files for train and dev, none for test (the
    CLI drops a missing one).  Returns (data root, bert dir, cache dir,
    image ids)."""
    import re
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.data.datasets import SpanDataset
    from mtvaf_tpu_torch.data.tokenization import build_tokenizer
    from mtvaf_tpu_torch.native.binding import maybe_accelerate

    root, bert_dir = span_tree(tmp)
    base = os.path.join(root, "twitter2015")
    img_dir = os.path.join(root, "twitter2015_images")
    cache = os.path.join(tmp, "aux_cache")
    pix_dir = os.path.join(cache, "img")
    for d in (img_dir, pix_dir):
        os.makedirs(d, exist_ok=True)
    cfg = Config(dataset_name="twitter15", max_seq=TRAIN_S)
    tok = maybe_accelerate(build_tokenizer(bert_dir, cfg.do_lower_case))
    ids = []
    for k, (mode, fname) in enumerate((("train", "train.txt"),
                                       ("dev", "valid.txt"),
                                       ("test", "test.txt"))):
        path = os.path.join(base, fname)
        with open(path) as f:
            lines = f.read().splitlines()
        split_ids = [f"{800000 + 10000 * k + i}.jpg"
                     for i in range(len(lines))]
        with open(path, "w") as f:
            f.write("\n".join(re.sub(r"imgid=\['[^']*'\]",
                                     f"imgid=['{img}']", line)
                              for line, img in zip(lines, split_ids)) + "\n")
        ids += split_ids
        if mode != "test":
            write_gcn_side_file(
                os.path.join(base, f"twitter15_{mode}.json"),
                SpanDataset.load(cfg, tok, path), seed=SEED + 20 + k)
    seed_pixel_cache(img_dir, pix_dir, ids, np.random.default_rng(SEED + 2))
    return root, bert_dir, cache, ids


def aux_phase(span_path, keep):
    """Phase 12: (a) the bare aux train step; (b) one fp32 aux step on the
    card against the CPU; (c) the aux heads through the CLI →
    ``SpanTrainer`` with images (ResNet-152 guides, the visual prefix)
    for two epochs; (d) ``load_predictor`` on its run directory: the
    DiGCN classification with a dev batch's side arrays against the
    trainer's, the extraction with images against the trainer's
    fp32-prefix forward, and ``BatchingServer`` with images held to
    ``predict_many``.  The run directory goes to ``keep`` (phase 13)."""
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.eval.span_decode import batch_eval_candidates
    from mtvaf_tpu_torch.infer import (SpanPredictor, load_predictor,
                                       serving_params)
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_mask_cuda, prefix_attention, prefix_attention_bwd_cuda)
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import init_span_model_params
    from mtvaf_tpu_torch.serve import BatchingServer
    from mtvaf_tpu_torch.train.optim import tree_items
    from mtvaf_tpu_torch.train.steps import export_params

    bert_cfg = BertConfig.base()
    layers = bert_cfg.num_hidden_layers
    t_phase = time.perf_counter()
    out = {"train_step": aux_train(bert_cfg, span_path["train_step"])}

    # (b) one fp32 aux step, card against CPU
    cfg = aux_config()
    out["fp32_step_vs_cpu"] = check_train_step_against_cpu(
        cfg, bert_cfg, params_from_jax(init_span_model_params(
            cfg, bert_cfg, seed=SEED + 6)), aux=True)
    torch.cuda.empty_cache()

    counters = (prefix_attention.launches, prefix_attention_bwd_cuda.launches,
                keep_mask_cuda.launches)
    with tempfile.TemporaryDirectory() as tmp:
        # (c) the trainer through the CLI, with images and the aux heads
        root, bert_dir, cache, ids = aux_tree(tmp)
        save = os.path.join(tmp, "aux_run")
        argv = ["--dataset_name", "twitter15", "--bert_name", bert_dir,
                "--logit_threshold", "0", "--data_root", root,
                "--save_path", save, "--cache_dir", cache, "--bf16",
                "--use_prefix", "--use_152",
                "--max_seq", str(TRAIN_S), "--train_batch_size",
                str(TRAIN_B), "--eval_batch_size", str(TRAINER_EVAL_BATCH),
                "--num_epochs", str(TRAINER_EPOCHS), "--eval_begin_epoch",
                "1", "--seed", str(SEED), "--do_train",
                "--do_aug", "--aug_type", cfg.aug_type,
                "--aug_cutoff_ratio", str(cfg.aug_cutoff_ratio),
                "--gcn_layer_number", str(cfg.gcn_layer_number),
                "--num_layers", str(cfg.num_layers)]
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        metrics, tr = run_cli(argv, bert_cfg, span=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2, masks = (c.value for c in counters)
        steps = sum(h["steps"] for h in tr.history)
        eval_batches = TRAINER_EPOCHS * -(-len(tr.dev_dataset)
                                          // TRAINER_EVAL_BATCH) \
            + -(-len(tr.test_dataset) // TRAINER_EVAL_BATCH)
        losses = [h["train_loss"] for h in tr.history]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite aux trainer loss: {losses}")
        if steps != TRAINER_EPOCHS * -(-TRAINER_SIZES["train"] // TRAIN_B):
            raise AssertionError(f"{steps} aux train steps")
        if k2 != 2 * layers * steps \
                or k1 != 2 * layers * steps + layers * eval_batches \
                or masks:
            raise AssertionError(
                f"K1 ran {k1}, K2 {k2}, the mask entry {masks} times for "
                f"{steps} aux train steps and {eval_batches} eval batches: "
                f"not {2 * layers} K1 + {2 * layers} K2 per step and "
                f"{layers} K1 per eval batch")
        gc = tr.guide_cache
        tensors = [p for _, p in tree_items(tr.state.params)] \
            + list(tr.state.opt_state.mu) + list(tr.state.opt_state.nu) \
            + [gc._dev_main, gc._dev_aux]
        if any(t is None or not t.is_cuda for t in tensors):
            raise AssertionError("an aux parameter, moment or guide-table "
                                 "tensor is not on the card")
        sides = [("adjacency_matrix" in d.arrays) for d in
                 (tr.train_dataset, tr.dev_dataset, tr.test_dataset)]
        if sides != [True, True, False] or gc.computed != len(ids):
            raise AssertionError(f"side arrays per split {sides}, "
                                 f"{gc.computed} of {len(ids)} images got "
                                 "guides")
        for name in ("best_model.npz", "train_predictions.json",
                     "dev_predictions.json", "test_predictions.json",
                     "final_metrics.json", "run_config.json"):
            if not os.path.exists(os.path.join(save, name)):
                raise AssertionError(f"the aux run wrote no {name}")

        evals = {}
        for name, ds in (("dev", tr.dev_dataset), ("test", tr.test_dataset)):
            prefix_attention.launches.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss = tr._predict(ds, compute_loss=True)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_batches = -(-len(ds) // TRAINER_EVAL_BATCH)
            if prefix_attention.launches.value != layers * n_batches:
                raise AssertionError(
                    f"aux {name} eval: K1 ran "
                    f"{prefix_attention.launches.value} times in "
                    f"{n_batches} batches")
            evals[name] = {"sentences": len(ds), "seconds": dt,
                           "sentences_per_s": len(ds) / dt, "loss": loss}
        out["trainer"] = {
            "epochs": tr.history, "wall_s": wall, "metrics": metrics,
            "images": len(ids), "guide_fill": {
                "images": gc.computed, "seconds": gc.compute_s},
            "bare_step_examples_per_s": out["train_step"]["examples_per_s"],
            "train_steps": steps, "eval_batches": eval_batches,
            "k1_launches": k1, "k2_launches": k2, "mask_launches": masks,
            "eval": evals}
        log("aux_trainer_path", json.dumps(out["trainer"]))

        # (d) serving the run directory
        pred = load_predictor(save, device="cuda")
        if not isinstance(pred, SpanPredictor) or not pred.serves_images:
            raise AssertionError(f"load_predictor built {type(pred)}")
        # every serving leaf equals the trainer's best model; the span
        # predictor keeps the prefix generator in fp32 (it builds the
        # prefix in fp32, as the JAX predictor does), so its prefix leaves
        # are held to the trainer's fp32 leaves, not to a bf16 cast
        want = dict(tree_items(serving_params(
            export_params(tr.state), pred.dtype, pred.device,
            prefix_dtype=torch.float32)))
        got = dict(tree_items(pred.params))
        if got.keys() != want.keys() or any(
                got[k].dtype != want[k].dtype
                or not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("the aux predictor's params differ from "
                                 "the trainer's best model")
        ds = tr.dev_dataset
        rows = list(range(TRAINER_EVAL_BATCH))
        host = {k: ds.arrays[k][rows].astype(np.int64)
                for k in ("input_ids", "input_mask", "segment_ids")}
        sents = [" ".join(ds.examples[ds.features[i].example_index]
                          .sent_tokens) for i in rows]
        examples, feats, pred_host = pred._make_host_batch(sents)
        if any(not np.array_equal(pred_host[k], host[k]) for k in host):
            raise AssertionError("the predictor tokenizes the dev "
                                 "sentences otherwise than the dataset")
        images = np.stack([ds.image_store.main_image(ds.image_ids[i])
                           for i in rows])
        gcn = (ds.arrays["valid_ids"][rows],
               ds.arrays["adjacency_matrix"][rows])
        # the trainer's steps on the same batch with the predictor's fp32
        # guides: an fp32-prefix forward
        dev = tr._device_batch({k: ds.arrays[k][rows] for k in
                                ("input_ids", "input_mask", "segment_ids",
                                 "valid_ids", "adjacency_matrix")})
        with torch.inference_mode():
            main_g, aux_g = pred._guides(images, None)
        s_tr, e_tr, seq_tr, _ = tr.extraction_step(
            tr.state.params, {**dev, "main_guides": main_g,
                              "aux_guides": aux_g})
        s_pr, e_pr, _, _ = pred.extract(host, images)
        if not (torch.equal(s_tr, s_pr) and torch.equal(e_tr, e_pr)):
            gap = max((s_tr - s_pr).abs().max().item(),
                      (e_tr - e_pr).abs().max().item())
            raise AssertionError("the predictor's extraction with images "
                                 "differs from the fp32-prefix forward by "
                                 f"{gap}")
        # what building the prefix from the bf16 guide table (the
        # trainer's eval) moves on the same batch
        table = tr._attach_guides({"example_index": np.asarray(rows)}, ds)
        s_tb, e_tb, _, _ = tr.extraction_step(
            tr.state.params, {**dev, "main_guides": table["main_guides"],
                              "aux_guides": table["aux_guides"]})
        bf16_prefix_gap = max((s_tb - s_tr).abs().max().item(),
                              (e_tb - e_tr).abs().max().item())
        se_np = torch.stack([s_tr, e_tr]).cpu().numpy()
        ss, se, _, cand = batch_eval_candidates(
            examples, feats, range(len(feats)), se_np[0], se_np[1], pred.cfg)
        pairs = torch.tensor(np.asarray([ss, se]), dtype=torch.int64,
                             device=pred.device)
        trained = tr.classification_step(tr.state.params, seq_tr, pairs,
                                         dev["valid_ids"],
                                         dev["adjacency_matrix"])
        want_res = pred._to_results(examples, feats, ss, se, cand,
                                    trained.argmax(dim=-1).cpu().numpy())
        got_res = pred.predict(sents, images=images, gcn=gcn)
        if got_res != want_res:
            raise AssertionError("the predictor's DiGCN classification "
                                 "with a dev batch's side arrays differs "
                                 "from the trainer's")
        del tr
        torch.cuda.empty_cache()

        sents = span_requests(N_REQUESTS, seed=SEED + 12)
        pix = [img for _, img in requests(2 * N_REQUESTS, seed=SEED + 13)
               if img is not None][:N_REQUESTS]
        server = BatchingServer(pred, max_batch=16, max_wait_ms=5.0,
                                pipeline_depth=4)
        results, errors = [None] * len(sents), []
        try:
            server.warmup()
            torch.cuda.synchronize()

            def client(idx):
                try:
                    for i in idx:
                        results[i] = server.submit(
                            sents[i], pix[i]).result(timeout=300)
                except BaseException as e:    # re-raised on the main thread
                    errors.append(e)

            prefix_attention.launches.reset()
            t0 = time.perf_counter()
            threads = [threading.Thread(
                target=client, args=(range(c, len(sents), CLIENTS),))
                for c in range(CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            torch.cuda.synchronize()
            serve_wall = time.perf_counter() - t0
            serve_k1 = prefix_attention.launches.value
            stats = server.stats()
        finally:
            server.close()
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise AssertionError("an aux client did not finish")
        many = pred.predict_many(sents, images=np.stack(pix), batch_size=16)
        if results != many:
            bad = [i for i, (r, m) in enumerate(zip(results, many)) if r != m]
            raise AssertionError(f"served aux results differ from "
                                 f"predict_many at requests {bad[:8]}")
        if stats["served"] != len(sents) or serve_k1 != layers \
                * stats["batches"]:
            raise AssertionError(f"aux serving: served {stats['served']}, "
                                 f"K1 ran {serve_k1} times for "
                                 f"{stats['batches']} batches")
        out["serve"] = {"requests": len(sents), "images": len(pix),
                        "batches": stats["batches"],
                        "mean_batch": stats["mean_batch"],
                        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                        "wall_s": serve_wall,
                        "sentences_per_s": len(sents) / serve_wall,
                        "k1_launches": serve_k1,
                        "spans": sum(len(r) for r in results),
                        "params_bitwise": len(want),
                        "extraction_bitwise_rows": len(rows),
                        "gcn_dispatch_rows": len(rows),
                        "bf16_guide_prefix_logit_gap": bf16_prefix_gap}
        log("aux_serve_path", json.dumps(out["serve"]))
        del pred
        torch.cuda.empty_cache()
        out["kept"] = keep_run(save, bert_dir, keep, "span")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"aux phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the serving tier: export bundles and the HTTP front end.


class Recorded:
    """A predictor behind ``BatchingServer`` that records every batch it is
    given (sentences and image rows, as the server padded them) with the
    results it returned, so that each can be held against the live
    predictor on the same batch: a text-only request's result depends on
    whether its batch carried images."""

    def __init__(self, pred):
        self.pred = pred
        self.serves_images = pred.serves_images
        self.batches = []

    def dispatch(self, sentences, images=None):
        return list(sentences), images, self.pred.dispatch(sentences,
                                                           images=images)

    def collect(self, handle):
        sentences, images, inner = handle
        out = self.pred.collect(inner)
        self.batches.append((sentences, images, out))
        return out

    def predict(self, sentences, images=None):
        return self.pred.predict(sentences, images=images)


def serve_threaded(server, reqs, timeout=300):
    """``reqs`` ((sentence, image or None) pairs) from ``CLIENTS`` closed-
    loop threads; (results, wall seconds)."""
    results, errors = [None] * len(reqs), []

    def client(idx):
        try:
            for i in idx:
                results[i] = server.submit(*reqs[i]).result(timeout=timeout)
        except BaseException as e:          # re-raised on the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(c, len(reqs), CLIENTS),))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * timeout)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client did not finish")
    return results, wall


def serve_bundle(name, bundle, live, reqs):
    """``reqs`` through ``BatchingServer`` → the bundle's predictor: every
    batch's results equal the live predictor's on the same batch, and K1
    ran once per layer per batch, inside the bundle's programs."""
    from mtvaf_tpu_torch.kernels.prefix_attention import prefix_attention
    from mtvaf_tpu_torch.serve import BatchingServer

    layers = live.bert_cfg.num_hidden_layers
    rec = Recorded(bundle)
    with BatchingServer(rec, max_batch=16, max_wait_ms=5.0,
                        pipeline_depth=4) as server:
        server.warmup()
        torch.cuda.synchronize()
        prefix_attention.launches.reset()
        results, wall = serve_threaded(server, reqs)
        launches = prefix_attention.launches.value
        stats = server.stats()
    if stats["served"] != len(reqs) or len(rec.batches) != stats["batches"]:
        raise AssertionError(f"{name} bundle: served {stats['served']} in "
                             f"{stats['batches']} batches")
    if launches != layers * stats["batches"]:
        raise AssertionError(f"{name} bundle: K1 ran {launches} times for "
                             f"{stats['batches']} batches")
    for sentences, images, got in rec.batches:
        if live.predict(sentences, images=images) != got:
            raise AssertionError(f"{name} bundle: a served batch differs "
                                 "from the live predictor's on it")
    out = {"requests": len(reqs), "batches": stats["batches"],
           "mean_batch": stats["mean_batch"], "p50_ms": stats["p50_ms"],
           "p99_ms": stats["p99_ms"], "wall_s": wall,
           "sentences_per_s": len(reqs) / wall, "k1_launches": launches,
           "image_batches": sum(i is not None for _, i, _ in rec.batches),
           "terms": sum(len(r) for r in results)}
    return results, out


def start_exports(runs):
    """Phase 13's two exports through the export CLI for cuda, each in a
    child process (``Child``), started before phases 15 and 16 so that
    they run beside them: phase 10's CRF run at rungs 1 and 16, phase
    12(c)'s span run at rung 16.  :func:`finish_export` collects each."""
    tmp = runs["dir"]
    out = {}
    for key, rungs in (("crf", "1,16"), ("span", "16")):
        run, bert = runs[key]
        bundle = os.path.join(tmp, f"{key}_bundle")
        out[key] = (Child(tmp, f"export_{key}",
                          "mtvaf_tpu_torch.cli.export_main",
                          ["--save_path", run, "--out", bundle,
                           "--batch_sizes", rungs, "--platforms", "cuda",
                           "--bert_name", bert]), time.time(), bundle)
    return out


def finish_export(export, timeout=900):
    """Wait for one of :func:`start_exports`' children: (manifest, wall s
    from its start to its manifest's write); logs each program's seconds
    and bytes."""
    child, t0, bundle = export
    try:
        child.proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.stop()
        raise AssertionError(f"export to {bundle} ran past {timeout} s")
    if child.proc.returncode != 0:
        raise AssertionError(f"export to {bundle} exited "
                             f"{child.proc.returncode}:\n"
                             f"{child.text()[-6000:]}")
    path = os.path.join(bundle, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    wall = os.path.getmtime(path) - t0
    programs = {p["name"]: {"seconds": p["seconds"], "bytes": p["bytes"]}
                for p in manifest["programs"]}
    log(f"export {os.path.basename(bundle)}: {len(programs)} programs in "
        f"{wall:.1f} s", json.dumps(programs))
    return manifest, wall


class Child:
    """A child process of this repository's code (``python -m module
    args``, with ``env`` added to this process's environment), its output
    in a log file under ``tmp``; stopped by :meth:`stop` (SIGINT, then a
    kill after 60 s)."""

    def __init__(self, tmp, name, module, args, env=None):
        self.log_path = os.path.join(tmp, f"{name}.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", module, *args],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
                stderr=subprocess.STDOUT, env={**os.environ, **(env or {})})

    def text(self):
        with open(self.log_path) as f:
            return f.read()

    def stop(self):
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def http_json(url, data=None, timeout=120):
    """(status, JSON body, seconds) of a GET, or a POST of ``data``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=None if data is None else json.dumps(data).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = json.loads(r.read())
            return r.status, body, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def http_text(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def parse_metrics(text):
    """Prometheus text → {name{labels}: value}; fails on a malformed line."""
    out = {}
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def as_json(results):
    return [[list(term) for term in r] for r in results]


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_ready(child, base, timeout=300):
    """Poll the child server's /healthz until it answers: seconds since
    its start."""
    while True:
        if child.proc.poll() is not None:
            raise AssertionError("serve_main exited early: "
                                 + child.text()[-3000:])
        if time.perf_counter() - child.t0 > timeout:
            raise AssertionError(f"serve_main did not come up in {timeout} s")
        try:
            if http_json(f"{base}/healthz", timeout=5)[0] == 200:
                return time.perf_counter() - child.t0
        except OSError:
            time.sleep(0.2)


def http_requests(child, base, sents, want):
    """POST ``sents`` one per request to the child server from ``CLIENTS``
    threads, hold each result to ``want``, read /stats and /metrics, stop
    the child with SIGINT and read its K1 count from its last log line."""
    replies, errors = [None] * len(sents), []

    def client(idx):
        try:
            for i in idx:
                replies[i] = http_json(f"{base}/predict",
                                       {"sentences": [sents[i]]})
        except BaseException as e:          # re-raised on the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(c, len(sents), CLIENTS),))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    code, stats, _ = http_json(f"{base}/stats")
    metrics = parse_metrics(http_text(f"{base}/metrics"))
    rc = child.stop()
    bad = [i for i, r in enumerate(replies)
           if r is None or r[0] != 200 or r[1]["results"] != as_json(
               [want[i]])]
    if bad:
        raise AssertionError(f"HTTP results differ from the in-process "
                             f"bundle's at requests {bad[:8]}: "
                             f"{replies[bad[0]]}")
    if code != 200 or stats["served"] != len(sents) \
            or metrics["mtvaf_served_total"] != len(sents):
        raise AssertionError(f"/stats {stats}, /metrics {metrics}")
    stopped = [line for line in child.text().splitlines()
               if "stopped:" in line]
    if rc != 0 or not stopped:
        raise AssertionError("serve_main did not stop cleanly: "
                             + child.text()[-3000:])
    k1 = json.loads(stopped[-1].split("stopped: ", 1)[1])["k1_launches"]
    if k1 != 12 * stats["batches"]:
        raise AssertionError(f"serve_main: K1 ran {k1} times for "
                             f"{stats['batches']} batches")
    lat = sorted(r[2] * 1e3 for r in replies)
    return {"requests": len(sents), "wall_s": wall,
            "sentences_per_s": len(sents) / wall,
            "client_p50_ms": lat[len(lat) // 2],
            "client_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "server_p50_ms": stats["p50_ms"],
            "server_p99_ms": stats["p99_ms"], "batches": stats["batches"],
            "mean_batch": stats["mean_batch"], "k1_launches": k1,
            "metrics_lines": len(metrics)}


def http_in_process(bundle, sents):
    """``build_app`` in this process over the bundle: base64 PNG images
    through the eval transform (where PIL is installed), and a burst
    against ``max_queue=1`` that must give both 200 and 429 with the
    rejections in /stats and /metrics."""
    import base64
    import io
    from mtvaf_tpu_torch.cli.serve_main import HTTPServer, build_app
    from mtvaf_tpu_torch.serve import BatchingServer

    def serving(server):
        httpd = HTTPServer(("127.0.0.1", 0), build_app(server))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"

    out = {}
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None:
        out["images"] = "held on the CPU only: no PIL on this machine"
    else:
        from mtvaf_tpu_torch.data.images import process_image_bytes
        rng = np.random.default_rng(SEED + 21)
        pngs = []
        for i in range(16):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (180 + 8 * i, 240, 3),
                                         dtype=np.uint8)).save(buf, "PNG")
            pngs.append(buf.getvalue())
        with BatchingServer(bundle, max_batch=16, max_wait_ms=5.0) as server:
            httpd, base = serving(server)
            try:
                code, body, dt = http_json(f"{base}/predict", {
                    "sentences": sents[:16],
                    "images": [base64.b64encode(p).decode() for p in pngs]})
            finally:
                httpd.shutdown()
                httpd.server_close()
        want = bundle.predict(sents[:16], images=np.stack(
            [process_image_bytes(p) for p in pngs]))
        if code != 200 or body["results"] != as_json(want):
            raise AssertionError(f"HTTP with images: {code}, results "
                                 "differ from the bundle's")
        out["images"] = {"requests": 1, "sentences": 16, "seconds": dt}

    with BatchingServer(bundle, max_batch=16, max_wait_ms=5.0,
                        max_queue=1) as server:
        httpd, base = serving(server)
        try:
            # alone, a request finds the queue empty.  In the burst the
            # 3-sentence POSTs go at once and each overflows the queue by
            # itself; the 1-sentence ones follow 30 ms apart, so the later
            # ones find the queue drained and must be served
            solo = http_json(f"{base}/predict", {"sentences": sents[:1]})[0]
            codes = [None] * 32

            def post(i):
                n = 1 if i % 2 else 3
                if n == 1:
                    time.sleep(0.03 * (i // 2))
                codes[i] = http_json(f"{base}/predict",
                                     {"sentences": sents[i:i + n]})[0]

            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(codes))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            stats = http_json(f"{base}/stats")[1]
            metrics = parse_metrics(http_text(f"{base}/metrics"))
        finally:
            httpd.shutdown()
            httpd.server_close()
    if not (solo == 200 and 200 in codes and 429 in codes
            and set(codes) <= {200, 429}):
        raise AssertionError(f"max_queue=1: alone {solo}, burst {codes}")
    if stats["rejected"] < 1 \
            or metrics["mtvaf_rejected_total"] != stats["rejected"]:
        raise AssertionError(f"rejections not counted: {stats} {metrics}")
    out["max_queue_1"] = {"solo": solo, "burst_posts": len(codes),
                          "burst_ok": codes.count(200),
                          "burst_shed_429": codes.count(429),
                          "rejected": stats["rejected"]}
    return out


def k1_host_ms():
    """Host time of one K1 call at the serving shape (B=16, H=12, S=128,
    T=144, bf16), between events over back-to-back calls (the kernel
    itself takes ~0.008 ms there): the ctypes wrapper alone, the operator
    ``mtvaf::prefix_attention_fwd``, and ``prefix_attention`` (the call
    each encoder layer makes), in turns."""
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        prefix_attention, prefix_attention_cuda)
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    q, k, v, bias = attention_inputs(g, 16, 12, 128, 144, 64, torch.bfloat16)
    calls = {
        "wrapper": lambda: prefix_attention_cuda(q, k, v, bias),
        "operator": lambda: torch.ops.mtvaf.prefix_attention_fwd(
            q, k, v, bias, 0, 0.0),
        "prefix_attention": lambda: prefix_attention(q, k, v, bias)}
    times = {name: [] for name in calls}
    with torch.inference_mode():
        for name in ("wrapper", "operator", "prefix_attention",
                     "prefix_attention", "operator", "wrapper"):
            times[name].append(cuda_ms(calls[name], iters=200, warmup=20))
    return {f"{name}_event_ms": sum(t) / len(t) for name, t in times.items()}


def serving_tier_phase(runs, serve_path, exports):
    """Phase 13: (a) phase 10's flagship CRF run exported for cuda at rungs
    1 and 16 (shared weights), loaded, held against the live predictor
    (emissions; phase 7's 64 requests through ``BatchingServer``); (b)
    phase 12(c)'s span run (prefix, images, DiGCN) exported at rung 16,
    64 image-bearing requests; (c) ``cli.serve_main --bundle`` over (a) in
    a child process, 64 text POSTs from 16 threads, then ``build_app`` in
    this process with images and with ``max_queue=1``; (d) K1's host time
    per call through the operator.  The exports ran in children during
    phases 15 and 16 (``exports``: :func:`start_exports`); the HTTP child
    loads its bundle while this process loads and serves its own; every
    timed serving run starts after the child is up and idle."""
    from mtvaf_tpu_torch.export import load_exported_predictor
    from mtvaf_tpu_torch.infer import load_predictor

    t_phase = time.perf_counter()
    out = {}
    tmp = runs["dir"]
    crf_run, crf_bert = runs["crf"]
    span_run, span_bert = runs["span"]
    bundle_dir, span_dir = exports["crf"][2], exports["span"][2]
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    children = []
    try:
        manifest, export_s = finish_export(exports["crf"])
        span_manifest, span_export_s = finish_export(exports["span"])
        names = sorted(p["name"] for p in manifest["programs"])
        if names != sorted(f"crf_decode{v}_b{r}" for r in (1, 16)
                           for v in ("", "_images", "_images_noaux")):
            raise AssertionError(f"CRF bundle programs {names}")
        server_child = Child(tmp, "serve_main",
                             "mtvaf_tpu_torch.cli.serve_main",
                             ["--bundle", bundle_dir, "--bert_name",
                              crf_bert, "--port", str(port), "--max_batch",
                              "16", "--max_wait_ms", "5"])
        children.append(server_child)

        # (a) the CRF bundle
        live = load_predictor(crf_run, bert_name=crf_bert, device="cuda")
        t0 = time.perf_counter()
        bundle = load_exported_predictor(bundle_dir, bert_name=crf_bert,
                                         device="cuda")
        reqs = requests(N_REQUESTS, seed=SEED)
        blank = np.zeros((224, 224, 3), np.float32)
        host = live._make_host_batch([s for s, _ in reqs[:16]])
        imgs16 = np.stack([blank if i is None else i for _, i in reqs[:16]])
        cases = {"text": None, "images": imgs16}
        with torch.inference_mode():
            got = {k: bundle.forward(host, v) for k, v in cases.items()}
            # load_s: manifest, weights, and the two programs that serving
            # at rung 16 runs (the others load on first use), one forward
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            gaps = {}
            for key, images in cases.items():
                a, b = got[key], live.forward(host, images)
                gaps[key] = (a["emissions"].float()
                             - b["emissions"].float()).abs().max().item()
                if not torch.equal(a["pred_tags"], b["pred_tags"]):
                    raise AssertionError(f"bundle tags differ ({key})")
        log(f"CRF bundle vs live forward: largest emission difference "
            f"{gaps}")
        ready_s = wait_ready(server_child, base)

        results, served = serve_bundle("CRF", bundle, live, reqs)
        out["crf"] = {"export_s": export_s, "load_s": load_s,
                      "programs": manifest["programs"],
                      "weights_bytes": os.path.getsize(
                          os.path.join(bundle_dir, "weights.npz")),
                      "resnet_bytes": os.path.getsize(
                          os.path.join(bundle_dir, "resnet.npz")),
                      "emission_gap": gaps, "serve": served,
                      "live_serve_phase7": {k: serve_path[k] for k in (
                          "p50_ms", "p99_ms", "sentences_per_s")}}
        log("bundle_crf_path", json.dumps(out["crf"]))
        del live
        torch.cuda.empty_cache()

        # (b) the span bundle with images and DiGCN
        live_span = load_predictor(span_run, bert_name=span_bert,
                                   device="cuda")
        t0 = time.perf_counter()
        span_bundle = load_exported_predictor(span_dir, bert_name=span_bert,
                                              device="cuda")
        sents = span_requests(N_REQUESTS, seed=SEED + 12)
        pix = [img for _, img in requests(2 * N_REQUESTS, seed=SEED + 13)
               if img is not None][:N_REQUESTS]
        span_bundle.predict(sents[:16])                  # as (a): the
        span_bundle.predict(sents[:16], images=np.stack(pix[:16]))
        torch.cuda.synchronize()                         # programs served
        span_load_s = time.perf_counter() - t0
        _, out["span"] = serve_bundle("span", span_bundle, live_span,
                                      list(zip(sents, pix)))
        out["span"].update(export_s=span_export_s, load_s=span_load_s,
                           programs=span_manifest["programs"])
        log("bundle_span_path", json.dumps(out["span"]))
        del live_span, span_bundle
        torch.cuda.empty_cache()

        # (c) HTTP: serve_main in the child process, then build_app here
        text = [s for s, _ in reqs]
        want = bundle.predict_many(text, batch_size=16)
        out["http"] = {"ready_s": ready_s,
                       **http_requests(server_child, base, text, want),
                       "in_process_live_phase7": out["crf"][
                           "live_serve_phase7"]}
        log("http_path", json.dumps(out["http"]))
        out["http_in_process"] = http_in_process(bundle, text)
        log("http_in_process", json.dumps(out["http_in_process"]))
        del bundle
        torch.cuda.empty_cache()
    finally:
        for child in children:
            child.stop()

    # (d) K1's host time per call through the operator
    out["k1_host"] = k1_host_ms()
    log("k1_host_ms", json.dumps(out["k1_host"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serving tier phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the options (per-layer remat, --params_bf16, the parallel
# Viterbi, the step profiler), with --use_align's S=500.

LONG_S = 500                     # --use_align's max_seq_agn
LONG_WARMUP, LONG_TIMED = 10, 20
# remat against no remat on the card (gradients): the replay runs the same
# kernels on the same inputs, so a leaf may differ only where a library
# sums in an order it picks anew per call
REMAT_RTOL, REMAT_ATOL = 1e-4, 1e-5
AGN_IDS = [f"img_{i}.jpg" for i in range(4)]   # make_learnable_span_file's
KERNEL_NAMES = {"k1": ("fwd_bf16_kernel",),
                "k2": ("dq_bf16_kernel", "dkdv_bf16_kernel")}


def kernel_counters():
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_mask_cuda, prefix_attention, prefix_attention_bwd_cuda)
    return {"k1": prefix_attention.launches,
            "k2": prefix_attention_bwd_cuda.launches,
            "mask": keep_mask_cuda.launches}


def reset_counts():
    for c in kernel_counters().values():
        c.reset()


def read_counts():
    return {k: c.value for k, c in kernel_counters().items()}


def profiled_calls(fn, iters=10):
    """(device ms, kernel launches) per call of ``fn`` under
    ``torch.profiler``: the summed kernel durations and the count of
    kernel records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / iters / 1e3,
            sum(e.count for e in kernels) / iters)


def timed_steps(step, state, batch, n):
    """``n`` steps between two events: (state, losses, device ms per
    step, wall ms per step, peak bytes allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        state, metrics = step(state, batch, SEED)
        losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (state, [x.item() for x in losses], start.elapsed_time(end) / n,
            wall / n * 1e3, torch.cuda.max_memory_allocated())


def long_step(bert_cfg):
    """(a) The span step at S=T=500 (text-only BERT-base, B=32, bf16,
    dropout live), without and with remat: one step each from one
    generator (the loss bit for bit, every gradient leaf bitwise or within
    ``REMAT_RTOL``/``REMAT_ATOL``; K1 12 → 24 launches, K2 12), then
    ``LONG_WARMUP`` untimed and ``LONG_TIMED`` timed steps of each, with
    the peak memory of the timed steps."""
    import dataclasses
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.core.flops import (H100_BF16_PEAK,
                                            train_flops_per_example)
    from mtvaf_tpu_torch.core.rng import fold_in
    from mtvaf_tpu_torch.data.synthetic import span_batch
    from mtvaf_tpu_torch.nn.models import init_span_model_params
    from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_span_loss_fn,
                                             make_train_step)

    cfg = span_config().replace(use_align=True, max_seq_agn=LONG_S)
    params = params_from_jax(init_span_model_params(cfg, bert_cfg,
                                                    seed=SEED))
    optimizer, _ = build_optimizer(params, cfg, total_steps=1000,
                                   pipeline="span")
    batch = {k: v.to(DEVICE) for k, v in span_batch(
        cfg, bert_cfg, TRAIN_B, LONG_S, seed=SEED).items()}
    flops = train_flops_per_example(bert_cfg, LONG_S, prefix_len=0)
    layers = bert_cfg.num_hidden_layers
    loss_fns = {name: make_span_loss_fn(
        cfg, dataclasses.replace(bert_cfg, remat=name == "remat"))
        for name in ("plain", "remat")}

    # one step's loss and gradients each, from one generator
    grads, one = {}, {}
    for name, loss_fn in loss_fns.items():
        state = create_train_state(params, optimizer, device=DEVICE)
        leaves = dict(tree_items(state.params))
        reset_counts()
        loss, _ = loss_fn(state.params, batch, fold_in(SEED, 0))
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        torch.cuda.synchronize()
        one[name] = read_counts()
        grads[name] = (loss.detach(), dict(zip(leaves, g)))
        del state, leaves, loss, g
    (loss0, g0), (loss1, g1) = grads["plain"], grads["remat"]
    worst, worst_path, not_bitwise = 0.0, None, []
    for path, a in g0.items():
        b = g1[path]
        if (a is None) != (b is None):
            raise AssertionError(f"remat: gradient of {path} on one side")
        if a is None or torch.equal(a, b):
            continue
        not_bitwise.append(path)
        diff = (a.float() - b.float()).abs().max().item()
        if diff > worst:
            worst, worst_path = diff, path
        if not torch.allclose(b.float(), a.float(), rtol=REMAT_RTOL,
                              atol=REMAT_ATOL):
            raise AssertionError(f"remat: the gradient of {path} differs by "
                                 f"{diff} (rtol {REMAT_RTOL}, atol "
                                 f"{REMAT_ATOL})")
    reason = "all bitwise" if not not_bitwise else (
        "the same kernels on the same inputs: these leaves were summed in "
        "an order a library picked anew for the replay")
    out = {"remat_vs_plain": {
        "loss": [loss0.item(), loss1.item()],
        "loss_bitwise": bool(torch.equal(loss0, loss1)),
        "leaves": len(g0), "leaves_not_bitwise": not_bitwise,
        "largest_diff": worst, "largest_diff_leaf": worst_path,
        "reason": reason, "rtol": REMAT_RTOL, "atol": REMAT_ATOL,
        "one_step_launches": one}}
    log("long_step_remat_vs_plain", json.dumps(out["remat_vs_plain"]))
    if not out["remat_vs_plain"]["loss_bitwise"]:
        raise AssertionError(f"remat: loss {loss1.item()} against "
                             f"{loss0.item()} without")
    for name, want_k1 in (("plain", layers), ("remat", 2 * layers)):
        if one[name] != {"k1": want_k1, "k2": layers, "mask": 0}:
            raise AssertionError(f"S=500 {name} step launched {one[name]}: "
                                 f"not {want_k1} K1 + {layers} K2")
    del grads, g0, g1, loss0, loss1
    torch.cuda.empty_cache()

    # timed steps of each
    for name, loss_fn in loss_fns.items():
        state = create_train_state(params, optimizer, device=DEVICE)
        step = make_train_step(loss_fn, optimizer)
        losses = []
        for _ in range(LONG_WARMUP):
            state, metrics = step(state, batch, SEED)
            losses.append(metrics["loss"].item())
        reset_counts()
        state, timed, step_ms, wall_ms, peak = timed_steps(step, state,
                                                           batch, LONG_TIMED)
        counts = read_counts()
        losses += timed
        ex_per_s = TRAIN_B / (step_ms / 1e3)
        out[name] = {"batch": TRAIN_B, "seq": LONG_S, "steps": LONG_TIMED,
                     "step_ms": step_ms, "wall_step_ms": wall_ms,
                     "examples_per_s": ex_per_s,
                     "mfu": flops * ex_per_s / H100_BF16_PEAK,
                     "peak_mem_gb": peak / 1e9,
                     "k1_launches": counts["k1"],
                     "k2_launches": counts["k2"],
                     "mask_launches": counts["mask"], "losses": losses}
        want_k1 = one[name]["k1"] * LONG_TIMED
        if counts != {"k1": want_k1, "k2": layers * LONG_TIMED, "mask": 0}:
            raise AssertionError(f"S=500 {name} steps launched {counts} in "
                                 f"{LONG_TIMED} steps")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite S=500 loss: {losses}")
        del state, step
        torch.cuda.empty_cache()
    out["remat_vs_plain"].update(
        step_ms_ratio=out["remat"]["step_ms"] / out["plain"]["step_ms"],
        peak_mem_ratio=out["remat"]["peak_mem_gb"]
        / out["plain"]["peak_mem_gb"])
    log("long_step_path", json.dumps(out))
    del params
    return out


def master_step(cfg, bert_cfg, params, bare):
    """(b) Phase 9's step (flagship, B=32, S=128, bf16, dropout live) with
    ``--params_bf16``: as phase 9, 15 untimed and 30 timed steps (the
    heads' warmup lifts the loss until ~35 steps); finite losses, the last
    5 below the first, live == bf16(master) after the last step; the
    kernel launches and device time per step beside phase 9's fp32-param
    step, profiled here."""
    from mtvaf_tpu_torch.train.optim import tree_items
    from mtvaf_tpu_torch.train.steps import MasterState, create_train_state

    cfg16 = cfg.replace(params_bf16=True)
    optimizer, state32, _, step, batch = train_setup(cfg16, bert_cfg,
                                                     params, DEVICE)
    state = create_train_state(params, optimizer, device=DEVICE,
                               params_dtype=torch.bfloat16)
    launches = {}
    for name, st in (("fp32_params", state32), ("params_bf16", state)):
        holder = {"s": st}

        def one_step():
            holder["s"], _ = step(holder["s"], batch, SEED)

        launches[name] = profiled_calls(one_step, iters=3)
    del state32, holder
    torch.cuda.empty_cache()
    state = create_train_state(params, optimizer, device=DEVICE,
                               params_dtype=torch.bfloat16)
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, batch, SEED)
        losses.append(metrics["loss"].item())
    reset_counts()
    state, timed, step_ms, wall_ms, peak = timed_steps(step, state, batch,
                                                       TIMED_STEPS)
    counts = read_counts()
    losses += timed
    if not isinstance(state.opt_state, MasterState):
        raise AssertionError("params_bf16 state holds no master")
    cast_ok = all(
        p.dtype == torch.bfloat16 and m.dtype == torch.float32
        and torch.equal(p, m.to(torch.bfloat16))
        for (_, p), (_, m) in zip(tree_items(state.params),
                                  tree_items(state.opt_state.master)))
    layers = bert_cfg.num_hidden_layers
    out = {"batch": TRAIN_B, "seq": TRAIN_S, "steps": TIMED_STEPS,
           "step_ms": step_ms, "wall_step_ms": wall_ms,
           "examples_per_s": TRAIN_B / (step_ms / 1e3),
           "peak_mem_gb": peak / 1e9, "k1_launches": counts["k1"],
           "k2_launches": counts["k2"], "mask_launches": counts["mask"],
           "live_is_bf16_master": cast_ok,
           "profiled": {k: {"device_ms_per_step": v[0],
                            "kernel_launches_per_step": v[1]}
                        for k, v in launches.items()},
           "phase9_step_ms": bare["step_ms"], "losses": losses}
    log("master_step_path", json.dumps(out))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite params_bf16 loss: {losses}")
    if not sum(losses[-5:]) / 5 < losses[0]:
        raise AssertionError(f"params_bf16 loss did not fall: {losses}")
    if not cast_ok:
        raise AssertionError("live params are not bf16(master)")
    if counts != {"k1": layers * TIMED_STEPS, "k2": layers * TIMED_STEPS,
                  "mask": 0}:
        raise AssertionError(f"params_bf16 steps launched {counts}")
    del state, step, optimizer
    torch.cuda.empty_cache()
    return out


def long_trainer(bert_cfg):
    """(c) The CLI → ``SpanTrainer`` with ``--use_align --remat
    --params_bf16 --profile_dir`` for 2 epochs on a synthetic twitter15
    tree with AGN files (320/96/96 sentences, S=500): 24 K1 + 12 K2 per
    train step and 12 K1 per eval batch, the profiler's trace naming K1
    and K2, an fp32 ``best_model.npz``; then ``load_predictor`` on the run
    → ``BatchingServer`` → ``SpanPredictor`` at S=500, 64 requests from 16
    threads, each equal to ``predict_many``'s."""
    from mtvaf_tpu_torch.data.synthetic import make_agn_file
    from mtvaf_tpu_torch.infer import SpanPredictor, load_predictor
    from mtvaf_tpu_torch.serve import BatchingServer

    layers = bert_cfg.num_hidden_layers
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, bert_dir = span_tree(tmp)
        agn = os.path.join(root, "AGN_data", "twitter2015")
        os.makedirs(agn)
        for k, mode in enumerate(("train", "dev", "test")):
            make_agn_file(os.path.join(agn, f"aux_{mode}.txt"), AGN_IDS,
                          seed=SEED + k)
        save, prof = os.path.join(tmp, "run"), os.path.join(tmp, "prof")
        argv = ["--dataset_name", "twitter15", "--bert_name", bert_dir,
                "--logit_threshold", "0", "--data_root", root,
                "--save_path", save, "--bf16", "--use_align",
                "--max_seq_agn", str(LONG_S), "--remat", "--params_bf16",
                "--profile_dir", prof, "--profile_steps", "2",
                "--train_batch_size", str(TRAIN_B),
                "--eval_batch_size", str(TRAINER_EVAL_BATCH),
                "--num_epochs", str(TRAINER_EPOCHS), "--eval_begin_epoch",
                "1", "--seed", str(SEED), "--do_train"]
        reset_counts()
        t0 = time.perf_counter()
        metrics, tr = run_cli(argv, bert_cfg, span=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = sum(h["steps"] for h in tr.history)
        eval_batches = TRAINER_EPOCHS * -(-len(tr.dev_dataset)
                                          // TRAINER_EVAL_BATCH) \
            + -(-len(tr.test_dataset) // TRAINER_EVAL_BATCH)
        losses = [h["train_loss"] for h in tr.history]
        if tr.train_dataset.arrays["input_ids"].shape[1] != LONG_S:
            raise AssertionError("the --use_align run is not at S=500")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite --use_align loss: {losses}")
        if counts != {"k1": 2 * layers * steps + layers * eval_batches,
                      "k2": layers * steps, "mask": 0}:
            raise AssertionError(
                f"--use_align trainer: {counts} for {steps} steps and "
                f"{eval_batches} eval batches: not {2 * layers} K1 + "
                f"{layers} K2 a step and {layers} K1 an eval batch")
        traces = os.listdir(prof)
        if traces != ["trace_steps_3-4.json"]:
            raise AssertionError(f"profile_dir holds {traces}")
        trace = os.path.join(prof, traces[0])
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        named = {k: sum(any(n in e.get("name", "") for n in names)
                        for e in events)
                 for k, names in KERNEL_NAMES.items()}
        # 2 steps: 48 K1 records (24 a step) and 48 of K2's two passes
        if not (named["k1"] and named["k2"]):
            raise AssertionError(f"the trace of 2 steps names K1 and K2 "
                                 f"{named} times")
        with np.load(os.path.join(save, "best_model.npz")) as best:
            dtypes = sorted({str(best[k].dtype) for k in best.files})
        if dtypes != ["float32"]:
            raise AssertionError(f"best_model.npz holds {dtypes}")
        out["trainer"] = {
            "epochs": tr.history, "wall_s": wall, "metrics": metrics,
            "train_steps": steps, "eval_batches": eval_batches,
            "k1_launches": counts["k1"], "k2_launches": counts["k2"],
            "mask_launches": counts["mask"],
            "profiler_mean_step_ms": tr.profiler.mean_step_ms,
            "trace_bytes": os.path.getsize(trace),
            "trace_kernel_records": kernels, "trace_named": named}
        log("long_trainer_path", json.dumps(out["trainer"]))
        del tr
        torch.cuda.empty_cache()

        pred = load_predictor(save, device=DEVICE)
        if not isinstance(pred, SpanPredictor) \
                or pred.cfg.effective_max_seq != LONG_S:
            raise AssertionError(f"load_predictor built {type(pred)} at "
                                 f"S={pred.cfg.effective_max_seq}")
        sents = span_requests(N_REQUESTS, seed=SEED + 14)
        with BatchingServer(pred, max_batch=16, max_wait_ms=5.0,
                            pipeline_depth=4) as server:
            server.warmup()
            torch.cuda.synchronize()
            reset_counts()
            results, serve_wall = serve_threaded(
                server, [(s,) for s in sents])
            k1 = read_counts()["k1"]
            stats = server.stats()
        many = pred.predict_many(sents, batch_size=16)
        if results != many:
            bad = [i for i, (r, m) in enumerate(zip(results, many)) if r != m]
            raise AssertionError(f"S=500 served span results differ from "
                                 f"predict_many at requests {bad[:8]}")
        if stats["served"] != len(sents) or k1 != layers * stats["batches"]:
            raise AssertionError(f"S=500 serving: served {stats['served']}, "
                                 f"K1 ran {k1} times for {stats['batches']} "
                                 "batches")
        out["serve"] = {"requests": len(sents), "seq": LONG_S,
                        "batches": stats["batches"],
                        "mean_batch": stats["mean_batch"],
                        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                        "wall_s": serve_wall,
                        "sentences_per_s": len(sents) / serve_wall,
                        "k1_launches": k1,
                        "spans": sum(len(r) for r in results)}
        log("long_serve_path", json.dumps(out["serve"]))
        del pred
        torch.cuda.empty_cache()
    return out


def parallel_decode(cfg, bert_cfg, params, resnet, tok, tmp):
    """(d) CRF serving with ``crf_decode_impl="parallel"``: phase 7's
    requests through ``BatchingServer`` → a parallel-decode
    ``CrfPredictor`` (12 K1 per batch), each served batch held to the scan
    predictor on the same batch (a tie that breaks otherwise is printed
    with both path scores, which must be equal); device ms and launches
    of fc + Viterbi at the served batch of 16 for both decodes; one text
    decode program of each exported for cuda: node count and seconds."""
    from mtvaf_tpu_torch.export import export_predictor
    from mtvaf_tpu_torch.infer import CrfPredictor
    from mtvaf_tpu_torch.nn.bert import bert_model
    from mtvaf_tpu_torch.nn.crf import (crf_decode, crf_decode_parallel,
                                        crf_sequence_score)
    from mtvaf_tpu_torch.nn.layers import dense
    from mtvaf_tpu_torch.serve import BatchingServer

    layers = bert_cfg.num_hidden_layers
    cfg_par = cfg.replace(crf_decode_impl="parallel")
    scan = CrfPredictor(cfg, bert_cfg, params, tok, resnet_params=resnet,
                        device=DEVICE)
    par = CrfPredictor(cfg_par, bert_cfg, params, tok, resnet_params=resnet,
                       device=DEVICE)
    reqs = requests(N_REQUESTS, seed=SEED)
    rec = Recorded(par)
    with BatchingServer(rec, max_batch=16, max_wait_ms=5.0,
                        pipeline_depth=4) as server:
        server.warmup()
        torch.cuda.synchronize()
        rec.batches.clear()
        reset_counts()
        _, wall = serve_threaded(server, reqs)
        k1 = read_counts()["k1"]
        stats = server.stats()
    if stats["served"] != len(reqs) or k1 != layers * stats["batches"]:
        raise AssertionError(f"parallel-decode serving: served "
                             f"{stats['served']}, K1 ran {k1} times for "
                             f"{stats['batches']} batches")
    ties, rows = [], 0
    crf = {k: v.float() for k, v in par.params["crf"].items()}
    with torch.inference_mode():
        for sentences, images, got in rec.batches:
            host = par._make_host_batch(sentences)
            a, b = par.forward(host, images), scan.forward(host, images)
            mask = torch.from_numpy(host["input_mask"]).to(DEVICE)
            rows += len(sentences)
            if scan.collect((list(sentences), host["label_ids"],
                             host["input_mask"], b["pred_tags"])) == got:
                continue
            differ = (a["pred_tags"] != b["pred_tags"]).any(dim=1)
            for i in differ.nonzero()[:, 0].tolist():
                s_par = crf_sequence_score(crf, a["emissions"][i:i + 1],
                                           a["pred_tags"][i:i + 1],
                                           mask[i:i + 1]).item()
                s_scan = crf_sequence_score(crf, a["emissions"][i:i + 1],
                                            b["pred_tags"][i:i + 1],
                                            mask[i:i + 1]).item()
                ties.append({"sentence": sentences[i], "parallel": s_par,
                             "scan": s_scan})
                log("parallel decode tie", json.dumps(ties[-1]))
                if abs(s_par - s_scan) > 1e-5 * max(1.0, abs(s_scan)):
                    raise AssertionError(
                        f"the parallel decode's path scores {s_par}, the "
                        f"scan's {s_scan}, for {sentences[i]!r}")
    out = {"serve": {"requests": len(reqs), "batches": stats["batches"],
                     "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                     "wall_s": wall, "sentences_per_s": len(reqs) / wall,
                     "k1_launches": k1, "rows_checked": rows,
                     "ties": ties}}

    # fc + Viterbi at the served batch of 16, both decodes
    host = scan._make_host_batch([s for s, _ in requests(16, seed=7)])
    with torch.inference_mode():
        batch = {k: torch.from_numpy(host[k]).to(DEVICE)
                 for k in ("input_ids", "input_mask", "segment_ids")}
        seq, _ = bert_model(scan.params["bert"], bert_cfg,
                            batch["input_ids"], batch["input_mask"],
                            token_type_ids=batch["segment_ids"],
                            dtype=scan.dtype)
        decode_stage = {}
        for name, fn in (("scan", crf_decode),
                         ("parallel", crf_decode_parallel)):
            def call(fn=fn):
                return fn(scan.params["crf"],
                          dense(scan.params["fc"], seq).float(),
                          batch["input_mask"])
            ms, launches = profiled_calls(call, iters=10)
            decode_stage[name] = {"device_ms": ms, "launches": launches,
                                  "event_ms": cuda_ms(call, iters=20,
                                                      warmup=3)}
    out["fc_and_viterbi_b16"] = decode_stage

    # one text decode program of each, exported for cuda
    exports = {}
    for name, c in (("scan", cfg), ("parallel", cfg_par)):
        text_only = CrfPredictor(c, bert_cfg, params, tok, device=DEVICE)
        bundle = os.path.join(tmp, f"decode_{name}")
        manifest = export_predictor(text_only, bundle, batch_sizes=(16,),
                                    platforms=(DEVICE,))
        t0 = time.perf_counter()
        program = torch.export.load(os.path.join(
            bundle, manifest["programs"][0]["file"]))
        exports[name] = {"export_s": manifest["programs"][0]["seconds"],
                         "load_s": time.perf_counter() - t0,
                         "nodes": len(program.graph.nodes),
                         "bytes": manifest["programs"][0]["bytes"]}
        del text_only, program
    out["export_b16"] = exports
    log("parallel_decode_path", json.dumps(out))
    del scan, par
    torch.cuda.empty_cache()
    return out


def options_phase(cfg, bert_cfg, params, resnet, tok, bare):
    """Phase 14: (a) the S=500 span step without and with remat; (b)
    phase 9's step with ``--params_bf16``; (c) the CLI → ``SpanTrainer``
    with ``--use_align --remat --params_bf16 --profile_dir`` and serving
    its run at S=500; (d) CRF serving and export with the parallel
    decode."""
    from mtvaf_tpu_torch.nn.bert import BertConfig

    t_phase = time.perf_counter()
    span_bert = BertConfig.base()
    out = {"long_step": long_step(span_bert),
           "master_step": master_step(cfg, bert_cfg, params, bare),
           **long_trainer(span_bert)}
    with tempfile.TemporaryDirectory() as tmp:
        out["parallel"] = parallel_decode(cfg, bert_cfg, params, resnet, tok,
                                          tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"options phase: {out['phase_s']:.1f} s")
    return out


def _kernel_name(mangled):
    """(name, template arguments) of a mangled ``..._kernel<...>`` symbol:
    the identifier ending in "kernel" whose length prefix matches."""
    end = mangled.find("kernel") + len("kernel")
    for start in range(end - 1, 0, -1):
        for k in (1, 2, 3):
            digits = mangled[start - k:start]
            if digits.isdigit() and int(digits) == end - start:
                args = mangled[end:]
                args = args[1:].split("EEv")[0] if args[:1] == "I" else ""
                return mangled[start:end], args
    return mangled, ""


# ---------------------------------------------------------------------------
# Phase 15: data parallelism (one process per rank) at the flagship width.

DP_TIMEOUT = 600


def dp_own_images(tr):
    """The image ids of the rows rank ``tr.rank`` was handed in a one-epoch
    run: its slice of every train batch and its eval batches."""
    from mtvaf_tpu_torch.data.datasets import iterate_batches
    cfg, ids = tr.cfg, set()
    for b in iterate_batches(tr.train_dataset.arrays, cfg.train_batch_size,
                             shuffle=True, seed=cfg.seed, epoch=1,
                             process_index=tr.rank, process_count=tr.world):
        ids |= {tr.train_dataset.features[i].img_id
                for i in b["example_index"]}
    for ds in (tr.dev_dataset, tr.test_dataset):
        for bi, b in enumerate(iterate_batches(ds.arrays,
                                               cfg.eval_batch_size)):
            if bi % tr.world == tr.rank:
                ids |= {ds.features[i].img_id for i in b["example_index"]}
    return ids


# leaves this small also keep each step's gradient (to print an element's)
STEP_GRAD_LEAF = 4096


def record_grads(optimizer):
    """What ``optimizer`` is handed over the run, kept on the card as the
    steps go: ``max/LEAF``, each element's largest |gradient|; ``sum/LEAF``
    the sum of its gradients; and, for a leaf of at most
    ``STEP_GRAD_LEAF`` elements, ``step/LEAF``, each step's gradient."""
    from mtvaf_tpu_torch.train.optim import tree_items
    apply, out = optimizer.apply, {}

    def recording(params, grads, state):
        for (k, _), g in zip(tree_items(params), grads):
            g = g.detach().float()
            m = out.get(f"max/{k}")
            out[f"max/{k}"] = g.abs() if m is None \
                else torch.maximum(m, g.abs())
            out[f"sum/{k}"] = g.clone() if m is None else out[f"sum/{k}"] + g
            if g.numel() <= STEP_GRAD_LEAF:
                out.setdefault(f"step/{k}", []).append(g)
        return apply(params, grads, state)

    optimizer.apply = recording
    return out


def dp_child(spec):
    """One process of phase 15 or 16 (``--dp-child SPEC``): the CLI through
    ``run_cli`` on ``spec["argv"]`` (RoBERTa-base with ``spec["roberta"]``),
    in a gloo group of its own making (``spec["gloo"]``), in the group the
    launcher's environment names, or alone; prints one ``dp_child`` JSON
    line with its data rank, model rank, history, metrics, kernel launches
    (counted from 0 just before the run), rows per train step and, with
    ``spec["table"]``, its guide table's images beside the images of its
    rows.  Under tensor parallelism the gradients it keeps
    (``spec["grads"]``) are gathered whole from the TP group, and global
    rank 0 writes them."""
    import datetime
    import torch.distributed as dist
    from mtvaf_tpu_torch.nn.bert import BertConfig

    # fp32 runs are compared across processes: no TF32 in convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if spec.get("deterministic_algorithms"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    gloo = spec.get("gloo")
    if gloo:
        dist.init_process_group(
            "gloo", init_method="file://" + gloo["store"],
            rank=gloo["rank"], world_size=gloo["world"],
            timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    seen = {}

    def on_trainer(tr):
        seen.update(rank=tr.rank, world=tr.world, rows=set())
        if spec.get("save_init"):
            from mtvaf_tpu_torch.core.checkpoint import save_best
            from mtvaf_tpu_torch.train.steps import export_params
            save_best(spec["save_init"], export_params(tr.state))
        if spec.get("grads"):
            seen["grads"] = record_grads(tr.optimizer)
        step = tr.train_step

        def counted(state, batch, seed):
            seen["rows"].add(int(batch["input_ids"].shape[0]))
            return step(state, batch, seed)

        tr.train_step = counted

    reset_counts()
    t0 = time.perf_counter()
    metrics, tr = run_cli(spec["argv"],
                          BertConfig.base(is_roberta=spec.get("roberta",
                                                              False)),
                          span=spec["span"], on_trainer=on_trainer)
    torch.cuda.synchronize()
    counts = read_counts()
    model_rank, writer = 0, True
    if tr.state.layout:
        from mtvaf_tpu_torch.core import mesh
        # the CLI forgot its grid on return; the group is this process's
        mesh.setup_grid(tr.cfg.mesh_model)
        model_rank, writer = mesh.model_rank(), mesh.rank() == 0
        if spec.get("grads"):
            seen["grads"] = tp_gather_grads(seen["grads"], tr.state.layout)
    # this rank's eval batches in one epoch: dev, then test (the CRF CLI
    # tests after the epoch and again on the best model at the end)
    mine = [len(range(seen["rank"], -(-len(d) // tr.cfg.eval_batch_size),
                      seen["world"]))
            for d in (tr.dev_dataset, tr.test_dataset)]
    out = {"rank": seen["rank"], "world": seen["world"],
           "model_rank": model_rank,
           "wall_s": time.perf_counter() - t0, "metrics": metrics,
           "history": tr.history, "counts": counts,
           "rows_per_step": sorted(seen["rows"]),
           "leaf_lr": {k: tr.cfg.lr * f
                       for k, f in tr.optimizer.factors.items()},
           "eval_batches": mine[0] + mine[1] * (1 if spec["span"] else 2)}
    if spec.get("grads") and writer:
        np.savez(spec["grads"], **{
            k: (torch.stack(v) if isinstance(v, list) else v).cpu().numpy()
            for k, v in seen["grads"].items()})
    if spec.get("table"):
        gc = tr.guide_cache
        out["table"] = {"keys": sorted({k[1] for k in gc._dev_rows}),
                        "own": sorted(dp_own_images(tr)),
                        "on_card": gc._dev_main is not None
                        and gc._dev_main.is_cuda}
    log("dp_child " + json.dumps(out))
    if gloo:
        dist.destroy_process_group()


def tp_gather_grads(kept, layout):
    """:func:`record_grads`' records of a TP rank (its shards) whole,
    gathered from the TP group (every rank of it calls this)."""
    from mtvaf_tpu_torch.core import mesh
    out = {}
    for kind in ("max", "sum"):
        part = {k.split("/", 1)[1]: v for k, v in kept.items()
                if k.startswith(kind + "/")}
        out.update({f"{kind}/{k}": v for k, v in
                    mesh.gather_tree(part, layout).items()})
    steps = {k.split("/", 1)[1]: v for k, v in kept.items()
             if k.startswith("step/")}
    for i in range(len(next(iter(steps.values()), []))):
        whole = mesh.gather_tree({k: v[i] for k, v in steps.items()}, layout)
        for k, v in whole.items():
            out.setdefault(f"step/{k}", []).append(v)
    return out


def dp_start(tmp, name, spec, launcher=False, env=None):
    """Start one phase-15 child (under ``torch.distributed.run`` with
    ``launcher``); returns (name, process, log path)."""
    path = os.path.join(tmp, f"{name}.log")
    cmd = [sys.executable, os.path.abspath(__file__), "--dp-child",
           json.dumps(spec)]
    if launcher:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", *cmd[1:]]
    with open(path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                env={**os.environ, **(env or {})},
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)))
    return name, proc, path


def dp_wait(children, timeout=DP_TIMEOUT):
    """Each child's ``dp_child`` result by name; a child that fails or
    outlives ``timeout`` stops the others and raises with its output."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for _, p, _ in children):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for _, p, _ in children):
                break
            time.sleep(0.2)
    finally:
        for _, p, _ in children:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = {}
    for name, p, path in children:
        with open(path) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("dp_child ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"child {name} exited "
                                 f"{p.returncode}:\n{text[-6000:]}")
        out[name] = json.loads(lines[-1].split(" ", 1)[1])
    return out


# An element whose largest |gradient| over the run stayed within this share
# of the run's largest gradient element is at rounding level: a bias that
# shifts every score of a softmax alike (the key third of attn/qkv/bias,
# the GCN heads' affine and attn_k biases) has a gradient that is zero in
# exact arithmetic, and AdamW moves such an element by up to lr a step in
# a direction that rounding sets, in each run its own.
ROUNDING = 1e-7
# An element whose two runs' gradient sums part by more than this share of
# steps × its largest |gradient| took another gradient in some step than
# summation order explains: a ReLU unit at its edge for some token, which
# one run passes and the other does not.  The share of such elements is
# held to PARTED_SHARE of the model's.
PARTED, PARTED_SHARE = 1e-3, 1e-4


def dp_leaf_diff(a_path, b_path, init_path=None, grads_path=None,
                 leaf_lr=None, a_grads_path=None, steps=None):
    """Two ``best_model.npz`` files compared leaf by leaf: whether all are
    bitwise equal; and, given the initial model ``init_path``, what the
    runs ``b`` and ``a`` kept of their gradients (``grads_path``,
    ``a_grads_path``: :func:`record_grads`), each leaf's lr and the
    number of steps, the rule of phase 15(b)/(c):

    * every element within 2·lr of ``b`` over the run;
    * over each leaf's elements whose gradient was not at rounding level
      (``ROUNDING``) and whose two runs' gradients did not part
      (``PARTED``), the difference's L2 norm within the larger of 2% of
      the norm of how far ``b`` moved them (the repo's trainer-test rule
      as a norm) and 1e-4 of their norm;
    * at most ``PARTED_SHARE`` of the elements parted.

    Also the largest share of the magnitude read, the rounding-level
    elements per leaf (with a gradient that was not exactly 0
    throughout), the parted elements per leaf, each leaf's norm ratio
    nearest its limit, and the elements nearest their 2·lr, each with its
    largest gradient and, from a leaf small enough, both runs' gradient at
    every step."""
    out = {"bitwise": True, "magnitude": (0.0, None), "rounding": {},
           "parted": {}, "norms": [], "nearest": [], "failed": []}
    held = init_path is not None
    init = np.load(init_path) if held else None
    grads = dict(np.load(grads_path)) if held else {}
    a_grads = dict(np.load(a_grads_path)) if held else {}
    top = max((float(v.max()) for k, v in grads.items()
               if k.startswith("max/")), default=0.0)
    norms, nearest, n_parted, n_real = [], [], 0, 0
    with np.load(a_path) as a, np.load(b_path) as b:
        if set(a.files) != set(b.files):
            raise AssertionError(f"{a_path} and {b_path} hold other leaves")
        for k in b.files:
            x, y = a[k], b[k]
            out["bitwise"] &= x.dtype == y.dtype and np.array_equal(x, y)
            if not held:
                continue
            diff = np.abs(x.astype(np.float64) - y)
            zero = np.zeros(y.shape, np.float32)
            g = grads.get(f"max/{k}", zero)
            flat = g <= ROUNDING * top
            parted = ~flat & (np.abs(
                a_grads.get(f"sum/{k}", zero).astype(np.float64)
                - grads.get(f"sum/{k}", zero)) > PARTED * steps * g)
            out["magnitude"] = max(out["magnitude"], (
                float(diff.max()) / max(float(np.abs(y).max()), 1e-30), k),
                key=lambda w: w[0])
            if (flat & (g > 0)).any():
                out["rounding"][k] = {
                    "elements": int((flat & (g > 0)).sum()),
                    "of": int(g.size),
                    "max_abs_diff": float(diff[flat].max()),
                    "max_grad": float(g[flat].max())}
            if parted.any():
                out["parted"][k] = {"elements": int(parted.sum()),
                                    "of": int(g.size),
                                    "max_abs_diff": float(diff[parted].max())}
            n_parted += int(parted.sum())
            n_real += int((~flat).sum())
            cap = 2 * leaf_lr.get(k, 0.0)
            share = diff / max(cap, 1e-30)
            i = int(share.argmax())
            near = {"leaf": k, "index": i, "abs_diff": float(diff.flat[i]),
                    "bound": cap, "max_grad": float(g.flat[i]),
                    "rounding_level": bool(flat.flat[i]),
                    "parted": bool(parted.flat[i])}
            for run, kept in (("steps_b", grads), ("steps_a", a_grads)):
                if f"step/{k}" in kept:
                    near[run] = kept[f"step/{k}"].reshape(
                        len(kept[f"step/{k}"]), -1)[:, i].tolist()
            nearest.append((float(share.flat[i]), near))
            if share.max() > 1:
                out["failed"].append(("element past 2·lr", k,
                                      int((share > 1).sum()),
                                      float(share.max())))
            held_norm = ~flat & ~parted
            if not held_norm.any():
                continue
            d = float(np.linalg.norm(diff[held_norm]))
            limit = max(2e-2 * float(np.linalg.norm(
                y[held_norm].astype(np.float64) - init[k][held_norm])),
                1e-4 * float(np.linalg.norm(y[held_norm])))
            norms.append((d / max(limit, 1e-30), k, d, limit))
            if d > limit:
                out["failed"].append(("leaf norm", k, d, limit))
    if held:
        init.close()
        out["top_grad"] = top
        out["parted_share"] = n_parted / max(n_real, 1)
        if out["parted_share"] > PARTED_SHARE:
            out["failed"].append(("parted", n_parted, n_real))
        out["norms"] = sorted(norms, reverse=True)[:3]
        out["nearest"] = [n for _, n in sorted(
            nearest, key=lambda w: -w[0])[:3]]
    return out


def dp_compare(name, ref, ranks, ref_save, dp_save, layers, phase="15",
               data=None):
    """Phase 15(b)/(c) (and 16(a)/(b)): each rank against the one-process
    run on the same flags and global batch, the ranks on a data axis of
    ``data`` (all of them by default)."""
    data = data or len(ranks)
    want_loss = ref["history"][0]["train_loss"]
    rel_loss = max(abs(r["history"][0]["train_loss"] - want_loss)
                   / abs(want_loss) for r in ranks)
    steps = ref["history"][0]["steps"]
    leaves = dp_leaf_diff(os.path.join(dp_save, "best_model.npz"),
                          os.path.join(ref_save, "best_model.npz"),
                          os.path.join(ref_save, "init_model.npz"),
                          os.path.join(ref_save, "grads.npz"),
                          ref["leaf_lr"],
                          os.path.join(dp_save, "grads.npz"), steps)
    out = {"train_loss": [want_loss] + [r["history"][0]["train_loss"]
                                        for r in ranks],
           "loss_rel_diff": rel_loss,
           "leaf_diff_over_magnitude": leaves["magnitude"],
           "top_grad": leaves["top_grad"],
           "rounding_level_elements": leaves["rounding"],
           "parted_elements": leaves["parted"],
           "parted_share": leaves["parted_share"],
           "leaf_norms_nearest_limit": leaves["norms"],
           "elements_nearest_2lr": leaves["nearest"],
           "metrics": [ref["metrics"]]
           + [r["metrics"] for r in ranks],
           "launches": dp_launches(ranks), "ref_launches": ref["counts"],
           "rows_per_step": [r["rows_per_step"] for r in ranks]}
    log(f"{'dp' if phase == '15' else 'tp'}_{name}", json.dumps(out))
    for r in ranks:
        if r["metrics"] != ref["metrics"]:
            raise AssertionError(f"{phase} {name}: rank {r['rank']}'s F1 "
                                 f"{r['metrics']} is not {ref['metrics']}")
        if r["rows_per_step"] != [ref["rows_per_step"][0] // data]:
            raise AssertionError(f"{phase} {name}: rank {r['rank']} took "
                                 f"{r['rows_per_step']} rows a step")
        c = r["counts"]
        if c["k2"] != layers * steps or c["mask"] or \
                c["k1"] != layers * (steps + r["eval_batches"]):
            raise AssertionError(
                f"{phase} {name}: rank {r['rank']} launched {c} for {steps} "
                f"steps and {r['eval_batches']} eval batches")
    if rel_loss > 1e-4 or leaves["failed"]:
        raise AssertionError(
            f"{phase} {name}: the ranks' loss differs by {rel_loss} (limit "
            f"1e-4 relative); past their limits: {leaves['failed']}; nearest: "
            f"{leaves['norms']}, {leaves['nearest']}")
    return out


def dp_launches(ranks):
    return {f"rank{r['rank']}" + (f"_model{r['model_rank']}"
                                  if len({x.get("model_rank", 0)
                                          for x in ranks}) > 1 else ""):
            {"k1": r["counts"]["k1"], "k2": r["counts"]["k2"],
             "mask": r["counts"]["mask"]}
            for r in ranks}


def dp_kernel_launches(dp_path, name):
    """Phase 15's launches of one kernel, per run and rank (each counted
    from 0 just before its run, in its own process)."""
    a = dp_path["a"]["launches"]
    return {"nccl_world1": a["nccl_world1"][name],
            "single": a["single"][name],
            **{f"{p}_{rank}": n[name]
               for p, key in (("gloo_fp32", "b"), ("gloo_span", "c"),
                              ("gloo_bf16", "d"))
               for rank, n in dp_path[key]["launches"].items()}}


def tp_kernel_launches(tp_path, rows, name):
    """Phase 16's launches of one kernel, per run and rank (each counted
    from 0 just before its run, in its own process), and its 16(k) rows."""
    launches = {f"{key}_{rank}": n[name]
                for key in ("a", "b", "c")
                for rank, n in tp_path[key]["launches"].items()}
    launches.update({f"{key}_single": tp_path[key]["ref_launches"][name]
                     for key in ("a", "b")})
    return {"launches": launches,
            "head_offset_rows": [r for k, r in rows.items()
                                 if k.split("_")[0] == name]}


def dp_phase(tmp):
    """Phase 15: data parallelism at the flagship width, one epoch per run
    on phase 10's synthetic Twitter-2015 tree (and phase 11's span tree):
    (a) NCCL at world size 1 through ``torch.distributed.run``, bitwise
    against the same flags in one process (both under deterministic
    algorithms); (b) two gloo ranks sharing the card, fp32 with images,
    against one process; (c) the span CLI with DualGCN and the masked span
    CE on two gloo ranks against one process; (d) bf16 on two gloo ranks,
    each rank's device guide table holding its own rows' images, against
    (a)'s one-process run.  Returns (its numbers, what phase 16 reuses:
    the trees and (d)'s two ranks under ``tmp``)."""
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.data.datasets import SpanDataset
    from mtvaf_tpu_torch.data.tokenization import build_tokenizer
    from mtvaf_tpu_torch.native.binding import maybe_accelerate
    from mtvaf_tpu_torch.nn.bert import BertConfig

    layers = BertConfig.base().num_hidden_layers
    t_phase = time.perf_counter()
    out = {}
    root, bert_dir, cache, _ = trainer_tree(tmp)
    span_root, span_bert = span_tree(tmp)
    cfg = Config(dataset_name="twitter15", max_seq=TRAIN_S)
    tok = maybe_accelerate(build_tokenizer(span_bert, cfg.do_lower_case))
    for k, (mode, fname) in enumerate((("train", "train.txt"),
                                       ("dev", "valid.txt"),
                                       ("test", "test.txt"))):
        path = os.path.join(span_root, "twitter2015", fname)
        write_gcn_side_file(
            os.path.join(span_root, "twitter2015",
                         f"twitter15_{mode}.json"),
            SpanDataset.load(cfg, tok, path), seed=SEED + 40 + k)

    def crf_argv(save, *extra):
        argv = _trainer_argv(root, bert_dir, cache,
                             os.path.join(tmp, save), "--do_train",
                             "--num_epochs", "1", *extra)
        if "--no_bf16" in extra:
            argv.remove("--bf16")
        return argv

    def span_argv(save):
        return ["--dataset_name", "twitter15", "--bert_name", span_bert,
                "--data_root", span_root, "--save_path",
                os.path.join(tmp, save), "--max_seq", str(TRAIN_S),
                "--train_batch_size", str(TRAIN_B), "--eval_batch_size",
                str(TRAINER_EVAL_BATCH), "--num_epochs", "1",
                "--eval_begin_epoch", "1", "--seed", str(SEED),
                "--logit_threshold", "0", "--num_layers", "2",
                "--span_ac_loss_mode", "masked", "--no_bf16",
                "--deterministic", "--do_train"]

    def spec(argv, span=False, gloo=None, **kw):
        return {"argv": argv, "span": span, "gloo": gloo, **kw}

    # (a) NCCL at world size 1 through the launcher, and one process;
    # one after the other, so that each one's examples/s is its own
    det = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    single = dp_wait([dp_start(tmp, "a_single", spec(
        crf_argv("a_single"), deterministic_algorithms=True), env=det)])
    nccl = dp_wait([dp_start(tmp, "a_nccl", spec(
        crf_argv("a_nccl"), deterministic_algorithms=True),
        launcher=True, env=det)])
    single, nccl = single["a_single"], nccl["a_nccl"]
    bitwise = dp_leaf_diff(
        os.path.join(tmp, "a_nccl", "best_model.npz"),
        os.path.join(tmp, "a_single", "best_model.npz"))["bitwise"]
    a = {"world": nccl["world"],
         "train_loss": [single["history"][0]["train_loss"],
                        nccl["history"][0]["train_loss"]],
         "metrics": [single["metrics"], nccl["metrics"]],
         "best_model_bitwise": bitwise,
         "examples_per_s": {
             "single": single["history"][0]["examples_per_s"],
             "nccl_world1": nccl["history"][0]["examples_per_s"]},
         "launches": {"single": single["counts"],
                      "nccl_world1": nccl["counts"]}}
    log("dp_nccl_world1", json.dumps(a))
    if nccl["world"] != 1 or not bitwise \
            or a["train_loss"][0] != a["train_loss"][1] \
            or single["metrics"] != nccl["metrics"] \
            or single["counts"] != nccl["counts"]:
        raise AssertionError(f"15(a): NCCL at world size 1 is not the "
                             f"one-process run bit for bit: {a}")
    out["a"] = a

    # (b), (c) and (d) side by side (eight processes): gloo ranks share
    # the card
    def ranks(name, argv, world=2, rank0=None, **kw):
        store = os.path.join(tmp, f"{name}.pg_store")
        return [dp_start(tmp, f"{name}_rank{r}", spec(
            argv, gloo={"rank": r, "world": world, "store": store},
            **kw, **(rank0 if r == 0 and rank0 else {})))
            for r in range(world)]

    def grads(save):
        return {"grads": os.path.join(tmp, save, "grads.npz")}

    def kept(save):
        return {"save_init": os.path.join(tmp, save, "init_model.npz"),
                **grads(save)}

    fp32 = ("--no_bf16", "--deterministic")
    wave = dp_wait([dp_start(tmp, "b_single",
                             spec(crf_argv("b_single", *fp32),
                                  **kept("b_single"))),
                    dp_start(tmp, "c_single",
                             spec(span_argv("c_single"), span=True,
                                  **kept("c_single")))]
                   + ranks("b", crf_argv("b_dp", *fp32),
                           rank0=grads("b_dp"))
                   + ranks("c", span_argv("c_dp"), span=True,
                           rank0=grads("c_dp"))
                   + ranks("d", crf_argv("d_dp"), table=True, rank0={
                       "save_init": os.path.join(tmp, "d_dp",
                                                 "init_model.npz")}))
    out["b"] = dp_compare(
        "b", wave["b_single"], [wave["b_rank0"], wave["b_rank1"]],
        os.path.join(tmp, "b_single"), os.path.join(tmp, "b_dp"),
        layers)

    d_ranks = [wave["d_rank0"], wave["d_rank1"]]
    want = single["history"][0]["train_loss"]
    d = {"train_loss": [want] + [r["history"][0]["train_loss"]
                                 for r in d_ranks],
         "launches": dp_launches(d_ranks),
         "table_images": [len(r["table"]["keys"]) for r in d_ranks],
         "own_images": [len(r["table"]["own"]) for r in d_ranks],
         "examples_per_s": d_ranks[0]["history"][0]["examples_per_s"]}
    log("dp_bf16_table", json.dumps(d))
    for r in d_ranks:
        t, loss = r["table"], r["history"][0]["train_loss"]
        if t["keys"] != t["own"] or not t["on_card"]:
            raise AssertionError(
                f"15(d): rank {r['rank']}'s guide table holds "
                f"{len(t['keys'])} images, its rows "
                f"{len(t['own'])}, and they differ")
        if not math.isfinite(loss) or abs(loss - want) > 0.05 * abs(want):
            raise AssertionError(f"15(d): rank {r['rank']}'s loss "
                                 f"{loss} is not within 5% of {want}")
        if r["counts"]["k1"] == 0 or r["counts"]["k2"] == 0:
            raise AssertionError(f"15(d): rank {r['rank']} launched "
                                 f"{r['counts']}")
    if set(d_ranks[0]["table"]["keys"]) == set(d_ranks[1]["table"]
                                               ["keys"]):
        raise AssertionError("15(d): both ranks' tables hold the same "
                             "images")
    out["d"] = d
    out["c"] = dp_compare(
        "c", wave["c_single"], [wave["c_rank0"], wave["c_rank1"]],
        os.path.join(tmp, "c_single"), os.path.join(tmp, "c_dp"),
        layers)
    out["seconds"] = time.perf_counter() - t_phase
    log("dp_phase_seconds", out["seconds"])
    return out, {"crf": (root, bert_dir, cache), "span": span_root,
                 "d_ranks": d_ranks}


# ---------------------------------------------------------------------------
# Phase 16: tensor parallelism.

# A TP rank's heads of BERT-base on a model axis of 2: heads 6-11.
TP_HEADS, TP_OFFSET = 6, 6
TP_TIMEOUT = 600


def check_head_offset(rate=0.1):
    """Phase 16(k): K1, K2 and the mask entry point keyed from head
    ``TP_OFFSET`` at the train shape with ``TP_HEADS`` heads: against their
    plain versions given the same (offset) masks, bit for bit against heads
    6-11 of a 12-head call on the same inputs, and timed beside the bound
    and SDPA.  Returns the rows."""
    from mtvaf_tpu_torch.kernels.prefix_attention import (
        keep_factors, keep_mask_cuda, keep_mask_reference,
        prefix_attention_bwd_cuda, prefix_attention_bwd_reference,
        prefix_attention_cuda, prefix_attention_reference)
    import torch.nn.functional as F

    dev = torch.device("cuda")
    b, h, s, t, d, dtype = TRAIN_B, TP_HEADS, TRAIN_S, TRAIN_S + 16, 64, \
        torch.bfloat16
    full_h, lo = TP_OFFSET + TP_HEADS, TP_OFFSET
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    q, k, v, bias = attention_inputs(g, b, full_h, s, t, d, dtype)
    do = torch.randn(b, full_h, s, d, device=dev, generator=g).to(dtype)
    part = [x[:, lo:].contiguous() for x in (q, k, v, do)]
    rows = {}

    # the mask entry point
    shape = (b, h, s, t)
    got = keep_mask_cuda(DROPOUT_SEED, rate, shape, dev, head_offset=lo)
    whole = keep_mask_cuda(DROPOUT_SEED, rate, (b, full_h, s, t), dev)
    plain = keep_mask_reference(DROPOUT_SEED, rate, shape, dev,
                                head_offset=lo)
    torch.cuda.synchronize()
    mask_bytes = b * h * s * t * 4
    rows["mask"] = {
        "shape": "train_h6_offset6", "rate": rate,
        "mismatches_vs_full_heads_6_11": int((got != whole[:, lo:]).sum()),
        "mismatches_vs_plain": int((got != plain).sum()),
        "ms": device_ms(lambda: keep_mask_cuda(DROPOUT_SEED, rate, shape, dev,
                                               head_offset=lo)),
        "plain_ms": device_ms(lambda: keep_mask_reference(
            DROPOUT_SEED, rate, shape, dev, head_offset=lo)),
        "bound_ms": mask_bytes / HBM_BPS * 1e3, "bound_by": "bytes",
        "library_ms": None}
    del whole, plain
    log("tp_keep_mask", json.dumps(rows["mask"]))
    if rows["mask"]["mismatches_vs_full_heads_6_11"] \
            or rows["mask"]["mismatches_vs_plain"]:
        raise AssertionError(f"16(k): the offset mask is not heads 6-11 of "
                             f"the full one: {rows['mask']}")

    for r in (0.0, rate):
        keep = keep_factors(DROPOUT_SEED, r, shape, dev, head_offset=lo) \
            if r else None
        o, lse = prefix_attention_cuda(*part[:3], bias, seed=DROPOUT_SEED,
                                       rate=r, head_offset=lo)
        o12, lse12 = prefix_attention_cuda(q, k, v, bias, seed=DROPOUT_SEED,
                                           rate=r)
        grads = prefix_attention_bwd_cuda(*part[:3], bias, o, lse, part[3],
                                          seed=DROPOUT_SEED, rate=r,
                                          head_offset=lo)
        grads12 = prefix_attention_bwd_cuda(q, k, v, bias, o12, lse12, do,
                                            seed=DROPOUT_SEED, rate=r)
        torch.cuda.synchronize()
        ro, _ = prefix_attention_reference(*part[:3], bias, keep)
        _, rlse = prefix_attention_reference(*part[:3], bias)
        rgrads = prefix_attention_bwd_reference(*part[:3], bias, o, lse,
                                                part[3], keep)
        bitwise_fwd = bool(torch.equal(o, o12[:, lo:])
                           and torch.equal(lse, lse12[:, lo:]))
        bitwise_bwd = all(torch.equal(a, w[:, lo:])
                          for a, w in zip(grads, grads12))
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        err_g = max((a.float() - p.float()).abs().max().item()
                    for a, p in zip(grads, rgrads))
        del o12, lse12, grads12, rgrads
        for name, err, atol, bitwise, fn, plain_fn, lib_fn, bound in (
                ("k1", max(err_o, err_lse), K1_ATOL[dtype], bitwise_fwd,
                 lambda: prefix_attention_cuda(
                     *part[:3], bias, seed=DROPOUT_SEED, rate=r,
                     head_offset=lo),
                 lambda: prefix_attention_reference(*part[:3], bias, keep),
                 lambda: F.scaled_dot_product_attention(
                     *part[:3], attn_mask=bias.to(dtype), dropout_p=r),
                 k1_bound(b, h, s, t, d, dtype)),
                ("k2", err_g, K2_ATOL[dtype], bitwise_bwd,
                 lambda: prefix_attention_bwd_cuda(
                     *part[:3], bias, o, lse, part[3], seed=DROPOUT_SEED,
                     rate=r, head_offset=lo),
                 lambda: prefix_attention_bwd_reference(
                     *part[:3], bias, o, lse, part[3], keep),
                 None, k2_bound(b, h, s, t, d, dtype))):
            ms = device_ms(fn)
            lib_ms = device_ms(lib_fn) if lib_fn else \
                sdpa_backward_ms(*part[:3], bias, part[3], r)
            row = {"shape": "train_h6_offset6", "B": b, "H": h, "S": s,
                   "T": t, "D": d, "rate": r, "head_offset": lo,
                   "max_abs_err": err, "atol": atol,
                   "bitwise_vs_full_heads_6_11": bitwise, "ms": ms,
                   "plain_ms": device_ms(plain_fn), "library_ms": lib_ms,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   **shares(dtype, ms, bound[0], lib_ms)}
            log(f"tp_{name}", json.dumps(row))
            rows[f"{name}_{'dropout' if r else 'plain'}"] = row
            if not (math.isfinite(err) and err <= atol and bitwise):
                raise AssertionError(f"16(k): {name} with head_offset "
                                     f"{lo} at rate {r}: {row}")
        del keep
    torch.cuda.empty_cache()
    return rows


def tp_phase(tmp, trees):
    """Phase 16: tensor parallelism at the flagship width on phase 15's
    trees, each run one epoch in children of this process (``--dp-child``),
    the ranks sharing the card over gloo: (a) the CRF CLI, fp32 with
    images and dropout on, at ``--mesh_model 2`` on two ranks against one
    process; (b) the span CLI with RoBERTa-base and DualGCN the same way;
    (c) bf16 CRF at ``--mesh_data 2 --mesh_model 2`` on four ranks against
    phase 15(d)'s two ranks at ``--mesh_data 2``."""
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.data.datasets import SpanDataset
    from mtvaf_tpu_torch.data.synthetic import make_roberta_vocab
    from mtvaf_tpu_torch.data.tokenization import build_tokenizer
    from mtvaf_tpu_torch.nn.bert import BertConfig
    import shutil

    layers = BertConfig.base().num_hidden_layers
    t_phase = time.perf_counter()
    root, bert_dir, cache = trees["crf"]
    # RoBERTa's span tree: phase 15's sentences, side files over RoBERTa's
    # tokens
    rob_root = os.path.join(tmp, "roberta_data")
    rob_bert = os.path.join(tmp, "roberta-base")
    make_roberta_vocab(rob_bert)
    os.makedirs(os.path.join(rob_root, "twitter2015"))
    cfg = Config(dataset_name="twitter15", max_seq=TRAIN_S,
                 bert_name=rob_bert)
    tok = build_tokenizer(rob_bert, cfg.do_lower_case)
    for k, (mode, fname) in enumerate((("train", "train.txt"),
                                       ("dev", "valid.txt"),
                                       ("test", "test.txt"))):
        path = shutil.copy(os.path.join(trees["span"], "twitter2015", fname),
                           os.path.join(rob_root, "twitter2015", fname))
        write_gcn_side_file(
            os.path.join(rob_root, "twitter2015", f"twitter15_{mode}.json"),
            SpanDataset.load(cfg, tok, path), seed=SEED + 60 + k)

    def crf_argv(save, *extra):
        argv = _trainer_argv(root, bert_dir, cache, os.path.join(tmp, save),
                             "--do_train", "--num_epochs", "1", *extra)
        if "--no_bf16" in extra:
            argv.remove("--bf16")
        return argv

    def span_argv(save, *extra):
        return ["--dataset_name", "twitter15", "--bert_name", rob_bert,
                "--data_root", rob_root, "--save_path",
                os.path.join(tmp, save), "--max_seq", str(TRAIN_S),
                "--train_batch_size", str(TRAIN_B), "--eval_batch_size",
                str(TRAINER_EVAL_BATCH), "--num_epochs", "1",
                "--eval_begin_epoch", "1", "--seed", str(SEED),
                "--logit_threshold", "0", "--num_layers", "2",
                "--span_ac_loss_mode", "masked", "--no_bf16",
                "--deterministic", "--do_train", *extra]

    def ranks(name, argv, world, span=False, **kw):
        store = os.path.join(tmp, f"{name}.pg_store")
        return [dp_start(tmp, f"{name}_rank{r}", {
            "argv": argv, "span": span, "gloo": {"rank": r, "world": world,
                                                 "store": store}, **kw})
            for r in range(world)]

    def kept(save):
        return {"save_init": os.path.join(tmp, save, "init_model.npz"),
                "grads": os.path.join(tmp, save, "grads.npz")}

    tp2 = ("--mesh_model", "2")
    wave = dp_wait(
        [dp_start(tmp, "tp_a_single", {
            "argv": crf_argv("tp_a_single", "--no_bf16"), "span": False,
            **kept("tp_a_single")}),
         dp_start(tmp, "tp_b_single", {
             "argv": span_argv("tp_b_single"), "span": True,
             "roberta": True, **kept("tp_b_single")})]
        + ranks("tp_a", crf_argv("tp_a", "--no_bf16", *tp2), 2,
                grads=os.path.join(tmp, "tp_a", "grads.npz"))
        + ranks("tp_b", span_argv("tp_b", *tp2), 2, span=True, roberta=True,
                grads=os.path.join(tmp, "tp_b", "grads.npz"))
        + ranks("tp_c", crf_argv("tp_c", "--mesh_data", "2", *tp2), 4),
        timeout=TP_TIMEOUT)
    out = {}
    for key, name in (("a", "tp_a"), ("b", "tp_b")):
        out[key] = dp_compare(
            key, wave[f"{name}_single"],
            [wave[f"{name}_rank{r}"] for r in range(2)],
            os.path.join(tmp, f"{name}_single"), os.path.join(tmp, name),
            layers, phase="16", data=1)
    out["c"] = tp_against_dp(
        [wave[f"tp_c_rank{r}"] for r in range(4)], trees["d_ranks"],
        os.path.join(tmp, "tp_c", "best_model.npz"),
        os.path.join(tmp, "d_dp", "best_model.npz"),
        os.path.join(tmp, "d_dp", "init_model.npz"), layers)
    out["seconds"] = time.perf_counter() - t_phase
    log("tp_phase_seconds", out["seconds"])
    return out


# Phase 16(c)'s leaf rule: each ``best_model.npz`` leaf of the 2×2 run
# within this share of how far the 2×1 run moved it from the initial model
# (L2 norms).  bf16 rounding in another summation order moves a leaf's
# AdamW steps by a few percent; a DP or TP group wired to the wrong ranks
# averages another shard's or another batch's gradient into a leaf and
# moves it by about as much as the leaf moved at all.
TP_C_SHARE = 0.25


def tp_against_dp(tp_ranks, dp_ranks, tp_best, dp_best, init, layers):
    """Phase 16(c): bf16 DP×TP (2×2) against phase 15(d)'s DP (2×1) on the
    same flags, whose data ranks draw the same dropout: the loss to 1e-2
    relative, dev and test F1 within 0.02, each ``best_model.npz`` leaf's
    difference within ``TP_C_SHARE`` of how far the 2×1 run moved it from
    ``init`` (or 1e-4 of its norm), K1/K2 launches per rank."""
    want = dp_ranks[0]["history"][0]
    steps = want["steps"]
    norms, failed = [], []
    with np.load(tp_best) as a, np.load(dp_best) as b, np.load(init) as i:
        if set(a.files) != set(b.files):
            raise AssertionError(f"16(c): {tp_best} and {dp_best} hold "
                                 f"other leaves")
        for k in b.files:
            y = b[k].astype(np.float64)
            d = float(np.linalg.norm(a[k] - y))
            moved = float(np.linalg.norm(y - i[k]))
            limit = max(TP_C_SHARE * moved, 1e-4 * float(np.linalg.norm(y)))
            norms.append((d / max(moved, 1e-30), k, d, moved))
            if d > limit:
                failed.append((k, d, limit))
    norms.sort(reverse=True)
    rel = max(abs(r["history"][0]["train_loss"] - want["train_loss"])
              / abs(want["train_loss"]) for r in tp_ranks)
    f1 = max(abs(r["metrics"][k] - dp_ranks[0]["metrics"][k])
             for r in tp_ranks for k in dp_ranks[0]["metrics"])
    out = {"train_loss": [want["train_loss"]]
           + [r["history"][0]["train_loss"] for r in tp_ranks],
           "loss_rel_diff": rel, "f1_max_abs_diff": f1,
           "metrics": [dp_ranks[0]["metrics"]]
           + [r["metrics"] for r in tp_ranks],
           # (|2×2 − 2×1| / |2×1 − init|, leaf, |2×2 − 2×1|, |2×1 − init|)
           "leaf_diff_over_movement": norms[:5],
           "leaves_past_limit": failed,
           "launches": dp_launches(tp_ranks),
           "dp_launches": dp_launches(dp_ranks),
           "rows_per_step": [r["rows_per_step"] for r in tp_ranks],
           "examples_per_s": [r["history"][0]["examples_per_s"]
                              for r in tp_ranks]}
    log("tp_c", json.dumps(out))
    for r in tp_ranks:
        c = r["counts"]
        if c["k2"] != layers * steps or c["mask"] or \
                c["k1"] != layers * (steps + r["eval_batches"]) or \
                r["rows_per_step"] != dp_ranks[0]["rows_per_step"]:
            raise AssertionError(f"16(c): rank {r['rank']}/"
                                 f"{r['model_rank']} launched {c} over "
                                 f"{r['rows_per_step']} rows a step")
    if rel > 1e-2 or f1 > 0.02 or failed:
        raise AssertionError(f"16(c): DP×TP is not DP to summation order: "
                             f"{out}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the C++ host runtime (batch WordPiece and the image op) and the
# parity harness's dry run.

# The image op against its plain numpy version, in normalised units: the
# same float32 formula on both sides (one rounding order), so they agree
# to a few ulps of values below ~3.
NATIVE_ATOL = 1e-5
# Crops of the two gradient images (300×400 and 400×300): the centre, rows
# and columns past the resized image (zero-padded), and a 128 crop.
GRADIENT_CROPS = {"centre": {}, "rows_past": {"top": 100, "left": 0},
                  "columns_past": {"top": 0, "left": 200},
                  "crop128": {"top": 40, "left": 60, "crop": 128}}
HOST_IMAGES = 32
# The parity dry run: five configs, six rows (c5 on both datasets).
PARITY_ROWS = 6
PARITY_TIMEOUT = 900


def gradient_image(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([yy * 255 / h, xx * 255 / w, (yy + xx) * 255 / (h + w)],
                    axis=-1).astype(np.uint8)


def host_ms(fn, items, repeats=3):
    """Host ms of ``fn`` per item, over ``repeats`` passes."""
    t0 = time.perf_counter()
    for _ in range(repeats):
        for item in items:
            fn(item)
    return (time.perf_counter() - t0) * 1e3 / (repeats * len(items))


def host_runtime_phase(card):
    """Phase 17(a): the C++ host runtime is loaded (``native:
    native``); the image op against its plain numpy version on phase 10's
    first images (regenerated from its seed, and equal to the rows its
    pixel cache holds) and on two gradient images at four crops, its
    mirror exact; the accelerated tokenizer's tokens and ids equal the
    Python tokenizer's on every sentence of phases 10's and 11's trees,
    whole and word by word (as feature conversion calls it); host ms per
    image and per 1000 sentences, native against PIL and Python."""
    from mtvaf_tpu_torch.data import images, readers
    from mtvaf_tpu_torch.data.tokenization import build_tokenizer
    from mtvaf_tpu_torch.native import binding, reference

    t_phase = time.perf_counter()
    status = binding.status()
    log(f"native: {status}")
    if status != "native":
        raise AssertionError(f"17(a): the C++ host runtime is not loaded: "
                             f"{status}")
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root, bert_dir, cache, ids = trainer_tree(tmp)
        out["phase10_tree_s"] = time.perf_counter() - t0
        span_root, _ = span_tree(tmp)

        # pixels: phase 10's first images, drawn again from its seed
        rng = np.random.default_rng(SEED)
        raws = [raw_image(rng) for _ in range(HOST_IMAGES)]
        worst, cases = 0.0, 0
        for raw, img in zip(raws, ids):
            got = binding.native_preprocess(raw)
            if not np.array_equal(got, np.load(os.path.join(
                    cache, "img", img + ".npy"))):
                raise AssertionError(f"17(a): the pixel cache's {img} is "
                                     "not the library's rows")
            worst = max(worst, float(np.abs(
                got - reference.img_preprocess(raw)).max()))
            if not np.array_equal(binding.native_preprocess(raw, hflip=True),
                                  got[:, ::-1]):
                raise AssertionError("17(a): hflip is not the mirrored crop")
            cases += 1
        for h, w in ((300, 400), (400, 300)):
            raw = gradient_image(h, w)
            for name, kw in GRADIENT_CROPS.items():
                got = binding.native_preprocess(raw, **kw)
                want = reference.img_preprocess(raw, **kw)
                if got.shape != want.shape:
                    raise AssertionError(f"17(a): {h}x{w} {name}: shape "
                                         f"{got.shape} != {want.shape}")
                worst = max(worst, float(np.abs(got - want).max()))
                if not np.array_equal(
                        binding.native_preprocess(raw, hflip=True, **kw),
                        got[:, ::-1]):
                    raise AssertionError(f"17(a): {h}x{w} {name}: hflip is "
                                         "not the mirrored crop")
                cases += 1
        out["image_max_abs_diff"] = worst
        out["image_cases"] = cases
        log(f"17(a) image op against native/reference.py: {cases} cases, "
            f"max |diff| {worst:.3e} (limit {NATIVE_ATOL})")
        if worst > NATIVE_ATOL:
            raise AssertionError(f"17(a): the image op is {worst} from its "
                                 f"plain version")

        # tokens: every sentence of phases 10's and 11's trees
        sentences = []
        for fname in ("train.txt", "valid.txt", "test.txt"):
            data = readers.read_mmtsv(
                os.path.join(root, "twitter2015", "twitter2015", fname),
                os.path.join(root, "ANP_data", "image_output2015.json"))[0]
            sentences += [words for words, _ in data]
            sentences += readers.read_absa_data(
                os.path.join(span_root, "twitter2015", fname))["words"]
        python = build_tokenizer(bert_dir)
        native = binding.maybe_accelerate(python)
        if not isinstance(native, binding.AcceleratedTokenizer):
            raise AssertionError("17(a): maybe_accelerate did not wrap the "
                                 "WordPiece tokenizer")
        for words in sentences:
            text = " ".join(words)
            want = python.tokenize(text)
            if native.tokenize(text) != want or [
                    native.tokenize(" " + w) for w in words] != [
                    python.tokenize(" " + w) for w in words] or \
                    native.convert_tokens_to_ids(want) != \
                    python.convert_tokens_to_ids(want):
                raise AssertionError(f"17(a): the tokenizers differ on "
                                     f"{text!r}")
        out["sentences"] = len(sentences)
        texts = [" ".join(words) for words in sentences]
        out["tokens_ms_per_1000"] = {
            name: {"sentence": 1000 * host_ms(tok.tokenize, texts),
                   "word_by_word": 1000 * host_ms(
                       lambda words, tok=tok: [tok.tokenize(" " + w)
                                               for w in words], sentences)}
            for name, tok in (("native", native), ("python", python))}

    out["image_ms"] = {"native": host_ms(binding.native_preprocess, raws)}
    try:
        import PIL  # noqa: F401
    except ImportError:
        out["image_ms"]["pil"] = None
        log("17(a): PIL is not installed: its time is not measured")
    else:
        out["image_ms"]["pil"] = host_ms(
            lambda raw: images._process_raw(raw, use_native=False), raws)
    out["seconds"] = time.perf_counter() - t_phase
    log("host_runtime", json.dumps(out))
    return out


def start_parity(tmp):
    """Phase 17(b): the parity harness's dry run on the card
    (``python -m mtvaf_tpu_torch.parity.harness --dry_run
    --skip_reference``), a child process started after phase 14 so that
    it runs beside phases 15 and 16, its processes on two host threads
    each (batches of 4: the card does their work), so as to take little
    of the host from phase 15's ranks."""
    out = os.path.join(tmp, "parity_out")
    return Child(tmp, "parity", "mtvaf_tpu_torch.parity.harness",
                 ["--dry_run", "--skip_reference", "--out", out],
                 env={"OMP_NUM_THREADS": "2"}), out


def finish_parity(parity, timeout=PARITY_TIMEOUT):
    """Wait for :func:`start_parity`'s child and hold its six rows: each
    "ours" run exited 0 with finite ``final_metrics.json``, loaded its
    backbone and ResNet from the harness's checkpoints (no "random init"
    in its log) and launched K1 and K2; prints the table and the seconds
    per row."""
    child, out = parity
    t_wait = time.perf_counter()
    try:
        child.proc.wait(timeout=max(timeout - (time.perf_counter()
                                               - child.t0), 1))
    except subprocess.TimeoutExpired:
        child.stop()
        raise AssertionError(f"17(b): the parity dry run ran past "
                             f"{timeout} s:\n{child.text()[-6000:]}")
    wall = time.perf_counter() - child.t0
    if child.proc.returncode != 0:
        raise AssertionError(f"17(b): the parity dry run exited "
                             f"{child.proc.returncode}:\n"
                             f"{child.text()[-6000:]}")
    with open(os.path.join(out, "parity.json")) as f:
        rows = json.load(f)["rows"]
    failed = []
    for row in rows:
        run = os.path.join(out, f"{row['config']}_{row['dataset']}")
        with open(os.path.join(run, "ours.log")) as f:
            text = f.read()
        metrics = os.path.join(run, "our_save", "final_metrics.json")
        values = []
        if os.path.exists(metrics):
            with open(metrics) as f:
                values = list(json.load(f).values())
        launches = row["our_launches"] or {}
        if row["our_rc"] != 0 or not values or \
                not all(math.isfinite(v) for v in values) or \
                "random init" in text or not launches.get("k1") or \
                not launches.get("k2"):
            failed.append((row, text[-3000:]))
    with open(os.path.join(out, "PARITY_RUN.md")) as f:
        log(f.read().rstrip())
    result = {"rows": len(rows), "wall_s": wall,
              "waited_s": time.perf_counter() - t_wait,
              "seconds": {f"{r['config']}_{r['dataset']}": r["our_seconds"]
                          for r in rows},
              "launches": {f"{r['config']}_{r['dataset']}": r["our_launches"]
                           for r in rows},
              "test_f1": {f"{r['config']}_{r['dataset']}": r["our_test_f1"]
                          for r in rows}}
    log("parity", json.dumps(result))
    if len(rows) != PARITY_ROWS or failed:
        raise AssertionError(f"17(b): {len(rows)} rows, failed: {failed}")
    return result


def ptxas_report(logs):
    """Registers, static shared memory and spills of every kernel instance,
    from ``nvcc -Xptxas -v``; fails on any spill.  The bf16 kernels take
    their tiles in dynamic shared memory, which ptxas does not see: each
    library reports its block's bytes (``dynamic_smem``)."""
    import re
    from mtvaf_tpu_torch.kernels.prefix_attention import _fn
    rows = []
    for lib, text in logs.items():
        row = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel, args = _kernel_name(m.group(1))
                row = {"lib": lib, "kernel": kernel, "template": args,
                       "route": "wgmma+TMA" if "bf16" in kernel
                       else "cuda-cores"}
                if "bf16" in kernel:   # the backward's size is per pass
                    args = (int(kernel.startswith("dkdv")),) \
                        if lib == "prefix_attention_bwd" else ()
                    row["dynamic_smem"] = _fn(lib, f"mtvaf_{lib}_smem")(*args)
                rows.append(row)
            elif row is not None:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    row["spill_stores"] = int(m.group(1))
                    row["spill_loads"] = int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    row["registers"] = int(m.group(1))
                    sm = re.search(r"(\d+) bytes smem", line)
                    row["static_smem"] = int(sm.group(1)) if sm else 0
    for row in rows:
        log("ptxas", json.dumps(row))
    if any(logs.values()) and not rows:
        raise AssertionError("no ptxas report in the build logs")
    spills = [r for r in rows if r.get("spill_stores") or r.get("spill_loads")]
    if spills:
        raise AssertionError(f"ptxas spilled registers: {spills}")
    return rows


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--resume-check"]:       # phase 10's child
        check_resume(*sys.argv[2:6])
        return 0
    if sys.argv[1:2] == ["--dp-child"]:           # phase 15's children
        dp_child(json.loads(sys.argv[2]))
        return 0
    from mtvaf_tpu_torch.data.tokenization import FullTokenizer
    from mtvaf_tpu_torch.kernels import build
    from mtvaf_tpu_torch.native.binding import maybe_accelerate

    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card})")

    t0 = time.perf_counter()
    built = build.build(build.all_kernels())
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(built)
    host_path = host_runtime_phase(card)

    k1_rows = check_prefix_attention()
    mask_row, k1_train = check_dropout()
    k2_rows = check_backward()
    tp_kernels = check_head_offset()

    cfg, bert_cfg, params, resnet = flagship()
    with tempfile.TemporaryDirectory() as tmp:
        vocab = f"{tmp}/vocab.txt"
        write_vocab(vocab)
        tok = maybe_accelerate(FullTokenizer(
            vocab, do_lower_case=cfg.do_lower_case))
    check_forward_against_cpu(cfg, bert_cfg, params, resnet, tok)
    check_train_step_against_cpu(cfg, bert_cfg, params)
    pred, serve_path = serve(cfg, bert_cfg, params, resnet, tok)
    breakdown(pred)
    del pred
    torch.cuda.empty_cache()
    train_path = train(cfg, bert_cfg, params)
    if "--profile" in sys.argv[1:]:
        profile_train(cfg, bert_cfg, params)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as keep:
        trainer_path = trainer_phase(train_path, keep)
        span_path = span_phase(train_path)
        aux_path = aux_phase(span_path, keep)
        runs = {"dir": keep, "crf": trainer_path.pop("kept"),
                "span": aux_path.pop("kept")}
        options_path = options_phase(cfg, bert_cfg, params, resnet, tok,
                                     train_path)
        del params, resnet
        torch.cuda.empty_cache()
        # phase 13's exports run beside phases 15 and 16, which check
        # agreement, and phase 13 serves their bundles after them
        exports = start_exports(runs)
        parity = start_parity(keep)
        try:
            with tempfile.TemporaryDirectory() as dp_tmp:
                dp_path, trees = dp_phase(dp_tmp)
                tp_path = tp_phase(dp_tmp, trees)
            tp_c = tp_path["c"]
            log("17(c) bf16 2x2 against 2x1 (16(c)): loss "
                f"{tp_c['loss_rel_diff']:.3e} apart (earlier reading: "
                "3.0e-3), largest leaf ratio "
                f"{tp_c['leaf_diff_over_movement'][0][0]:.4f} (earlier: "
                "0.0137)")
            tier_path = serving_tier_phase(runs, serve_path, exports)
            parity_path = finish_parity(parity)
        finally:
            for child, _, _ in exports.values():
                child.stop()
            parity[0].stop()

    serve_row = next(r for r in k1_rows if r["shape"] == "serve_bf16")
    k2_row = next(r for r in k2_rows
                  if r["shape"] == "train_bf16" and r["rate"] > 0)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def span_rows(rows, err):
        return [{"shape": r["shape"], "rate": r["rate"], "S": r["S"],
                 "T": r["T"], "max_abs_err": r[err],
                 **{k: r[k] for k in keys}}
                for r in rows if r["shape"] in SPAN_SHAPES]

    def path_launches(path):
        return {name: {"train_step": path["train_step"][f"{name}_launches"],
                       "trainer": path["trainer"][f"{name}_launches"],
                       "serve": path["serve"]["k1_launches"]
                       if name == "k1" else 0}
                for name in ("k1", "k2", "mask")}

    span_launches, aux_launches = path_launches(span_path), \
        path_launches(aux_path)
    long_step_path = options_path["long_step"]
    # phase 14's paths, each counted from 0 just before it
    long_launches = {
        name: {"step_s500": long_step_path["plain"][f"{name}_launches"],
               "remat_step_s500": long_step_path["remat"][f"{name}_launches"],
               "trainer_s500": options_path["trainer"][f"{name}_launches"],
               "params_bf16_step":
                   options_path["master_step"][f"{name}_launches"],
               "serve_s500": options_path["serve"]["k1_launches"]
               if name == "k1" else 0,
               "crf_parallel_serve":
                   options_path["parallel"]["serve"]["k1_launches"]
                   if name == "k1" else 0}
        for name in ("k1", "k2", "mask")}
    log("profiler_misses", json.dumps(profiler_misses))
    log("host_runtime_summary", json.dumps({
        "image_ms": host_path["image_ms"],
        "tokens_ms_per_1000": host_path["tokens_ms_per_1000"],
        "image_max_abs_diff": host_path["image_max_abs_diff"],
        "parity_seconds": parity_path["seconds"],
        "parity_wall_s": parity_path["wall_s"],
        "parity_waited_s": parity_path["waited_s"],
        "host_runtime_s": host_path["seconds"], "card": card}))
    log(card)
    log(json.dumps({"kernels": [{
        "name": "prefix_attention_fwd",
        "route": "cuda", "design": {"bfloat16": DESIGN[torch.bfloat16],
                                    "float32": DESIGN[torch.float32]},
        "source": "mtvaf_tpu_torch/csrc/prefix_attention_fwd.cu",
        "replaces": "mtvaf_tpu/kernels/prefix_attention.py:71",
        "ptxas": [r for r in ptxas if r["lib"] == "prefix_attention_fwd"
                  and r["kernel"] != "keep_mask_kernel"],
        "launches": train_path["k1_launches"],
        "max_abs_err": k1_train["max_abs_err_o"],
        **{k: k1_train[k] for k in keys},
        "serve": {"launches": serve_path["k1_launches"],
                  "max_abs_err": serve_row["max_abs_err_o"],
                  **{k: serve_row[k] for k in keys}},
        "trainer": {"launches": trainer_path["k1_launches"]},
        "span": {"launches": span_launches["k1"],
                 "shapes": span_rows(k1_rows, "max_abs_err_o")},
        "aux": {"launches": aux_launches["k1"]},
        "long": {"launches": long_launches["k1"]},
        "bundle": {"launches": {"crf": tier_path["crf"]["serve"]["k1_launches"],
                                "span": tier_path["span"]["k1_launches"]}},
        "http": {"launches": tier_path["http"]["k1_launches"]},
        "host_ms_per_call": tier_path["k1_host"],
        "parity": {"launches": {k: v["k1"] for k, v in
                                parity_path["launches"].items()}},
        "dp": dp_kernel_launches(dp_path, "k1"),
        "tp": tp_kernel_launches(tp_path, tp_kernels, "k1"),
    }, {
        "name": "prefix_attention_bwd",
        "route": "cuda", "design": {"bfloat16": DESIGN[torch.bfloat16],
                                    "float32": DESIGN[torch.float32]},
        "source": "mtvaf_tpu_torch/csrc/prefix_attention_bwd.cu",
        "replaces": "mtvaf_tpu/kernels/prefix_attention.py:99",
        "ptxas": [r for r in ptxas if r["lib"] == "prefix_attention_bwd"],
        "launches": train_path["k2_launches"],
        "max_abs_err": k2_row["max_abs_err"],
        **{k: k2_row[k] for k in keys},
        "trainer": {"launches": trainer_path["k2_launches"]},
        "span": {"launches": span_launches["k2"],
                 "shapes": span_rows(k2_rows, "max_abs_err")},
        "aux": {"launches": aux_launches["k2"]},
        "long": {"launches": long_launches["k2"]},
        "parity": {"launches": {k: v["k2"] for k, v in
                                parity_path["launches"].items()}},
        "dp": dp_kernel_launches(dp_path, "k2"),
        "tp": tp_kernel_launches(tp_path, tp_kernels, "k2"),
    }, {
        "name": "prefix_attention_keep_mask",
        "route": "cuda", "design": "cuda-cores",
        "source": "mtvaf_tpu_torch/csrc/prefix_attention_fwd.cu",
        "replaces": "tests/test_attention_dropout_tpu.py:91",
        "on_main_path": False,
        "launches": train_path["mask_launches"],
        "trainer": {"launches": trainer_path["mask_launches"]},
        "span": {"launches": span_launches["mask"]},
        "aux": {"launches": aux_launches["mask"]},
        "long": {"launches": long_launches["mask"]},
        "dp": dp_kernel_launches(dp_path, "mask"),
        "tp": tp_kernel_launches(tp_path, tp_kernels, "mask"),
        "max_abs_err": float(mask_row["mismatches"]),
        **{k: mask_row[k] for k in keys[:4]},
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
