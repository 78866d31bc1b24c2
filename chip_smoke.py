#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mtvaf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:

1. build every CUDA kernel of the port from ``mtvaf_tpu_torch/csrc`` (one
   nvcc per source, all started together), print each instance's ptxas
   registers, static shared memory and spills, and fail on a spill;
2. hold the prefix-attention forward kernel (K1) against its plain PyTorch
   version on the card, at the shapes the serving path gives it, and time
   kernel, plain version and the one-call PyTorch yardstick (SDPA) beside
   the kernel's bound (each row names its dtype's design: bf16 on wgmma
   fed by TMA, fp32 on the CUDA cores; its share of the bound; its time
   over SDPA's);
3. at the train shape: the dropout-mask entry point's masks bit-identical
   to the plain Philox masks, the kept fraction within 1% of 1 - rate, and
   K1 with dropout against the plain forward given the same masks;
4. hold the backward kernel (K2) against the plain backward in the same
   dtype and against fp32 autograd of the plain forward, at the train shape
   (bf16 and fp32) and at S=512 (bf16), with dropout off and on; time K2
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
   reach the timed phases).

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
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel tolerances (max abs over o and lse).  Against the plain version in
# the inputs' dtype: in bf16 that version rounds scores and probabilities to
# bf16 while the kernel keeps fp32, so they differ by a few bf16 ulps (H100
# reading: o 0.0117, lse 0.0062 at the serving shape).  Against the plain
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


def attention_inputs(g, b, h, s, t, d, dtype):
    """q (B,H,S,D), k and v (B,H,T,D) in ``dtype``, drawn from ``g``, and an
    fp32 bias (B,1,1,T) that masks a ragged tail of each row's keys."""
    dev = g.device
    q = torch.randn(b, h, s, d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, h, t, d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, h, t, d, device=dev, generator=g).to(dtype)
    lengths = torch.randint(t // 2, t + 1, (b,), device=dev, generator=g)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None])
    return q, k, v, ((1.0 - mask.float()) * -10000.0)[:, None, None, :]


def check_prefix_attention():
    import torch.nn.functional as F

    from mtvaf_tpu_torch.kernels.prefix_attention import (
        prefix_attention_cuda, prefix_attention_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, (b, h, s, t, d, dtype) in {
            "serve_bf16": (16, 12, 128, 144, 64, torch.bfloat16),
            "serve_fp32": (16, 12, 128, 144, 64, torch.float32),
            "s512_bf16": (16, 12, 512, 528, 64, torch.bfloat16)}.items():
        q, k, v, bias = attention_inputs(g, b, h, s, t, d, dtype)
        o, lse = prefix_attention_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        ro, rlse = prefix_attention_reference(q, k, v, bias)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        fo, flse = prefix_attention_reference(q.float(), k.float(),
                                              v.float(), bias)
        err_fp32 = (o.float() - fo).abs().max().item()
        err_lse_fp32 = (lse - flse).abs().max().item()
        ok = (math.isfinite(err_o) and err_o <= K1_ATOL[dtype]
              and err_lse <= K1_ATOL[dtype]
              and err_fp32 <= K1_ATOL_VS_FP32[dtype]
              and err_lse_fp32 <= K1_ATOL_VS_FP32[dtype])
        mask_q = bias.to(dtype)
        ms = device_ms(lambda: prefix_attention_cuda(q, k, v, bias))
        event_ms = cuda_ms(lambda: prefix_attention_cuda(q, k, v, bias))
        plain_ms = device_ms(lambda: prefix_attention_reference(q, k, v,
                                                                bias))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask_q))
        bound_ms, bound_by, nbytes, flops = k1_bound(b, h, s, t, d, dtype)
        row = {"shape": name, "B": b, "H": h, "S": s, "T": t, "D": d,
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
            "s512_bf16": (16, 12, 512, 528, 64, torch.bfloat16)}.items():
        q, k, v, bias = attention_inputs(g, b, h, s, t, d, dtype)
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

    return device_ms(fwd_bwd) - device_ms(fwd)


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


def requests(n, seed):
    from mtvaf_tpu_torch.data.images import _normalize
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sent = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 40))))
        img = None
        if i % 2 == 0:
            img = _normalize(rng.integers(0, 256, (224, 224, 3), np.uint8))
        out.append((sent, img))
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


def check_train_step_against_cpu(cfg, bert_cfg, params, device="cuda"):
    from mtvaf_tpu_torch.data.synthetic import crf_batch
    from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_crf_loss_fn)

    cfg32 = cfg.replace(bf16=False)
    loss_fn = make_crf_loss_fn(cfg32, bert_cfg)
    optimizer, _ = build_optimizer(params, cfg32, total_steps=1000,
                                   pipeline="crf")
    batch = crf_batch(cfg, bert_cfg, 2, 32, seed=SEED + 5)
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
        ratio = (got - want).abs().max().item() \
            / (1e-3 * max(1.0, want.abs().max().item()))
        if not math.isfinite(ratio) or ratio > worst:
            worst, worst_path = ratio, path
    log(f"train step fp32 card vs CPU (B=2, S=32): loss {loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} (rel {rel:.2e}, limit 1e-4); worst gradient leaf "
        f"{worst_path} at {worst:.3f} of its limit 1e-3*max(1, max|g|)")
    if not (rel <= 1e-4 and worst <= 1.0):
        raise AssertionError("train step on the card disagrees with the CPU")


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
    from mtvaf_tpu_torch.data.images import _normalize
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
    for img in ids:
        open(os.path.join(img_dir, img), "wb").close()
        np.save(os.path.join(pix_dir, img + ".npy"), _normalize(
            rng.integers(0, 256, (224, 224, 3), np.uint8)))
    make_vocab_file(os.path.join(tmp, "bert", "vocab.txt"))
    return root, os.path.join(tmp, "bert"), os.path.join(tmp, "cache"), ids


def run_cli(argv, bert_cfg, on_epoch_log=None):
    """``cli.main.main(argv)`` with the trainer it built kept (and its
    params at the end of ``train()``, before the CLI reloads the best
    model); ``on_epoch_log`` is called with each trainer log message."""
    import logging
    import mtvaf_tpu_torch.train.trainer_crf as trainer_crf
    from mtvaf_tpu_torch.cli.main import main as cli_main
    from mtvaf_tpu_torch.train.optim import tree_items

    made = []
    base_cls = trainer_crf.CrfTrainer

    class Kept(base_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def train(self):
            out = super().train()
            self.trained_params = {k: v.detach().clone()
                                   for k, v in tree_items(self.state.params)}
            return out

    class Hook(logging.Handler):
        def emit(self, record):
            on_epoch_log(record.getMessage())

    log = logging.getLogger("mtvaf_tpu_torch.train.trainer_crf")
    hook = Hook() if on_epoch_log else None
    trainer_crf.CrfTrainer = Kept
    if hook:
        log.addHandler(hook)
    try:
        metrics = cli_main(argv, bert_cfg_override=bert_cfg,
                           device="cuda")
    finally:
        trainer_crf.CrfTrainer = base_cls
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


def trainer_phase(bare_step):
    """Phase 10: train the flagship configuration through the CLI for two
    epochs, check launches, devices and files, reload the best model into
    a predictor, time eval and checkpoints; then preempt a run with a real
    SIGTERM after epoch 1, resume it, and hold the result against an
    uninterrupted run."""
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
        shutil.rmtree(save)
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
    from mtvaf_tpu_torch.data.tokenization import FullTokenizer
    from mtvaf_tpu_torch.kernels import build

    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card})")

    t0 = time.perf_counter()
    built = build.build(build.all_kernels())
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(built)

    k1_rows = check_prefix_attention()
    mask_row, k1_train = check_dropout()
    k2_rows = check_backward()

    cfg, bert_cfg, params, resnet = flagship()
    with tempfile.TemporaryDirectory() as tmp:
        vocab = f"{tmp}/vocab.txt"
        write_vocab(vocab)
        tok = FullTokenizer(vocab, do_lower_case=cfg.do_lower_case)
    check_forward_against_cpu(cfg, bert_cfg, params, resnet, tok)
    check_train_step_against_cpu(cfg, bert_cfg, params)
    pred, serve_path = serve(cfg, bert_cfg, params, resnet, tok)
    breakdown(pred)
    del pred
    torch.cuda.empty_cache()
    train_path = train(cfg, bert_cfg, params)
    if "--profile" in sys.argv[1:]:
        profile_train(cfg, bert_cfg, params)
    del params, resnet
    torch.cuda.empty_cache()
    trainer_path = trainer_phase(train_path)

    serve_row = next(r for r in k1_rows if r["shape"] == "serve_bf16")
    k2_row = next(r for r in k2_rows
                  if r["shape"] == "train_bf16" and r["rate"] > 0)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("profiler_misses", json.dumps(profiler_misses))
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
    }, {
        "name": "prefix_attention_keep_mask",
        "route": "cuda", "design": "cuda-cores",
        "source": "mtvaf_tpu_torch/csrc/prefix_attention_fwd.cu",
        "replaces": "tests/test_attention_dropout_tpu.py:91",
        "on_main_path": False,
        "launches": train_path["mask_launches"],
        "trainer": {"launches": trainer_path["mask_launches"]},
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
