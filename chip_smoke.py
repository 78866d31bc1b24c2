#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mtvaf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:

1. build every CUDA kernel of the port from ``mtvaf_tpu_torch/csrc`` (one
   nvcc per source, all started together);
2. hold the prefix-attention forward kernel (K1) against its plain PyTorch
   version on the card, at the shapes the serving path gives it, and time
   kernel, plain version and the one-call PyTorch yardstick (SDPA) beside
   the kernel's bound;
3. at the train shape: the dropout-mask entry point's masks bit-identical
   to the plain Philox masks, the kept fraction within 1% of 1 - rate, and
   K1 with dropout against the plain forward given the same masks;
4. hold the backward kernel (K2) against the plain backward in the same
   dtype and against fp32 autograd of the plain forward, at the train shape
   (bf16 and fp32) and at S=512 (bf16), with dropout off and on; time K2,
   the plain backward and SDPA's backward beside K2's bound;
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
   of one step.

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


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
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
        ms = cuda_ms(lambda: prefix_attention_cuda(q, k, v, bias))
        plain_ms = cuda_ms(lambda: prefix_attention_reference(q, k, v, bias))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask_q))
        bound_ms, bound_by, nbytes, flops = k1_bound(b, h, s, t, d, dtype)
        row = {"shape": name, "B": b, "H": h, "S": s, "T": t, "D": d,
               "dtype": str(dtype).split(".")[1], "max_abs_err_o": err_o,
               "max_abs_err_lse": err_lse, "max_abs_err_o_vs_fp32": err_fp32,
               "max_abs_err_lse_vs_fp32": err_lse_fp32,
               "atol": K1_ATOL[dtype], "atol_vs_fp32": K1_ATOL_VS_FP32[dtype],
               "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops}
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
    mask_ms = cuda_ms(lambda: keep_mask_cuda(DROPOUT_SEED, rate, shape, dev))
    mask_plain_ms = cuda_ms(lambda: keep_mask_reference(DROPOUT_SEED, rate,
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
    ms = cuda_ms(lambda: prefix_attention_cuda(q, k, v, bias,
                                               seed=DROPOUT_SEED, rate=rate))
    plain_ms = cuda_ms(lambda: prefix_attention_reference(q, k, v, bias,
                                                          keep))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias.to(dtype), dropout_p=rate))
    bound_ms, bound_by, nbytes, flops = k1_bound(b, h, s, t, d, dtype)
    row = {"shape": "train_bf16_dropout", "B": b, "H": h, "S": s, "T": t,
           "D": d, "rate": rate, "max_abs_err_o": err_o,
           "max_abs_err_o_vs_fp32": err_fp32, "max_abs_err_lse": err_lse,
           "atol": K1_ATOL[dtype], "atol_vs_fp32": K1_ATOL_VS_FP32[dtype],
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops}
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
            ms = cuda_ms(lambda: prefix_attention_bwd_cuda(
                q, k, v, bias, o, lse, do, seed=DROPOUT_SEED, rate=rate),
                iters=20)
            plain_ms = cuda_ms(lambda: prefix_attention_bwd_reference(
                q, k, v, bias, o, lse, do, keep), iters=20)
            lib_ms = sdpa_backward_ms(q, k, v, bias, do, rate)
            bound_ms, bound_by, nbytes, flops = k2_bound(b, h, s, t, d, dtype)
            row = {"shape": name, "B": b, "H": h, "S": s, "T": t, "D": d,
                   "rate": rate, "dtype": str(dtype).split(".")[1],
                   "max_abs_err": err, "max_abs_err_vs_fp32": err32,
                   "atol": K2_ATOL[dtype],
                   "atol_vs_fp32": K2_ATOL_VS_FP32[dtype], "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes, "flops": flops}
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

    return cuda_ms(fwd_bwd, iters=20) - cuda_ms(fwd, iters=20)


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


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from mtvaf_tpu_torch.data.tokenization import FullTokenizer
    from mtvaf_tpu_torch.kernels import build

    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card})")

    t0 = time.perf_counter()
    built = build.build(build.all_kernels())
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, text in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

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

    serve_row = next(r for r in k1_rows if r["shape"] == "serve_bf16")
    k2_row = next(r for r in k2_rows
                  if r["shape"] == "train_bf16" and r["rate"] > 0)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "prefix_attention_fwd",
        "route": "cuda",
        "source": "mtvaf_tpu_torch/csrc/prefix_attention_fwd.cu",
        "replaces": "mtvaf_tpu/kernels/prefix_attention.py:71",
        "launches": train_path["k1_launches"],
        "max_abs_err": k1_train["max_abs_err_o"],
        **{k: k1_train[k] for k in keys},
        "serve": {"launches": serve_path["k1_launches"],
                  "max_abs_err": serve_row["max_abs_err_o"],
                  **{k: serve_row[k] for k in keys}},
    }, {
        "name": "prefix_attention_bwd",
        "route": "cuda",
        "source": "mtvaf_tpu_torch/csrc/prefix_attention_bwd.cu",
        "replaces": "mtvaf_tpu/kernels/prefix_attention.py:99",
        "launches": train_path["k2_launches"],
        "max_abs_err": k2_row["max_abs_err"],
        **{k: k2_row[k] for k in keys},
    }, {
        "name": "prefix_attention_keep_mask",
        "route": "cuda",
        "source": "mtvaf_tpu_torch/csrc/prefix_attention_fwd.cu",
        "replaces": "tests/test_attention_dropout_tpu.py:91",
        "on_main_path": False,
        "launches": train_path["mask_launches"],
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
