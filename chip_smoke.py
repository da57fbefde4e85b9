#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``paddle_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # the full run; needs one CUDA card
    python3 chip_smoke.py --profile  # and traces decode (phases 3, 7, 10)
    python3 chip_smoke.py --decode-profile-only   # phase 3's trace alone
    python3 chip_smoke.py --decode-tail-only      # phase 2's tail rows alone

Phases (any failure raises, so the script exits non-zero):

1. Device and build: the card's name and power limit, then every kernel
   of ``paddle_tpu_torch/csrc`` compiled by nvcc from the checkout, with
   each kernel's registers and spills (ptxas), and the tensor-core
   instructions of the attention and decode-tail kernels' SASS
   (``cuobjdump``; none fails the run).
2. Each kernel against its plain PyTorch version on the card, in bf16 at
   the serving and training paths' shapes, with its time (CUDA events,
   median of 20 after warm-up; 5 for the sequence-4096 attention rows),
   its back-to-back time (CUDA events around 10 calls in a row, divided
   by 10: the host's pace where the wrapper's host time exceeds the
   kernel's), its profiled time (the device kernels' own durations over
   10 calls from ``torch.profiler``, divided by 10), the plain version's
   time, the least time the card could take (bound), and one PyTorch
   library call computing the same function, timed the same three ways,
   as a yardstick only (the port never calls it). Paged decode attention
   runs at 13 shapes (the main one B 8, max_len 2048, page size 16, sum
   of lengths 5594; the decode profile's 8 x 512; B 1 and 32; 1, 2, 8
   and 16 query heads per KV head; page sizes 8 and 32; f32; ragged
   lengths with a dead row, which must be exactly 0), timed cold: kernel
   and yardstick rotate over copies of the pool and of the gathered pages
   that touch more than 100 MB, as each layer's own pool is cold in a
   decode step; the warm figure is printed beside it. ``rms_norm`` runs at
   8 and 4096 rows of 4096 (and at widths 512, 2048, 4096 by 1, 8 and 4096
   rows in bf16 and f32 untimed). The attention backward is held per
   element against its plain version on the same inputs (delta from the
   forward's out, as the kernel and splash take it). The fused decode-tail
   kernels run at 8 and 32 rows of Llama-3-8B's widths, timed cold (kernel
   and yardsticks rotate over copies of Wq | Wk | Wv and of Wo touching
   more than 100 MB; the warm figure beside it), beside two yardsticks timed
   by the same three measures: ``torch.matmul`` of the product alone and
   the port's discrete sequence they replace; then each wrapper's host µs a
   call, and edge shapes (1 and 33 rows, uneven slices of the contraction,
   hidden 384 and 1408) in bf16 and f32. The
   sliding-window (LocalMask) flash forward and backward run at Mistral-7B's
   training shape (sequence 8192, window 4096; the plain version one KV head
   at a time), beside SDPA with the band as its mask and the causal kernel
   at the same sequence, which the local one must beat; and at edge shapes
   in f32 and bf16. DeepSeek-V2-Lite's kernels: the MLA decode (B 8, H 16,
   r 512, dr 64, T 4096, ragged pos; with an allowed mask whose fully
   masked row must come out 0) beside SDPA as MQA, the causal flash
   forward at q/k width 192, v width 128, beside SDPA, and rms_norm at
   width 512; the width-192 flash backward at phase 12's shape (sequence
   4096, 16 heads, V2-Lite's softmax scale) beside SDPA's backward, and at
   edge shapes (a sequence of 1000, a rectangular s_kv > s_q, an f32
   case) through the autograd Function. The FullMask (the functional API's
   ``causal=False``): forward with lse and backward at [1, 4096, 32 | 8,
   128] beside SDPA non-causal and its backward, and at edge shapes (1024 x
   4096 and 4096 x 1024, a sequence of 1000, f32). ``splash_hop`` at
   [1, 32 | 8, 4096, 128] for each kind of the ring's hops (full, causal at
   offset 0, local at offset 4096 with window 4096, whose dead row must be
   out 0 and lse -inf) beside SDPA on the hop's mask, and a local hop with
   dead rows 95-127 in f32.
3. The serving path at full width: Llama-3-8B (bf16, all 32 layers, random
   weights from a seeded generator on the card) behind
   ``ContinuousBatchEngine(max_batch=8, max_len=2048)``, ten greedy
   requests, served with ``FLAGS_use_fused_decode_tail`` off, on, and off
   again; then speculative decoding (k = 4, fused tail on) of eight greedy
   requests whose prompts repeat a seeded 16-token pattern. Kernel launch
   counts are zeroed just before and read just after each run; the fused
   run must launch each fused kernel 32 times per decode step and the
   norm kernels 32 times per step fewer each.
4. Wiring: two layers at full width in f32, the same weights on the card
   (kernels) and on the CPU (plain versions); greedy tokens must be
   identical card vs CPU, fused vs discrete, and speculative vs one-token,
   and the prefill logits must agree.
5. The training path at full width: the Llama-3-8B training recipe of the
   JAX package's ``bench.py`` (``_bench_config("8b")``: tied embeddings,
   chunked fused lm-head + CE, bf16 parameters, AdamW with f32 masters and
   bf16 moments, sequence 4096, batch 1) at depth 4, random weights from a
   seeded generator, one fixed random batch; ``train_step`` once to warm
   up, then 5 timed steps; one more step under ``torch.profiler`` for the
   kernels' share of the step. Launch counts are zeroed just before the
   first step and read just after the last timed one.
6. Training wiring: two layers at full width in f32, sequence 128, the
   same weights on the card and on the CPU; one ``train_step`` each; the
   losses, every gradient and every parameter after the step must agree.
7. Mistral-7B serving (after the Llama models are freed): all 32 layers,
   bf16, random weights, ``ContinuousBatchEngine(max_batch=4,
   max_len=12288)``, greedy prompts of 8192 and 2048 tokens (exact buckets:
   the LocalMask flash kernel) and 4700 and 300 (padded: the f32 einsum, as
   the JAX package), 32 new tokens each, decode through the band gather;
   fused tail off, then on. Counts zeroed before and read after each run.
8. Mistral-7B training: its widths at depth 4, sequence 8192 (above the
   window), phase 5's recipe with untied embeddings; the local kernels
   must run once per layer and step.
9. Windowed wiring, f32, card against CPU: two Mistral layers at full
   width, window 256, a 512-token prompt and 16 greedy tokens at max_len
   1024 (tokens identical, prefill logits within 1e-3); one training step
   at sequence 512, window 128, held as phase 6.
10. DeepSeek-V2-Lite serving (after the Mistral models are freed): the
   published configuration (27 layers, hidden 2048, MLA with
   kv_lora_rank 512, 64 routed experts top-6 and 2 shared, yarn RoPE),
   bf16, random weights, ``ContinuousBatchEngine(max_batch=8,
   max_len=4096)`` in latent mode; eight greedy prompts, exact buckets
   (1024, 2048: the expanded flash kernel at width 192) and padded ones
   (the absorbed einsum, as the JAX package), 64 new tokens each. The MLA
   decode kernel must run 27 times per decode step, the width-192 flash
   kernel 27 times per exact prefill, and no paged, append or width-128
   flash kernel. ``--profile`` traces 10 decode steps at 8 slots.
11. DeepSeek wiring, f32, card against CPU: two V2-Lite layers at full
   width (one dense, one MoE), an exact and a padded prompt, 8 greedy
   tokens each: tokens identical, prefill logits within 1e-3.
12. DeepSeek-V2-Lite training: its published widths at depth 4 (layer 0
   dense, three MoE layers; untied, vocab 102400), sequence 4096 (its
   pretraining length), batch 1, chunked fused lm-head + CE, bf16
   parameters; phase 5's AdamW with DeepSeek-V2's beta2 0.95 and
   global-norm clip 1.0, and a linear warm-up to 3e-4 cut to 2 steps so
   the loss can fall within the run. The width-192 flash forward and
   backward kernels must run once per layer and step; every parameter
   gets a gradient, the first loss is within 5% of ln V + std^2 / 2 and
   the loss falls. One more step is profiled.
13. DeepSeek training wiring, f32, card against CPU: two V2-Lite layers at
   full width, sequence 128, three steps of phase 12's recipe (clip and
   schedule included, the warm-up starting at 1e-4 so that every step
   updates, a fresh batch each step), the CPU side taking the card's
   weights and optimizer state before each step; each step's loss,
   gradients and parameters held as phase 6 holds them.
14. The Paddle flash-attention functional API at Llama-3-8B's attention
   width, bf16: ``nn.functional.flash_attention(causal=False)`` forward and
   backward at sequence 4096, ``flash_attn_unpadded`` over segments 2048,
   1024, 512, 384 and 200 (the last one the plain composite, as in JAX),
   ``memory_efficient_attention`` at 32 heads; each held against its plain
   version. ``flash_attention_full`` must run once per supported call or
   segment and ``flash_attention_full_bwd`` once per backward.
15. Ring attention on one card: degree 4, local sequence 4096 (global
   16384), 32 | 8 heads, bf16, ``ring_attention(impl="auto")`` causal,
   non-causal and with window 4096; ``splash_hop`` must run once per live
   hop (4, 4, 2; the ranks folded into the batch) and each result agree
   per element with the whole-sequence flash kernel at 16384. The hops
   alone are timed beside the ring. Then the ring's gradients at local 1024
   (global 4096) in f32 against the plain whole-sequence gradients.
16. The kernels line, then the card line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package. It exits with
code 2 and prints no result when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
# dense tensor-core bf16; float32 on the CUDA cores (the MLA decode's
# arithmetic, f32 as in the reference)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas/fused_norm.py:99",
    "add_rms_norm": "paddle_tpu/ops/pallas/fused_norm.py:193",
    "append_attention": "paddle_tpu/ops/pallas/append_attention.py:135",
    "flash_attention_bshd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "paged_attention": "paddle_tpu/generation.py:289",
    "fused_rope": "paddle_tpu/ops/pallas/fused_norm.py:289",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "fused_qkv_rope": "paddle_tpu/ops/pallas/decode_tail.py:260",
    "fused_epilogue": "paddle_tpu/ops/pallas/decode_tail.py:347",
    "flash_attention_local": "paddle_tpu/ops/pallas/flash_attention.py:97",
    "flash_attention_local_bwd": "paddle_tpu/ops/pallas/flash_attention.py:97",
    "mla_decode": "paddle_tpu/ops/pallas/mla_decode.py:147",
    "flash_attention_mla": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "flash_attention_mla_bwd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "flash_attention_full": "paddle_tpu/ops/pallas/flash_attention.py:106",
    "flash_attention_full_bwd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "splash_hop": "paddle_tpu/ops/pallas/flash_attention.py:171",
}
SOURCES = {
    "rms_norm": "paddle_tpu_torch/csrc/fused_norm.cu",
    "add_rms_norm": "paddle_tpu_torch/csrc/fused_norm.cu",
    "append_attention": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_bshd": "paddle_tpu_torch/csrc/append_attention.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "fused_rope": "paddle_tpu_torch/csrc/fused_norm.cu",
    "flash_attention_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "fused_qkv_rope": "paddle_tpu_torch/csrc/decode_tail.cu",
    "fused_epilogue": "paddle_tpu_torch/csrc/decode_tail.cu",
    "flash_attention_local": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_local_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "mla_decode": "paddle_tpu_torch/csrc/mla_decode.cu",
    "flash_attention_mla": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_mla_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_full": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_full_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "splash_hop": "paddle_tpu_torch/csrc/append_attention.cu",
}
# the kernels each main path must launch
SERVING_KERNELS = ("rms_norm", "add_rms_norm", "append_attention",
                   "flash_attention_bshd", "paged_attention")
TRAINING_KERNELS = ("rms_norm", "add_rms_norm", "fused_rope",
                    "flash_attention_bshd", "flash_attention_bwd")
FUSED_KERNELS = ("fused_qkv_rope", "fused_epilogue", "paged_attention")
MISTRAL_TRAINING_KERNELS = ("rms_norm", "add_rms_norm", "fused_rope",
                            "flash_attention_local",
                            "flash_attention_local_bwd")
DEEPSEEK_TRAINING_KERNELS = ("rms_norm", "add_rms_norm", "flash_attention_mla",
                             "flash_attention_mla_bwd")
SPEC_K = 4
TRAIN_SEQ, TRAIN_DEPTH, TRAIN_STEPS = 4096, 4, 5
# Mistral-7B: sliding window 4096; training at 8192, above the window
LOCAL_SEQ, WINDOW = 8192, 4096
MISTRAL_LENS, MISTRAL_NEW = (8192, 2048, 4700, 300), 32
# DeepSeek-V2-Lite serving: exact buckets 2048 and 1024 (twice each), padded
# 1500, 700, 300 and 100; 64 new tokens each
DEEPSEEK_LENS, DEEPSEEK_NEW = (2048, 1024, 1500, 700, 300, 2048, 1024, 100), 64
# deepseek-ai/DeepSeek-V2-Lite config.json rope_scaling
V2_LITE_YARN = {"type": "yarn", "factor": 40, "beta_fast": 32,
                "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                "original_max_position_embeddings": 4096}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3):
    """Median ms of ``reps`` calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


HOST_CALLS = 2000


def host_us(fn, calls=HOST_CALLS):
    """Host µs of one call: ``calls`` calls in a row on the host clock,
    the device kept ahead of them (a host-paced row's own cost)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def profiled_ms(fn, calls=10):
    """Device ms of one call: the durations of every device kernel (and
    memset or copy) that ``torch.profiler`` records over ``calls`` calls,
    summed and divided by ``calls``. The kernels' own time: neither the
    host's time nor the gaps between launches count. The profiler can drop
    a session's records (a session has come back empty), which only
    lowers the sum: two sessions that each record at least one kernel a
    call are taken, up to five tried, and the larger figure stands."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    totals = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in kernels) >= calls:
            totals.append(sum(e.device_time_total for e in kernels))
            if len(totals) == 2:
                break
    if not totals:
        raise AssertionError("torch.profiler recorded no device time")
    return max(totals) / 1e3 / calls


def kernel_times(fn, reps=20, warmup=3):
    """(median ms of one call, as ``time_ms``; back-to-back ms of one call:
    CUDA events around 10 calls in a row, divided by 10; profiled ms of
    one call, as ``profiled_ms``). Back to back, a launch queues behind the
    last one's device work only while that work outlasts the host's time
    for the next call: where the wrapper's host time exceeds the kernel's
    (rows of a few µs), the back-to-back figure is the host's pace, not
    the kernel's. The profiled figure is the kernel's own."""
    import torch

    median = time_ms(fn, reps, warmup)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(10):
        fn()
    b.record()
    b.synchronize()
    return median, a.elapsed_time(b) / 10, profiled_ms(fn)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_gqa(q, k, v, mask=None, causal=False, scale=None):
    """One library call: q [B,H,S,D], k [B,hk,T,D], v [B,hk,T,Dv] (GQA)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal, scale=scale,
                                          enable_gqa=True)


# ---------------------------------------------------------------- phase 2 --

def close_bf16(out, ref, atol=2e-3, rtol=2.0 ** -7):
    """(max abs err, every |out - ref| <= atol + rtol |ref|)."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok


def make_record(results):
    """``record(...)``: logs one phase-2 row and keeps the main shape's
    figures in ``results`` by kernel name."""

    def record(name, shape, err, tol_ok, times, plain_ms, lib, bnd, main,
               warm=None):
        """``times`` and ``lib`` (None where no single PyTorch call
        computes the function) from ``kernel_times``; ``warm``: the
        profiled ms of the kernel and of the library call with their
        inputs in L2, for a row whose ``times`` and ``lib`` rotate over
        copies of them (cold)."""
        ms, dev_ms, prof_ms = times
        lib_ms, lib_dev, lib_prof = lib if lib is not None else (None,) * 3
        b_ms, b_by = bnd

        def f4(v):
            return "null" if v is None else f"{v:.4f}"

        log(f"  {name:22s} {shape:38s} max_abs_err={err:.3e} ok={tol_ok} "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} profiled_ms={prof_ms:.4f} "
            f"host_ms={ms - prof_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={f4(lib_ms)} library_device_ms={f4(lib_dev)} "
            f"library_profiled_ms={f4(lib_prof)} "
            + ("" if warm is None else
               f"warm_profiled_ms={warm[0]:.4f} warm_library_profiled_ms="
               f"{f4(warm[1])} ")
            + f"bound_ms={b_ms:.5f} ({b_by}) share={b_ms / ms:.3f} "
            f"device_share={b_ms / dev_ms:.3f} "
            f"profiled_share={b_ms / prof_ms:.3f}")
        if not tol_ok:
            raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms, device_ms=dev_ms, profiled_ms=prof_ms,
                     plain_ms=plain_ms, library_ms=lib_ms,
                     library_device_ms=lib_dev, library_profiled_ms=lib_prof,
                     l2="warm" if warm is None else "cold",
                     warm_profiled_ms=prof_ms if warm is None else warm[0],
                     bound_ms=b_ms, bound_by=b_by, shape=shape)

    return record


def check_kernels(results):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.hopper import (append_attention, flash_attention,
                                             fused_norm)

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    record = make_record(results)

    # attention: one bf16 rounding of an f32 result whose sums ran in
    # another order; norms: two bf16 roundings (normalised value, then the
    # weight product) after an f32 value that may differ in its last bit
    log("phase 2: kernels vs plain versions (bf16; tolerance "
        "|k - p| <= 2e-3 + 2^-7 |p|, norms 1e-6 + 2^-6 |p|, rope 2^-7 |p|, "
        "lse 1e-3; attention gradients as attention, against the plain "
        "backward on the same out)")
    d = 4096
    # rows 8: a decode step at 8 slots (the kernels line's row); 4096: a
    # training step's sequence
    for rows in (8, 4096):
        x, r, w = randn(rows, d), randn(rows, d), randn(d, scale=0.5) + 1
        out = fused_norm.rms_norm(x, w, 1e-5)
        ref = fused_norm.rms_norm_plain(x, w, 1e-5)
        err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
        nbytes = 2 * rows * d * 2 + d * 2
        # a call here is host-paced: 100 single calls after 20 to warm up
        record("rms_norm", f"rows={rows} d={d}", err, ok,
               kernel_times(lambda: fused_norm.rms_norm(x, w, 1e-5), 100, 20),
               time_ms(lambda: fused_norm.rms_norm_plain(x, w, 1e-5)),
               kernel_times(lambda: F.rms_norm(x, (d,), w, 1e-5), 100, 20),
               bound(nbytes, 4 * rows * d, "bfloat16"), rows == 8)
        if rows == 8:
            log(f"  rms_norm rows={rows} d={d}: host us a call, {HOST_CALLS} "
                f"calls in a row on the host clock: the wrapper "
                f"{host_us(lambda: fused_norm.rms_norm(x, w, 1e-5)):.2f}, "
                f"F.rms_norm "
                f"{host_us(lambda: F.rms_norm(x, (d,), w, 1e-5)):.2f}")
        o, h = fused_norm.add_rms_norm(x, r, w, 1e-5)
        ro, rh = fused_norm.add_rms_norm_plain(x, r, w, 1e-5)
        err, ok = close_bf16(o, ro, atol=1e-6, rtol=2.0 ** -6)
        ok = ok and torch.equal(h, rh)
        nbytes = 4 * rows * d * 2 + d * 2
        record("add_rms_norm", f"rows={rows} d={d}", err, ok,
               kernel_times(lambda: fused_norm.add_rms_norm(x, r, w, 1e-5),
                            100, 20),
               time_ms(lambda: fused_norm.add_rms_norm_plain(x, r, w, 1e-5)),
               None, bound(nbytes, 5 * rows * d, "bfloat16"), rows == 8)

    H, hk, D = 32, 8, 128
    # (S, T, pos, valid prompt length or None): prefill buckets of the
    # serving path (padded ones carry `allowed`) and one chunk at pos > 0
    cases = [(128, 128, 0, 100), (512, 512, 0, 300), (1024, 1024, 0, 700),
             (128, 1024, 500, None)]
    for S, T, pos, n_valid in cases:
        q, k, v = randn(1, S, H, D), randn(1, T, hk, D), randn(1, T, hk, D)
        allowed = None
        if n_valid is not None:
            allowed = torch.zeros(1, T, dtype=torch.bool, device=dev)
            allowed[0, :n_valid] = True
        out = append_attention.append_attention(q, k, v, pos, allowed)
        ref = append_attention.append_attention_plain(q, k, v, pos, allowed)
        err, ok = close_bf16(out, ref)
        cols = torch.arange(T, device=dev)
        vis = cols[None, :] <= (pos + torch.arange(S, device=dev))[:, None]
        if allowed is not None:
            vis = vis & allowed[0][None, :]
        # only the K/V columns some query sees must be read (the kernel
        # skips the tiles past pos + S); the mask over the reachable ones
        pairs = int(vis.sum()) * H
        n_cols = int(vis.any(0).sum())
        reach = min(T, pos + S)
        nbytes = 2 * S * H * D * 2 + 2 * n_cols * hk * D * 2 + (
            reach if allowed is not None else 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = vis[None, None]
        record("append_attention",
               f"S={S} T={T} pos={pos} allowed={n_valid}", err, ok,
               kernel_times(lambda: append_attention.append_attention(
                   q, k, v, pos, allowed)),
               time_ms(lambda: append_attention.append_attention_plain(
                   q, k, v, pos, allowed)),
               kernel_times(lambda: sdpa_gqa(qt, kt, vt, mask=mask)),
               bound(nbytes, 4 * D * pairs, "bfloat16"),
               (S, T, n_valid) == (1024, 1024, 700))

    S = 512
    q, k, v = randn(1, S, H, D), randn(1, S, hk, D), randn(1, S, hk, D)
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True)
    err, ok = close_bf16(out, ref)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    record("flash_attention_bshd", f"S={S} causal", err, ok,
           kernel_times(lambda: flash_attention.flash_attention_bshd(
               q, k, v, causal=True)),
           time_ms(lambda: flash_attention.flash_attention_plain(
               q, k, v, causal=True)),
           kernel_times(lambda: sdpa_gqa(qt, kt, vt, causal=True)),
           bound(2 * S * (H + hk) * D * 2, 4 * D * H * S * (S + 1) // 2,
                 "bfloat16"), True)

    check_norm_edges()
    check_paged_rows(record)
    torch.cuda.empty_cache()
    check_decode_tail_kernels(record)
    check_training_kernels(record, randn)
    torch.cuda.empty_cache()
    # the sliding-window kernels: edge shapes, then Mistral-7B's training
    # shape
    check_local_edges()
    check_flash_rows(record, randn, LOCAL_SEQ, WINDOW)
    torch.cuda.empty_cache()
    check_deepseek_kernels(record, randn)
    torch.cuda.empty_cache()
    # the full mask (the functional API) and the ring hop
    t0 = time.perf_counter()
    check_full_edges()
    check_flash_rows(record, randn, TRAIN_SEQ, None, full=True)
    torch.cuda.empty_cache()
    check_hop_rows(record, randn)
    torch.cuda.empty_cache()
    log(f"  the full-mask and splash_hop rows took "
        f"{time.perf_counter() - t0:.1f}s")


def check_norm_edges():
    """``rms_norm`` off its timed rows: widths 512, 2048 and 4096 at 1, 8
    and 4096 rows, in bf16 and f32, each against its plain version at the
    norms' tolerance."""
    import torch

    from paddle_tpu_torch.ops.hopper import fused_norm

    gen = torch.Generator("cuda").manual_seed(99)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (512, 2048, 4096):
            for rows in (1, 8, 4096):
                x = torch.randn(rows, d, generator=gen, device="cuda").to(
                    dtype)
                w = (torch.randn(d, generator=gen, device="cuda") * 0.5
                     + 1).to(dtype)
                out = fused_norm.rms_norm(x, w, 1e-5)
                ref = fused_norm.rms_norm_plain(x, w, 1e-5)
                err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"rms_norm {dtype} rows={rows} d={d}: kernel "
                        f"disagrees with its plain version (max abs err "
                        f"{err})")
    log(f"  rms_norm edges (d 512 / 2048 / 4096, rows 1 / 8 / 4096, bf16 "
        f"and f32): max abs err {worst:.3e}, all within tolerance")


# (label, B, max_len, page size, KV heads, dtype, lengths): H 32, D 128;
# lengths None are drawn as the main row's (seed 7, sum 5594)
PAGED_CASES = (
    ("main", 8, 2048, 16, 8, "bfloat16", None),
    ("decode profile", 8, 2048, 16, 8, "bfloat16", [512] * 8),
    ("B=1 full", 1, 2048, 16, 8, "bfloat16", [2048]),
    ("B=1 one short", 1, 2048, 16, 8, "bfloat16", [2047]),
    ("B=32", 32, 2048, 16, 8, "bfloat16", "random"),
    ("G=1", 8, 2048, 16, 32, "bfloat16", None),
    ("G=2", 8, 2048, 16, 16, "bfloat16", None),
    ("G=8", 8, 2048, 16, 4, "bfloat16", None),
    ("G=16", 8, 2048, 16, 2, "bfloat16", None),
    ("ps=8", 8, 2048, 8, 8, "bfloat16", None),
    ("ps=32", 8, 2048, 32, 8, "bfloat16", None),
    ("f32", 8, 2048, 16, 8, "float32", None),
    # 1, ps - 1, ps, ps + 1, a dead row, a full row and one past the pages
    ("edges", 7, 2048, 16, 8, "bfloat16", [1, 15, 16, 17, 0, 2048, 2100]),
)
# bytes each timed call of a paged row's rotation must touch in all, so
# that no call finds its pages in the 50 MB L2
PAGED_COLD_BYTES = 120e6


def check_paged_rows(record):
    """Paged decode attention at ``PAGED_CASES`` (H 32, D 128), each held
    against its plain version at the attention tolerance (a dead row must
    be exactly 0 and finite; the plain version, whose dead row is NaN, is
    compared on the live rows). Timed cold, as on the main path, where
    each of 32 layers has its own pool and a decode step finds it out of
    L2: the kernel and the SDPA yardstick (over pages gathered beforehand,
    with the length mask) rotate over at least 4 copies of the pool and of
    the gathered pages, together touching more than ``PAGED_COLD_BYTES``.
    The warm figure (one copy, back in L2 from the last call) is printed
    beside it. The pool holds B * max_len / ps pages in a seeded random
    order."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import paged_attention

    dev = torch.device("cuda")
    H, D = 32, 128
    gen = torch.Generator(dev).manual_seed(77)
    rng = np.random.RandomState(7)
    rng.permutation(8 * 2048 // 16)
    main_lens = rng.randint(1, 2048 + 1, size=8)     # sum 5594
    for label, B, max_len, ps, hk, dt, lens in PAGED_CASES:
        dtype = getattr(torch, dt)
        es = 2 if dtype == torch.bfloat16 else 4
        pps = max_len // ps
        n_pages = B * pps
        perm = np.random.RandomState(7).permutation(n_pages).astype(
            np.int32)
        if lens is None:
            lens = main_lens
        elif lens == "random":
            lens = np.random.RandomState(8).randint(1, max_len + 1, size=B)
        page_indices = torch.from_numpy(perm.reshape(B, pps)).to(dev)
        lengths = torch.tensor(np.asarray(lens), dtype=torch.int32,
                               device=dev)
        vis = lengths.clamp(max=pps * ps)
        n_tok = int(vis.sum())
        n_idx = int(((vis + ps - 1) // ps).sum())
        # each visible K and V row read once, q read and out written once,
        # the lengths and the visible pages' indices
        nbytes = (n_tok * hk * D * 2 * es + 2 * B * H * D * es + B * 4
                  + n_idx * 4)
        copies = max(4, math.ceil(PAGED_COLD_BYTES / max(
            n_tok * hk * D * 2 * es, 1)))

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)

        q = rnd(B, H, D)
        kps = [rnd(hk, n_pages, ps, D) for _ in range(copies)]
        vps = [rnd(hk, n_pages, ps, D) for _ in range(copies)]
        out = paged_attention.paged_attention(q, kps[0], vps[0], lengths,
                                              page_indices)
        ref = paged_attention.paged_attention_plain(q, kps[0], vps[0],
                                                    lengths, page_indices)
        live = lengths > 0
        err, ok = close_bf16(out[live], ref[live])
        dead = ~live
        if bool(dead.any()):
            dead_ok = (bool((out[dead] == 0).all())
                       and bool(torch.isfinite(out).all()))
            log(f"  paged_attention {label}: {int(dead.sum())} dead row(s) "
                f"exactly 0 and finite: {dead_ok}")
            ok = ok and dead_ok
        kgs = [paged_attention.gather_pages(kp, page_indices) for kp in kps]
        vgs = [paged_attention.gather_pages(vp, page_indices) for vp in vps]
        pmask = (torch.arange(pps * ps, device=dev)[None, :]
                 < lengths[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]
        turn = iter(range(1 << 62))

        def kernel(i=None):
            c = next(turn) % copies if i is None else i
            return paged_attention.paged_attention(q, kps[c], vps[c],
                                                   lengths, page_indices)

        def library(i=None):
            c = next(turn) % copies if i is None else i
            return sdpa_gqa(q4, kgs[c], vgs[c], mask=pmask)

        warm = (profiled_ms(lambda: kernel(0)), profiled_ms(
            lambda: library(0)))
        shape = (f"B={B} max_len={max_len} ps={ps} G={H // hk} {dt} "
                 f"sum_len={n_tok}")
        record("paged_attention", f"{label}: {shape} cold", err, ok,
               kernel_times(kernel),
               time_ms(lambda: paged_attention.paged_attention_plain(
                   q, kps[0], vps[0], lengths, page_indices)),
               kernel_times(library),
               bound(nbytes, 4 * H * D * n_tok, dt), label == "main",
               warm=warm)
        del q, kps, vps, kgs, vgs, out, ref
    torch.cuda.empty_cache()


def check_full_edges():
    """The full-mask kernels off the main path's shape, forward with lse and
    backward against the plain versions (the backward's on the kernel
    forward's out): rectangular each way (1024 x 4096, 4096 x 1024), a
    sequence that ends in a short tile (1000) and MHA in f32; then a local
    hop with dead rows (block 128, offset 128, window 96: rows 95-127 see
    no column) in f32. Tolerances as ``check_local_edges``; a dead row must
    come out 0 with lse -inf in the kernel and the plain version."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    gen = torch.Generator("cuda").manual_seed(77)
    scale = 1.0 / math.sqrt(128)
    for s_q, s_kv, H, hk, dtype in (
            (1024, 4096, 32, 8, torch.bfloat16),
            (4096, 1024, 32, 8, torch.bfloat16),
            (1000, 1000, 8, 2, torch.bfloat16),
            (333, 200, 4, 4, torch.float32)):
        q, k, v, dout = (torch.randn(1, n, h, 128, generator=gen,
                                     device="cuda").to(dtype)
                         for n, h in ((s_q, H), (s_kv, hk), (s_kv, hk),
                                      (s_q, H)))
        out, lse = append_attention.launch(q, k, v, 0, None, scale,
                                           "flash_attention_full",
                                           with_lse=True, kind="full")
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    scale, full=True)
        ref = flash_attention.flash_attention_plain(q, k, v, causal=False)
        ref_grads = flash_attention.flash_attention_bwd_plain(
            q, k, v, out, dout, scale, full=True)
        sc = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(1, s_q, hk, H // hk, 128).float(),
                          k.float()) * scale
        ref_lse = torch.logsumexp(sc, dim=-1).reshape(1, H, s_q)
        del sc
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip((out, lse) + tuple(grads),
                                (ref, ref_lse) + tuple(ref_grads))]
        edge = (f"full edges {str(dtype)[6:]} s_q={s_q} s_kv={s_kv} H={H} "
                f"hk={hk}")
        log(f"  {edge}: max abs err out {errs[0]:.2e} lse {errs[1]:.2e} "
            f"dq/dk/dv {errs[2]:.2e}/{errs[3]:.2e}/{errs[4]:.2e}")
        if dtype == torch.float32:
            tops = [float(b.abs().max()) for b in ref_grads]
            ok = (errs[0] <= 2e-5 and errs[1] <= 2e-5
                  and all(e <= 1e-5 * max(t, 1.0)
                          for e, t in zip(errs[2:], tops)))
        else:
            ok = (close_bf16(out, ref)[1] and errs[1] <= 1e-3
                  and close_grads(edge, grads, ref_grads)[1])
        if not ok:
            raise AssertionError(f"full-mask flash kernels disagree with "
                                 f"their plain version at s_q={s_q} "
                                 f"s_kv={s_kv} {dtype}")
        del q, k, v, dout, out, lse, grads, ref, ref_grads
    q, k, v = (torch.randn(2, h, 128, 128, generator=gen, device="cuda")
               for h in (8, 2, 2))
    out, lse = flash_attention.splash_hop(q * scale, k, v, "local",
                                          offset=128, window=96)
    ref, ref_lse = flash_attention.splash_hop_plain(q * scale, k, v, "local",
                                                    offset=128, window=96)
    dead = torch.arange(128, device="cuda") >= 95
    ok = (bool((out[:, :, dead] == 0).all())
          and bool(torch.isneginf(lse[:, :, dead]).all())
          and bool(torch.isneginf(ref_lse[:, :, dead]).all())
          and not bool(torch.isnan(out).any() or torch.isnan(lse).any()))
    err = float((out - ref).abs().max())
    lse_err = float((lse[:, :, ~dead] - ref_lse[:, :, ~dead]).abs().max())
    log(f"  hop edge f32 local offset 128 W 96, dead rows 95-127: max abs "
        f"err out {err:.2e} lse (live rows) {lse_err:.2e}; dead rows out 0, "
        f"lse -inf: {ok}")
    if not (ok and err <= 2e-5 and lse_err <= 2e-5):
        raise AssertionError("splash_hop disagrees with its plain version, "
                             "or its dead rows are not as documented")


def hop_cells(kind, S, T, offset, window):
    """Visible (query, key) cells of one head of a hop."""
    rows = np.arange(S)[:, None] + offset
    cols = np.arange(T)[None, :]
    if kind == "full":
        return S * T
    seen = cols <= rows
    if kind == "local":
        seen &= cols > rows - window
    return int(seen.sum())


def check_hop_rows(record, randn):
    """``splash_hop`` at [1, 32 | 8, 4096, 128] (JAX's [B, H, S, D], q
    pre-scaled), bf16, for each kind of the ring's hops: full, causal at
    offset 0, and local at offset 4096 with window 4096 (a Mistral ring's
    hop 1 at local 4096, whose row 4095 sees no column). Each against
    ``splash_hop_plain`` per element on the live rows (out as the
    attention rows, lse within 1e-3); a dead row must be out 0, lse -inf.
    Kernel ms is the launch on the ring's [B, S, H, D] layout
    (``hop_bshd``); the public call's transposes are timed beside it. The
    yardstick is SDPA on the hop's mask."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import flash_attention

    S, H, hk, D = TRAIN_SEQ, 32, 8, 128
    q = randn(1, H, S, D, scale=1.0 / math.sqrt(D))
    k, v = randn(1, hk, S, D), randn(1, hk, S, D)
    qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    for kind, offset, window in (("full", 0, None), ("causal", 0, None),
                                 ("local", S, WINDOW)):
        out, lse = flash_attention.splash_hop(q, k, v, kind, offset=offset,
                                              window=window)
        with torch.no_grad():
            ref, ref_lse = flash_attention.splash_hop_plain(
                q, k, v, kind, offset=offset, window=window)
        live = ~torch.isneginf(ref_lse[0, 0])
        err, ok = close_bf16(out[:, :, live], ref[:, :, live])
        lse_err = float((lse[:, :, live] - ref_lse[:, :, live]).abs().max())
        dead_ok = (bool((out[:, :, ~live] == 0).all())
                   and bool(torch.isneginf(lse[:, :, ~live]).all()))
        ok = ok and lse_err <= 1e-3 and dead_ok and not bool(
            torch.isnan(out).any() or torch.isnan(lse).any())
        n_dead = int((~live).sum())
        log(f"  splash_hop {kind} offset={offset}: lse max abs err "
            f"{lse_err:.3e}, dead rows {n_dead} (out 0, lse -inf: "
            f"{dead_ok})")
        del ref, ref_lse
        mask = causal = None
        if kind == "local":
            rows = torch.arange(S, device=q.device)[:, None] + offset
            cols = torch.arange(S, device=q.device)[None, :]
            mask = ((cols <= rows) & (cols > rows - window))[None, None]
        causal = kind == "causal"
        cells = hop_cells(kind, S, S, offset, window)
        public_ms = time_ms(lambda: flash_attention.splash_hop(
            q, k, v, kind, offset=offset, window=window), reps=5, warmup=1)
        kernel_ms = kernel_times(lambda: flash_attention.hop_bshd(
            qb, kb, vb, kind, offset=offset, window=window), reps=5,
            warmup=1)
        log(f"  splash_hop {kind}: [B, H, S, D] call with its transposes "
            f"{public_ms:.4f} ms, launch on [B, S, H, D] {kernel_ms[0]:.4f} "
            "ms")
        record("splash_hop", f"[1,{H}|{hk},{S},{D}] {kind} offset={offset}"
               + (f" W={window}" if window else ""), err, ok, kernel_ms,
               time_ms(lambda: flash_attention.splash_hop_plain(
                   q, k, v, kind, offset=offset, window=window), reps=3,
                   warmup=1),
               kernel_times(lambda: sdpa_gqa(q, k, v, mask=mask,
                                             causal=causal, scale=1.0),
                            reps=5, warmup=1),
               bound(2 * S * (H + hk) * D * 2 + H * S * 4,
                     4 * D * H * cells, "bfloat16"), kind == "full")


# weights the decode-tail rows rotate over, as on the main path, where each
# of 32 layers streams its own weights cold from device memory
TAIL_COLD_BYTES = 100e6


def one_ulp_of_max(out, ref):
    """(max abs err, within one bf16 ulp of the largest entry): both sides
    sum exact f32 products in f32, in another order; an entry may round to
    its other bf16 neighbour, and RoPE of such a pair stays within one ulp
    of the largest entry."""
    err = max(float((o.float() - r.float()).abs().max())
              for o, r in zip(out, ref))
    top = max(float(r.float().abs().max()) for r in ref)
    return err, err <= 2.0 ** (np.floor(np.log2(top)) - 7)


def within_f32(out, ref):
    """(max abs err, within 1e-5 of the largest entry): f32 sums in another
    order."""
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    return err, err <= 1e-5 * max(float(r.abs().max()) for r in ref)


def tail_inputs(R, hidden, H, hk, d, dtype, seed, copies=1):
    """Seeded inputs of both tail kernels: x, w_norm, ``copies`` sets of
    (wq, wk, wv) and of wo, per-row cos / sin at random positions, attn and
    the residual."""
    import torch

    from paddle_tpu_torch.models.llama import _rope_tables

    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(dtype)

    cos, sin = _rope_tables(2048, d, 500000.0, device="cuda")
    pos = torch.randint(0, 2048, (R,), generator=g, device="cuda")
    wqkv = [tuple(rnd(hidden, n * d, scale=0.02) for n in (H, hk, hk))
            for _ in range(copies)]
    wo = [rnd(H * d, hidden, scale=0.02) for _ in range(copies)]
    return dict(x=rnd(R, hidden), wn=rnd(hidden, scale=0.1) + 1, wqkv=wqkv,
                wo=wo, cos=cos[pos], sin=sin[pos], pos=pos, tables=(cos, sin),
                attn=rnd(R, H * d), res=rnd(R, hidden))


def check_decode_tail_kernels(record):
    """The fused decode tail at Llama-3-8B widths, bf16: R = 8 rows (a decode
    step at 8 slots) and R = 32 (a verify chunk of 8 slots x k = 4), timed
    cold: the kernel and both yardsticks rotate over copies of the weights
    (Wq | Wk | Wv, and Wo) that touch more than ``TAIL_COLD_BYTES``, as each
    layer's weights are cold in a decode step; the warm figure (one copy)
    beside it. The yardsticks, never used by the port's kernels, timed by
    the same three measures: one ``torch.matmul`` of the product alone
    (x @ Wq|Wk|Wv, attn @ Wo) and the port's discrete sequence the kernel
    replaces. Then each wrapper's host µs a call, and the edge shapes:
    R 1 and 33 (two row tiles) at those widths, uneven slices of the
    contraction, hidden 384 and 1152, in bf16 and f32."""
    import math

    import torch

    from paddle_tpu_torch.generation import _rope_rows
    from paddle_tpu_torch.ops.hopper import decode_tail, fused_norm

    hidden, H, hk, d, eps = 4096, 32, 8, 128, 1e-5
    bf = torch.bfloat16
    log("  decode tail: tolerance one bf16 ulp of the largest entry (f32: "
        "1e-5 of it); two launches on the same inputs must give the same "
        "bits; timed cold over weight copies touching more than "
        f"{TAIL_COLD_BYTES / 1e6:.0f} MB, warm beside")
    wbytes_qkv = hidden * (H + 2 * hk) * d * 2
    wbytes_o = H * d * hidden * 2
    n_qkv = max(3, math.floor(TAIL_COLD_BYTES / wbytes_qkv) + 1)
    n_o = max(3, math.floor(TAIL_COLD_BYTES / wbytes_o) + 1)
    base = tail_inputs(32, hidden, H, hk, d, bf, 11, copies=max(n_qkv, n_o))
    wqkv, wo = base["wqkv"][:n_qkv], base["wo"][:n_o]
    cat = [torch.cat(w, dim=1) for w in wqkv]   # the product's yardstick
    cos, sin = base["tables"]
    turn = iter(range(1 << 62))

    def cold(n):
        return next(turn) % n

    for R in (8, 32):
        x, attn, res = base["x"][:R], base["attn"][:R], base["res"][:R]
        c, s, pos = base["cos"][:R], base["sin"][:R], base["pos"][:R]
        wn = base["wn"]

        def qkv(i=None):
            wq, wk, wv = wqkv[cold(n_qkv) if i is None else i]
            return decode_tail.fused_qkv_rope(x, wn, wq, wk, wv, c, s, eps,
                                              H, hk, d)

        def qkv_matmul(i=None):
            return x @ cat[cold(n_qkv) if i is None else i]

        def qkv_discrete(i=None):
            wq, wk, wv = wqkv[cold(n_qkv) if i is None else i]
            n = fused_norm.rms_norm(x, wn, eps)
            q, k, v = n @ wq, n @ wk, n @ wv
            return (_rope_rows(q.reshape(R, 1, H, d), cos, sin, pos),
                    _rope_rows(k.reshape(R, 1, hk, d), cos, sin, pos), v)

        wq, wk, wv = wqkv[0]
        args = (x, wn, wq, wk, wv, c, s, eps, H, hk, d)
        out = decode_tail.fused_qkv_rope(*args)
        ref = decode_tail.fused_qkv_rope_plain(*args)
        err, ok = one_ulp_of_max(out, ref)
        ok = ok and all(torch.equal(a, b) for a, b in
                        zip(out, decode_tail.fused_qkv_rope(*args)))
        cost = decode_tail._qkv_cost({"batch": R, "hidden": hidden,
                                      "wtot": (H + 2 * hk) * d,
                                      "dtype": "bfloat16"})
        split = tail_split(getattr(decode_tail, "qkv_scratch", None), R,
                           hidden, H, hk, d)
        tail_yardsticks(f"fused_qkv_rope R={R}", (
            (f"torch.matmul x[{R},{hidden}] @ Wq|Wk|Wv[{hidden},"
             f"{(H + 2 * hk) * d}]", qkv_matmul),
            ("discrete rms_norm + 3 matmuls + 2 ropes", qkv_discrete)))
        record("fused_qkv_rope",
               f"R={R} hidden={hidden} H={H} hk={hk} split={split} cold",
               err, ok, kernel_times(qkv),
               time_ms(lambda: decode_tail.fused_qkv_rope_plain(*args)),
               None, bound(cost["bytes"], cost["flops"], "bfloat16"),
               R == 8, warm=(profiled_ms(lambda: qkv(0)), None))

        def epilogue(i=None):
            return decode_tail.fused_epilogue(
                attn, wo[cold(n_o) if i is None else i], res, wn, eps)

        def epi_matmul(i=None):
            return attn @ wo[cold(n_o) if i is None else i]

        def epi_discrete(i=None):
            return fused_norm.add_rms_norm(
                attn @ wo[cold(n_o) if i is None else i], res, wn, eps)

        eargs = (attn, wo[0], res, wn, eps)
        out = decode_tail.fused_epilogue(*eargs)
        ref = decode_tail.fused_epilogue_plain(*eargs)
        err, ok = one_ulp_of_max(out, ref)
        ok = ok and all(torch.equal(a, b) for a, b in
                        zip(out, decode_tail.fused_epilogue(*eargs)))
        cost = decode_tail._epilogue_cost({"batch": R, "width": H * d,
                                           "hidden": hidden,
                                           "dtype": "bfloat16"})
        split = tail_split(getattr(decode_tail, "epilogue_scratch", None), R,
                           H * d, hidden)
        tail_yardsticks(f"fused_epilogue R={R}", (
            (f"torch.matmul attn[{R},{H * d}] @ Wo", epi_matmul),
            ("discrete matmul + add_rms_norm", epi_discrete)))
        record("fused_epilogue",
               f"R={R} width={H * d} hidden={hidden} split={split} cold",
               err, ok, kernel_times(epilogue),
               time_ms(lambda: decode_tail.fused_epilogue_plain(*eargs)),
               None, bound(cost["bytes"], cost["flops"], "bfloat16"),
               R == 8, warm=(profiled_ms(lambda: epilogue(0)), None))
        if R == 8:
            log(f"  decode tail R={R}: host us a call, {HOST_CALLS} calls in "
                f"a row on the host clock: fused_qkv_rope "
                f"{host_us(lambda: qkv(0)):.2f}, fused_epilogue "
                f"{host_us(lambda: epilogue(0)):.2f}")
    del base, wqkv, wo, cat
    torch.cuda.empty_cache()
    check_tail_edges()


def tail_split(scratch, *shape):
    """The bf16 body's slice count of a tail kernel at ``shape``, as its
    wrapper picks it (``scratch``: ``qkv_scratch`` or ``epilogue_scratch``;
    None, and "-" returned, for a checkout whose kernels take no split)."""
    import torch

    if scratch is None:
        return "-"
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return scratch(*shape, n_sm, 1)[0]


def tail_yardsticks(what, sticks):
    """Logs each yardstick's three measures cold (rotating over the weight
    copies, as the row's kernel) and its warm profiled ms (copy 0)."""
    for name, fn in sticks:
        ms, dev_ms, prof_ms = kernel_times(fn)
        log(f"  yardstick {what}: {name}: ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"profiled_ms={prof_ms:.4f} (cold) warm_profiled_ms="
            f"{profiled_ms(lambda: fn(0)):.4f}")


# (R, hidden, H, hk): one row and two row tiles at Llama-3-8B widths; a
# contraction in uneven slices; the hidden-384 case of three heads
TAIL_EDGES = ((1, 4096, 32, 8), (33, 4096, 32, 8), (17, 1408, 4, 2),
              (40, 384, 3, 1))


def check_tail_edges():
    """Both tail kernels off the timed rows, against their plain versions
    (bf16: one ulp of the largest entry and the same bits over two launches;
    f32: 1e-5 of the largest entry), with the bf16 bodies' slice count and
    whether the last slice is shorter."""
    import torch

    from paddle_tpu_torch.ops.hopper import decode_tail

    d, eps = 128, 1e-5
    for dtype in (torch.bfloat16, torch.float32):
        for R, hid, h, hk in TAIL_EDGES:
            t = tail_inputs(R, hid, h, hk, d, dtype, R + hid)
            wq, wk, wv = t["wqkv"][0]
            args = (t["x"], t["wn"], wq, wk, wv, t["cos"], t["sin"], eps, h,
                    hk, d)
            eargs = (t["attn"], t["wo"][0], t["res"], t["wn"], eps)
            code = int(dtype == torch.bfloat16)
            qkv_split = getattr(decode_tail, "qkv_scratch", None)
            epi_split = getattr(decode_tail, "epilogue_scratch", None)
            for name, fn, plain, a, split, k in (
                    ("fused_qkv_rope", decode_tail.fused_qkv_rope,
                     decode_tail.fused_qkv_rope_plain, args,
                     tail_split(qkv_split, R, hid, h, hk, d), hid),
                    ("fused_epilogue", decode_tail.fused_epilogue,
                     decode_tail.fused_epilogue_plain, eargs,
                     tail_split(epi_split, R, h * d, hid), h * d)):
                out = fn(*a)
                same = all(torch.equal(o, p) for o, p in zip(out, fn(*a)))
                ref = plain(*a)
                err, ok = (one_ulp_of_max if code else within_f32)(out, ref)
                slices = ""
                if code and split != "-":
                    chunks = k // decode_tail.CHUNK
                    per = -(-chunks // split)
                    slices = (f" (slices of {per} chunks, the last "
                              f"{chunks - per * (split - 1)})")
                log(f"  {name} {str(dtype)[6:]} R={R} hidden={hid} H={h} "
                    f"hk={hk}: split {split if code else '-'}{slices} max "
                    f"abs err {err:.3e} ok={ok} same bits={same}")
                if not (ok and same):
                    raise AssertionError(
                        f"{name} {dtype} R={R} hidden={hid}: kernel disagrees "
                        "with its plain version or with itself")


def check_training_kernels(record, randn):
    """The training path's kernels at Llama-3-8B widths, sequence 4096."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.hopper import fused_norm

    S, H, hk, D = TRAIN_SEQ, 32, 8, 128
    cos, sin = _rope_tables(S, D, 500000.0, device="cuda")
    for heads in (H, hk):
        x = randn(1, S, heads, D)
        out = fused_norm.fused_rope(x, cos, sin)
        ref = fused_norm._rope_ref_full(x, cos, sin)
        # the kernel rounds as the plain version does: bit-identical expected
        err, ok = close_bf16(out, ref, atol=0.0, rtol=2.0 ** -7)
        record("fused_rope", f"x=[1,{S},{heads},{D}]", err, ok,
               kernel_times(lambda: fused_norm.fused_rope(x, cos, sin)),
               time_ms(lambda: fused_norm._rope_ref_full(x, cos, sin)),
               None, bound(2 * x.numel() * 2 + 2 * S * D * 4, 3 * x.numel(),
                           "bfloat16"), heads == H)

    check_flash_rows(record, randn, S, None)


def band_cells(s, window):
    """Visible (query, key) cells of one head under the LocalMask of
    ``window`` at S = T = ``s``: query i sees min(i + 1, window) keys."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def check_local_edges():
    """The local kernels off the main path's shape, forward with lse and
    backward against the plain versions (the backward's on the kernel
    forward's out): sequences that end in a short tile, a rectangular
    s_q < s_kv (pos > 0), windows of 1 and wider than the sequence, several
    groupings, f32 and bf16. f32: out and lse within 2e-5, each gradient
    within 1e-5 of its largest entry (sums in another order); bf16: out as
    the main rows, lse within 1e-3, gradients per element as
    ``close_grads``."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    gen = torch.Generator("cuda").manual_seed(99)
    for s_q, s_kv, H, hk, W, dtype in (
            (200, 200, 8, 2, 37, torch.float32),
            (64, 300, 4, 1, 100, torch.float32),
            (130, 130, 4, 4, 1, torch.float32),
            (333, 333, 8, 2, 1000, torch.bfloat16),
            (256, 512, 8, 1, 70, torch.bfloat16)):
        q, k, v, dout = (torch.randn(1, n, h, 128, generator=gen,
                                     device="cuda").to(dtype)
                         for n, h in ((s_q, H), (s_kv, hk), (s_kv, hk),
                                      (s_q, H)))
        scale = 1.0 / math.sqrt(128)
        pos = s_kv - s_q
        out, lse = append_attention.launch(q, k, v, pos, None, scale,
                                           "flash_attention_local",
                                           with_lse=True, window=W)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    scale, window=W)
        ref = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                    window=W)
        ref_grads = flash_attention.flash_attention_bwd_plain(
            q, k, v, out, dout, scale, window=W)
        rows = torch.arange(s_q, device="cuda")[:, None] + pos
        cols = torch.arange(s_kv, device="cuda")[None]
        band = (cols <= rows) & (cols > rows - W)
        g = H // hk
        sc = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(1, s_q, hk, g, 128).float(),
                          k.float()) * scale
        ref_lse = torch.logsumexp(sc.masked_fill(~band, float("-inf")),
                                  dim=-1).reshape(1, H, s_q)
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip((out, lse) + tuple(grads),
                                (ref, ref_lse) + tuple(ref_grads))]
        edge = (f"local edges {str(dtype)[6:]} s_q={s_q} s_kv={s_kv} H={H} "
                f"hk={hk} W={W}")
        log(f"  {edge}: max abs err out {errs[0]:.2e} lse {errs[1]:.2e} "
            f"dq/dk/dv {errs[2]:.2e}/{errs[3]:.2e}/{errs[4]:.2e}")
        if dtype == torch.float32:
            tops = [float(b.abs().max()) for b in ref_grads]
            ok = (errs[0] <= 2e-5 and errs[1] <= 2e-5
                  and all(e <= 1e-5 * max(t, 1.0)
                          for e, t in zip(errs[2:], tops)))
        else:
            ok = (close_bf16(out, ref)[1] and errs[1] <= 1e-3
                  and close_grads(edge, grads, ref_grads)[1])
        if not ok:
            raise AssertionError(f"local flash kernels disagree with their "
                                 f"plain version at s_q={s_q} s_kv={s_kv} "
                                 f"W={W} {dtype}")


def check_flash_rows(record, randn, S, window, full=False):
    """The flash forward with lse and its backward at [1, S, 32 | 8, 128],
    bf16, causal (``window`` None), under the LocalMask of ``window``, or
    under the FullMask (``full``):
    each against its plain version, which runs one KV head (its g query
    heads) at a time, the same function in 1/8 of the memory (its f32
    scores take 1.1 GB per KV head at S = 8192); the backward against
    ``flash_attention_bwd_plain`` on the same out, per element
    (``close_grads``). Yardsticks: SDPA, causal, with the band as its
    mask, or without a mask. With a window also the prefill's call (no
    lse) and the causal kernel at the same S, which the local one must
    beat, or the kernel did not skip the tiles below the band."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    H, hk, D = 32, 8, 128
    g = H // hk
    scale = 1.0 / math.sqrt(D)
    fwd_name, bwd_name = flash_attention._counters(window, full=full)
    label = (f"S={S} full" if full else f"S={S} causal" if window is None
             else f"S={S} W={window} local")
    q, k, v = randn(1, S, H, D), randn(1, S, hk, D), randn(1, S, hk, D)
    dout = randn(1, S, H, D)
    cells = S * S if full else band_cells(S, window or S)
    heads = [(slice(j * g, (j + 1) * g), slice(j, j + 1)) for j in range(hk)]

    def plain_fwd():
        return torch.cat([flash_attention.flash_attention_plain(
            q[:, :, hq], k[:, :, hkv], v[:, :, hkv], causal=not full,
            window=window) for hq, hkv in heads], dim=2)

    rows = torch.arange(S, device=q.device)
    band = (rows[None, :] <= rows[:, None]) | full
    if window is not None:
        band = band & (rows[None, :] > rows[:, None] - window)
    with torch.no_grad():
        ref = plain_fwd()
        lses = []
        for hq, hkv in heads:
            sc = torch.einsum("bshd,btd->bhst", q[:, :, hq].float(),
                              k[:, :, hkv.start].float()) * scale
            lses.append(torch.logsumexp(sc.masked_fill(~band, float("-inf")),
                                        dim=-1))
            del sc
        ref_lse = torch.cat(lses, dim=1)
        del lses

    def fwd(name=fwd_name, win=window, kind="full" if full else None):
        return append_attention.launch(q, k, v, 0, None, scale, name,
                                       with_lse=True, window=win, kind=kind)

    out, lse = fwd()
    err, ok = close_bf16(out, ref)
    lse_err = float((lse - ref_lse).abs().max())
    ok = ok and lse_err <= 1e-3        # f32, sums in another order
    log(f"  {fwd_name} lse vs plain: max abs err {lse_err:.3e} (tolerance "
        f"1e-3)")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None if window is None else band[None, None]
    causal = window is None and not full

    def sdpa():
        return sdpa_gqa(qt, kt, vt, mask=mask, causal=causal)

    plain_ms = time_ms(plain_fwd, reps=3, warmup=1)
    sdpa_t = kernel_times(sdpa, reps=5, warmup=1)
    kernel_ms = kernel_times(fwd, reps=5, warmup=1)
    nbytes = 2 * S * (H + hk) * D * 2
    record(fwd_name, f"{label}, lse", err, ok, kernel_ms, plain_ms, sdpa_t,
           bound(nbytes + H * S * 4, 4 * D * H * cells, "bfloat16"), True)
    if window is not None:
        causal_ms = time_ms(lambda: fwd("flash_attention_bshd", None, None),
                            reps=5, warmup=1)
        log(f"  causal kernel at S={S} (with lse) {causal_ms:.4f} ms, local "
            f"kernel W={window} {kernel_ms[0]:.4f} ms: ratio "
            f"{kernel_ms[0] / causal_ms:.3f} (visible cells {cells} vs "
            f"{S * (S + 1) // 2}, ratio {cells / (S * (S + 1) / 2):.3f})")
        if not kernel_ms[0] < causal_ms:
            raise AssertionError("the local flash forward is not faster than "
                                 "the causal one: the kernel did not skip "
                                 "the tiles below the band")

        def prefill():
            return flash_attention.flash_attention_bshd(q, k, v, causal=True,
                                                        window=window)

        out2 = prefill()
        err2, ok2 = close_bf16(out2, ref)
        record(fwd_name, f"{label} (prefill)", err2,
               ok2 and torch.equal(out2, out), kernel_times(prefill, reps=5,
                                                       warmup=1),
               plain_ms, sdpa_t, bound(nbytes, 4 * D * H * cells,
                                        "bfloat16"), False)
        del out2
    del ref, ref_lse

    def bwd():
        return flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   scale, window=window,
                                                   full=full)

    # the plain backward one KV head (its g query heads) at a time; its
    # time is the sum of the heads' times
    ref_grads = [[], [], []]
    plain_ms = 0.0
    for hq, hkv in heads:
        args = (q[:, :, hq], k[:, :, hkv], v[:, :, hkv], out[:, :, hq],
                dout[:, :, hq])

        def plain_bwd():
            return flash_attention.flash_attention_bwd_plain(
                *args, scale, window=window, full=full)

        for acc, gr in zip(ref_grads, plain_bwd()):
            acc.append(gr)
        plain_ms += time_ms(plain_bwd, reps=3, warmup=1)
    ref_grads = [torch.cat(parts, dim=2) for parts in ref_grads]
    err, ok = close_grads(bwd_name, bwd(), ref_grads)
    del ref_grads
    lib_leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    lib_out = sdpa_gqa(*lib_leaves, mask=mask, causal=causal)
    dout_t = dout.transpose(1, 2).contiguous()
    lib_ms = kernel_times(lambda: torch.autograd.grad(
        lib_out, lib_leaves, dout_t, retain_graph=True), reps=5, warmup=1)
    del lib_out, lib_leaves
    nbytes = (3 * S * H * D + 2 * S * hk * D) * 2 + H * S * 4 + (
        S * H * D + 2 * S * hk * D) * 2
    # S, dP, dV, dK and dQ: five products of 2 * D operations per pair
    record(bwd_name, label, err, ok, kernel_times(bwd, reps=5, warmup=1),
           plain_ms, lib_ms, bound(nbytes, 10 * D * H * cells, "bfloat16"),
           True)


def check_deepseek_kernels(record, randn):
    """DeepSeek-V2-Lite's kernels at its serving shapes: the MLA decode (B 8,
    H 16, r 512, dr 64, T 4096, bf16 buffers, f32 pre-scaled queries,
    ragged per-row pos including 0 and T - 1; once more with an allowed
    mask holding an interior hole and one fully masked row, which must come
    out exactly 0; once more at the decode lengths of phase 10's profile),
    the causal flash forward at q/k width 192, v width 128
    (q [1, 2048, 16, 192], V2-Lite's yarn softmax scale), and rms_norm at
    the latent width 512. Yardsticks: SDPA as MQA over [c_kv | k_pe] with
    the length mask, SDPA causal at the same widths, F.rms_norm."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.models.deepseek import mla_softmax_scale
    from paddle_tpu_torch.ops.hopper import (flash_attention, fused_norm,
                                             mla_decode)

    dev = torch.device("cuda")
    B, H, r, dr, T = 8, 16, 512, 64, 4096
    gen = torch.Generator(dev).manual_seed(4321)
    # pre-scaled f32 queries against unit bf16 latents: scores of spread 2
    qs = 2.0 / (r + dr) ** 0.5
    q_lat = torch.randn(B, H, r, generator=gen, device=dev) * qs
    q_pe = torch.randn(B, H, dr, generator=gen, device=dev) * qs
    ckv, kpe = randn(B, T, r), randn(B, T, dr)
    pos = torch.tensor([0, T - 1, 1000, 2047, 3071, 17, 4000, 2500],
                       dtype=torch.int32, device=dev)
    holed = torch.ones(B, T, dtype=torch.bool, device=dev)
    holed[2, 100:300] = False      # an interior hole
    holed[5] = False               # a row that sees no column
    log("  mla_decode: f32 on both sides, sums in another order: tolerance "
        "|k - p| <= 1e-4 + 1e-4 |p|; a fully masked row exactly 0")
    q_sdpa = torch.cat([q_lat, q_pe], -1).to(torch.bfloat16)[:, :, None]
    k_sdpa = torch.cat([ckv, kpe], -1)[:, None]     # MQA: one KV head
    v_sdpa = ckv[:, None]
    # the ragged rows (the kernels line's row), with the mask, and the
    # lengths of phase 10's profiled decode (8 slots of 1024-token prompts
    # some steps in), where each row sees a quarter of the buffer
    serving = torch.arange(1040, 1040 + B, dtype=torch.int32, device=dev)
    for rows, allowed in ((pos, None), (pos, holed), (serving, None)):
        out = mla_decode.mla_decode(q_lat, q_pe, ckv, kpe, rows, allowed)
        ref = mla_decode.mla_decode_plain(q_lat, q_pe, ckv, kpe, rows,
                                          allowed)
        diff = (out - ref).abs()
        ok = bool((diff <= 1e-4 + 1e-4 * ref.abs()).all())
        vis = torch.arange(T, device=dev)[None, :] <= rows[:, None].long()
        label = f"B={B} H={H} r={r} dr={dr} T={T} ragged pos"
        if rows is serving:
            label = f"B={B} H={H} r={r} dr={dr} T={T} pos 1040-{1039 + B}"
        if allowed is not None:
            vis = vis & allowed
            dead = bool((out[5] == 0).all())
            log(f"  mla_decode with allowed: the fully masked row is exactly "
                f"0: {dead}")
            ok = ok and dead
            label += ", allowed"
        mask = vis[:, None, None, :]
        n_cols = int((rows.long() + 1).sum())
        # every visible column's latent and rope key read once, the queries,
        # row limits (and the mask up to each limit), the output written once
        nbytes = (n_cols * (r + dr) * 2 + B * H * (r + dr) * 4 + B * 4
                  + B * H * r * 4 + (n_cols if allowed is not None else 0))
        record("mla_decode", label, float(diff.max()), ok,
               kernel_times(lambda: mla_decode.mla_decode(
                   q_lat, q_pe, ckv, kpe, rows, allowed)),
               time_ms(lambda: mla_decode.mla_decode_plain(
                   q_lat, q_pe, ckv, kpe, rows, allowed)),
               kernel_times(lambda: sdpa_gqa(q_sdpa, k_sdpa, v_sdpa,
                                             mask=mask, scale=1.0)),
               bound(nbytes, n_cols * H * (4 * r + 2 * dr), "float32"),
               rows is pos and allowed is None)
    del ckv, kpe, k_sdpa, v_sdpa

    from paddle_tpu_torch.models.deepseek import DeepseekV2Config

    scale = mla_softmax_scale(DeepseekV2Config(rope_scaling=V2_LITE_YARN))
    S, dqk, dv = 2048, 192, 128
    q, k, v = randn(1, S, H, dqk), randn(1, S, H, dqk), randn(1, S, H, dv)
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True,
                                               sm_scale=scale)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                sm_scale=scale)
    err, ok = close_bf16(out, ref)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    cells = S * (S + 1) // 2
    record("flash_attention_mla", f"[1,{S},{H},{dqk}|{dv}] causal "
           f"scale={scale:.4f}", err, ok,
           kernel_times(lambda: flash_attention.flash_attention_bshd(
               q, k, v, causal=True, sm_scale=scale), reps=10),
           time_ms(lambda: flash_attention.flash_attention_plain(
               q, k, v, causal=True, sm_scale=scale), reps=3, warmup=1),
           kernel_times(lambda: sdpa_gqa(qt, kt, vt, causal=True,
                                         scale=scale), reps=10),
           bound(2 * S * H * (2 * dqk + 2 * dv), 2 * (dqk + dv) * H * cells,
                 "bfloat16"), True)
    del q, k, v, qt, kt, vt, out, ref
    check_mla_backward(record, randn, scale)

    d = 512
    for rows in (8, 2048):
        x, w = randn(rows, d), randn(d, scale=0.5) + 1
        out = fused_norm.rms_norm(x, w, 1e-6)
        ref = fused_norm.rms_norm_plain(x, w, 1e-6)
        err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
        record("rms_norm", f"rows={rows} d={d}", err, ok,
               kernel_times(lambda: fused_norm.rms_norm(x, w, 1e-6)),
               time_ms(lambda: fused_norm.rms_norm_plain(x, w, 1e-6)),
               kernel_times(lambda: F.rms_norm(x, (d,), w, 1e-6)),
               bound(2 * rows * d * 2 + d * 2, 4 * rows * d, "bfloat16"),
               False)


def close_grads(name, grads, refs):
    """bf16 (dq, dk, dv) each held per element against the plain
    backward's: one rounding of f32 sums run in another order,
    |k - p| <= 2e-3 + 2^-7 |p|, with the median |p| logged beside the
    limit. Returns (max abs err, ok)."""
    err, ok = 0.0, True
    for g_name, gr, rg in zip(("dq", "dk", "dv"), grads, refs):
        e, o = close_bf16(gr, rg)
        med = float(rg.float().abs().median())
        log(f"  {name} {g_name}: max abs err {e:.3e}, median |plain| "
            f"{med:.3e} (tolerance 2e-3 + 2^-7 |plain|: "
            f"{2e-3 + 2.0 ** -7 * med:.3e} at the median) ok={o}")
        err, ok = max(err, e), ok and o
    return err, ok


def check_mla_backward(record, randn, scale):
    """The width-192 flash backward (``flash_attention_mla_bwd``): first at
    edge shapes through the autograd Function (``flash_attention_bshd`` on
    inputs that need a gradient): a sequence of 1000 (a partial last
    tile), a rectangular s_q 200 < s_kv 700 (pos 500), both bf16 at 16
    heads, and f32 at [1, 130 | 300, 4]; then at phase 12's shape
    [1, 4096, 16, 192 | 128], causal, bf16, from the forward's out and lse,
    beside SDPA's backward. The out is held against the plain forward and
    the gradients per element against ``flash_attention_bwd_plain`` on
    the same q, k, v, out and dout (delta from the kernel forward's out,
    as the kernel takes it): bf16 as ``close_grads`` (the out as the
    forward rows), f32 out within 2e-5 and each gradient within 1e-5 of
    max(1, its largest entry)."""
    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    H, dqk, dv = 16, 192, 128
    gen = torch.Generator("cuda").manual_seed(192)
    for s_q, s_kv, heads, dtype in ((1000, 1000, H, torch.bfloat16),
                                    (200, 700, H, torch.bfloat16),
                                    (130, 300, 4, torch.float32)):
        q, k, v, dout = (torch.randn(1, n, heads, d, generator=gen,
                                     device="cuda").to(dtype)
                         for n, d in ((s_q, dqk), (s_kv, dqk), (s_kv, dv),
                                      (s_q, dv)))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention.flash_attention_bshd(*leaves, causal=True,
                                                   sm_scale=scale)
        grads = torch.autograd.grad(out, leaves, dout)
        out = out.detach()
        ref = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                    sm_scale=scale)
        ref_grads = flash_attention.flash_attention_bwd_plain(q, k, v, out,
                                                              dout, scale)
        edge = (f"flash_attention_mla_bwd edge {str(dtype)[6:]} s_q={s_q} "
                f"s_kv={s_kv} H={heads}")
        if dtype == torch.float32:
            errs = [float((a - b).abs().max())
                    for a, b in zip((out,) + tuple(grads),
                                    (ref,) + tuple(ref_grads))]
            ok = errs[0] <= 2e-5 and all(
                e <= 1e-5 * max(float(b.abs().max()), 1.0)
                for e, b in zip(errs[1:], ref_grads))
            log(f"  {edge}: max abs err out {errs[0]:.2e} dq/dk/dv "
                f"{errs[1]:.2e}/{errs[2]:.2e}/{errs[3]:.2e} ok={ok}")
        else:
            e_out, ok = close_bf16(out, ref)
            log(f"  {edge}: max abs err out {e_out:.2e} ok={ok}")
            ok = close_grads(edge, grads, ref_grads)[1] and ok
        if not ok:
            raise AssertionError(f"the width-192 flash backward disagrees "
                                 f"with its plain version at s_q={s_q} "
                                 f"s_kv={s_kv} {dtype}")
    del q, k, v, dout, leaves, out, ref, grads, ref_grads

    S = TRAIN_SEQ
    q, k = randn(1, S, H, dqk), randn(1, S, H, dqk)
    v, dout = randn(1, S, H, dv), randn(1, S, H, dv)
    out, lse = append_attention.launch(q, k, v, 0, None, scale,
                                       "flash_attention_mla", with_lse=True)

    def bwd():
        return flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   scale)

    def plain_bwd():
        return flash_attention.flash_attention_bwd_plain(q, k, v, out, dout,
                                                         scale)

    err, ok = close_grads("flash_attention_mla_bwd", bwd(), plain_bwd())
    plain_ms = time_ms(plain_bwd, reps=3, warmup=1)
    lib_leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
    lib_out = sdpa_gqa(*lib_leaves, causal=True, scale=scale)
    dout_t = dout.transpose(1, 2).contiguous()
    lib_ms = kernel_times(lambda: torch.autograd.grad(
        lib_out, lib_leaves, dout_t, retain_graph=True), reps=5, warmup=1)
    del lib_out, lib_leaves
    cells = S * (S + 1) // 2
    # inputs q, k, v, out, dout, lse read once; dq, dk, dv written once
    nbytes = (S * H * (2 * dqk + 3 * dv) * 2 + H * S * 4
              + S * H * (2 * dqk + dv) * 2)
    # S (2 dqk), dP (2 dv), dV (2 dv), dK and dQ (2 dqk each) per pair
    record("flash_attention_mla_bwd", f"[1,{S},{H},{dqk}|{dv}] causal "
           f"scale={scale:.4f}", err, ok, kernel_times(bwd, reps=5, warmup=1),
           plain_ms, lib_ms,
           bound(nbytes, (6 * dqk + 4 * dv) * H * cells, "bfloat16"), True)


# ---------------------------------------------------------------- phase 3 --

class _Timed:
    """Mix-in for ``ContinuousBatchEngine``: synchronises around each
    prefill and step to time them, and keeps the logits after the first
    decode step."""

    def _prefill_into(self, slot, req):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super()._prefill_into(slot, req)
        torch.cuda.synchronize()
        self.prefill_ms.append((int(req.ids.size),
                                (time.perf_counter() - t0) * 1e3))

    def step(self):
        import torch

        n_pre = len(self.prefill_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().step()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        pre = sum(ms for _, ms in self.prefill_ms[n_pre:])
        self.step_ms.append(total - pre)
        if self.first_logits is None:
            self.first_logits = self._last.float().clone()
        return out


def timed_engine(model, **kw):
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    class TimedEngine(_Timed, ContinuousBatchEngine):
        pass

    eng = TimedEngine(model, **kw)
    eng.prefill_ms, eng.step_ms, eng.first_logits = [], [], None
    return eng


def serve_run(model, card, label, prompts, news, fused, log_prefills=False,
              **engine_kw):
    """One serving run of the main path: launch counts zeroed just before
    and read just after. Returns (counts, stats, decode step ms list, the
    first decode step's logits, outputs); the engine and its pool go."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.utils.flags import flag_overrides

    cfg = model.config
    eng = timed_engine(model, **{**dict(max_batch=8, max_len=2048,
                                        page_size=16), **engine_kw})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with flag_overrides({"use_fused_decode_tail": fused}):
        reset_launches()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=m)
                for p, m in zip(prompts, news)]
        out = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    stats = eng.stats()
    for rid, m in zip(rids, news):
        toks = out[rid]
        if len(toks) != m or eng.finish_reason(rid) != "length":
            raise AssertionError(f"{label} request {rid}: {len(toks)} "
                                 f"tokens, reason {eng.finish_reason(rid)}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{label} request {rid}: token out of range")
    if not torch.isfinite(eng._last).all():
        raise AssertionError(f"{label}: non-finite logits")
    steps = stats["decode_steps"]
    dec_tokens = stats["tokens_generated"]
    dec_ms = sum(eng.step_ms)
    log(f"  [{card}] {label}: {len(rids)} requests, {dec_tokens} tokens, "
        f"{steps} decode steps, wall {wall:.2f}s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if log_prefills:
        for n, ms in eng.prefill_ms:
            log(f"  [{card}] {label}: prefill prompt={n} "
                f"bucket={eng._bucket(n)} ms={ms:.2f}")
    log(f"  [{card}] {label}: decode ms/step median="
        f"{statistics.median(eng.step_ms):.3f} mean={dec_ms / steps:.3f}; "
        f"decode tokens/s={dec_tokens / (dec_ms / 1e3):.1f}")
    log(f"  launches ({label}): {json.dumps(counts)}")
    outputs = [out[r] for r in rids]
    return counts, stats, eng.step_ms, eng.first_logits, outputs


def serve_full_width(profile=False):
    """Phase 3: the discrete path, the fused decode tail and the discrete
    path again (the two flag-off runs bracket the noise), then speculative
    decoding with the fused tail. Returns the launch counts of the counted
    runs, summed."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 3: Llama-3-8B, {n_layers} layers, bf16, "
        f"{n_params / 1e9:.2f}B parameters drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    card = card_line()
    lens = [100, 128, 256, 300, 512, 700, 1000, 1024, 64, 33]
    news = [16 if i % 2 == 0 else 64 for i in range(len(lens))]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in lens]
    runs = {}
    for label, fused in (("flag off", False), ("flag on", True),
                         ("flag off again", False)):
        runs[label] = serve_run(model, card, label, prompts, news, fused,
                                log_prefills=label == "flag off")
    off, on = runs["flag off"], runs["flag on"]
    require_launched(off[0], SERVING_KERNELS, "serving")
    require_launched(on[0], FUSED_KERNELS, "fused serving")
    steps = off[1]["decode_steps"]
    if on[1]["decode_steps"] != steps:
        raise AssertionError("flag-on and flag-off runs took different "
                             "numbers of decode steps")
    for counts, label in ((off[0], "flag off"), (on[0], "flag on")):
        if counts["paged_attention"] != n_layers * steps:
            raise AssertionError(f"{label}: paged_attention launched "
                                 f"{counts['paged_attention']} times for "
                                 f"{steps} steps of {n_layers} layers")
    fused_n = n_layers * steps
    if not (on[0]["fused_qkv_rope"] == on[0]["fused_epilogue"] == fused_n):
        raise AssertionError(f"fused kernels launched "
                             f"{on[0]['fused_qkv_rope']} / "
                             f"{on[0]['fused_epilogue']} times, expected "
                             f"{fused_n}")
    for name in ("rms_norm", "add_rms_norm"):
        fewer = off[0][name] - on[0].get(name, 0)
        if fewer != fused_n:
            raise AssertionError(f"{name}: {fewer} fewer launches with the "
                                 f"flag on, expected {fused_n}")
    same = sum(int(np.sum(a == b)) for a, b in zip(off[4], on[4]))
    n_tok = sum(len(a) for a in off[4])
    dlog = float((on[3] - off[3]).abs().max())
    log(f"  [{card}] fused vs discrete (bf16, reported only): "
        f"{same}/{n_tok} tokens identical ({same / n_tok:.3f}); first "
        f"decode step's logits max abs diff {dlog:.4f} (|logits| <= "
        f"{float(off[3].abs().max()):.3f}); per decode step "
        f"2 x {n_layers} fused launches for {2 * n_layers} fewer norm "
        f"launches")
    del runs

    spec_counts = serve_speculative(model, card)
    if profile:
        profile_decode(model, card)
    del model
    torch.cuda.empty_cache()
    total = Counter(off[0])
    total.update(on[0])
    total.update(spec_counts)
    return total


def serve_speculative(model, card):
    """Speculative serving, fused tail on, k = SPEC_K: eight greedy requests
    whose prompts repeat a seeded 16-token pattern. The fused kernels'
    row counts are recorded by wrapping the two module functions the model
    calls (the launch counts stay the wrappers' own)."""
    from paddle_tpu_torch.ops.hopper import decode_tail

    rows = {"fused_qkv_rope": Counter(), "fused_epilogue": Counter()}
    real = {name: getattr(decode_tail, name) for name in rows}

    def spy(name):
        def call(first, *a, **kw):
            rows[name][first.shape[0]] += 1
            return real[name](first, *a, **kw)
        return call

    rng = np.random.RandomState(7)
    prompts = [np.tile(rng.randint(0, model.config.vocab_size, size=16), 16)
               for _ in range(8)]
    news = [64] * 8
    try:
        for name in rows:
            setattr(decode_tail, name, spy(name))
        counts, stats, step_ms, _, _ = serve_run(
            model, card, f"speculative k={SPEC_K}, flag on", prompts, news,
            True, speculative_k=SPEC_K)
    finally:
        for name, fn in real.items():
            setattr(decode_tail, name, fn)
    n = stats["spec_dispatches"]
    rounds = stats["spec_emitted_tokens"] - stats["spec_accepted_tokens"]
    rate = stats["spec_accepted_tokens"] / max(rounds * (SPEC_K - 1), 1)
    spec_ms = sum(step_ms)
    log(f"  [{card}] speculative: {n} dispatches, acceptance rate {rate:.3f}"
        f", emitted tokens per slot per dispatch "
        f"{stats['accepted_tokens_per_dispatch']:.3f}, tokens per dispatch "
        f"{stats['spec_emitted_tokens'] / n:.2f}, ms per dispatch median "
        f"{statistics.median(step_ms):.3f} mean {spec_ms / n:.3f}, "
        f"tokens/s {stats['spec_emitted_tokens'] / (spec_ms / 1e3):.1f}; "
        f"fused kernel calls by rows "
        f"{json.dumps({k: dict(v) for k, v in rows.items()})}")
    # the verify chunk attends in PyTorch (chunk-causal mask), as the JAX
    # package does in XLA on every backend: no paged kernel on this path
    require_launched(counts, FUSED_KERNELS[:2], "speculative serving")
    for name, by_rows in rows.items():
        if by_rows[8 * SPEC_K] <= 0:
            raise AssertionError(f"{name} never ran with {8 * SPEC_K} rows "
                                 "on the speculative path")
    if stats["spec_dispatches"] != stats["decode_steps"]:
        raise AssertionError("a greedy speculative run took one-token steps")
    return counts


def require_launched(counts, names, path):
    for name in names:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")


# the fused-tail kernels' names in a trace: the bf16 bodies and the f32
# ones (and an earlier checkout's, which --decode-profile-only may run)
TAIL_KERNEL_NAMES = ("qkv_tc_kernel", "epilogue_tc_kernel",
                     "fused_qkv_rope_kernel", "fused_epilogue_kernel")


def profile_decode(model, card, n_steps=10, slots=8, max_len=2048,
                   prompt=512):
    """Where a decode step's time goes at full occupancy, with the fused
    tail off and on where the model's layers take it (the MLA family has
    none, so it is traced once): ``slots`` requests of ``prompt`` tokens;
    ``n_steps`` steps timed on the host clock, then ``n_steps`` more under
    ``torch.profiler`` for the device time and count of each kernel, and
    the host time of each PyTorch op. One stream, so kernel times do not
    overlap: their sum over the unprofiled wall time is the device's busy
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import fused_decode_structural
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.utils.flags import flag_overrides

    layer = model.llama.layers[0]
    tail = fused_decode_structural(layer, layer.input_layernorm.weight.dtype)
    for fused in (False, True) if tail else (False,):
        with flag_overrides({"use_fused_decode_tail": fused}):
            eng = ContinuousBatchEngine(model, max_batch=slots,
                                        max_len=max_len)
            rng = np.random.RandomState(5)
            for _ in range(slots):
                eng.add_request(rng.randint(0, model.config.vocab_size,
                                            size=prompt),
                                max_new_tokens=2 * n_steps + 4)
            for _ in range(2):
                eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n_steps):
                    eng.step()
                torch.cuda.synchronize()
            rows, host = [], []
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:   # kernels, not host ops
                    rows.append((e.device_time_total / 1e3 / n_steps,
                                 e.count / n_steps, e.key))
                elif e.key.startswith("aten::"):
                    host.append((e.self_cpu_time_total / 1e3 / n_steps,
                                 e.count / n_steps, e.key))
            rows.sort(reverse=True)
            host.sort(reverse=True)
            busy_ms = sum(r[0] for r in rows)
            n_kern = sum(r[1] for r in rows)
            paged_ms = sum(r[0] for r in rows if "paged_" in r[2])
            tail_ms = sum(r[0] for r in rows
                          if any(k in r[2] for k in TAIL_KERNEL_NAMES))
            log(f"profile: [{card}] {model.config.__class__.__name__} decode "
                f"at {slots} active slots, prompts {prompt}, max_len "
                f"{max_len}, fused tail {'on' if fused else 'off'}: "
                f"{wall_ms:.3f} ms/step wall (unprofiled), device busy "
                f"{busy_ms:.3f} ms/step (share {busy_ms / wall_ms:.3f}), "
                f"{n_kern:.0f} CUDA kernels launched per step; paged "
                f"attention kernels {paged_ms:.3f} ms/step (share of busy "
                f"{paged_ms / busy_ms:.3f}); fused-tail kernels "
                f"{tail_ms:.3f} ms/step (share of busy "
                f"{tail_ms / busy_ms:.3f})")
            for ms, count, key in rows[:12]:
                log(f"  {ms:8.3f} ms/step {count:7.1f}/step  {key[:80]}")
            log("  host time by op (self, profiled): " + "; ".join(
                f"{key} {ms:.2f} ms x{count:.0f}"
                for ms, count, key in host[:8]))
            eng.run_until_done()
            del eng


# ---------------------------------------------------------------- phase 4 --

def wiring_check():
    """Two layers at full width in f32, the same weights on the card and the
    CPU. Greedy tokens must be identical: card vs CPU (discrete path),
    fused vs discrete on the card, fused card vs CPU, and speculative
    (k = SPEC_K, fused) card vs the one-token CPU run."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.utils.flags import flag_overrides

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2, dtype="float32")
    gen = torch.Generator("cuda").manual_seed(1)
    m_gpu = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    m_cpu = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    m_cpu.load_state_dict(m_gpu.state_dict())
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, size=37)

    def run(model, fused=False, k=None):
        with flag_overrides({"use_fused_decode_tail": fused}):
            eng = ContinuousBatchEngine(model, max_batch=1, max_len=64,
                                        speculative_k=k)
            rid = eng.add_request(prompt, max_new_tokens=8)
            first = eng._last[0].cpu()
            eng.step()
            step1 = eng._last[0].cpu()
            return eng.run_until_done()[rid], first, step1

    card, card_first, card_step1 = run(m_gpu)
    cpu, cpu_first, _ = run(m_cpu)
    fused, _, fused_step1 = run(m_gpu, fused=True)
    spec, _, _ = run(m_gpu, fused=True, k=SPEC_K)
    err = float((card_first - cpu_first).abs().max())
    ferr = float((fused_step1 - card_step1).abs().max())
    tol = 1e-3   # f32 on both sides, sums in another order on the card
    log(f"phase 4: 2 layers at full width, f32: card tokens {card.tolist()}"
        f" cpu tokens {cpu.tolist()} fused card tokens {fused.tolist()} "
        f"speculative (k={SPEC_K}, fused) card tokens {spec.tolist()}; "
        f"prefill logits card vs cpu max abs err {err:.3e} (tolerance "
        f"{tol}, |logits| <= {float(cpu_first.abs().max()):.3f}); first "
        f"decode step's logits fused vs discrete on the card max abs err "
        f"{ferr:.3e} (tolerance {tol})")
    for name, toks in (("card", card), ("fused card", fused),
                       ("speculative card", spec)):
        if not np.array_equal(toks, cpu):
            raise AssertionError(f"{name} and CPU greedy tokens differ")
    if not (err <= tol and ferr <= tol):
        raise AssertionError("logits differ beyond the tolerance")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5 --

def train_config(**kw):
    """The JAX package's 8B training recipe (bench.py ``_bench_config``)."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    base = dict(max_position_embeddings=TRAIN_SEQ, tie_word_embeddings=True,
                fuse_linear_cross_entropy=True, dtype="bfloat16")
    base.update(kw)
    return LlamaConfig.llama3_8b(**base)


def make_train_step(model, learning_rate=3e-4, **opt_kw):
    """(``train_step``, its optimizer) of phase 5's AdamW (weight decay 0.1,
    bf16 moments, f32 masters); ``learning_rate`` a rate or a schedule,
    which the caller steps, and more AdamW keywords in ``opt_kw``."""
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate, parameters=model.parameters(),
                weight_decay=0.1, moment_dtype="bfloat16", **opt_kw)
    return train_step(model, lambda m, x, y: m(x, labels=y)[0], opt), opt


def recipe_text(opt_kw) -> str:
    """The log's description of ``make_train_step``'s AdamW with a recipe's
    keywords ``opt_kw``."""
    rate = opt_kw.get("learning_rate", 3e-4)
    parts = [f"{rate:g}" if isinstance(rate, float) else
             f"LinearWarmup {rate.start_lr:g} -> {rate.end_lr:g} over "
             f"{rate.warmup_steps} steps"]
    if "beta2" in opt_kw:
        parts.append(f"beta2 {opt_kw['beta2']:g}")
    clip = opt_kw.get("grad_clip")
    if clip is not None:
        parts.append(f"{type(clip).__name__}({clip.clip_norm:g})")
    return f"AdamW({', '.join(parts)}, wd 0.1, bf16 moments, f32 masters)"


def step_schedule(opt_kw):
    """Advance the recipe's learning-rate schedule, if it has one (the
    caller's job, as in the JAX package); return the rate just used."""
    sched = opt_kw.get("learning_rate", 3e-4)
    if not hasattr(sched, "step"):
        return sched
    used = sched.get_lr()
    sched.step()
    return used


def deepseek_recipe(start_lr=0.0) -> dict:
    """DeepSeek-V2's optimizer settings (the paper: AdamW, beta2 0.95,
    weight decay 0.1, gradient clipping at norm 1.0, a linear warm-up from
    0) with the warm-up cut to 2 steps from ``start_lr`` to a peak of 3e-4:
    fresh AdamW keywords, since a schedule is stateful."""
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, lr

    return dict(learning_rate=lr.LinearWarmup(3e-4, 2, start_lr, 3e-4),
                beta2=0.95, grad_clip=ClipGradByGlobalNorm(1.0))


def token_batch(vocab, seq, seed, device):
    """(inputs, labels) [1, seq] of one random token row."""
    import torch

    ids = np.random.RandomState(seed).randint(0, vocab, size=(1, seq + 1))
    ids = torch.from_numpy(ids).to(device)
    return ids[:, :-1], ids[:, 1:]


def train_run(phase, cfg, seq, kernels, seed, recipe=dict):
    """The training main path of one configuration: ``train_step`` once to
    warm up, then TRAIN_STEPS timed steps on one fixed random batch, launch
    counts zeroed just before the first step and read just after the last;
    then one profiled step. ``recipe()`` gives the AdamW keywords beyond
    phase 5's (a schedule is stepped after each step). Returns the
    counts."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.weights import model_class

    model = model_class(cfg)(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(
                                 seed))
    n_params = sum(p.numel() for p in model.parameters())
    opt_kw = recipe()
    step = make_train_step(model, **opt_kw)[0]
    x, y = token_batch(cfg.vocab_size, seq, 0, "cuda")
    card = card_line()
    log(f"{phase}: {cfg.num_hidden_layers} layers, {n_params / 1e9:.3f}B "
        f"parameters, bf16, seq {seq}, batch 1, window "
        f"{cfg.sliding_window}, {recipe_text(opt_kw)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts zeroed just before, read just after
    reset_launches()
    losses, step_ms = [], []
    for _ in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_schedule(opt_kw)
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[1:])
    log(f"  [{card}] losses {[round(v, 4) for v in losses]}")
    log(f"  [{card}] step ms: warm-up {step_ms[0]:.1f}, then "
        f"{[round(v, 1) for v in step_ms[1:]]}; median {med:.1f} ms, "
        f"{seq / (med / 1e3):.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches ({1 + TRAIN_STEPS} steps): {json.dumps(counts)}")
    require_launched(counts, kernels, "training")
    # logits at init: normed hidden (rms 1) times the output embedding
    # (std 0.02) have std 0.02 * sqrt(hidden); for V such logits the
    # expected loss is ln V + std^2 / 2
    sigma = cfg.initializer_range * np.sqrt(cfg.hidden_size)
    expect = np.log(cfg.vocab_size) + sigma ** 2 / 2
    log(f"  first loss {losses[0]:.4f}: expected {expect:.4f} (ln V = "
        f"{np.log(cfg.vocab_size):.4f}, + std^2/2 with std {sigma:.3f}); "
        f"ratio {losses[0] / expect:.4f}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if abs(losses[0] / expect - 1) > 0.05:
        raise AssertionError("first loss is not within 5% of its expectation")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
    for name, p in model.named_parameters():
        if p.grad is None or not float(p.grad.abs().max()) > 0:
            raise AssertionError(f"{name} got no gradient")
    profile_train_step(step, x, y, card, med)
    del step, model
    torch.cuda.empty_cache()
    return counts


def train_full_width():
    """Phase 5: the Llama-3-8B recipe at depth 4, sequence 4096."""
    return train_run("phase 5: training, Llama-3-8B widths",
                     train_config(num_hidden_layers=TRAIN_DEPTH), TRAIN_SEQ,
                     TRAINING_KERNELS, 2)


def profile_train_step(step, x, y, card, step_ms):
    """Device time of one more step by kernel, from ``torch.profiler``; one
    stream, so kernel times add up, and their sum over the unprofiled step
    time ``step_ms`` is the device's busy share. The port's kernels are
    named ``*_kernel`` in csrc."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    ours, groups = {}, {"port kernels": 0.0, "GEMMs": 0.0, "other": 0.0}
    for ms, _, key in rows:
        tag = next((t for t in ("append_attention_kernel",
                                "append_attention_tc_kernel",
                                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkdv_tc_kernel",
                                "flash_bwd_dq_tc_kernel",
                                "flash_bwd_delta_kernel", "rope_kernel",
                                "add_rms_norm_kernel", "rms_norm_kernel")
                    if t in key), None)
        if tag is not None:
            ours[tag] = ours.get(tag, 0.0) + ms
            groups["port kernels"] += ms
        elif any(t in key for t in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["GEMMs"] += ms
        else:
            groups["other"] += ms
    log(f"profile: [{card}] one training step: {step_ms:.1f} ms wall "
        f"(unprofiled median), device busy {busy:.1f} ms (share "
        f"{busy / step_ms:.3f}); by group (ms): "
        f"{json.dumps({k: round(v, 2) for k, v in groups.items()})}; the "
        f"port's kernels (ms): "
        f"{json.dumps({k: round(v, 2) for k, v in ours.items()})}")
    for ms, count, key in rows[:16]:
        log(f"  {ms:9.3f} ms {count:5d}x  {key[:80]}")


# ---------------------------------------------------------------- phase 6 --

def train_wiring_check(phase="phase 6: training wiring", cfg=None, seq=128,
                       seed=3, recipe=dict, steps=1):
    """``steps`` train steps of f32 weights on the card and on the CPU,
    AdamW keywords from ``recipe()`` (its schedule stepped after each
    step), a fresh random batch each step, as training takes one. Before
    each step the CPU model and optimizer take the card's weights and
    optimizer state, so both sides start every step from the same state:
    each step's loss, every gradient and every parameter after it must
    agree. Returns the card steps' launch counts.

    On one repeated batch two updates take a V2-Lite pair's loss from
    11.87 to 0.0064, and at that loss softmax cross-entropy's p - 1 is
    f32 rounding on both sides (losses 3.5e-05 apart from equal state):
    fresh batches keep each step at a loss near ln V."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.weights import model_class

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = train_config(num_hidden_layers=2, dtype="float32")
    cls = model_class(cfg)
    m_gpu = cls(cfg, device="cuda",
                generator=torch.Generator("cuda").manual_seed(seed))
    m_cpu = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sides = []
    for model in (m_gpu, m_cpu):
        opt_kw = recipe()
        step, opt = make_train_step(model, **opt_kw)
        sides.append((model, opt_kw, step, opt))
    log(f"{phase}, {cfg.num_hidden_layers} layers at full width, f32, seq "
        f"{seq}, window {cfg.sliding_window}, {steps} step(s) of "
        f"{recipe_text(sides[0][1])}, a fresh batch each; the CPU side takes "
        f"the card's weights and optimizer state before each step. "
        f"Tolerances: loss 1e-5 "
        f"relative, gradients 1e-4 of each tensor's largest, parameters "
        f"2 x the step's rate, share of a tensor off by > 1e-6 1e-3")
    ok = True
    reset_launches()
    for i in range(steps):
        m_cpu.load_state_dict(m_gpu.state_dict())
        sd = sides[0][3].state_dict()
        sd["state"] = {name: {k: t.to("cpu", copy=True)
                              for k, t in st.items()}
                       for name, st in sd["state"].items()}
        sides[1][3].set_state_dict(sd)
        losses, rates = [], []
        for model, opt_kw, step, opt in sides:
            losses.append(float(step(*token_batch(cfg.vocab_size, seq, 4 + i,
                                                  model.device))))
            rates.append(step_schedule(opt_kw))
        # f32 on both sides, sums in another order on the card. An Adam
        # step moves a weight by about lr * g / (|g| + eps), so where |g|
        # is at the rounding noise the step may differ: the bulk must
        # agree within 1e-6, at most 0.1% of a tensor may differ, and by
        # no more than 2 x the step's rate
        p_tol = 2 * rates[0]
        loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
        g_err, g_name, p_err, p_share = 0.0, "", 0.0, 0.0
        cpu_params = dict(m_cpu.named_parameters())
        for name, p in m_gpu.named_parameters():
            q = cpu_params[name]
            e = float((p.grad.cpu() - q.grad).abs().max() / q.grad.abs().max())
            if e > g_err:
                g_err, g_name = e, name
            d = (p.detach().cpu() - q.detach()).abs()
            p_err = max(p_err, float(d.max()))
            p_share = max(p_share, float((d > 1e-6).float().mean()))
        step_ok = (loss_err <= 1e-5 and g_err <= 1e-4 and p_err <= p_tol
                   and p_share <= 1e-3 and rates[0] == rates[1])
        log(f"  step {i + 1} at rate {rates[0]:g}: loss card {losses[0]} cpu "
            f"{losses[1]} (rel err {loss_err:.2e}); gradients max rel err "
            f"{g_err:.2e} ({g_name}); parameters after it max abs err "
            f"{p_err:.2e} (tolerance {p_tol:.1e}), largest share off by > "
            f"1e-6 {p_share:.2e}; ok={step_ok}")
        ok = ok and step_ok
    counts = dict(launches)
    log(f"  card launches {json.dumps(counts)}")
    if not ok:
        raise AssertionError("card and CPU training steps differ")
    del m_gpu, m_cpu, sides
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 7 --

def mistral_config(**kw):
    from paddle_tpu_torch.models import MistralConfig

    return MistralConfig.mistral_7b(**{"dtype": "bfloat16", **kw})


def serve_mistral(profile=False):
    """Phase 7: Mistral-7B (all 32 layers, bf16, random weights) behind
    ``ContinuousBatchEngine(max_batch=4, max_len=12288)``: prompts of 8192
    and 2048 tokens (exact buckets: the LocalMask flash kernel, the band
    biting at 8192 only), 4700 (padded to 8192) and 300 (padded to 512),
    both padded ones through the f32 einsum as in the JAX package; decode
    over a cache wider than the window through the band gather. Served with
    the fused decode tail off, then on. Returns the summed launch counts."""
    import torch

    from paddle_tpu_torch.models import MistralForCausalLM

    cfg = mistral_config()
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = MistralForCausalLM(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(
                                   5))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 7: Mistral-7B, {n_layers} layers, bf16, window "
        f"{cfg.sliding_window}, {n_params / 1e9:.2f}B parameters drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    card = card_line()
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in MISTRAL_LENS]
    news = [MISTRAL_NEW] * len(prompts)
    # exact buckets: page size (16) times a power of two
    n_exact = sum(1 for n in MISTRAL_LENS if n >= 16 and n & (n - 1) == 0)
    total = Counter()
    for label, fused in (("Mistral flag off", False),
                         ("Mistral flag on", True)):
        counts, stats, _, _, _ = serve_run(
            model, card, label, prompts, news, fused, log_prefills=True,
            max_batch=4, max_len=12288)
        steps = stats["decode_steps"]
        want = {"flash_attention_local": n_layers * n_exact,
                "flash_attention_bshd": 0, "append_attention": 0,
                "paged_attention": 0}
        if fused:
            want.update(fused_qkv_rope=n_layers * steps,
                        fused_epilogue=n_layers * steps)
        for name, n in want.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"{label}: {name} launched "
                                     f"{counts.get(name, 0)} times, expected "
                                     f"{n} ({steps} decode steps)")
        require_launched(counts, ("rms_norm", "add_rms_norm"), label)
        total.update(counts)
    if profile:
        profile_decode(model, card, slots=4, max_len=12288, prompt=8192)
    del model
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- phase 8 --

def train_mistral():
    """Phase 8: Mistral-7B widths at depth 4, sequence 8192 (above the
    4096 window), the training recipe of phase 5 with untied embeddings."""
    counts = train_run("phase 8: training, Mistral-7B widths",
                       mistral_config(num_hidden_layers=TRAIN_DEPTH,
                                      fuse_linear_cross_entropy=True),
                       LOCAL_SEQ, MISTRAL_TRAINING_KERNELS, 6)
    per_run = TRAIN_DEPTH * (1 + TRAIN_STEPS)
    for name in ("flash_attention_local", "flash_attention_local_bwd"):
        if counts.get(name, 0) != per_run:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} "
                                 f"times in {1 + TRAIN_STEPS} steps, "
                                 f"expected {per_run}")
    if counts.get("flash_attention_bshd", 0) or counts.get(
            "flash_attention_bwd", 0):
        raise AssertionError("windowed training launched the causal kernels")
    return counts


# ---------------------------------------------------------------- phase 9 --

def window_wiring_check():
    """Two Mistral layers at full width in f32 with the window cut to 256
    (so the CPU's plain einsum stays small), the same weights on the card
    and the CPU: a 512-token exact-bucket prompt and 16 greedy tokens at
    max_len 1024 (the LocalMask flash kernel with the band biting, then
    decode through the band gather), greedy tokens identical and prefill
    logits within 1e-3; then one training step at sequence 512 with window
    128 held as phase 6 holds it."""
    import torch

    from paddle_tpu_torch.models import MistralForCausalLM
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mistral_config(num_hidden_layers=2, sliding_window=256,
                         dtype="float32")
    m_gpu = MistralForCausalLM(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(
                                   7))
    m_cpu = MistralForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    m_cpu.load_state_dict(m_gpu.state_dict())
    prompt = np.random.RandomState(9).randint(0, cfg.vocab_size, size=512)

    def run(model):
        eng = ContinuousBatchEngine(model, max_batch=1, max_len=1024)
        rid = eng.add_request(prompt, max_new_tokens=16)
        first = eng._last[0].cpu()
        return eng.run_until_done()[rid], first

    reset_launches()
    card, card_first = run(m_gpu)
    counts = dict(launches)
    cpu, cpu_first = run(m_cpu)
    err = float((card_first - cpu_first).abs().max())
    tol = 1e-3   # f32 on both sides, sums in another order on the card
    log(f"phase 9: windowed wiring, 2 Mistral layers at full width, f32, "
        f"window 256, prompt 512: card tokens {card.tolist()} cpu tokens "
        f"{cpu.tolist()}; prefill logits card vs cpu max abs err {err:.3e} "
        f"(tolerance {tol}, |logits| <= {float(cpu_first.abs().max()):.3f});"
        f" card launches {json.dumps(counts)}")
    if counts.get("flash_attention_local", 0) != cfg.num_hidden_layers:
        raise AssertionError("the windowed prefill did not launch the local "
                             "flash kernel once per layer")
    if counts.get("paged_attention", 0) != 0:
        raise AssertionError("windowed decode over a wider cache launched "
                             "the paged kernel instead of the band gather")
    if not np.array_equal(card, cpu):
        raise AssertionError("card and CPU greedy tokens differ (window)")
    if not err <= tol:
        raise AssertionError("windowed prefill logits differ beyond the "
                             "tolerance")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()
    counts = train_wiring_check(
        "phase 9: windowed training wiring",
        mistral_config(num_hidden_layers=2, sliding_window=128,
                       fuse_linear_cross_entropy=True, dtype="float32"),
        512, seed=8)
    for name in ("flash_attention_local", "flash_attention_local_bwd"):
        if counts.get(name, 0) != cfg.num_hidden_layers:
            raise AssertionError(f"windowed training step: {name} launched "
                                 f"{counts.get(name, 0)} times")


# --------------------------------------------------------------- phase 10 --

def deepseek_config(**kw):
    """DeepSeek-V2-Lite as published (deepseek-ai/DeepSeek-V2-Lite
    config.json): no preset in the JAX package, so built from its fields."""
    from paddle_tpu_torch.models import DeepseekV2Config

    base = dict(vocab_size=102400, hidden_size=2048, intermediate_size=10944,
                num_hidden_layers=27, num_attention_heads=16,
                num_key_value_heads=16, max_position_embeddings=163840,
                rms_norm_eps=1e-6, rope_theta=10000.0,
                rope_scaling=V2_LITE_YARN, tie_word_embeddings=False,
                n_routed_experts=64, n_shared_experts=2,
                num_experts_per_tok=6, moe_intermediate_size=1408,
                first_k_dense_replace=1, norm_topk_prob=False,
                routed_scaling_factor=1.0, moe_scoring_func="softmax",
                n_group=1, topk_group=1, router_aux_loss_coef=0.001,
                q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128, dtype="bfloat16")
    base.update(kw)
    return DeepseekV2Config(**base)


def serve_deepseek(profile=False):
    """Phase 10: DeepSeek-V2-Lite (all 27 layers, bf16, random weights)
    behind ``ContinuousBatchEngine(max_batch=8, max_len=4096)`` in latent
    mode, eight greedy prompts (exact buckets through the width-192 flash
    kernel, padded ones through the absorbed einsum), 64 new tokens each.
    Returns the launch counts."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM

    cfg = deepseek_config()
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = DeepseekV2ForCausalLM(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(11))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 10: DeepSeek-V2-Lite, {n_layers} layers, bf16, "
        f"{n_params / 1e9:.2f}B parameters drawn in "
        f"{time.perf_counter() - t0:.1f}s; MLA r={cfg.kv_lora_rank} "
        f"dr={cfg.qk_rope_head_dim}, {cfg.n_routed_experts} experts top-"
        f"{cfg.num_experts_per_tok} + {cfg.n_shared_experts} shared, "
        f"capacity factor {cfg.moe_capacity_factor}")
    card = card_line()
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in DEEPSEEK_LENS]
    news = [DEEPSEEK_NEW] * len(prompts)
    n_exact = sum(1 for n in DEEPSEEK_LENS if n >= 16 and n & (n - 1) == 0)
    counts, stats, _, _, _ = serve_run(
        model, card, "DeepSeek-V2-Lite", prompts, news, False,
        log_prefills=True, max_batch=8, max_len=4096)
    steps = stats["decode_steps"]
    want = {"flash_attention_mla": n_layers * n_exact,
            "mla_decode": n_layers * steps, "flash_attention_bshd": 0,
            "flash_attention_local": 0, "append_attention": 0,
            "paged_attention": 0, "fused_qkv_rope": 0, "fused_epilogue": 0}
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"DeepSeek-V2-Lite: {name} launched "
                                 f"{counts.get(name, 0)} times, expected {n} "
                                 f"({steps} decode steps, {n_exact} exact "
                                 "prefills)")
    require_launched(counts, ("rms_norm", "add_rms_norm"), "DeepSeek serving")
    if profile:
        profile_decode(model, card, slots=8, max_len=4096, prompt=1024)
    del model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- phase 11 --

def deepseek_wiring_check():
    """Two DeepSeek-V2-Lite layers at full width in f32 (one dense, one
    MoE), the same weights on the card and the CPU: a 64-token prompt (the
    exact bucket: the expanded flash kernel) and a 40-token one (padded to
    64: the absorbed einsum), 8 greedy tokens each through the MLA decode;
    tokens identical, prefill logits within 1e-3."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = deepseek_config(num_hidden_layers=2, dtype="float32")
    m_gpu = DeepseekV2ForCausalLM(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(13))
    m_cpu = DeepseekV2ForCausalLM(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    m_cpu.load_state_dict(m_gpu.state_dict())
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (64, 40)]

    def run(model):
        eng = ContinuousBatchEngine(model, max_batch=2, max_len=256)
        rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        first = eng._last.cpu().clone()
        out = eng.run_until_done()
        return [out[r] for r in rids], first, eng.stats()["decode_steps"]

    reset_launches()
    card, card_first, steps = run(m_gpu)
    counts = dict(launches)
    cpu, cpu_first, _ = run(m_cpu)
    err = float((card_first - cpu_first).abs().max())
    tol = 1e-3   # f32 on both sides, sums in another order on the card
    log(f"phase 11: DeepSeek wiring, 2 V2-Lite layers at full width, f32, "
        f"prompts 64 (exact) and 40 (padded): card tokens "
        f"{[t.tolist() for t in card]} cpu tokens {[t.tolist() for t in cpu]};"
        f" prefill logits card vs cpu max abs err {err:.3e} (tolerance {tol}, "
        f"|logits| <= {float(cpu_first.abs().max()):.3f}); card launches "
        f"{json.dumps(counts)}")
    if counts.get("flash_attention_mla", 0) != cfg.num_hidden_layers:
        raise AssertionError("the exact prefill did not launch the width-192 "
                             "flash kernel once per layer")
    if counts.get("mla_decode", 0) != cfg.num_hidden_layers * steps:
        raise AssertionError(f"mla_decode launched {counts.get('mla_decode')}"
                             f" times for {steps} steps")
    if not all(np.array_equal(a, b) for a, b in zip(card, cpu)):
        raise AssertionError("card and CPU greedy tokens differ (DeepSeek)")
    if not err <= tol:
        raise AssertionError("DeepSeek prefill logits differ beyond the "
                             "tolerance")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 12 --

def train_deepseek():
    """Phase 12: DeepSeek-V2-Lite at depth 4 (layer 0 dense, three MoE
    layers), full width, sequence 4096, DeepSeek-V2's optimizer settings
    (``deepseek_recipe``). The width-192 flash forward and backward run
    once per layer and step, no width-128 attention kernel."""
    counts = train_run("phase 12: training, DeepSeek-V2-Lite widths (cut: "
                       "the paper's warm-up of 2000 steps to 2)",
                       deepseek_config(num_hidden_layers=TRAIN_DEPTH,
                                       fuse_linear_cross_entropy=True),
                       TRAIN_SEQ, DEEPSEEK_TRAINING_KERNELS, 12,
                       recipe=deepseek_recipe)
    per_run = TRAIN_DEPTH * (1 + TRAIN_STEPS)
    for name in ("flash_attention_mla", "flash_attention_mla_bwd"):
        if counts.get(name, 0) != per_run:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} "
                                 f"times in {1 + TRAIN_STEPS} steps, "
                                 f"expected {per_run}")
    for name in ("flash_attention_bshd", "flash_attention_bwd",
                 "flash_attention_local", "fused_rope"):
        if counts.get(name, 0):
            raise AssertionError(f"DeepSeek training launched {name}")
    return counts


# --------------------------------------------------------------- phase 13 --

def deepseek_train_wiring_check():
    """Phase 13: two V2-Lite layers (one dense, one MoE) at full width in
    f32, sequence 128, three steps of phase 12's recipe with the warm-up
    starting at 1e-4 (rates 1e-4, 2e-4, 3e-4: three real updates, clipped,
    each on a fresh batch) on the card and on the CPU, each step from the
    same state, held as phase 6 holds its step; the card runs the f32
    instantiation of the width-192 kernels at the weights of each step."""
    cfg = deepseek_config(num_hidden_layers=2, dtype="float32",
                          fuse_linear_cross_entropy=True)
    steps = 3
    counts = train_wiring_check("phase 13: DeepSeek training wiring", cfg,
                                128, seed=14, steps=steps,
                                recipe=lambda: deepseek_recipe(1e-4))
    for name in ("flash_attention_mla", "flash_attention_mla_bwd"):
        if counts.get(name, 0) != steps * cfg.num_hidden_layers:
            raise AssertionError(f"DeepSeek training steps: {name} launched "
                                 f"{counts.get(name, 0)} times")


# --------------------------------------------------------------- phase 14 --

def functional_api():
    """Phase 14: the Paddle flash-attention functional API at Llama-3-8B's
    attention width (32 | 8 heads, 128), bf16: ``flash_attention(causal=
    False)`` forward and backward at sequence 4096; ``flash_attn_unpadded``
    over a packed batch of segments 2048, 1024, 512, 384 and 200 (the last
    one not a multiple of 128: the plain composite, as in JAX);
    ``memory_efficient_attention`` at 32 heads with a custom scale. Each
    output is held per element against the plain version on the same
    inputs (the backward against the plain backward on the kernel's out).
    Counts are zeroed before and read after: ``flash_attention_full`` once
    per supported call or segment, ``flash_attention_full_bwd`` once per
    backward, nothing else."""
    import math

    import torch

    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.hopper import _build, flash_attention

    gen = torch.Generator("cuda").manual_seed(4242)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    S, H, hk, D = TRAIN_SEQ, 32, 8, 128
    scale = 1.0 / math.sqrt(D)
    q, k, v = (randn(1, S, h, D).requires_grad_() for h in (H, hk, hk))
    dout = randn(1, S, H, D)
    segs = (2048, 1024, 512, 384, 200)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(segs)]),
                      dtype=torch.int32, device="cuda")
    pq, pk, pv = (randn(int(cu[-1]), h, D) for h in (H, hk, hk))
    mq, mk, mv = (randn(1, S, H, D) for _ in range(3))
    m_scale = 0.05

    _build.reset_launches()
    t0 = time.perf_counter()
    out, sm = F.flash_attention(q, k, v, causal=False)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    packed = F.flash_attn_unpadded(pq, pk, pv, cu, cu, max(segs), max(segs))
    mea = IF.memory_efficient_attention(mq, mk, mv, scale=m_scale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = Counter(_build.launches)
    log(f"phase 14: functional API at Llama-3-8B attention width, bf16, "
        f"{wall:.3f}s (first calls): launches {dict(counts)}")
    n_kernel = 1 + sum(n % 128 == 0 for n in segs) + 1
    if counts != Counter(flash_attention_full=n_kernel,
                         flash_attention_full_bwd=1):
        raise AssertionError(f"phase 14: launches {dict(counts)}, want "
                             f"flash_attention_full {n_kernel} and "
                             f"flash_attention_full_bwd 1")
    if sm is not None:
        raise AssertionError("flash_attention must return (out, None)")
    with torch.no_grad():
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        ref = flash_attention.flash_attention_plain(qd, kd, vd, causal=False)
        err, ok = close_bf16(out, ref)
        del ref
        ref_grads = flash_attention.flash_attention_bwd_plain(
            qd, kd, vd, out.detach(), dout, scale, full=True)
    g_err, g_ok = close_grads("phase 14 flash_attention backward", grads,
                              ref_grads)
    del ref_grads
    log(f"  flash_attention(causal=False) [1, {S}, {H} | {hk}, {D}]: out "
        f"max abs err {err:.3e} ok={ok}; grads max abs err {g_err:.3e} "
        f"ok={g_ok}")
    ok = ok and g_ok
    with torch.no_grad():
        for i, n in enumerate(segs):
            a, b = int(cu[i]), int(cu[i + 1])
            ref = flash_attention.flash_attention_plain(
                pq[None, a:b], pk[None, a:b], pv[None, a:b], causal=False)
            e, o = close_bf16(packed[None, a:b], ref)
            log(f"  flash_attn_unpadded segment {n} "
                f"({'kernel' if n % 128 == 0 else 'plain composite'}): max "
                f"abs err {e:.3e} ok={o}")
            ok = ok and o
        qf = mq * (m_scale * math.sqrt(D))
        ref = flash_attention.flash_attention_plain(qf, mk, mv, causal=False)
        e, o = close_bf16(mea, ref)
        log(f"  memory_efficient_attention [1, {S}, {H}, {D}] scale "
            f"{m_scale}: max abs err {e:.3e} ok={o}")
        ok = ok and o

    def fwd_bwd():
        o, _ = F.flash_attention(q, k, v, causal=False)
        return torch.autograd.grad(o, (q, k, v), dout)

    def unpadded():
        return F.flash_attn_unpadded(pq, pk, pv, cu, cu, max(segs), max(segs))

    log(f"  flash_attention forward + backward {time_ms(fwd_bwd, 3, 1):.4f} "
        f"ms; flash_attn_unpadded ({len(segs)} segments) "
        f"{time_ms(unpadded, 3, 1):.4f} ms")
    if not ok:
        raise AssertionError("phase 14: a functional-API output disagrees "
                             "with its plain version")
    return counts


# --------------------------------------------------------------- phase 15 --

RING_DEGREE = 4


def ring_on_one_card():
    """Phase 15: ring attention at degree 4 on one card, Llama-3-8B's
    attention width (32 | 8 heads, 128), local sequence 4096 (global
    16384), bf16, through ``ring_attention(impl="auto")``: causal,
    non-causal, and causal with Mistral's window 4096. Counts are zeroed
    before and read after each: ``splash_hop`` once per live hop (the live
    ranks folded into the batch), 4, 4 and 2, and nothing else. Each result
    is held per element against the whole-sequence flash kernel at 16384
    (causal, full, local), which phase 2 holds against its plain version.
    The hops alone (the same launches, no combine) are timed beside the
    ring, so the combine's and the rolls' cost shows. Then the ring's
    gradients at local 1024 (global 4096) in f32 against the plain
    whole-sequence attention's, by autograd."""
    import math

    import torch

    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.ops.hopper import _build, flash_attention

    gen = torch.Generator("cuda").manual_seed(5151)
    n, s_loc, H, hk, D = RING_DEGREE, TRAIN_SEQ, 32, 8, 128
    ring = cp.LocalRing(n)
    scale = 1.0 / math.sqrt(D)
    q, k, v = (torch.randn(1, n * s_loc, h, D, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for h in (H, hk, hk))
    qs, ks, vs = (cp.shard(t, n) for t in (q, k, v))
    counts = Counter()
    log(f"phase 15: ring attention, degree {n}, local {s_loc} (global "
        f"{n * s_loc}), [{H} | {hk}, {D}], bf16, impl auto")
    for causal, window, hops in ((True, None, 4), (False, None, 4),
                                 (True, WINDOW, 2)):
        label = ("causal" if causal and window is None else "full"
                 if not causal else f"local W={window}")

        def run(causal=causal, window=window):
            return cp.ring_attention(qs, ks, vs, ring, causal=causal,
                                     window=window)

        _build.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = Counter(_build.launches)
        counts.update(got)
        if got != Counter(splash_hop=hops):
            raise AssertionError(f"phase 15 {label}: launches {dict(got)}, "
                                 f"want splash_hop {hops}")
        whole = flash_attention.flash_attention_bshd(q, k, v, causal=causal,
                                                     window=window)
        err, ok = close_bf16(cp.unshard(out), whole)
        ok = ok and not bool(torch.isnan(out).any())

        def hop(t, causal=causal, window=window):
            kind, offset = cp._hop_kind(t, s_loc, causal, window)
            lo, hi = cp._live_entries(ring, t, causal)
            r = hi - lo
            return flash_attention.hop_bshd(
                qs[lo:hi].reshape(r, s_loc, H, D),
                ks[lo:hi].reshape(r, s_loc, hk, D),
                vs[lo:hi].reshape(r, s_loc, hk, D), kind, offset=offset,
                window=window, scale=scale)

        live = range(cp._live_hops(n, s_loc, causal, window))
        ring_ms = time_ms(run, reps=3, warmup=1)
        hop_ms = time_ms(lambda: [hop(t) for t in live], reps=3, warmup=1)
        per_hop = [time_ms(lambda t=t: hop(t), reps=3, warmup=1)
                   for t in live]
        log(f"  ring {label}: per hop (kind, ranks, ms) " + ", ".join(
            f"({cp._hop_kind(t, s_loc, causal, window)[0]}, "
            f"{n - t if causal else n}, {ms:.3f})"
            for t, ms in zip(live, per_hop)))
        whole_ms = time_ms(lambda: flash_attention.flash_attention_bshd(
            q, k, v, causal=causal, window=window), reps=3, warmup=1)
        log(f"  ring {label}: splash_hop launches {got['splash_hop']}, max "
            f"abs err vs the whole-sequence kernel {err:.3e} ok={ok}; ring "
            f"{ring_ms:.3f} ms, its hop launches alone {hop_ms:.3f} ms "
            f"(combine and rolls {ring_ms - hop_ms:.3f} ms), whole-sequence "
            f"kernel {whole_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"phase 15 {label}: the ring disagrees with "
                                 f"the whole-sequence kernel")
        del out, whole
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()

    s_loc = 1024
    q, k, v = (torch.randn(1, n * s_loc, h, D, generator=gen, device="cuda")
               for h in (H, hk, hk))
    dout = torch.randn(1, n * s_loc, H, D, generator=gen, device="cuda")
    leaves = [cp.shard(t, n).requires_grad_() for t in (q, k, v)]
    _build.reset_launches()
    out = cp.ring_attention(*leaves, ring, causal=True)
    grads = torch.autograd.grad(cp.unshard(out), leaves, dout)
    torch.cuda.synchronize()
    if dict(_build.launches) != {"splash_hop": n}:
        raise AssertionError(f"phase 15 gradients: launches "
                             f"{dict(_build.launches)}")
    counts.update(_build.launches)
    grads = [cp.unshard(g) for g in grads]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = flash_attention.flash_attention_plain(*ref_leaves, causal=True)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    errs = [float((cp.unshard(out) - ref).detach().abs().max())] + [
        float((a - b).abs().max()) for a, b in zip(grads, ref_grads)]
    tops = [float(b.abs().max()) for b in ref_grads]
    ok = errs[0] <= 2e-5 and all(e <= 1e-5 * max(t, 1.0)
                                 for e, t in zip(errs[1:], tops))
    log(f"  ring gradients, local {s_loc} (global {n * s_loc}), f32, causal: "
        f"out max abs err {errs[0]:.2e}, dq/dk/dv {errs[1]:.2e}/"
        f"{errs[2]:.2e}/{errs[3]:.2e} (largest {tops[0]:.2e}/{tops[1]:.2e}/"
        f"{tops[2]:.2e}; tolerance 1e-5 of each) ok={ok}")
    if not ok:
        raise AssertionError("phase 15: the ring's gradients disagree with "
                             "the plain whole-sequence gradients")
    return counts


def tensor_core_sass(lib) -> tuple:
    """(HMMA, HGMMA) instructions in a built library's SASS, from
    ``cuobjdump -sass``: mma.sync and wgmma products on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sass.count("HMMA"), sass.count("HGMMA")


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name, for the ptxas lines:
    ``append_attention_tc_kernel<192,128>``, ``..._kernel<f,128,128>`` for
    an instance on float, ``<bf16,128>`` on bfloat16. The name is the last
    ``<length><identifier>`` of the nested name (after the anonymous
    namespace's)."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    i, name = m.end(), None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if name is None or not name.endswith("_kernel"):
        return mangled
    targs = re.match(r"I(.*?)EEv", mangled[i:])
    if targs is None:
        return name
    args = re.findall(r"Li(\d+)E", targs.group(1))
    if targs.group(1).startswith("f"):
        args = ["f"] + args
    elif targs.group(1).startswith("13__nv_bfloat16"):
        args = ["bf16"] + args
    return f"{name}<{','.join(args)}>"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3, 7 and 10, trace 10 decode steps "
                         "with torch.profiler, fused tail off and on "
                         "(Llama-3-8B at 8 slots, Mistral-7B at 4 slots of "
                         "8192-token prompts; DeepSeek-V2-Lite at 8 slots of "
                         "1024-token prompts, no fused tail)")
    ap.add_argument("--decode-tail-only", action="store_true",
                    help="phase 1, then phase 2's decode-tail rows alone "
                         "(cold and warm, yardsticks, host us, edges); prints "
                         "no result line. Run from another checkout's root, "
                         "it measures that checkout's kernels")
    ap.add_argument("--decode-profile-only", action="store_true",
                    help="phase 1, then phase 3's Llama-3-8B decode "
                         "profile alone (8 slots of 512-token prompts, "
                         "fused tail off and on); prints no result line. "
                         "Run from another checkout's root, it profiles "
                         "that checkout's package")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.hopper import _build

    t_start = time.perf_counter()
    log(f"phase 1: {card_line()} | python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    _build.build()
    log(f"  built {len(_build.sources())} kernel sources in "
        f"{_build.build_info.get('seconds', 0.0):.1f}s into "
        f"{_build.build_dir()}")
    for stem, text in sorted(_build.build_info.get("ptxas", {}).items()):
        kernel = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                kernel = kernel_name(line.rsplit(" ", 1)[-1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {stem} {kernel}: {line.strip()}")
    # the attention and decode-tail kernels' bf16 bodies multiply on the
    # tensor cores (the two partial runs may measure an earlier checkout)
    partial = args.decode_tail_only or args.decode_profile_only
    for stem in ("append_attention", "flash_attention", "decode_tail"):
        hmma, hgmma = tensor_core_sass(_build.build()[stem])
        log(f"  sass {stem}: {hmma} HMMA (mma.sync), {hgmma} HGMMA (wgmma)")
        if hmma + hgmma == 0 and not partial:
            raise AssertionError(f"{stem}: no tensor-core instruction in its "
                                 "SASS")

    if args.decode_tail_only:
        check_decode_tail_kernels(make_record({}))
        return 0
    if args.decode_profile_only:
        from paddle_tpu_torch.models.llama import (LlamaConfig,
                                                   LlamaForCausalLM)

        model = LlamaForCausalLM(
            LlamaConfig.llama3_8b(dtype="bfloat16"), device="cuda",
            generator=torch.Generator("cuda").manual_seed(0))
        profile_decode(model, card_line())
        return 0
    results: dict = {}
    check_kernels(results)
    counts = Counter(serve_full_width(args.profile))
    wiring_check()
    counts.update(train_full_width())
    train_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(serve_mistral(args.profile))
    counts.update(train_mistral())
    window_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(serve_deepseek(args.profile))
    deepseek_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(train_deepseek())
    deepseek_train_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts.update(functional_api())
    counts.update(ring_on_one_card())
    log(f"phases 14-15 took {time.perf_counter() - t0:.1f}s")

    kernels = []
    for name in SOURCES:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "profiled_ms": r["profiled_ms"],
            "library_device_ms": r["library_device_ms"],
            "library_profiled_ms": r["library_profiled_ms"], "l2": r["l2"],
            "warm_profiled_ms": r["warm_profiled_ms"], "shape": r["shape"]})
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
