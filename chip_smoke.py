#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uresnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths at the flagship width of
configs/train_2d_512.yaml (2D U-ResNet, base 16, depth 5, 2 blocks per
level, 3 classes, bf16, 512^2, batch 32) with random seeded weights:

  1. device   — requires a CUDA device; prints the card's name and power
                limit (nvidia-smi) and the torch / CUDA versions;
  2. build    — compiles uresnet_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernels  — the fused conv's tensor-core kernel vs its plain version at
                every shape the flagship forward gives it (enumerated from
                the model) x {residual+ReLU, ReLU, residual}, plus a ragged
                spatial case; the CUDA-core kernel on an f32 case and a
                ragged-channel case; the launch counters show which kernel
                ran each. Then at batch 32, as the forward calls it, checks
                the kernel again and times it beside its bound, the
                CUDA-core kernel on the same bf16 operands, the plain
                version and the cuDNN bf16 composition; the CUDA-core kernel likewise at the f32
                forward's shapes; the v1 entry point at two shapes;
  4. serve    — 64 synthetic 512^2 events through ``python -m
                uresnet_tpu_torch.cli.infer`` (2 batches of 32) from a
                checkpoint in the JAX npz layout; checks the export and that
                the tensor-core kernel launched exactly 44 times per batch;
  4b. serve32 — the same events with ``model.compute_dtype=float32``: the
                CUDA-core kernel launches 44 times per batch, and the scores
                agree with the bf16 run's;
  5. forward  — the same events with ``kernel_backend=xla`` (cuDNN) for
                agreement, and both whole forwards timed.

  6. profile  — ``torch.profiler`` over both whole forwards: per forward
                the wall time, the device's busy time and idle share, the
                peak memory and the top kernels; the full profiler tables go
                to build/uresnet_tpu_torch/smoke/profile.txt;
  7. train    — 30 steps of ``python -m uresnet_tpu_torch.cli.train`` on
                synthetic 512^2 events (sparse transfer, densify on the
                device, class-balance weights, Adam with the cosine
                schedule); checks the logged losses and the checkpoint's
                JAX key layout, serves 32 events from it through
                ``cli.infer`` (exactly 44 kernel launches), times
                ``train_step_light`` and profiles 3 steps (appended to
                profile.txt);
  7b. dw      — the bf16 conv's f32 weight gradient vs float64 at a
                flagship shape, and its data gradient vs stock autograd.

Then one JSON line of kernel results, the card line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and the last line is not printed. Scratch files go under
build/uresnet_tpu_torch/smoke/ in the checkout.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 alone (a short check of the kernels) and prints no result
line.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "uresnet_tpu_torch", "smoke")
DEVICE = "cuda"
SEED = 0
N_EVENTS = 64
TRAIN_EVENTS = 256
TRAIN_STEPS = 30

# configs/train_2d_512.yaml, written out so no YAML parser is needed. The
# port serves canonical: pack/pack_extra_h are accepted and ignored.
FLAGSHIP = {
    "model": {"dims": 2, "num_class": 3, "base_filters": 16, "depth": 5,
              "compute_dtype": "bfloat16", "pack": True, "pack_extra_h": True},
    "data": {"image_size": 512, "batch_size": 32, "planes": [2],
             "weight_mode": "class_balance", "num_threads": 4,
             "backend": "auto"},
    "optim": {"lr": 1.0e-3, "schedule": "cosine", "decay_steps": 20000},
    "train": {"iterations": 20000, "summary_iter": 50, "checkpoint_iter": 1000,
              "val_iter": 500},
}

# kernel vs plain tolerances. bf16: one bf16 ulp of the output (<= 2^-7
# relative; both sides round the same f32 sum once) plus 1e-4 of the
# tensor's max-abs for f32 accumulation-order differences near zero.
# f32 (TF32 off on both sides): 1e-4 of the max-abs.
BF16_REL, BF16_SLACK, F32_REL = 2.0 ** -7, 1e-4, 1e-4
# whole forward, kernel vs cuDNN path, bf16: the two round at different
# places over ~60 convs (CPU estimate at 128^2: max softmax |d| 0.0056,
# argmax agreement 99.5% of charge pixels)
FWD_MAX_SOFTMAX_DIFF, FWD_MIN_AGREE = 0.05, 0.98
# the bf16 conv's f32 weight gradient vs the float64 product of the same
# bf16 operands, relative to its max: bf16 rounding would be ~4e-3
DW_REL = 1e-5
KERNELS_ONLY = False  # phases 1-3 alone (--kernels-only)
# an H100 SXM's published peaks (NVIDIA data sheet, dense), for the bounds
HBM_BYTES_PER_S, BF16_PEAK, F32_PEAK = 3.35e12, 989e12, 67e12


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def time_ms(fn, reps=5, warmup=2, inner=1) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` of CUDA
    events around ``inner`` calls back to back, divided by ``inner``. With
    ``inner`` > 1 a call of a short kernel is timed as the forward runs it,
    queued behind the previous one, and not with the host's launch
    latency in it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def randomize_bn(model, g):
    """Non-trivial seeded BN affine and running stats (var > 0), so folding
    changes the weights."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            c = buf.shape[0]
            if name.endswith(".mean"):
                buf.copy_(torch.randn(c, generator=g) * 0.1)
            elif name.endswith(".var"):
                buf.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
        for name, p in model.named_parameters():
            c = p.shape[0]
            if name.endswith(".bn.scale"):
                p.copy_(torch.rand(c, generator=g) + 0.5)
            elif name.endswith(".bn.bias"):
                p.copy_(torch.randn(c, generator=g) * 0.1)


def check_close(got, want, dtype):
    """(max abs err, max err / max|want|); raises past the tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    if dtype == torch.bfloat16:
        bad = err > BF16_REL * want.abs() + BF16_SLACK * scale
    else:
        bad = err > F32_REL * scale
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} elements out of tolerance, "
                             f"max abs err {err.max().item():.3e}")
    return err.max().item(), err.max().item() / max(scale, 1e-30)


def bound(B, H, W, C, Co, res, dtype):
    """(least ms, what bounds it) for one fused conv on an H100: its bytes
    (x, w, scale, bias, residual read once, y written once) over HBM's rate
    against its FLOP over the peak rate of the units it runs on (bf16:
    tensor cores; f32: CUDA cores, TF32 being off)."""
    e = 2 if dtype == torch.bfloat16 else 4
    px = B * H * W
    nbytes = e * (px * C + 9 * C * Co + px * Co * (2 if res else 1)) + 8 * Co
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 18 * C * Co * px / (BF16_PEAK if e == 2 else F32_PEAK) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_by(parts):
    """What bounds a sum of calls: 'bytes' when the calls bound by their
    bytes carry at least half of the summed bound. ``parts`` holds
    (calls, bound ms, what bounds it) per shape."""
    by_bytes = sum(n * t for n, t, by in parts if by == "bytes")
    return "bytes" if 2 * by_bytes >= sum(n * t for n, t, _ in parts) else "operations"


def operand_maker(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def operands(B, H, W, C, Co, dtype, res=True):
        x = torch.randn(B, H, W, C, generator=g, device=dev).to(dtype)
        w = (torch.randn(3, 3, C, Co, generator=g, device=dev)
             * (2.0 / (9 * C)) ** 0.5).to(dtype)
        scale = torch.rand(Co, generator=g, device=dev) + 0.5
        bias = torch.randn(Co, generator=g, device=dev) * 0.1
        r = (torch.randn(B, H, W, Co, generator=g, device=dev).to(dtype)
             if res else None)
        return x, w, scale, bias, r
    return operands


def cudnn_composition(x, w, bias, r):
    """The 'xla' backend's composition (scale is 1 there): cuDNN conv with
    bias, then the residual add and ReLU as separate passes."""
    from uresnet_tpu_torch.ops.conv import conv

    y = conv(x, {"w": w, "b": bias}, compute_dtype=x.dtype)
    return torch.relu(y + r) if r is not None else torch.relu(y)


def cuda_core_bf16(fused_mod, x, w, scale, bias, r):
    """The CUDA-core kernel on bf16 operands, called through the
    library's C entry (the wrapper sends these shapes to the tensor-core
    kernel): timed beside it, counted nowhere."""
    out = torch.empty(x.shape[:3] + w.shape[3:], dtype=x.dtype, device=x.device)
    err = fused_mod._lib().uresnet_fused_conv3x3_bf16(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        r.data_ptr() if r is not None else None, out.data_ptr(),
        *x.shape, w.shape[3], 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA-core kernel launch failed: CUDA error {err}")
    return out


def forward_calls(fold, serve, cfg, dev):
    """{(C, Co, H, W, residual): calls} of one forward of ``serve``."""
    calls = {}
    real = fold.fused_conv3x3_bn_relu_v2

    def record(x, w, scale, bias, residual=None, *, relu=True):
        key = (w.shape[2], w.shape[3], x.shape[1], x.shape[2],
               residual is not None)
        calls[key] = calls.get(key, 0) + 1
        return real(x, w, scale, bias, residual, relu=relu)

    fold.fused_conv3x3_bn_relu_v2 = record
    try:
        S = cfg.data.image_size
        serve(torch.rand(1, S, S, 1, device=dev))
    finally:
        fold.fused_conv3x3_bn_relu_v2 = real
    return calls


def kernel_phase(fused_mod, fold, serve, cfg, dev, card):
    """Both kernels vs the plain version; which kernel each case ran; the
    tensor-core kernel's times at the forward's shapes at batch 32. Returns
    the tensor-core kernel's record and its per-call rows."""
    calls = forward_calls(fold, serve, cfg, dev)
    shapes = sorted({k[:4] for k in calls}, key=lambda s: (-s[2], s[0]))
    print(f"[kernels] flagship forward: {sum(calls.values())} fused calls, "
          f"{len(shapes)} distinct (C, Co, H, W): {shapes}", flush=True)
    operands = operand_maker(dev, SEED)

    def check_cases(cases, counter):
        worst = 0.0
        fused_mod.launches_tensor_core = fused_mod.launches_cuda_core = 0
        for (C, Co, H, W), dtype, res, relu in cases:
            x, w, scale, bias, r = operands(1, H, W, C, Co, dtype, res)
            got = fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r,
                                                     relu=relu)
            want = fused_mod.fused_conv3x3_bn_relu_v2_reference(
                x, w, scale, bias, r, relu=relu)
            torch.cuda.synchronize()
            abs_err, rel_err = check_close(got, want, dtype)
            worst = max(worst, abs_err)
            print(f"[kernels] {counter}: {C}->{Co} @{H}x{W} {str(dtype)[6:]} "
                  f"residual={res} relu={relu}: max abs err {abs_err:.3e}, "
                  f"rel {rel_err:.3e} ok", flush=True)
        ran = {"tensor_core": fused_mod.launches_tensor_core,
               "cuda_core": fused_mod.launches_cuda_core}
        if ran[counter] != len(cases) or sum(ran.values()) != len(cases):
            raise AssertionError(f"{len(cases)} cases meant for the {counter} "
                                 f"kernel launched {ran}")
        return worst

    tc_worst = check_cases(
        [(s, torch.bfloat16, res, relu) for s in shapes
         for res, relu in ((True, True), (False, True), (True, False))]
        + [((32, 48, 37, 53), torch.bfloat16, True, True)],   # ragged H, W
        "tensor_core")
    check_cases([((64, 64, 128, 128), torch.float32, True, True),   # f32
                 ((24, 40, 37, 53), torch.bfloat16, True, True)],  # ragged C
                "cuda_core")

    # at the main path's batch, per (shape, residual) as the forward calls
    # it; summed over one forward's calls
    B = cfg.data.batch_size
    rows = []
    for (C, Co, H, W, res), n in sorted(calls.items(), key=lambda kv: -kv[0][2]):
        x, w, scale, bias, r = operands(B, H, W, C, Co, torch.bfloat16, res)
        t_k = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2(
            x, w, scale, bias, r), inner=10)
        t_1 = time_ms(lambda: cuda_core_bf16(fused_mod, x, w, scale, bias, r),
                      inner=10)
        t_p = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2_reference(
            x, w, scale, bias, r), inner=10)
        t_c = time_ms(lambda: cudnn_composition(x, w, bias, r), inner=10)
        abs_err, _ = check_close(  # also at the main path's exact shape
            fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r),
            fused_mod.fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, r),
            torch.bfloat16)
        tc_worst = max(tc_worst, abs_err)
        t_b, by = bound(B, H, W, C, Co, res, torch.bfloat16)
        nbytes = 2 * B * H * W * (C + Co * (2 if res else 1))
        flop = 18 * C * Co * H * W * B
        print(f"[kernels] B={B} {C}->{Co} @{H}x{W} residual={res} x{n}: max "
              f"abs err {abs_err:.3e} ok; tensor-core kernel {t_k:.4f} ms "
              f"({flop / t_k / 1e9:.1f} TFLOP/s, {nbytes / t_k / 1e6:.0f} "
              f"GB/s), bound {t_b:.4f} ms ({by}; {t_b / t_k:.3f} of it), "
              f"cuda-core kernel {t_1:.4f} ms, plain(f32) {t_p:.4f} ms, cudnn bf16 "
              f"{t_c:.4f} ms | {card}", flush=True)
        rows.append((n, t_k, t_1, t_p, t_c, t_b, by))
    total = [sum(row[0] * row[i] for row in rows) for i in range(1, 6)]
    by_bytes = sum(row[0] * row[5] for row in rows if row[6] == "bytes")
    print(f"[kernels] per forward ({sum(calls.values())} calls): tensor-core "
          f"kernel {total[0]:.3f} ms, bound {total[4]:.3f} ms ({by_bytes:.3f} "
          f"of it bytes-bound), cuda-core kernel {total[1]:.3f} ms, plain(f32) "
          f"{total[2]:.3f} ms, cudnn bf16 composition {total[3]:.3f} ms | "
          f"{card}", flush=True)
    return {"max_abs_err": tc_worst, "ms": total[0], "plain_ms": total[2],
            "bound_ms": total[4],
            "bound_by": bound_by([(row[0], row[5], row[6]) for row in rows]),
            "library_ms": total[3]}


def cuda_core_phase(fused_mod, fold, cfg, model, dev, card):
    """The CUDA-core kernel at the shapes of the f32 forward (the flagship
    with compute_dtype float32), batch 32: checked against the plain
    version and timed beside its bound and the cuDNN f32 composition (TF32
    off), summed over one forward's calls."""
    from uresnet_tpu_torch.engine.export import build_serving_fn

    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    calls = forward_calls(fold, build_serving_fn(cfg32, model), cfg32, dev)
    operands = operand_maker(dev, SEED + 4)
    B = cfg.data.batch_size
    worst, total, parts = 0.0, [0.0] * 4, []
    for (C, Co, H, W, res), n in sorted(calls.items(), key=lambda kv: -kv[0][2]):
        x, w, scale, bias, r = operands(B, H, W, C, Co, torch.float32, res)
        t_k = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2(
            x, w, scale, bias, r), reps=3, warmup=1, inner=5)
        t_p = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2_reference(
            x, w, scale, bias, r), reps=3, warmup=1, inner=5)
        t_c = time_ms(lambda: cudnn_composition(x, w, bias, r), reps=3,
                      warmup=1, inner=5)
        abs_err, _ = check_close(
            fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r),
            fused_mod.fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, r),
            torch.float32)
        worst = max(worst, abs_err)
        t_b, by = bound(B, H, W, C, Co, res, torch.float32)
        parts.append((n, t_b, by))
        print(f"[kernels] f32 B={B} {C}->{Co} @{H}x{W} residual={res} x{n}: "
              f"max abs err {abs_err:.3e} ok; cuda-core kernel {t_k:.4f} ms, "
              f"bound {t_b:.4f} ms ({by}), plain(f32) {t_p:.4f} ms, cudnn f32 "
              f"{t_c:.4f} ms", flush=True)
        for i, t in enumerate((t_k, t_p, t_c, t_b)):
            total[i] += n * t
    print(f"[kernels] f32 per forward ({sum(calls.values())} calls): "
          f"cuda-core kernel {total[0]:.3f} ms, bound {total[3]:.3f} ms, "
          f"plain(f32) {total[1]:.3f} ms, cudnn f32 composition "
          f"{total[2]:.3f} ms | {card}", flush=True)
    return {"max_abs_err": worst, "ms": total[0], "plain_ms": total[1],
            "bound_ms": total[3], "bound_by": bound_by(parts),
            "library_ms": total[2]}


def v1_phase(fused_mod, cfg, dev):
    """The v1 entry point (the same kernels) at two flagship shapes, batch
    32: one launch each with the count from 0 — its run — then held
    against the plain version and timed. Returns its record, summed over
    the two shapes."""
    operands = operand_maker(dev, SEED + 1)
    B, shapes = cfg.data.batch_size, ((16, 16, 512, 512, True),
                                      (128, 64, 128, 128, False))
    ops = [operands(B, H, W, C, Co, torch.bfloat16, res)
           for C, Co, H, W, res in shapes]
    fused_mod.launches_v1 = 0
    outs = [fused_mod.fused_conv3x3_bn_relu(*o) for o in ops]
    torch.cuda.synchronize()
    launches = fused_mod.launches_v1
    if launches != len(shapes):
        raise AssertionError(f"v1 launches {launches} != {len(shapes)}")
    rec = {"launches": launches, "max_abs_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    parts = []
    for (C, Co, H, W, res), o, got in zip(shapes, ops, outs):
        abs_err, _ = check_close(got, fused_mod.fused_conv3x3_bn_relu_reference(*o),
                                 torch.bfloat16)
        t_k = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu(*o), inner=10)
        t_p = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_reference(*o),
                      inner=10)
        t_c = time_ms(lambda: cudnn_composition(o[0], o[1], o[3], o[4]),
                      inner=10)
        t_b, by = bound(B, H, W, C, Co, res, torch.bfloat16)
        parts.append((1, t_b, by))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        for k, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_c),
                     ("bound_ms", t_b)):
            rec[k] += t
        print(f"[kernels] v1 B={B} {C}->{Co} @{H}x{W} residual={res}: max abs "
              f"err {abs_err:.3e} ok; kernel {t_k:.4f} ms, bound {t_b:.4f} ms "
              f"({by}), plain(f32) {t_p:.4f} ms, cudnn bf16 {t_c:.4f} ms",
              flush=True)
    rec["bound_by"] = bound_by(parts)
    return rec


def profile_forwards(fns, x, path, card, reps=3, warmup=3, unit="forward",
                     append=False):
    """torch.profiler over ``reps`` calls of each fn (``fn(x)``), after
    ``warmup``. Per call (``unit``): host wall time, device busy time (the
    union of the card's kernel and copy intervals) and its idle share of
    that wall, peak memory, and the kernels that take the most device time.
    The full tables go to ``path`` (appended with ``append``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tables = [card]
    for name, fn in fns.items():
        for _ in range(warmup):
            fn(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events() if e.device_type == DeviceType.CUDA)
        if not dev:  # a measurement, not a check: say so and go on
            print(f"[profile] {name}: device time not measured (the profiler "
                  f"saw no device events)", flush=True)
            continue
        busy_us, end, per_kernel = 0.0, float("-inf"), collections.Counter()
        for a, b, kname in dev:
            per_kernel[kname] += b - a
            if b > end:
                busy_us += b - max(a, end)
                end = b
        busy_ms = busy_us / 1e3 / reps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[profile] {name}: wall {wall_ms:.3f} ms/{unit}, device busy "
              f"{busy_ms:.3f} ms/{unit}, idle share {1 - busy_ms / wall_ms:.4f}, "
              f"peak memory {peak:.3f} GiB | {card}", flush=True)
        for kname, us in per_kernel.most_common(8):
            print(f"[profile]   {us / 1e3 / reps:9.3f} ms/{unit}  {kname[:90]}",
                  flush=True)
        tables += [f"== {name}: wall {wall_ms:.3f} ms/{unit}, device busy "
                   f"{busy_ms:.3f} ms/{unit}, peak memory {peak:.3f} GiB",
                   prof.key_averages().table(sort_by="self_device_time_total",
                                             row_limit=25)]
    with open(path, "a" if append else "w") as f:
        f.write("\n".join(tables) + "\n")
    print(f"[profile] tables written to {path}", flush=True)


def run_cli(cli, argv, tag="serve"):
    """A CLI's main with its stdout echoed; returns the dict of its last
    line (cli.infer: the metrics; cli.train: the final summary)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("".join(f"[{tag}]{' ' * (8 - len(tag))}{line}\n"
                  for line in out.splitlines()), end="")
    if rc != 0:
        raise RuntimeError(f"{cli.__name__} exited {rc}")
    return ast.literal_eval(out.strip().splitlines()[-1].split(": ", 1)[1])


def check_export(path, stats, n_events, num_class):
    """The cli.infer npz: its columns, finite softmax rows, pred = argmax,
    every event counted. Returns the npz."""
    z = np.load(path)
    cols = {"event_id", "plane_id", "coords", "scores", "pred", "label"}
    if set(z.files) != cols:
        raise AssertionError(f"npz columns {sorted(z.files)} != {sorted(cols)}")
    scores = z["scores"]
    if scores.ndim != 2 or scores.shape[1] != num_class:
        raise AssertionError(f"scores shape {scores.shape}")
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite scores")
    row_err = np.abs(scores.sum(1) - 1).max()
    if row_err > 1e-5:
        raise AssertionError(f"softmax rows off 1 by {row_err}")
    if not np.array_equal(z["pred"], scores.argmax(1)):
        raise AssertionError("pred != argmax(scores)")
    if stats["n_events"] != n_events:
        raise AssertionError(f"n_events {stats['n_events']} != {n_events}")
    return z


def serve_counted(fused_mod, infer, argv, out, n_events, num_class, kernel,
                  per_batch=44, batch_events=32):
    """cli.infer with every launch counter set to 0 just before and read just
    after: the entry point ``launches`` and the kernel named by ``kernel``
    ('tensor_core' or 'cuda_core') must count ``per_batch`` per batch, the
    other kernel none. Returns (npz, the counts, wall s)."""
    fused_mod.launches = fused_mod.launches_v1 = 0
    fused_mod.launches_tensor_core = fused_mod.launches_cuda_core = 0
    t0 = time.time()
    stats = run_cli(infer, argv + ["--output", out])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {"v2": fused_mod.launches,
              "tensor_core": fused_mod.launches_tensor_core,
              "cuda_core": fused_mod.launches_cuda_core}
    n = per_batch * -(-n_events // batch_events)
    want = {"v2": n, "tensor_core": 0, "cuda_core": 0}
    want[kernel] = n
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")
    return check_export(out, stats, n_events, num_class), counts, wall


def agreement(z, zx, what):
    """Two exports of the same events: same pixels; softmax and argmax
    within the forward tolerances."""
    for k in ("event_id", "plane_id", "coords", "label"):
        if not np.array_equal(z[k], zx[k]):
            raise AssertionError(f"{what}: export column {k} differs")
    d = np.abs(z["scores"] - zx["scores"]).max()
    agree = float((z["pred"] == zx["pred"]).mean())
    if not (d <= FWD_MAX_SOFTMAX_DIFF and agree >= FWD_MIN_AGREE):
        raise AssertionError(f"{what}: max softmax diff {d} (tol "
                             f"{FWD_MAX_SOFTMAX_DIFF}), argmax agreement "
                             f"{agree} (min {FWD_MIN_AGREE})")
    return d, agree


def train_phase(cfg_path, cfg, fused_mod, card, dev):
    """Phase 7: cli.train at the flagship width, its checkpoint, serving
    from it, the step's time, memory and profile."""
    from uresnet_tpu_torch import generate_file, load_config
    from uresnet_tpu_torch.cli import infer, train
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.models.convert import flatten_tree, jax_train_state

    S = cfg.data.image_size
    planes = tuple(cfg.data.planes)
    t0 = time.time()
    train_file = generate_file(os.path.join(WORK, "train.usef"), TRAIN_EVENTS,
                               seed=SEED + 1, shape=(S, S), planes=planes)
    ckpt_dir, log_dir = os.path.join(WORK, "train_ckpt"), os.path.join(WORK, "train_log")
    overrides = [f"data.input_files={train_file}", "data.synthetic=false",
                 "train.summary_iter=10", "train.checkpoint_iter=0",
                 "train.val_iter=0", f"train.checkpoint_dir={ckpt_dir}",
                 f"train.log_dir={log_dir}"]
    run_cli(train, [cfg_path, *overrides, "--iterations", str(TRAIN_STEPS),
                    "--device", DEVICE], tag="train")
    torch.cuda.synchronize()
    wall = time.time() - t0
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(10, TRAIN_STEPS + 1, 10)):
        raise AssertionError(f"logged steps {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"non-finite loss: {[r['loss'] for r in rows]}")
    ckpt = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:08d}.npz")
    tcfg = load_config(cfg_path, overrides)
    tr = Trainer(tcfg, device=dev)
    ts, step, cursor = tr.restore(ckpt)  # every leaf, or it raises
    want = {"train_state/" + k.replace(".", "/") for k in flatten_tree(
        jax_train_state(ts.model, ts.opt, ts.key))} | {"meta/step",
                                                       "meta/data_cursor"}
    with np.load(ckpt) as z:
        keys = set(z.files)
    if keys != want or step != TRAIN_STEPS or ts.opt.step != TRAIN_STEPS:
        raise AssertionError(f"checkpoint {ckpt}: step {step}, opt step "
                             f"{ts.opt.step}; keys missing "
                             f"{sorted(want - keys)[:5]}, extra "
                             f"{sorted(keys - want)[:5]}")
    print(f"[train]   {TRAIN_STEPS} steps in {wall:.2f} s wall (incl. data "
          f"generation, loader start, first-step setup); losses "
          f"{[round(r['loss'], 4) for r in rows]} finite; checkpoint holds the "
          f"{len(keys)} leaves of the JAX layout and restores at step {step}, "
          f"data cursor {cursor}", flush=True)

    # serve from the trained checkpoint
    n_serve = cfg.data.batch_size // len(planes)
    events = generate_file(os.path.join(WORK, "serve32.usef"), n_serve,
                           seed=SEED + 2, shape=(S, S), planes=planes)
    out = os.path.join(WORK, "scores_trained.npz")
    _, counts, _ = serve_counted(
        fused_mod, infer, [cfg_path, "--checkpoint", ckpt, "--input", events,
                           "--device", DEVICE], out, n_serve,
        cfg.model.num_class, "tensor_core")
    print(f"[train]   served {n_serve} events from the trained checkpoint: "
          f"kernel launches {counts} (= 44 x 1 on the tensor-core kernel), "
          f"export checked", flush=True)

    # the step's time, memory and profile at batch 32
    loader = tr.make_loader(train=True)
    loader.start()
    try:
        host = loader.next()
    finally:
        loader.stop()
        if hasattr(loader, "close"):
            loader.close()
    host.pop("cursor", None)
    batch = tr.device_batch(host)
    state = [ts]

    def step(_=None):
        state[0], m = tr.train_step_light(state[0], batch)
        return m

    B = cfg.data.batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_step = time_ms(step, reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(step()["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss} in the timed steps")
    print(f"[train]   B={B} {S}^2 bf16 train_step_light (sparse batch, densify "
          f"on device): {t_step:.2f} ms/step = {B / t_step * 1e3:.1f} img/s, "
          f"peak memory {peak:.3f} GiB | {card}", flush=True)
    layer_times(tr, state[0], batch, card)
    profile_forwards({"train step": step}, None,
                     os.path.join(WORK, "profile.txt"), card, unit="step",
                     append=True)
    return t_step, peak


def layer_times(tr, ts, batch, card, reps=5):
    """The train step's layers timed apart with CUDA events (median of
    ``reps`` after one warm-up): densify, forward, loss, backward,
    optimizer. The update is computed and dropped."""
    from uresnet_tpu_torch.engine.losses import weighted_softmax_xent
    from uresnet_tpu_torch.engine.optim import adam_update

    names = ("densify", "forward", "loss", "backward", "optimizer")
    params = dict(ts.model.named_parameters())
    trainable = [k for k, p in params.items() if p.requires_grad]
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        dense = tr._prepare(batch)
        ev[1].record()
        with torch.enable_grad():
            logits, _ = ts.model(dense["data"], train=True)
            ev[2].record()
            loss = weighted_softmax_xent(logits, dense["label"], dense["weight"])
            ev[3].record()
            grads = torch.autograd.grad(loss, [params[k] for k in trainable])
        ev[4].record()
        adam_update(dict(zip(trainable, grads)), ts.opt,
                    {k: p.detach() for k, p in params.items()}, tr.cfg.optim)
        ev[5].record()
        ev[5].synchronize()
        rows.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    med = np.median(np.array(rows[1:]), axis=0)
    print("[train]   layers, ms/step (median of %d): %s; sum %.2f | %s" % (
        reps, ", ".join(f"{n} {t:.2f}" for n, t in zip(names, med)),
        med.sum(), card), flush=True)


def dw_phase(dev):
    """Phase 7b: the bf16 conv's f32 weight gradient vs the float64 product
    of the same bf16 operands, and its data gradient vs stock bf16
    autograd (exactly), at two flagship shapes, batch 4. The dw limit is
    asserted at 256->256 @32^2, a 4096-term reduction; at 16->16 @512^2
    each dw element sums 2^20 products, and f32 accumulation alone may
    round that sum by ~1e-5 of its max, so that error is reported."""
    import torch.nn.functional as F

    from uresnet_tpu_torch.ops.conv import conv_general

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for C, S, asserted in ((256, 32, True), (16, 512, False)):
        x = torch.randn(4, S, S, C, generator=g, device=dev).bfloat16()
        w = torch.randn(3, 3, C, C, generator=g, device=dev) * (2 / (9 * C)) ** 0.5
        gy = torch.randn(4, S, S, C, generator=g, device=dev).bfloat16()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # one dgrad algorithm
        try:
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            conv_general(xa, wa, stride=1,
                         compute_dtype=torch.bfloat16).backward(gy)
            xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
            F.conv2d(xs.permute(0, 3, 1, 2), ws.bfloat16().permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1).backward(gy)
            w64 = w.bfloat16().double().requires_grad_()
            conv_general(x.double(), w64, stride=1,
                         compute_dtype=torch.float64).backward(gy.double())
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if wa.grad.dtype != torch.float32:
            raise AssertionError(f"dw dtype {wa.grad.dtype}")
        ref = w64.grad.abs().max()
        rel = float((wa.grad.double() - w64.grad).abs().max() / ref)
        rel_stock = float((ws.grad.double() - w64.grad).abs().max() / ref)
        if asserted and rel > DW_REL:
            raise AssertionError(f"{C}->{C} @{S}^2: dw relative error "
                                 f"{rel:.3e} > {DW_REL}")
        if not torch.equal(xa.grad, xs.grad):
            raise AssertionError(
                f"{C}->{C} @{S}^2: dx differs from stock bf16 autograd, max "
                f"{(xa.grad.float() - xs.grad.float()).abs().max()}")
        print(f"[dw]      {C}->{C} @{S}^2 B=4 bf16: f32 dw max error / max|dw| "
              f"vs float64 {rel:.3e} "
              f"({'limit ' + str(DW_REL) if asserted else 'reported'}; stock "
              f"autograd's bf16 dw {rel_stock:.3e}); dx equal to stock bf16 "
              f"autograd", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"[device]  {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False  # the plain versions: true f32
    torch.backends.cuda.matmul.allow_tf32 = False

    from uresnet_tpu_torch import generate_file, load_config
    from uresnet_tpu_torch.cli import infer
    from uresnet_tpu_torch.engine.checkpoint import (save_checkpoint,
                                                     train_state_tree)
    from uresnet_tpu_torch.engine.export import build_serving_fn
    from uresnet_tpu_torch.models import fold
    from uresnet_tpu_torch.models.convert import jax_params
    from uresnet_tpu_torch.models.uresnet import UResNet
    from uresnet_tpu_torch.ops.cuda import build
    from uresnet_tpu_torch.ops.cuda import conv2d as fused_mod

    # 2. build
    t0 = time.time()
    lib = build.build()
    build.load_library()
    print(f"[build]   {os.path.relpath(lib, ROOT)} in {time.time() - t0:.2f} s",
          flush=True)
    log = lib.with_suffix(".so.log")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "registers" in line or "spill" in line:
            print(f"[build]   ptxas: {line.strip()}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    cfg_path = os.path.join(WORK, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(FLAGSHIP, f)
    cfg = load_config(cfg_path)
    g = torch.Generator().manual_seed(SEED)
    model = UResNet(cfg.model, generator=g)
    randomize_bn(model, g)
    model.to(dev)
    serve = build_serving_fn(cfg, model)

    # 3. both kernels vs plain; times at the main paths' shapes; v1
    tc_rec = kernel_phase(fused_mod, fold, serve, cfg, dev, card)
    cc_rec = cuda_core_phase(fused_mod, fold, cfg, model, dev, card)
    v1_rec = v1_phase(fused_mod, cfg, dev)
    if KERNELS_ONLY:
        return

    # 4. the main path through the normal entry point (bf16: tensor cores)
    ckpt = save_checkpoint(os.path.join(WORK, "ckpt"), 0,
                           train_state_tree(*jax_params(model), 0))
    S = cfg.data.image_size
    events = generate_file(os.path.join(WORK, "events.usef"), N_EVENTS,
                           seed=SEED, shape=(S, S), planes=tuple(cfg.data.planes))
    argv = [cfg_path, "--checkpoint", ckpt, "--input", events, "--device", DEVICE]
    batch_events = cfg.data.batch_size // len(cfg.data.planes)
    z, counts, wall = serve_counted(
        fused_mod, infer, argv, os.path.join(WORK, "scores_auto.npz"),
        N_EVENTS, cfg.model.num_class, "tensor_core", batch_events=batch_events)
    tc_rec["launches"] = counts["tensor_core"]
    print(f"[serve]   {N_EVENTS} events, {len(z['scores'])} charge pixels "
          f"exported, kernel launches {counts} (= 44 per batch, tensor-core "
          f"kernel), {wall:.2f} s wall incl. host densify/export", flush=True)

    # 4b. the f32 serving path (CUDA-core kernel), held to the bf16 one
    z32, counts, wall = serve_counted(
        fused_mod, infer, argv + ["model.compute_dtype=float32"],
        os.path.join(WORK, "scores_f32.npz"), N_EVENTS, cfg.model.num_class,
        "cuda_core", batch_events=batch_events)
    cc_rec["launches"] = counts["cuda_core"]
    d, agree = agreement(z32, z, "f32 vs bf16 kernel path")
    print(f"[serve32] {N_EVENTS} events at compute_dtype float32: kernel "
          f"launches {counts} (= 44 per batch, CUDA-core kernel), {wall:.2f} s "
          f"wall; vs the bf16 kernel path: max softmax diff {d:.3e}, argmax "
          f"agreement {agree:.5f}", flush=True)

    # 5. whole forward: kernel vs plain (cuDNN) path
    zx, _, _ = serve_counted(
        fused_mod, infer, argv + ["model.kernel_backend=xla"],
        os.path.join(WORK, "scores_xla.npz"), N_EVENTS, cfg.model.num_class,
        "tensor_core", per_batch=0, batch_events=batch_events)
    d, agree = agreement(z, zx, "kernel vs cudnn forward")
    print(f"[forward] kernel vs cudnn path on {len(z['scores'])} charge pixels: "
          f"max softmax diff {d:.3e} (tol {FWD_MAX_SOFTMAX_DIFF}), argmax "
          f"agreement {agree:.5f} (min {FWD_MIN_AGREE})", flush=True)

    B = cfg.data.batch_size
    x = torch.rand(B, S, S, 1, generator=torch.Generator().manual_seed(SEED))
    x = (x * (x > 0.98)).to(dev)  # ~2% charge pixels, like the events
    serve_xla = build_serving_fn(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, kernel_backend="xla")), model)
    t_auto = time_ms(lambda: serve(x), reps=7)
    t_xla = time_ms(lambda: serve_xla(x), reps=7)
    k_ms = tc_rec["ms"]
    print(f"[forward] B={B} {S}^2 bf16 forward+softmax: kernel path "
          f"{t_auto:.2f} ms = {B / t_auto * 1e3:.1f} img/s; cudnn path "
          f"{t_xla:.2f} ms = {B / t_xla * 1e3:.1f} img/s; kernel share of the "
          f"kernel-path forward {k_ms / t_auto:.3f} (kernel {k_ms:.2f} ms, "
          f"its cudnn bf16 composition {tc_rec['library_ms']:.2f} ms, plain "
          f"f32 {tc_rec['plain_ms']:.2f} ms per forward) | {card}", flush=True)

    # 6. where the forward's time goes
    profile_forwards({"kernel path": serve, "cudnn path": serve_xla}, x,
                     os.path.join(WORK, "profile.txt"), card)

    # 7. the training path; 7b. the f32 weight gradient on the card
    train_phase(cfg_path, cfg, fused_mod, card, dev)
    dw_phase(dev)

    leaked = sorted(m for m in sys.modules if m in ("jax", "uresnet_tpu")
                    or m.startswith(("jax.", "jaxlib", "uresnet_tpu.")))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    src = "uresnet_tpu_torch/csrc/conv2d.cu"
    kernels = [
        dict(name="fused_conv3x3_bn_relu_v2 (tensor-core kernel)",
             replaces="uresnet_tpu/ops/pallas/conv2d.py:130", **tc_rec),
        dict(name="fused_conv3x3_bn_relu_v2 (CUDA-core kernel, f32 path)",
             replaces="uresnet_tpu/ops/pallas/conv2d.py:130", **cc_rec),
        dict(name="fused_conv3x3_bn_relu", 
             replaces="uresnet_tpu/ops/pallas/conv2d.py:182", **v1_rec)]
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": src,
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    KERNELS_ONLY = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        raise SystemExit(f"usage: {sys.argv[0]} [--kernels-only]")
    main()
