#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uresnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at the flagship width of
configs/train_2d_512.yaml (2D U-ResNet, base 16, depth 5, 2 blocks per
level, 3 classes, bf16, 512^2, batch 32) with random seeded weights:

  1. device   — requires a CUDA device; prints the card's name and power
                limit (nvidia-smi) and the torch / CUDA versions;
  2. build    — compiles uresnet_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernels  — the fused conv kernel vs its plain version at every shape the
                flagship forward gives it (enumerated from the model), plus
                an f32 case and a ragged case; then at batch 32, as the
                forward calls it, checks the kernel again and times it, the
                plain version and the cuDNN bf16 composition;
  4. serve    — 64 synthetic 512^2 events through ``python -m
                uresnet_tpu_torch.cli.infer`` (2 batches of 32) from a
                checkpoint in the JAX npz layout; checks the export and that
                the kernel launched exactly 44 times per batch;
  5. forward  — the same events with ``kernel_backend=xla`` (cuDNN) for
                agreement, and both whole forwards timed.

  6. profile  — ``torch.profiler`` over both whole forwards: per forward
                the wall time, the device's busy time and idle share, the
                peak memory and the top kernels; the full profiler tables go
                to build/uresnet_tpu_torch/smoke/profile.txt.

Then one JSON line of kernel results, the card line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and the last line is not printed. Scratch files go under
build/uresnet_tpu_torch/smoke/ in the checkout.
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


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def time_ms(fn, reps=5, warmup=2) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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


def kernel_phase(fused_mod, fold, serve, cfg, dev):
    """Kernel vs plain at every shape of the flagship forward; timings."""
    from uresnet_tpu_torch.ops.conv import conv

    calls = {}  # (C, Co, H, W, residual) -> calls per forward
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
    shapes = sorted({k[:4] for k in calls}, key=lambda s: (-s[2], s[0]))
    print(f"[kernels] flagship forward: {sum(calls.values())} fused calls, "
          f"{len(shapes)} distinct (C, Co, H, W): {shapes}", flush=True)

    g = torch.Generator(device=dev).manual_seed(SEED)

    def operands(B, H, W, C, Co, dtype):
        x = torch.randn(B, H, W, C, generator=g, device=dev).to(dtype)
        w = (torch.randn(3, 3, C, Co, generator=g, device=dev)
             * (2.0 / (9 * C)) ** 0.5).to(dtype)
        scale = torch.rand(Co, generator=g, device=dev) + 0.5
        bias = torch.randn(Co, generator=g, device=dev) * 0.1
        res = torch.randn(B, H, W, Co, generator=g, device=dev).to(dtype)
        return x, w, scale, bias, res

    worst = 0.0
    cases = [(s, torch.bfloat16, res, relu) for s in shapes
             for res, relu in ((True, True), (False, True), (True, False))]
    cases += [((64, 64, 128, 128), torch.float32, True, True),   # f32
              ((24, 40, 37, 53), torch.bfloat16, True, True)]    # ragged
    for (C, Co, H, W), dtype, res, relu in cases:
        x, w, scale, bias, r = operands(1, H, W, C, Co, dtype)
        r = r if res else None
        got = fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r, relu=relu)
        want = fused_mod.fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias,
                                                            r, relu=relu)
        torch.cuda.synchronize()
        abs_err, rel_err = check_close(got, want, dtype)
        worst = max(worst, abs_err)
        print(f"[kernels] {C}->{Co} @{H}x{W} {str(dtype)[6:]} residual={res} "
              f"relu={relu}: max abs err {abs_err:.3e}, rel {rel_err:.3e} ok",
              flush=True)

    # times at the main path's batch, per (shape, residual) as the forward
    # calls it; summed over one forward's calls
    B = cfg.data.batch_size
    ms = plain_ms = cudnn_ms = 0.0
    for (C, Co, H, W, res), n in sorted(calls.items(), key=lambda kv: -kv[0][2]):
        x, w, scale, bias, r = operands(B, H, W, C, Co, torch.bfloat16)
        r = r if res else None
        p = {"w": w, "b": bias}
        t_k = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2(
            x, w, scale, bias, r))
        t_p = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2_reference(
            x, w, scale, bias, r))

        def cudnn():  # the 'xla' backend's composition (scale is 1 there)
            y = conv(x, p, compute_dtype=torch.bfloat16)
            return torch.relu(y + r) if r is not None else torch.relu(y)

        t_c = time_ms(cudnn)
        abs_err, _ = check_close(  # also at the main path's exact shape
            fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r),
            fused_mod.fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, r),
            torch.bfloat16)
        worst = max(worst, abs_err)
        flop = 2 * 9 * C * Co * H * W * B
        print(f"[kernels] B={B} {C}->{Co} @{H}x{W} residual={res} x{n}: "
              f"max abs err {abs_err:.3e} ok; "
              f"kernel {t_k:.4f} ms ({flop / t_k / 1e9:.2f} TFLOP/s), "
              f"plain(f32) {t_p:.4f} ms, cudnn bf16 {t_c:.4f} ms", flush=True)
        ms += n * t_k
        plain_ms += n * t_p
        cudnn_ms += n * t_c
    return worst, ms, plain_ms, cudnn_ms


def profile_forwards(fns, x, path, card, reps=3, warmup=3):
    """torch.profiler over ``reps`` forwards of each serving fn, after
    ``warmup``. Per forward: host wall time, device busy time (the union of
    the card's kernel and copy intervals) and its idle share of that wall,
    peak memory, and the kernels that take the most device time. The full
    tables go to ``path``."""
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
        print(f"[profile] {name}: wall {wall_ms:.3f} ms/forward, device busy "
              f"{busy_ms:.3f} ms/forward, idle share {1 - busy_ms / wall_ms:.4f}, "
              f"peak memory {peak:.3f} GiB | {card}", flush=True)
        for kname, us in per_kernel.most_common(8):
            print(f"[profile]   {us / 1e3 / reps:9.3f} ms/forward  {kname[:90]}",
                  flush=True)
        tables += [f"== {name}: wall {wall_ms:.3f} ms/forward, device busy "
                   f"{busy_ms:.3f} ms/forward, peak memory {peak:.3f} GiB",
                   prof.key_averages().table(sort_by="self_device_time_total",
                                             row_limit=25)]
    with open(path, "w") as f:
        f.write("\n".join(tables) + "\n")
    print(f"[profile] tables written to {path}", flush=True)


def run_cli(infer, argv):
    """cli.infer.main with its stdout echoed; returns its metrics dict."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = infer.main(argv)
    out = buf.getvalue()
    print("".join(f"[serve]   {line}\n" for line in out.splitlines()), end="")
    if rc != 0:
        raise RuntimeError(f"cli.infer exited {rc}")
    return ast.literal_eval(out.strip().splitlines()[-1].split(": ", 1)[1])


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

    # 3. kernel vs plain at the slice's shapes
    worst, k_ms, p_ms, c_ms = kernel_phase(fused_mod, fold, serve, cfg, dev)

    # 4. the main path through the normal entry point
    ckpt = save_checkpoint(os.path.join(WORK, "ckpt"), 0,
                           train_state_tree(*jax_params(model), 0))
    S = cfg.data.image_size
    events = generate_file(os.path.join(WORK, "events.usef"), N_EVENTS,
                           seed=SEED, shape=(S, S), planes=tuple(cfg.data.planes))
    out_auto = os.path.join(WORK, "scores_auto.npz")
    argv = [cfg_path, "--checkpoint", ckpt, "--input", events, "--device", DEVICE]
    fused_mod.launches = 0
    t0 = time.time()
    stats = run_cli(infer, argv + ["--output", out_auto])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fused_mod.launches
    n_batches = -(-N_EVENTS // (cfg.data.batch_size // len(cfg.data.planes)))
    z = np.load(out_auto)
    cols = {"event_id", "plane_id", "coords", "scores", "pred", "label"}
    if set(z.files) != cols:
        raise AssertionError(f"npz columns {sorted(z.files)} != {sorted(cols)}")
    scores = z["scores"]
    if scores.ndim != 2 or scores.shape[1] != cfg.model.num_class:
        raise AssertionError(f"scores shape {scores.shape}")
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite scores")
    row_err = np.abs(scores.sum(1) - 1).max()
    if row_err > 1e-5:
        raise AssertionError(f"softmax rows off 1 by {row_err}")
    if not np.array_equal(z["pred"], scores.argmax(1)):
        raise AssertionError("pred != argmax(scores)")
    if stats["n_events"] != N_EVENTS:
        raise AssertionError(f"n_events {stats['n_events']} != {N_EVENTS}")
    if launches != 44 * n_batches:
        raise AssertionError(f"kernel launches {launches} != 44 x {n_batches}")
    print(f"[serve]   {N_EVENTS} events in {n_batches} batches, "
          f"{len(scores)} charge pixels exported, kernel launches {launches} "
          f"(= 44 x {n_batches}), {wall:.2f} s wall incl. host densify/export",
          flush=True)

    # 5. whole forward: kernel vs plain (cuDNN) path
    out_xla = os.path.join(WORK, "scores_xla.npz")
    run_cli(infer, argv + ["--output", out_xla, "model.kernel_backend=xla"])
    zx = np.load(out_xla)
    for k in ("event_id", "plane_id", "coords", "label"):
        if not np.array_equal(z[k], zx[k]):
            raise AssertionError(f"export column {k} differs between backends")
    d = np.abs(scores - zx["scores"]).max()
    agree = float((z["pred"] == zx["pred"]).mean())
    if not (d <= FWD_MAX_SOFTMAX_DIFF and agree >= FWD_MIN_AGREE):
        raise AssertionError(f"kernel vs cudnn forward: max softmax diff {d} "
                             f"(tol {FWD_MAX_SOFTMAX_DIFF}), argmax agreement "
                             f"{agree} (min {FWD_MIN_AGREE})")
    print(f"[forward] kernel vs cudnn path on {len(scores)} charge pixels: max "
          f"softmax diff {d:.3e} (tol {FWD_MAX_SOFTMAX_DIFF}), argmax agreement "
          f"{agree:.5f} (min {FWD_MIN_AGREE})", flush=True)

    B = cfg.data.batch_size
    x = torch.rand(B, S, S, 1, generator=torch.Generator().manual_seed(SEED))
    x = (x * (x > 0.98)).to(dev)  # ~2% charge pixels, like the events
    serve_xla = build_serving_fn(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, kernel_backend="xla")), model)
    t_auto = time_ms(lambda: serve(x), reps=7)
    t_xla = time_ms(lambda: serve_xla(x), reps=7)
    print(f"[forward] B={B} {S}^2 bf16 forward+softmax: kernel path "
          f"{t_auto:.2f} ms = {B / t_auto * 1e3:.1f} img/s; cudnn path "
          f"{t_xla:.2f} ms = {B / t_xla * 1e3:.1f} img/s; kernel share of the "
          f"kernel-path forward {k_ms / t_auto:.3f} (kernel {k_ms:.2f} ms, "
          f"its cudnn bf16 composition {c_ms:.2f} ms, plain f32 {p_ms:.2f} ms "
          f"per forward) | {card}", flush=True)

    # 6. where the forward's time goes
    profile_forwards({"kernel path": serve, "cudnn path": serve_xla}, x,
                     os.path.join(WORK, "profile.txt"), card)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "fused_conv3x3_bn_relu_v2", "route": "cuda",
        "source": "uresnet_tpu_torch/csrc/conv2d.cu",
        "replaces": "uresnet_tpu/ops/pallas/conv2d.py:130",
        "launches": launches, "max_abs_err": worst,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
