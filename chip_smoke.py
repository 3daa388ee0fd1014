#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uresnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving, training and analysis paths at the flagship width of
configs/train_2d_512.yaml (2D U-ResNet, base 16, depth 5, 2 blocks per
level, 3 classes, bf16, 512^2, batch 32), and then of the 3D U-ResNet of
configs/train_3d_192.yaml, with random seeded weights:

  1. device   — requires a CUDA device; prints the card's name and power
                limit (nvidia-smi) and the torch / CUDA versions;
  2. build    — compiles uresnet_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernels  — the fused conv's three kernels vs the plain version: the
                tensor-core kernel in bf16 and in f16, and the f32
                tensor-core kernel (3xTF32), at every shape their forward
                gives them (enumerated from the model) x {residual+ReLU,
                ReLU, residual}, plus a ragged spatial case (f32: and 8-
                and 40-channel cases); the channel tails in all three
                dtypes (C or Co not a multiple of 16, rows not 16-byte
                multiples: 1->16, 3->5, 12->16, 16->4, 20->36, 24->40,
                40->24 at 37x53); every f32 case also against a float64
                conv of the same operands at 1e-5 of the max, beside the
                plain version's error; the launch counters show which
                kernel ran each. Then at batch 32, as the forward calls it,
                checks the bf16 and the f16 kernel again and times each
                beside its bound, the plain version and the cuDNN
                composition in its dtype; the f32 kernel likewise at the
                f32 forward's shapes, beside the plain version, cuDNN's f32
                composition and both bounds (CUDA-core f32, tensor-core
                3xTF32); the channel-tail route's own run (two calls at
                batch 32, counted: bf16 24->40, f32 20->36); the v1 entry
                point at two shapes;
  3b. bn      — train BN's four kernels (csrc/bn_train.cu: statistics,
                affine + residual + ReLU, gradient sums, input gradient)
                vs their plain versions, forward and every gradient, in
                bf16, f16 and f32 (f64 at the smallest shape) at the
                training steps' 2D and 3D level-0 shapes and the deepest
                2D level; each bf16 kernel timed beside its byte bound,
                the plain versions and the library's train BN + ReLU
                (phases 7 and 9 count the launches of the main path's
                steps: each kernel once per BatchNorm module a step, 55
                in 2D and 45 in 3D);
  4. serve    — 64 synthetic 512^2 events through ``python -m
                uresnet_tpu_torch.cli.infer`` (2 batches of 32, the default
                streamed sparse export) from a checkpoint in the JAX npz
                layout; checks the export and that the tensor-core kernel
                launched exactly 44 times per batch;
  4b. serve32 — the same events with ``model.compute_dtype=float32``: the
                f32 tensor-core kernel launches 44 times per batch, and the
                scores agree with the bf16 run's;
  4c. serve16 — the same events with ``model.compute_dtype=float16``: the
                f16 tensor-core kernel launches 44 times per batch, and the
                scores agree with the bf16 run's;
  5. forward  — the same events with ``kernel_backend=xla`` (cuDNN) for
                agreement, and both whole forwards timed; the f16 forward
                on its kernel; the f32 forward on the f32 tensor-core
                kernel and on cuDNN's true f32.

  6. profile  — ``torch.profiler`` over both whole forwards and the f32
                forward on its kernel: per forward
                the wall time, the device's busy time and idle share, the
                peak memory and the top kernels; the full profiler tables go
                to build/uresnet_tpu_torch/smoke/profile.txt;
  7. train    — 30 steps of ``python -m uresnet_tpu_torch.cli.train`` in
                the config's packed layout (phases 7, 9, 11, 12 and 14
                print the layout they train in) on
                synthetic 512^2 events (sparse transfer, densify on the
                device, class-balance weights, Adam with the cosine
                schedule) with one ``train.val_exact`` validation at the
                last step (``evaluate_dataset`` over the held-out file);
                checks the logged losses, the validation's event count and
                the checkpoint's JAX key layout, serves 32 events from it
                through ``cli.infer`` (exactly 44 kernel launches), times
                ``train_step_light`` (steps queued back to back, after the
                earlier phases' cached memory is released), counts its
                train-BN launches and profiles 3 steps (appended to
                profile.txt);
  7b. dw      — the bf16 conv's f32 weight gradient vs float64 at a
                flagship shape, and its data gradient vs stock autograd;
  8. ana      — the analysis surface on phase 4's checkpoint and events:
                ``cli.infer`` in its default sparse export, ``--export
                dense`` and ``--format usef``, and ``run_inference`` on the
                host-densify path, each with exactly 44 tensor-core
                launches per batch; the three npz exports are bit-equal and the
                USEF file holds the npz scores; ``--metrics-only --input``
                gives the sparse pass's mIoU; ``--tiled`` scores every
                point of 16 events of 1024^2; then the passes' wall times
                over 128 events (readback groups 1 and 4) and the device
                time of the ana steps and their readbacks.

  9. 3d      — BASELINE config 4 (configs/train_3d_192.yaml: 3D, base 16,
                depth 4, bf16 with the f32 head, 192^3, batch 1, remat off),
                where no fused kernel runs (every launch count stays 0): a
                seeded full-size model's f32 forward on the card against
                the CPU's at 48^3; 30 steps of ``cli.train`` on 64 synthetic
                192^3 events with one ``val_exact`` validation, the
                checkpoint's 5-D JAX layout, f32 logits; train_step_light's
                time, layers and peak memory at batch 1, 2 and 4 (remat
                off) and 4 (remat block), a profile of 3 steps, the f32
                head's cost in TF32 and true f32; from the
                checkpoint, ``cli.infer`` on 16 events: sparse, dense and
                host exports bit-equal, USEF, ``--metrics-only`` (16 x
                192^3 voxels), ``--tiled`` on 4 events of 256^3 (8 tiles
                each), bf16 vs f32 scores; the serving forward's vol/s and
                profile, and the sparse analysis pass's events/s.

 10. artifact — the serving artifact and the checkpoint lifecycle, with
                cuDNN's TF32 flag left at torch's default (True): phase 7's
                trained checkpoint exported by ``python -m
                uresnet_tpu_torch.tools.export_serving --selftest`` as a
                bf16 and an f32 ``.uxm`` (batch 32, 512^2), reloaded with
                ``load_serving`` and run on phase 4's events densified: 44
                tensor-core (bf16) or f32 tensor-core (f32) launches per batch
                through the loaded program, scores vs ``build_serving_fn``;
                the f32 forward in-process (both backends) and through the
                f32 artifact vs the CPU's at 1e-4, the flags unchanged after;
                phase 9's config-4 checkpoint as a 192^3 ``.uxm`` with its
                f32 head, bit-equal scores under either TF32 flag, 0 fused
                launches; the loaded forwards timed beside
                ``build_serving_fn``; a bf16 release checkpoint
                (``make_release_ckpt``) whose ``--metrics-only`` equals the
                full checkpoint's; ``cli.train --profile`` writing a trace
                that names CUDA kernels.
 11. dp       — data parallelism at configs/train_2d_512_dp8.yaml's share
                of one card (batch 32, plane 2, augment, parallel.data 0),
                each rank a ``chip_smoke.py --dp-worker`` process in the
                torchrun environment: ``cli.train --distributed`` at world
                1 on NCCL (10 steps and one ``val_exact``: losses against a
                one-process run, 44 fused launches per local batch, the
                all-reduces per step from the profiler, the DP step's ms
                against phase 7's); two ranks on the one card through gloo
                between CUDA tensors (4 steps at global batch 32 and one
                ``evaluate_dataset``): the ranks' replicas bit-equal, the
                losses and rank 0's checkpoints against one process on the
                rank-major batch, both ranks' evaluations equal and equal to
                one process's on rank 0's checkpoint, only rank 0 wrote;
 12. mp       — BASELINE config 3 (configs/train_multiplane.yaml: 30 rows =
                10 events x 3 planes, augment): 30 ``cli.train`` steps with
                one ``val_exact`` (n_pixels = events x 3 x 512^2);
                train_step_light at 30 and 96 rows (without remat if the
                30-row peak x 3.2 stays under 72 GiB) and batch 64 of plane
                2; ``cli.infer`` on 3-plane events: sparse and dense exports
                bit-equal, ``--metrics-only``, 44 launches per batch.
 13. tp       — tensor parallelism: configs/train_2d_512_tp.yaml at one
                data shard's shape (batch 32, 512^2, bf16) with its model
                axis of 2, as two ``--dp-worker tp`` ranks on the one card
                through gloo: train_step_light timed, each rank's peak
                memory and param + moment bytes against one process's, the
                collectives per step (profiler), the gathered state saved by
                rank 0 and restored in one process (digest equal); then
                ``cli.train --distributed`` (4 steps, one ``val_exact``
                over phase 7's 256 events on the gathered state, 44
                tensor-core launches per 32-row batch on each rank), the
                losses against one process on the same batches;
 14. sp       — the spatial halo exchange: configs/train_3d_192_sp.yaml at
                one data group's shape (batch 2, 192^3, remat block, f32
                head) with its spatial axis of 2 (96 of 192 D planes a
                rank), the same checks with 0 fused launches; the first
                step's loss held (MESH_STEPS' comment); then the same leg in
                true f32 in both layouts, packed as shipped and canonical
                (``model.pack=false``: the canonical convs' halos, the
                transposed conv's among them), each first loss within 1e-5
                of one process.
                With two or more cards phases 13-14 also run on NCCL, one
                card a rank (data 2 on four cards); with one they print
                that those legs did not run.
 15. packed   — the packed layout (models/packed.py; cuDNN convs and
                torch's relayouts, 0 fused launches) against the canonical
                one: the packed train forward at the flagship width, 512^2,
                batch 4: f32 logits (TF32 off) within 1e-4 of the max,
                float64 gradients within 1e-4 of each leaf's max, and a
                planted backward fault in the stem's packing that this
                check must flag; config 2's train_step_light at
                batch 32 in three legs (packed as shipped, canonical, the
                packed loss) and config 4's at batch 1, 192^3 (packed,
                canonical), in turns: ms/step, rate, peak GiB, the bf16
                first-step losses within 1e-2, the forward/backward split;
                both configs' profiles per layout (top kernels, the weight
                gradients, convertTensor and copies per step) and one
                config-4 level-0 weight gradient in each layout. The SP
                leg in packed f32 is phase 14's f32 leg.
 16. tools    — ``python -m uresnet_tpu_torch.tools.bench`` three times
                (the default 2D train step at 512^2, batch 32, packed;
                ``--infer``; ``--dims 3``): one JSON line each with
                bench.py's keys, the 2D train ms/step within 15% of phase
                7's; then ``tools.reproduce_flagship`` in-process on
                configs/train_2d_512.yaml at 30 iterations, 64 training
                and 64 held-out events (width, depth and batch uncut; the
                YAML needs PyYAML on the card): it exits 0, stages 2 and 4
                print the same ``metrics:`` line, each stage's wall time
                printed; its ckpt/, log/ and artifacts/ files are removed
                after.

Then one JSON line of kernel results, the card line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
non-zero and the last line is not printed. Scratch files go under
build/uresnet_tpu_torch/smoke/ in the checkout.

    python3 chip_smoke.py --kernels-only

runs phases 1-3b alone (a short check of the kernels) and prints no result
line; ``--parallel-only`` runs the build and phases 13-14 (with two or more
cards their NCCL legs alone: the run for a four-card machine) and prints
no result line; ``--packed-only`` the build and phase 15. ``--dp-worker MODE SPEC`` is one rank of phase 11 (modes
nccl, gloo) or of phases 13-14 (tp, sp), started by them.
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
ANA_EVENTS = 128  # phase 8's timed passes

# configs/train_2d_512.yaml, written out so no YAML parser is needed. It
# trains packed as shipped (pack, pack_extra_h: models/packed.py); serving
# and analysis run the BN-folded canonical forward, as in the JAX package.
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

# configs/train_3d_192.yaml (BASELINE config 4), written out the same way:
# 3D, base 16, depth 4, 2 blocks per level, bf16 with the f32 head, 192^3,
# batch 1, remat off; its pack: true trains packed (96^3 x 128 at level 0).
CONFIG4 = {
    "model": {"dims": 3, "num_class": 3, "base_filters": 16, "depth": 4,
              "compute_dtype": "bfloat16", "pack": True, "remat": False,
              "head_dtype": "float32"},
    "data": {"image_size": 192, "batch_size": 1, "planes": [0],
             "weight_mode": "class_balance", "backend": "auto",
             "max_points": 24576, "num_threads": 4},
    "optim": {"lr": 2.0e-4, "schedule": "cosine", "decay_steps": 10000,
              "warmup_steps": 200, "grad_clip_norm": 1.0},
    "train": {"iterations": 10000},
}
VOL_TRAIN_EVENTS = 64   # phase 9's training file (and its val_exact set)
VOL_ANA_EVENTS = 16     # phase 9's analysis file
VOL_TILED = (4, 256)    # phase 9's tiled file: events, edge (8 tiles each)
VOL_CHECK = 48          # edge of the card-vs-CPU check
# phase 9's timed train steps: (batch, remat). Without remat batch 4 takes
# 56 GiB of the H100's 80 GB; block remat brings it to 24 GiB.
VOL_BATCHES = ((1, False), (2, False), (4, False), (4, "block"))

# kernel vs plain tolerances. bf16: one bf16 ulp of the output (<= 2^-7
# relative; both sides round the same f32 sum once) plus 1e-4 of the
# tensor's max-abs for f32 accumulation-order differences near zero; f16
# likewise with one f16 ulp (<= 2^-10 relative). f32 (TF32 off on both
# sides): 1e-4 of the max-abs.
BF16_REL, BF16_SLACK, F32_REL = 2.0 ** -7, 1e-4, 1e-4
F16_REL = 2.0 ** -10
# the f32 tensor-core kernel against a float64 conv of the same operands,
# relative to the max: true f32 and 3xTF32 read ~5e-7 at K = 9*C up to
# 4608, one TF32 product ~3e-4 (tests/test_torch_f32_split.py)
F64_REL = 1e-5
# whole forward, kernel vs cuDNN path, bf16: the two round at different
# places over ~60 convs (CPU estimate at 128^2: max softmax |d| 0.0056,
# argmax agreement 99.5% of charge pixels)
FWD_MAX_SOFTMAX_DIFF, FWD_MIN_AGREE = 0.05, 0.98
# the bf16 conv's f32 weight gradient vs the float64 product of the same
# bf16 operands, relative to its max: bf16 rounding would be ~4e-3
DW_REL = 1e-5
KERNELS_ONLY = False  # phases 1-3b alone (--kernels-only)
# kernel-name fragments of layout conversions (cuDNN's nchwToNhwc-style
# transposes, torch's permute copies)
LAYOUT_KERNELS = ("nchwtonhwc", "nhwctonchw", "transpose", "permute",
                  "ncdhw", "ndhwc")
# an H100 SXM's published peaks (NVIDIA data sheet, dense), for the bounds;
# BF16_PEAK is the bf16 and fp16 tensor-core rate; TF32 494.7 TFLOP/s dense
# (the data sheet's 989.4 is with sparsity)
HBM_BYTES_PER_S, BF16_PEAK, F32_PEAK = 3.35e12, 989e12, 67e12
TF32_PEAK = 494.7e12


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


def layout_line(cfg, tag):
    """Print the training layout a phase runs: ``pack``, ``pack_extra_h``,
    ``train.packed_loss``, the phases per logit of the train loss, the
    level-0 phases and the packed levels (models/packed.py)."""
    from uresnet_tpu_torch.models.packed import (_hpack_level, _packed_level,
                                                 loss_layout_phases)

    m = cfg.model
    levels = [lvl for lvl in range(m.depth) if m.pack and _packed_level(m, lvl)]
    lvl0 = ((2 ** m.dims) * (2 if _hpack_level(m, 0) else 1)) if 0 in levels else 1
    per_logit = loss_layout_phases(m) if cfg.train.packed_loss else 1
    print(f"[{tag}]{' ' * (8 - len(tag))}layout: pack {m.pack}, pack_extra_h "
          f"{m.pack_extra_h}, packed_loss {cfg.train.packed_loss}, phases per "
          f"logit {per_logit}; level 0 in {lvl0} phases, packed levels "
          f"{levels}", flush=True)


def check_close(got, want, dtype):
    """(max abs err, max err / max|want|); raises past the tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    if dtype in (torch.bfloat16, torch.float16):
        rel = BF16_REL if dtype == torch.bfloat16 else F16_REL
        bad = err > rel * want.abs() + BF16_SLACK * scale
    else:
        bad = err > F32_REL * scale
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} elements out of tolerance, "
                             f"max abs err {err.max().item():.3e}")
    return err.max().item(), err.max().item() / max(scale, 1e-30)


def bound(B, H, W, C, Co, res, dtype, tf32x3=False):
    """(least ms, what bounds it) for one fused conv on an H100: its bytes
    (x, w, scale, bias, residual read once, y written once) over HBM's rate
    against its FLOP over the peak rate of the units it runs on (bf16 and
    f16: tensor cores; f32: CUDA cores; f32 with ``tf32x3``: three TF32
    tensor-core products per term, 3 x FLOP at the TF32 peak)."""
    e = torch.tensor([], dtype=dtype).element_size()
    px = B * H * W
    nbytes = e * (px * C + 9 * C * Co + px * Co * (2 if res else 1)) + 8 * Co
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    flop = 18 * C * Co * px
    if e == 2:
        t_ops = flop / BF16_PEAK * 1e3
    else:
        t_ops = (3 * flop / TF32_PEAK if tf32x3 else flop / F32_PEAK) * 1e3
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


def conv_f64(x, w, scale, bias, r, relu=True):
    """The fused conv's function in float64 on the card (cuDNN's double
    conv): the yardstick that tells f32 accuracy from TF32's."""
    y = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    y = y * scale.double() + bias.double()
    if r is not None:
        y = y + r.double()
    return torch.relu(y) if relu else y


def rel_err(got, want):
    """max |got - want| / max |want|."""
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


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


# the channel-tail cases of phase 3 at 37x53, in every dtype: C or Co not
# a multiple of 16, and rows that are not 16-byte multiples (C or Co odd,
# or not a multiple of 8; f32: not of 4)
RAGGED_CASES = ((1, 16), (3, 5), (12, 16), (16, 4), (20, 36), (24, 40),
                (40, 24))
# each dtype's kernel counter (ops/cuda/conv2d.py kernel_for)
KERNEL_OF = {torch.bfloat16: "tensor_core", torch.float16: "f16_tensor_core",
             torch.float32: "f32_tensor_core"}


def kernel_phase(fused_mod, fold, serve, serve32, cfg, dev, card):
    """The three kernels vs the plain version, the f32 cases also vs
    float64; which kernel each case ran; the bf16 and f16 kernels' times at
    the 16-bit forward's shapes at batch 32. Returns the bf16 and f16
    kernels' records and the f32 tensor-core kernel's worst error."""
    calls = forward_calls(fold, serve, cfg, dev)
    shapes = sorted({k[:4] for k in calls}, key=lambda s: (-s[2], s[0]))
    shapes32 = sorted({k[:4] for k in forward_calls(fold, serve32, cfg, dev)},
                      key=lambda s: (-s[2], s[0]))
    print(f"[kernels] flagship forward: {sum(calls.values())} fused calls, "
          f"{len(shapes)} distinct (C, Co, H, W): {shapes}; the f32 forward's "
          f"{shapes32}", flush=True)
    operands = operand_maker(dev, SEED)

    def check_cases(cases, dtype, what):
        """Each case once, through the op, against the plain version (f32
        also against float64); all on ``dtype``'s kernel counter."""
        worst = 0.0
        counted(fused_mod, lambda: None)  # every count to 0
        for (C, Co, H, W), res, relu in cases:
            x, w, scale, bias, r = operands(1, H, W, C, Co, dtype, res)
            got = fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r,
                                                     relu=relu)
            want = fused_mod.fused_conv3x3_bn_relu_v2_reference(
                x, w, scale, bias, r, relu=relu)
            torch.cuda.synchronize()
            abs_err, rel = check_close(got, want, dtype)
            worst = max(worst, abs_err)
            f64 = ""
            if dtype == torch.float32:  # true f32: within F64_REL of float64
                ref = conv_f64(x, w, scale, bias, r, relu)
                e_k, e_p = rel_err(got, ref), rel_err(want, ref)
                if e_k > F64_REL:
                    raise AssertionError(f"{what} {C}->{Co} @{H}x{W}: "
                                         f"{e_k:.3e} of the max from float64 "
                                         f"(limit {F64_REL})")
                f64 = (f"; vs float64 {e_k:.3e} of the max (limit {F64_REL}; "
                       f"plain f32 {e_p:.3e})")
            print(f"[kernels] {what}: {C}->{Co} @{H}x{W} {str(dtype)[6:]} "
                  f"residual={res} relu={relu}: max abs err {abs_err:.3e}, "
                  f"rel {rel:.3e}{f64} ok", flush=True)
        counts = launch_counts(fused_mod)
        want = {k: 0 for k in counts}
        want["v2"] = want[KERNEL_OF[dtype]] = len(cases)
        if counts != want:
            raise AssertionError(f"{len(cases)} {what} cases launched {counts}, "
                                 f"not {want}")
        return worst

    variants = ((True, True), (False, True), (True, False))
    worst = {}
    for dtype in (torch.bfloat16, torch.float16):
        worst[dtype] = check_cases(
            [(s, res, relu) for s in shapes for res, relu in variants]
            + [((32, 48, 37, 53), True, True)],   # ragged H, W
            dtype, f"{KERNEL_OF[dtype]} flagship shapes")
    f32_worst = check_cases(
        [(s, res, relu) for s in shapes32 for res, relu in variants]
        # ragged H, W (tiles cut at the edges) at each channel tile: wgmma
        # at 64 and 32 (16x16-pixel tiles), mma.sync at 16 and 8 (8x32)
        + [((C, C, 37, 53), True, True) for C in (64, 32, 16, 8)]
        + [((32, 48, 37, 53), True, True),     # Co = 3 x 16
           ((24, 40, 37, 53), False, True)],   # Co = 5 x 8
        torch.float32, "f32_tensor_core flagship shapes")
    # the channel tails with residual and ReLU, and the first two without
    tails = ([((C, Co, 37, 53), True, True) for C, Co in RAGGED_CASES]
             + [((C, Co, 37, 53), False, False) for C, Co in RAGGED_CASES[:2]])
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        err = check_cases(tails, dtype, f"{KERNEL_OF[dtype]} channel tails")
        if dtype == torch.float32:
            f32_worst = max(f32_worst, err)
        else:
            worst[dtype] = max(worst[dtype], err)

    # at the main path's batch, per (shape, residual) as the forward calls
    # it; summed over one forward's calls
    B = cfg.data.batch_size
    recs = {}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        rows = []
        for (C, Co, H, W, res), n in sorted(calls.items(), key=lambda kv: -kv[0][2]):
            x, w, scale, bias, r = operands(B, H, W, C, Co, dtype, res)
            t_k = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2(
                x, w, scale, bias, r), inner=10)
            t_p = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2_reference(
                x, w, scale, bias, r), reps=3, inner=5)
            t_c = time_ms(lambda: cudnn_composition(x, w, bias, r), inner=10)
            abs_err, _ = check_close(  # also at the main path's exact shape
                fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r),
                fused_mod.fused_conv3x3_bn_relu_v2_reference(x, w, scale, bias, r),
                dtype)
            worst[dtype] = max(worst[dtype], abs_err)
            t_b, by = bound(B, H, W, C, Co, res, dtype)
            nbytes = 2 * B * H * W * (C + Co * (2 if res else 1))
            flop = 18 * C * Co * H * W * B
            print(f"[kernels] {name} B={B} {C}->{Co} @{H}x{W} residual={res} x{n}: "
                  f"max abs err {abs_err:.3e} ok; tensor-core kernel {t_k:.4f} ms "
                  f"({flop / t_k / 1e9:.1f} TFLOP/s, {nbytes / t_k / 1e6:.0f} "
                  f"GB/s), bound {t_b:.4f} ms ({by}; {t_b / t_k:.3f} of it), "
                  f"plain(f32) {t_p:.4f} ms, cudnn {name} {t_c:.4f} ms | {card}",
                  flush=True)
            rows.append((n, t_k, t_p, t_c, t_b, by))
        total = [sum(row[0] * row[i] for row in rows) for i in range(1, 5)]
        by_bytes = sum(row[0] * row[4] for row in rows if row[5] == "bytes")
        print(f"[kernels] {name} per forward ({sum(calls.values())} calls): "
              f"tensor-core kernel {total[0]:.3f} ms, bound {total[3]:.3f} ms "
              f"({by_bytes:.3f} of it bytes-bound; {total[3] / total[0]:.3f} of "
              f"it), plain(f32) {total[1]:.3f} ms, cudnn {name} composition "
              f"{total[2]:.3f} ms | {card}", flush=True)
        recs[dtype] = {"max_abs_err": worst[dtype], "ms": total[0],
                       "plain_ms": total[1], "bound_ms": total[3],
                       "bound_by": bound_by([(row[0], row[4], row[5]) for row in rows]),
                       "library_ms": total[2]}
    return recs[torch.bfloat16], recs[torch.float16], f32_worst


def f32_phase(fused_mod, fold, serve32, cfg, dev, card, worst):
    """The f32 tensor-core kernel at the shapes of the f32 forward (the
    flagship with compute_dtype float32), batch 32, per (shape, residual)
    as the forward calls it: checked against the plain version and timed
    beside the plain version and the cuDNN f32 composition (TF32 off), with
    both bounds: the CUDA cores' f32 and the tensor cores' 3xTF32. Summed
    over one forward's calls. Returns the kernel's record (its bound: the
    3xTF32 one, the smaller)."""
    calls = forward_calls(fold, serve32, cfg, dev)
    operands = operand_maker(dev, SEED + 4)
    B = cfg.data.batch_size
    names = ("f32 tensor-core kernel", "plain(f32)", "cudnn f32 composition",
             "3xTF32 bound", "CUDA-core f32 bound")
    total, parts = [0.0] * len(names), []
    for (C, Co, H, W, res), n in sorted(calls.items(), key=lambda kv: -kv[0][2]):
        x, w, scale, bias, r = operands(B, H, W, C, Co, torch.float32, res)
        fns = (lambda: fused_mod.fused_conv3x3_bn_relu_v2(x, w, scale, bias, r),
               lambda: fused_mod.fused_conv3x3_bn_relu_v2_reference(
                   x, w, scale, bias, r),
               lambda: cudnn_composition(x, w, bias, r))
        worst = max(worst, check_close(fns[0](), fns[1](), torch.float32)[0])
        t = [time_ms(fn, reps=3, warmup=1, inner=5) for fn in fns]
        t_b3, by = bound(B, H, W, C, Co, res, torch.float32, tf32x3=True)
        t_b1, _ = bound(B, H, W, C, Co, res, torch.float32)
        t += [t_b3, t_b1]
        parts.append((n, t_b3, by))
        flop = 18 * C * Co * H * W * B
        nbytes = 4 * B * H * W * (C + Co * (2 if res else 1))
        print(f"[kernels] f32 B={B} {C}->{Co} @{H}x{W} residual={res} x{n}: "
              f"ok; f32 tensor-core kernel {t[0]:.4f} ms ({flop / t[0] / 1e9:.1f} "
              f"f32 TFLOP/s, {nbytes / t[0] / 1e6:.0f} GB/s; {t_b3 / t[0]:.3f} of "
              f"the 3xTF32 bound {t_b3:.4f} ms, {by}), CUDA-core f32 bound "
              f"{t_b1:.4f} ms, plain(f32) {t[1]:.4f} ms, cudnn f32 {t[2]:.4f} ms "
              f"| {card}", flush=True)
        for i, v in enumerate(t):
            total[i] += n * v
    print(f"[kernels] f32 per forward ({sum(calls.values())} calls): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in zip(names, total))
          + f"; the f32 tensor-core kernel at {total[3] / total[0]:.3f} of the "
          f"3xTF32 bound | {card}", flush=True)
    return {"max_abs_err": worst, "ms": total[0], "plain_ms": total[1],
            "bound_ms": total[3], "bound_by": bound_by(parts),
            "library_ms": total[2]}


def ragged_phase(fused_mod, cfg, dev, card):
    """The channel-tail route, ragged channel counts through the op at
    batch 32, 256^2 (no model config has them: the forward sends only
    multiples of 16 to the op): one launch each with the counts from 0 --
    its run, on the tensor-core kernels' counters -- then held against the
    plain version and timed beside the cuDNN composition and the tensor
    cores' bound (f32: 3xTF32). Returns its record, summed over the two
    calls."""
    operands = operand_maker(dev, SEED + 2)
    B, cases = cfg.data.batch_size, ((24, 40, 256, 256, True, torch.bfloat16),
                                     (20, 36, 256, 256, False, torch.float32))
    ops = [operands(B, H, W, C, Co, dt, res) for C, Co, H, W, res, dt in cases]
    outs, counts, _ = counted(fused_mod, lambda: [
        fused_mod.fused_conv3x3_bn_relu_v2(*o) for o in ops])
    want = {k: 0 for k in counts}
    want["v2"] = len(cases)
    for *_, dt in cases:
        want[KERNEL_OF[dt]] += 1
    if counts != want:
        raise AssertionError(f"channel-tail run launched {counts}, not {want}")
    rec = {"launches": counts["v2"], "max_abs_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    parts = []
    for (C, Co, H, W, res, dt), o, got in zip(cases, ops, outs):
        abs_err, _ = check_close(
            got, fused_mod.fused_conv3x3_bn_relu_v2_reference(*o), dt)
        t_k = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2(*o), reps=3,
                      warmup=1, inner=5)
        t_p = time_ms(lambda: fused_mod.fused_conv3x3_bn_relu_v2_reference(*o),
                      reps=3, warmup=1, inner=5)
        t_c = time_ms(lambda: cudnn_composition(o[0], o[1], o[3], o[4]),
                      reps=3, warmup=1, inner=5)
        t_b, by = bound(B, H, W, C, Co, res, dt, tf32x3=dt == torch.float32)
        parts.append((1, t_b, by))
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
        for k, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_c),
                     ("bound_ms", t_b)):
            rec[k] += t
        print(f"[kernels] ragged B={B} {C}->{Co} @{H}x{W} {str(dt)[6:]} "
              f"residual={res}: {KERNEL_OF[dt]} kernel; max abs err "
              f"{abs_err:.3e} ok; kernel {t_k:.4f} ms, bound {t_b:.4f} ms "
              f"({by}; {t_b / t_k:.3f} of it), plain(f32) {t_p:.4f} ms, cudnn "
              f"{t_c:.4f} ms | {card}", flush=True)
    print(f"[kernels] ragged pair: kernels {rec['ms']:.4f} ms, cudnn "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_ms'] / rec['ms']:.3f} of it), launches {counts} | "
          f"{card}", flush=True)
    rec["bound_by"] = bound_by(parts)
    return rec


# phase 3b: train BN's kernels (ops/cuda/bn_train.py) at the shapes of the
# training steps' largest and smallest calls: (name, shape, phases,
# residual); every call on the main path has the ReLU
BN_CASES = (("2D level 0", (32, 128, 256, 128), 8, True),
            ("3D level 0", (1, 96, 96, 96, 128), 8, False),
            ("2D deepest", (32, 16, 16, 512), 1, True))
BN_KERNELS = ("stats", "apply", "grad_reduce", "grad_input")
# kernel vs plain on the same operands. The sums (stats, grad_reduce) add
# ~8.4 M terms a channel in another order: within BN_SUM_REL of their max,
# beyond what ReLU masks recomputed from x may account for (`bn_flip_slack`).
# The elementwise outputs: check_close's bounds, but at most BN_FLIPS of
# the elements outside them (such a mask flips an element's gradient).
BN_SUM_REL, BN_FLIPS = 1e-5, 1e-6
def graph_ms(fn, inner=20, reps=5) -> float:
    """Device ms of one call of ``fn``: a CUDA graph of ``inner`` calls,
    replayed, so the host's launch cost is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    t = time_ms(graph.replay, reps=reps, warmup=1) / inner
    del graph
    return t


def bn_launches(mod):
    return {k: getattr(mod, f"launches_bn_train_{k}") for k in BN_KERNELS}


def bn_check(name, got, want, dtype, n):
    """check_close for an elementwise output, but allowing BN_FLIPS of the
    elements past the tolerance; (max err / max|want|, elements past it)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    scale = max(want.abs().max().item(), 1e-30)
    rel = {torch.bfloat16: BF16_REL, torch.float16: F16_REL}.get(dtype)
    if rel is None:
        bad = int((err > F32_REL * scale).sum())
    else:
        bad = int((err > rel * want.abs() + BF16_SLACK * scale).sum())
    if bad > max(1, BN_FLIPS * n):
        raise AssertionError(f"{name}: {bad} elements out of tolerance, max "
                             f"abs err {err.max().item():.3e}")
    return err.max().item() / scale, bad


def bn_sum_check(name, got, want, slack=0.0):
    """Sums within BN_SUM_REL of their max, beyond ``slack`` (per sum)."""
    err = ((got.double() - want.double()).abs() - slack).clamp_min(0)
    rel = (err.max() / want.double().abs().max().clamp_min(1e-30)).item()
    if not rel <= BN_SUM_REL:
        raise AssertionError(f"{name}: sums {rel:.3e} of the max from the "
                             f"plain version (limit {BN_SUM_REL})")
    return rel


def bn_flip_slack(dout, x, mean, rstd, scale, bias):
    """What the gradient sums may differ by where the ReLU mask is
    recomputed from x: the kernel rounds x * g + b once (fma), the plain
    version twice, so an element whose value lies within 2^-20 of its
    terms' size may fall on either side of 0. Per sum: the elements'
    |dy|, and |dy * xhat|."""
    C = mean.shape[0]
    xs = x.to(mean.dtype).view(-1, C)
    g = scale * rstd
    b = bias - mean * g
    near = ((xs * g + b).abs() <= 2.0 ** -20 * ((xs * g).abs() + b.abs()))
    d = dout.to(mean.dtype).view(-1, C).abs() * near
    return torch.cat([d.sum(0), (d * ((xs - mean) * rstd).abs()).sum(0)])


def bn_zero():
    """Set the four train-BN launch counters to 0."""
    from uresnet_tpu_torch.ops.cuda import bn_train

    for k in BN_KERNELS:
        setattr(bn_train, f"launches_bn_train_{k}", 0)


def bn_main_path(model, steps, tag, card) -> int:
    """The four kernels' launches since `bn_zero`, over ``steps`` train
    steps of the main path: each kernel once per BatchNorm module of the
    model a step, so no train BN ran unfused. Returns their sum."""
    from uresnet_tpu_torch.models.blocks import BatchNorm
    from uresnet_tpu_torch.ops.cuda import bn_train

    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    got = bn_launches(bn_train)
    if got != dict.fromkeys(BN_KERNELS, n_bn * steps):
        raise AssertionError(f"{tag}: train BN launches {got} over {steps} "
                             f"steps, not {n_bn} of each a step")
    print(f"[bn]      {tag}: {n_bn} BatchNorm modules, launches over "
          f"{steps} timed steps {got} = {n_bn} of each kernel a step | "
          f"{card}", flush=True)
    return sum(got.values())


def bn_phase(dev, card):
    """Phase 3b: train BN's four kernels against their plain versions on
    the card, forward and every gradient, in bf16, f16 and f32 (f64 at the
    smallest shape), at BN_CASES; the launch counters; each kernel's time
    in bf16 beside its bound (bytes: each operand read once, each output
    written once, at 3.35 TB/s), the plain versions' and the library's
    (F.batch_norm(training=True) + residual + ReLU, forward and backward:
    a yardstick only); a kernel's time is a CUDA graph's replay, its eager
    time a call (the host's launch cost, where it is the longer) beside it.
    Returns the record of the kernels row; its ``launches`` are counted on
    the main path's train steps (phases 7 and 9, `bn_main_path`)."""
    from uresnet_tpu_torch.ops.cuda import bn_train as bn

    t0 = time.time()
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    rec = {"launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "library_ms": 0.0, "bound_by": "bytes"}
    for name, shape, P, res in BN_CASES:
        dtypes = (torch.bfloat16, torch.float16, torch.float32)
        if name == "2D deepest":
            dtypes += (torch.float64,)
        for dt in dtypes:
            sd = bn.stats_dtype(dt)
            W = shape[-1]
            C = W // P
            rows = int(np.prod(shape[:-1]))
            n = rows * W

            def rnd(*s, dtype=dt):
                return torch.randn(*s, generator=g, device=dev).to(dtype)

            x = (rnd(rows, W, dtype=torch.float32) * 1.5 + 0.3).to(dt)
            r = rnd(rows, W) if res else None
            dout = rnd(rows, W)
            scale = torch.rand(C, generator=g, device=dev).to(sd) + 0.5
            bias = rnd(C, dtype=sd) * 0.1
            run = (rnd(C, dtype=sd), torch.rand(C, generator=g,
                                                device=dev).to(sd) + 0.5)
            before = bn_launches(bn)
            sums = bn.bn_train_stats(x, C, 1e-3, *run, 0.99)
            errs = [bn_sum_check("stats", sums[:2 * C + 1],
                                 bn.bn_train_stats_reference(
                                     x, C, 1e-3, *run, 0.99)[:2 * C + 1])]
            # the kernel's moments and running stats, from its sums, as
            # torch takes them
            mean, var, rstd = sums[2 * C + 1:5 * C + 1].view(3, C).unbind()
            errs.append(bn_sum_check("stats' moments", sums[2 * C + 1:],
                                     torch.cat([*bn.moments(sums, C, 1e-3),
                                                bn.running(run[0], mean, 0.99),
                                                bn.running(run[1], var, 0.99)])))
            count = sums[2 * C:2 * C + 1]
            vecs = (mean, rstd, scale, bias)
            out = bn.bn_train_apply(x, r, *vecs, relu=True)
            want = bn.bn_train_apply_reference(x, r, *vecs, True)
            e, flips = bn_check("apply", out, want, dt, n)
            errs.append(e)
            mask = out if res else None
            red = bn.bn_train_grad_reduce(dout, x, mask, *vecs, relu=True)
            errs.append(bn_sum_check(
                "grad_reduce", red, bn.bn_train_grad_reduce_reference(
                    dout, x, mask, *vecs, True),
                0.0 if res else bn_flip_slack(dout, x, *vecs)))
            dx, dres = bn.bn_train_grad_input(dout, x, mask, *vecs, red,
                                              count, relu=True, residual=res)
            wdx, wdres = bn.bn_train_grad_input_reference(
                dout, x, mask, *vecs, red, count, True, res)
            e, f2 = bn_check("grad_input dx", dx, wdx, dt, n)
            errs.append(e)
            flips += f2
            if res:
                e, f3 = bn_check("grad_input dres", dres, wdres, dt, n)
                errs.append(e)
                flips += f3
            torch.cuda.synchronize()
            counts = {k: v - before[k] for k, v in bn_launches(bn).items()}
            if counts != dict.fromkeys(BN_KERNELS, 1):
                raise AssertionError(f"bn {name} {dt}: launches {counts}")
            rec["max_abs_err"] = max(rec["max_abs_err"], max(errs))
            line = (f"[bn]      {name} {tuple(shape)} {P} phases of {C} "
                    f"{str(dt)[6:]}, relu{' + residual' if res else ''}: "
                    f"kernel vs plain, of the max: stats {errs[0]:.2e} "
                    f"(moments {errs[1]:.2e}), apply {errs[2]:.2e}, grad "
                    f"sums {errs[3]:.2e}, dx {errs[4]:.2e}"
                    + (f", dres {errs[5]:.2e}" if res else "")
                    + f"; {flips} elements past the ulp bound")
            if dt != torch.bfloat16:
                print(line + f" | {card}", flush=True)
                continue
            # times (bf16, the training dtype): each kernel alone; the
            # plain versions and the library, forward and backward
            e = x.element_size()
            act, vb = n * e, 4 * C
            least = {"stats": act + 9 * vb + 4,
                     "apply": act * (2 + res) + 4 * vb,
                     "grad_reduce": act * (2 + res) + 6 * vb,
                     "grad_input": act * (3 + 2 * res) + 6 * vb + 4}
            calls = {
                "stats": lambda: bn.bn_train_stats(x, C, 1e-3, *run, 0.99),
                "apply": lambda: bn.bn_train_apply(x, r, *vecs, relu=True),
                "grad_reduce": lambda: bn.bn_train_grad_reduce(
                    dout, x, mask, *vecs, relu=True),
                "grad_input": lambda: bn.bn_train_grad_input(
                    dout, x, mask, *vecs, red, count, relu=True,
                    residual=res)}
            parts, t_four = [], 0.0
            for k in BN_KERNELS:
                t = graph_ms(calls[k])
                t_eager = time_ms(calls[k], reps=5, warmup=2, inner=10)
                b = least[k] / HBM_BYTES_PER_S * 1e3
                parts.append(f"{k} {t:.4f} ms (bound {b:.4f}, "
                             f"{100 * b / t:.1f}%, {least[k] / t / 1e6:.0f} GB/s;"
                             f" eager {t_eager:.4f} ms a call)")
                t_four += t
                rec["ms"] += t
                rec["bound_ms"] += b

            def plain():
                s_ = bn.bn_train_stats_reference(x, C, 1e-3, *run, 0.99)
                m_, _, q_ = s_[2 * C + 1:5 * C + 1].view(3, C).unbind()
                o_ = bn.bn_train_apply_reference(x, r, m_, q_, scale, bias,
                                                 True)
                v_ = (m_, q_, scale, bias)
                k_ = o_ if res else None
                red_ = bn.bn_train_grad_reduce_reference(dout, x, k_, *v_, True)
                bn.bn_train_grad_input_reference(dout, x, k_, *v_, red_,
                                                 s_[2 * C:2 * C + 1], True, res)

            xl = x.view(-1, C).detach().requires_grad_()
            rl = r.view(-1, C) if res else None
            w_, b_ = scale.clone().requires_grad_(), bias.clone().requires_grad_()

            def library():
                y = torch.nn.functional.batch_norm(xl, None, None, w_, b_,
                                                   training=True, eps=1e-3)
                if rl is not None:
                    y = y + rl
                torch.autograd.grad(torch.relu(y), (xl, w_, b_),
                                    dout.view(-1, C))

            t_plain = time_ms(plain, reps=3, warmup=1)
            t_lib = time_ms(library, reps=3, warmup=1)
            rec["plain_ms"] += t_plain
            rec["library_ms"] += t_lib
            print(line + f"; {'; '.join(parts)}; the four {t_four:.4f}"
                  f" ms, plain {t_plain:.4f} ms, library "
                  f"(F.batch_norm + relu, fwd + bwd) {t_lib:.4f} ms | {card}",
                  flush=True)
            del xl, rl, w_, b_
        torch.cuda.empty_cache()
    print(f"[bn]      phase 3b wall {time.time() - t0:.1f} s | {card}",
          flush=True)
    return rec


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
                     append=False, top=8):
    """torch.profiler over ``reps`` calls of each fn (``fn(x)``), after
    ``warmup``. Per call (``unit``): host wall time, device busy time (the
    union of the card's kernel and copy intervals) and its idle share of
    that wall, peak memory, the ``top`` kernels that take the most device
    time, and every layout-conversion kernel (an NCHW/NHWC transpose that
    cuDNN or torch inserts). The full tables go to ``path`` (appended with
    ``append``). Returns {name: {kernel: ms per call}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tables, per_fn = [card], {}
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
        per_fn[name] = {k: us / 1e3 / reps for k, us in per_kernel.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[profile] {name}: wall {wall_ms:.3f} ms/{unit}, device busy "
              f"{busy_ms:.3f} ms/{unit}, idle share {1 - busy_ms / wall_ms:.4f}, "
              f"peak memory {peak:.3f} GiB | {card}", flush=True)
        for kname, us in per_kernel.most_common(top):
            print(f"[profile]   {us / 1e3 / reps:9.3f} ms/{unit}  {kname[:90]}",
                  flush=True)
        layout = [(k, us) for k, us in per_kernel.most_common()
                  if any(p in k.lower() for p in LAYOUT_KERNELS)]
        print(f"[profile]   layout-conversion kernels: "
              f"{len(layout)} distinct, {sum(us for _, us in layout) / 1e3 / reps:.3f} "
              f"ms/{unit}", flush=True)
        for kname, us in layout[:6]:
            print(f"[profile]     {us / 1e3 / reps:9.3f} ms/{unit}  {kname[:110]}",
                  flush=True)
        tables += [f"== {name}: wall {wall_ms:.3f} ms/{unit}, device busy "
                   f"{busy_ms:.3f} ms/{unit}, peak memory {peak:.3f} GiB",
                   prof.key_averages().table(sort_by="self_device_time_total",
                                             row_limit=25)]
    with open(path, "a" if append else "w") as f:
        f.write("\n".join(tables) + "\n")
    print(f"[profile] tables written to {path}", flush=True)
    return per_fn


def run_main(cli, argv, tag):
    """A CLI's or tool's main with its stdout echoed under ``tag``; raises
    if it exits non-zero, else returns its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("".join(f"[{tag}]{' ' * max(8 - len(tag), 1)}{line}\n"
                  for line in out.splitlines()), end="")
    if rc != 0:
        raise RuntimeError(f"{cli.__name__} exited {rc}")
    return out


def run_cli(cli, argv, tag="serve"):
    """`run_main`, returning the dict of the last line (cli.infer: the
    metrics; cli.train: the final summary)."""
    out = run_main(cli, argv, tag)
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


def launch_counts(fused_mod):
    """{'v2': the v2 entry point's launches, kernel: its launches}."""
    return {"v2": fused_mod.launches,
            **{k: getattr(fused_mod, f"launches_{k}") for k in KERNEL_OF.values()}}


def counted(fused_mod, fn):
    """``fn()`` with every launch counter set to 0 just before and read just
    after. Returns (its result, the counts, wall s)."""
    fused_mod.launches = fused_mod.launches_v1 = 0
    for k in KERNEL_OF.values():
        setattr(fused_mod, f"launches_{k}", 0)
    t0 = time.time()
    result = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return result, launch_counts(fused_mod), wall


def expect_launches(counts, n_batches, kernel="tensor_core", per_batch=44):
    """The entry point ``launches`` and the kernel named by ``kernel``
    ('tensor_core', 'f16_tensor_core' or 'f32_tensor_core') counted
    ``per_batch`` per batch, the other kernels none."""
    n = per_batch * n_batches
    want = {"v2": n, **{k: 0 for k in KERNEL_OF.values()}}
    want[kernel] = n
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != {want}")


def serve_counted(fused_mod, infer, argv, out, n_events, num_class, kernel,
                  per_batch=44, batch_events=32):
    """cli.infer, counted (`counted`, `expect_launches`). Returns (npz, its
    metrics, the counts, wall s)."""
    stats, counts, wall = counted(
        fused_mod, lambda: run_cli(infer, argv + ["--output", out]))
    expect_launches(counts, -(-n_events // batch_events), kernel, per_batch)
    return check_export(out, stats, n_events, num_class), stats, counts, wall


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


def identical(z, zx, what):
    """Two exports of the same forward over the same pixels: every column
    bit-equal."""
    for k in ("event_id", "plane_id", "coords", "label", "scores", "pred"):
        if not np.array_equal(z[k], zx[k]):
            raise AssertionError(f"{what}: export column {k} differs")


def train_phase(cfg_path, cfg, fused_mod, card, dev):
    """Phase 7: cli.train at the flagship width, its checkpoint, serving
    from it, the step's time, memory, train-BN launches and profile."""
    from uresnet_tpu_torch import generate_file, load_config
    from uresnet_tpu_torch.cli import infer, train
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.models.convert import flatten_tree, jax_train_state

    layout_line(cfg, "train")
    S = cfg.data.image_size
    planes = tuple(cfg.data.planes)
    t0 = time.time()
    train_file = generate_file(os.path.join(WORK, "train.usef"), TRAIN_EVENTS,
                               seed=SEED + 1, shape=(S, S), planes=planes)
    ckpt_dir, log_dir = os.path.join(WORK, "train_ckpt"), os.path.join(WORK, "train_log")
    overrides = [f"data.input_files={train_file}", "data.synthetic=false",
                 "train.summary_iter=10", "train.checkpoint_iter=0",
                 f"train.val_iter={TRAIN_STEPS}", "train.val_exact=true",
                 f"train.checkpoint_dir={ckpt_dir}", f"train.log_dir={log_dir}"]
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
    # the exactly-once validation: the held-out file (the training file
    # here) counted once
    with open(os.path.join(log_dir, "val_metrics.jsonl")) as f:
        val = [json.loads(line) for line in f]
    if ([v["step"] for v in val] != [TRAIN_STEPS]
            or val[0]["n_events"] != TRAIN_EVENTS
            or val[0]["n_pixels"] != TRAIN_EVENTS * S * S
            or not np.isfinite(val[0]["loss"])):
        raise AssertionError(f"val_exact validation {val}")
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
    # the validation's own time, from the two logs' clocks: the val row is
    # written when it ends, the last train row just before it starts
    val_s = val[0]["wall_s"] - rows[-1]["wall_s"]
    print(f"[train]   {TRAIN_STEPS} steps in {wall - val_s:.2f} s wall (incl. "
          f"data generation, loader start, first-step setup; without the "
          f"val_exact validation, {val_s:.2f} s by the logs' wall_s); losses "
          f"{[round(r['loss'], 4) for r in rows]} finite; checkpoint holds the "
          f"{len(keys)} leaves of the JAX layout and restores at step {step}, "
          f"data cursor {cursor}; val_exact validation at step "
          f"{val[0]['step']}: n_events {val[0]['n_events']:.0f}, miou "
          f"{val[0]['miou']:.6f}, loss {val[0]['loss']:.6f}", flush=True)

    # serve from the trained checkpoint
    n_serve = cfg.data.batch_size // len(planes)
    events = generate_file(os.path.join(WORK, "serve32.usef"), n_serve,
                           seed=SEED + 2, shape=(S, S), planes=planes)
    out = os.path.join(WORK, "scores_trained.npz")
    _, _, counts, _ = serve_counted(
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
    # the earlier phases' cached blocks go back to the card first, as
    # phase 9 does before its steps: held, they leave the allocator too
    # little room for the step's, and its frees and mallocs stall it
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bn_zero()
    # steps back to back, as a training loop (and the bench tool) runs
    # them: the host queues each while the card runs the one before
    t_step = time_ms(step, reps=5, warmup=3, inner=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(step()["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss} in the timed steps")
    launches = bn_main_path(state[0].model, 3 + 5 * 5 + 1,
                            f"B={B} {S}^2 train_step_light", card)
    print(f"[train]   B={B} {S}^2 bf16 train_step_light (sparse batch, densify "
          f"on device; 5 steps queued): {t_step:.2f} ms/step = "
          f"{B / t_step * 1e3:.1f} img/s, peak memory {peak:.3f} GiB | "
          f"{card}", flush=True)
    layer_times(tr, state[0], batch, card)
    profile_forwards({"train step": step}, None,
                     os.path.join(WORK, "profile.txt"), card, unit="step",
                     append=True)
    return t_step, peak, launches


def layer_times(tr, ts, batch, card, reps=5, tag="train"):
    """The train step's layers timed apart with CUDA events (median of
    ``reps`` after one warm-up): densify, forward, loss, backward,
    optimizer, in the trainer's layout (packed with ``model.pack``; the
    packed loss's targets scattered packed). The update is computed and
    dropped. Returns the medians."""
    from uresnet_tpu_torch.engine.losses import weighted_softmax_xent
    from uresnet_tpu_torch.engine.optim import adam_update

    names = ("densify", "forward", "loss", "backward", "optimizer")
    params = dict(ts.model.named_parameters())
    trainable = [k for k, p in params.items() if p.requires_grad]
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        ph = tr._loss_phases
        dense = tr._prepare(batch, packed_targets=ph > 1)
        ev[1].record()
        with torch.enable_grad():
            logits, _ = ts.model(dense["data"], train=True,
                                 packed_logits=ph > 1)
            if ph > 1:
                logits = logits.reshape(logits.shape[:-1]
                                        + (ph, tr.cfg.model.num_class))
            ev[2].record()
            label, weight, _ = tr._targets(dense, logits)
            loss = weighted_softmax_xent(logits, label, weight)
            ev[3].record()
            grads = torch.autograd.grad(loss, [params[k] for k in trainable])
        ev[4].record()
        adam_update(dict(zip(trainable, grads)), ts.opt,
                    {k: p.detach() for k, p in params.items()}, tr.cfg.optim)
        ev[5].record()
        ev[5].synchronize()
        rows.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    med = np.median(np.array(rows[1:]), axis=0)
    print("[%s]%slayers, ms/step (median of %d): %s; sum %.2f | %s" % (
        tag, " " * (8 - len(tag)), reps,
        ", ".join(f"{n} {t:.2f}" for n, t in zip(names, med)), med.sum(),
        card), flush=True)
    return dict(zip(names, med))


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


def ana_state(cfg_path, ckpt, dev, overrides=()):
    """The trainer and state ``cli.infer`` builds: the config, a Trainer on
    ``dev`` and the checkpoint's params and BN state."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.engine.checkpoint import load_serving_state
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.models.convert import load_jax_params

    tr = Trainer(load_config(cfg_path, list(overrides)), device=dev)
    ts = tr.init_state()
    load_jax_params(ts.model, *load_serving_state(ckpt)[:2])
    return tr, ts


def check_usef(path, src, z, cfg):
    """The USEF writeback of ``src`` against the npz export ``z`` of the
    same events: per input plane p the planes p*num_class+cls, at the
    in-window points in detector coords (file order), labels the argmax,
    values equal to the npz scores at the exported pixels (npz coords are
    window coords: the host window, equal to the device's, maps them)."""
    from uresnet_tpu_torch.data import events as ev
    from uresnet_tpu_torch.data.pipeline import crop_or_pad_coords
    from uresnet_tpu_torch.engine.evaluator import score_plane_id

    S, C = cfg.data.image_size, cfg.model.num_class
    back, inputs = ev.read_events(path), ev.read_events(src)
    if len(back) != len(inputs):
        raise AssertionError(f"usef: {len(back)} events != {len(inputs)}")
    hits = 0
    for eidx, (eo, ei) in enumerate(zip(back, inputs)):
        by_id = {p.plane_id: p for p in eo.planes}
        want_ids = {score_plane_id(pid, c, C) for pid in cfg.data.planes
                    for c in range(C)}
        if set(by_id) != want_ids:
            raise AssertionError(f"usef event {eidx}: plane ids {sorted(by_id)}")
        for pin in ei.planes:
            if pin.plane_id not in cfg.data.planes:
                continue
            cls = [by_id[score_plane_id(pin.plane_id, c, C)] for c in range(C)]
            shifted, inwin = crop_or_pad_coords(pin.coords, pin.shape, S,
                                                values=pin.values)
            sc = np.stack([p.values for p in cls], 1)
            if (any(not np.array_equal(p.coords, pin.coords[inwin]) for p in cls)
                    or any(tuple(p.shape) != tuple(pin.shape) for p in cls)
                    or not np.array_equal(cls[0].labels, sc.argmax(1))):
                raise AssertionError(f"usef event {eidx} plane {pin.plane_id}: "
                                     f"coords, shape or labels wrong")
            origin = (pin.coords[inwin][0] - shifted[inwin][0]) if inwin.any() else 0
            at = dict(zip(map(tuple, pin.coords[inwin].tolist()), sc))
            sel = (z["event_id"] == eidx) & (z["plane_id"] == pin.plane_id)
            for c, s in zip((z["coords"][sel] + origin).tolist(), z["scores"][sel]):
                if not np.array_equal(at[tuple(c)], s):
                    raise AssertionError(f"usef event {eidx}: scores at {c} "
                                         f"{at[tuple(c)]} != npz {s}")
                hits += 1
    if hits != len(z["scores"]):
        raise AssertionError(f"usef holds {hits} of {len(z['scores'])} npz pixels")
    return hits


def ana_phase(cfg_path, cfg, ckpt, events, fused_mod, card, dev):
    """Phase 8: the analysis surface at the flagship width (see the module
    docstring)."""
    from uresnet_tpu_torch import generate_file
    from uresnet_tpu_torch.cli import infer
    from uresnet_tpu_torch.data import events as ev
    from uresnet_tpu_torch.data.loader import make_batch_loader
    from uresnet_tpu_torch.engine import evaluator
    from uresnet_tpu_torch.engine.export import build_logits_fn

    S, C = cfg.data.image_size, cfg.model.num_class
    planes = tuple(cfg.data.planes)
    be = cfg.data.batch_size // len(planes)
    argv = [cfg_path, "--checkpoint", ckpt, "--input", events, "--device", DEVICE]
    out = {m: os.path.join(WORK, f"ana_{m}.npz") for m in ("sparse", "dense", "host")}

    # 8a. the three exports and the USEF writeback, each counted
    z, st, cnt = {}, {}, {}
    for mode, extra in (("sparse", []), ("dense", ["--export", "dense"])):
        z[mode], st[mode], cnt[mode], _ = serve_counted(
            fused_mod, infer, argv + extra, out[mode], N_EVENTS, C,
            "tensor_core", batch_events=be)
    tr, ts = ana_state(cfg_path, ckpt, dev)
    st["host"], cnt["host"], _ = counted(fused_mod, lambda: evaluator.run_inference(
        tr, ts, events, out["host"], streamed=False))
    expect_launches(cnt["host"], -(-N_EVENTS // be))
    z["host"] = check_export(out["host"], st["host"], N_EVENTS, C)
    usef = os.path.join(WORK, "ana_scores.usef")
    _, cnt["usef"], _ = counted(fused_mod, lambda: run_cli(
        infer, argv + ["--format", "usef", "--output", usef], tag="ana"))
    expect_launches(cnt["usef"], -(-N_EVENTS // be))
    for m in ("dense", "host"):
        identical(z[m], z["sparse"], f"{m} vs sparse export")
    hits = check_usef(usef, events, z["sparse"], cfg)
    print(f"[ana]     {N_EVENTS} events: sparse, dense, host exports of "
          f"{len(z['sparse']['scores'])} charge pixels bit-equal in every "
          f"column (scores and pred included); usef writeback "
          f"holds the npz scores at all {hits} pixels; kernel launches "
          f"{ {m: c['tensor_core'] for m, c in cnt.items()} } (= 44 per batch, "
          f"no other kernel's launch)", flush=True)

    # 8b. the exactly-once gate on the same file: the sparse pass's counts
    m, counts, _ = counted(fused_mod, lambda: run_cli(
        infer, argv + ["--metrics-only"], tag="ana"))
    expect_launches(counts, -(-N_EVENTS // be))
    if (m["n_events"] != N_EVENTS or m["n_pixels"] != N_EVENTS * S * S
            or abs(m["miou"] - st["sparse"]["miou"]) > 1e-9):
        raise AssertionError(f"--metrics-only {m} vs the sparse pass's miou "
                             f"{st['sparse']['miou']}")
    print(f"[ana]     --metrics-only: n_events {m['n_events']:.0f}, n_pixels "
          f"{m['n_pixels']:.0f}, miou {m['miou']!r} (sparse pass "
          f"{st['sparse']['miou']!r}), loss {m['loss']:.6f}; launches {counts}",
          flush=True)

    # 8c. full coverage of events larger than one window
    big = generate_file(os.path.join(WORK, "ana_1024.usef"), 16, seed=SEED + 5,
                        shape=(2 * S, 2 * S), planes=planes)
    tiled = os.path.join(WORK, "ana_tiled.usef")
    mt, counts, wall = counted(fused_mod, lambda: run_cli(
        infer, [cfg_path, "--checkpoint", ckpt, "--input", big, "--tiled",
                "--format", "usef", "--output", tiled, "--device", DEVICE],
        tag="ana"))
    expect_launches(counts, -(-int(mt["n_tiles"]) // cfg.data.batch_size))
    n_pts = n_scored = 0
    for eo, ei in zip(ev.read_events(tiled), ev.read_events(big)):
        by_id = {p.plane_id: p for p in eo.planes}
        for pin in ei.planes:
            sc = np.stack([by_id[pin.plane_id * C + c].values for c in range(C)], 1)
            if (not np.array_equal(by_id[pin.plane_id * C].coords, pin.coords)
                    or not np.isfinite(sc).all()):
                raise AssertionError("tiled: a point is missing or not scored")
            n_pts += len(pin.values)
            n_scored += len(sc)
    if n_scored != n_pts or n_pts == 0:
        raise AssertionError(f"tiled: {n_scored} of {n_pts} points scored")
    print(f"[ana]     --tiled: 16 events of {2 * S}^2, {int(mt['n_tiles'])} "
          f"tiles, all {n_pts} charge points scored (finite, file order); "
          f"launches {counts} (= 44 per {cfg.data.batch_size} tile rows); "
          f"{wall:.2f} s wall", flush=True)

    # 8d. wall times of the passes over ANA_EVENTS events
    n_time = ANA_EVENTS
    ana128 = generate_file(os.path.join(WORK, "ana_128.usef"), n_time,
                           seed=SEED + 6, shape=(S, S), planes=planes)
    o = os.path.join(WORK, "ana_timed.npz")
    walls = {}
    # the two readback groups in turns (K 1, 4, 4, 1) within each mode
    for name, kw in [("sparse", dict(readback_group=k)) for k in (1, 4, 4, 1)] + [
            ("dense", dict(export="dense", readback_group=k)) for k in (1, 4, 4, 1)] + [
            ("host", dict(streamed=False)), ("tiled", dict(tiled=True))]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluator.run_inference(tr, ts, ana128, o, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        key = name + (f" K={kw['readback_group']}" if "readback_group" in kw else "")
        walls.setdefault(key, []).append(wall)
        print(f"[ana]     {key}: {n_time} events in {wall:.3f} s = "
              f"{n_time / wall:.1f} events/s (run_inference, {n_time // be} "
              f"batches of {be}) | {card}", flush=True)
    # where the host's time goes in the default pass: the main thread's
    # profile (the loader's decode threads are not in it)
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    evaluator.run_inference(tr, ts, ana128, o, readback_group=4)
    torch.cuda.synchronize()
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(12)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if ln.lstrip().startswith("ncalls"))
    print("[ana]     main-thread profile of the sparse K=4 pass, by own time:",
          flush=True)
    for ln in lines[start - 1:start + 13]:
        print(f"[ana]       {ln.strip()[:150]}", flush=True)

    # the device time of one batch's steps and readbacks, CUDA events
    dcfg = dataclasses.replace(
        cfg.data, input_files=(ana128,), synthetic=False, random_access=False,
        weight_mode="ones", transfer="sparse",
        max_points=max(cfg.data.max_points, -(-ev.max_plane_points(ana128, planes) // 256) * 256))
    loader = make_batch_loader(dcfg, num_class=C, train=False)
    try:
        host = loader.next()
    finally:
        loader.stop()
        if hasattr(loader, "close"):
            loader.close()
    host.pop("cursor", None)
    batch = tr.device_batch(host)
    logits_fn = build_logits_fn(tr.cfg, ts.model)
    sparse = dict(batch, row_valid=torch.ones(cfg.data.batch_size, device=dev))
    t_sparse = time_ms(lambda: evaluator._ana_step_sparse(tr.cfg, logits_fn, sparse), reps=7)
    t_dense = time_ms(lambda: evaluator._ana_step(tr.cfg, logits_fn, batch), reps=7)
    t_fwd = time_ms(lambda: logits_fn(evaluator._densify_ones(tr.cfg, batch)["data"]), reps=7)
    outs = {"sparse": evaluator._ana_step_sparse(tr.cfg, logits_fn, sparse),
            "dense": evaluator._ana_step(tr.cfg, logits_fn, batch)}
    rb = {k: time_ms(lambda: evaluator._readback(v), reps=7) for k, v in outs.items()}
    mb = {k: sum(t.numel() * t.element_size() for t in v.values()) / 1e6
          for k, v in outs.items()}
    print(f"[ana]     device per batch of {cfg.data.batch_size} (median of 7): "
          f"sparse step {t_sparse:.3f} ms (densify + forward {t_fwd:.3f}, then "
          f"softmax, gather, counts), dense step {t_dense:.3f} ms; readback "
          f"sparse {mb['sparse']:.2f} MB {rb['sparse']:.3f} ms, dense "
          f"{mb['dense']:.2f} MB {rb['dense']:.3f} ms | {card}", flush=True)
    n_b = n_time // be
    for key, ws in walls.items():
        wall = float(np.median(ws))
        dev_ms = t_dense if key.startswith(("dense", "host")) else t_sparse
        print(f"[ana]     {key}: device steps {n_b * dev_ms:.1f} ms of "
              f"{wall * 1e3:.1f} ms wall (median of {len(ws)}; share "
              f"{n_b * dev_ms / (wall * 1e3):.3f}); the rest is host work",
              flush=True)


def vol_card_vs_cpu(cfg, card, dev):
    """Phase 9a: a seeded config-4 model of full width and depth, f32 (TF32
    off), carried to the card: its eval forward and its BN-folded serving
    forward there equal the CPU's within 1e-4 of the max at VOL_CHECK^3,
    batch 1. Also whether F.pad keeps a channels_last_3d tensor
    channels-last on the card (the stride-2 convs' asymmetric pad)."""
    import torch.nn.functional as F

    from uresnet_tpu_torch.engine.export import build_logits_fn
    from uresnet_tpu_torch.models.convert import jax_params, load_jax_params
    from uresnet_tpu_torch.models.uresnet import UResNet

    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    g = torch.Generator().manual_seed(SEED + 9)
    cpu_model = UResNet(cfg32.model, generator=g)
    randomize_bn(cpu_model, g)
    card_model = UResNet(cfg32.model, generator=torch.Generator(), device=dev)
    load_jax_params(card_model, *jax_params(cpu_model))
    S = VOL_CHECK
    x = torch.rand(1, S, S, S, 1, generator=g)
    x = x * (x > 0.9)
    worst = {}
    with torch.no_grad():
        for name, fn in (("eval forward", lambda m, v: m(v)[0]),
                         ("folded forward", lambda m, v: build_logits_fn(
                             cfg32, m)(v))):
            want = fn(cpu_model, x)
            got = fn(card_model, x.to(dev)).cpu()
            err = (got - want).abs().max().item() / want.abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"3D {name}: card vs CPU {err:.3e} of "
                                     f"the max (limit 1e-4)")
            worst[name] = err
    E = cfg.data.image_size  # a level-0 activation: 16 channels at E^3
    xl = torch.zeros(1, E, E, E, cfg.model.base_filters, dtype=torch.bfloat16,
                     device=dev).permute(0, 4, 1, 2, 3)  # as ops/conv.py views it
    kept = F.pad(xl, (0, 1, 0, 1, 0, 1)).is_contiguous(
        memory_format=torch.channels_last_3d)
    del xl
    if not kept:
        raise AssertionError("F.pad made a channels_last_3d tensor "
                             "channels-first: every stride-2 conv copies")
    print(f"[3d]      card vs CPU, f32 (TF32 off), full width and depth, "
          f"{S}^3 batch 1: eval forward {worst['eval forward']:.3e}, folded "
          f"forward {worst['folded forward']:.3e} of the max (limit 1e-4); "
          f"F.pad keeps channels_last_3d on the card", flush=True)


def vol_train(cfg_path, fused_mod, card, dev):
    """Phase 9b: cli.train at 192^3 (30 steps, one val_exact validation)
    and the checkpoint's 5-D JAX layout. Returns the checkpoint's path and
    the run's overrides."""
    from uresnet_tpu_torch import generate_file, load_config
    from uresnet_tpu_torch.cli import train
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.models.convert import flatten_tree, jax_train_state

    cfg = load_config(cfg_path)
    S, n = cfg.data.image_size, VOL_TRAIN_EVENTS
    t0 = time.time()
    train_file = generate_file(os.path.join(WORK, "vol_train.usef"), n,
                               seed=SEED + 11, shape=(S,) * 3, planes=(0,))
    ckpt_dir = os.path.join(WORK, "vol_ckpt")
    log_dir = os.path.join(WORK, "vol_log")
    overrides = [f"data.input_files={train_file}", "data.synthetic=false",
                 "train.summary_iter=10", "train.checkpoint_iter=0",
                 f"train.val_iter={TRAIN_STEPS}", "train.val_exact=true",
                 f"train.checkpoint_dir={ckpt_dir}", f"train.log_dir={log_dir}"]
    _, counts, _ = counted(fused_mod, lambda: run_cli(
        train, [cfg_path, *overrides, "--iterations", str(TRAIN_STEPS),
                "--device", DEVICE], tag="3d"))
    wall = time.time() - t0
    expect_launches(counts, 1, per_batch=0)
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(log_dir, "val_metrics.jsonl")) as f:
        val = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(10, TRAIN_STEPS + 1, 10)):
        raise AssertionError(f"logged steps {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"non-finite loss: {[r['loss'] for r in rows]}")
    if ([v["step"] for v in val] != [TRAIN_STEPS] or val[0]["n_events"] != n
            or val[0]["n_pixels"] != n * S ** 3
            or not np.isfinite(val[0]["loss"])):
        raise AssertionError(f"val_exact validation {val}")
    ckpt = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:08d}.npz")
    tcfg = load_config(cfg_path, overrides)
    tr = Trainer(tcfg, device=dev)
    ts, step, _ = tr.restore(ckpt)
    want = {"train_state/" + k.replace(".", "/") for k in flatten_tree(
        jax_train_state(ts.model, ts.opt, ts.key))} | {"meta/step",
                                                       "meta/data_cursor"}
    with np.load(ckpt) as z:
        keys = set(z.files)
        stem = z["train_state/params/stem/conv/w"].shape
        mid = z["train_state/params/mid_b0/cb1/conv/w"].shape
    fb = cfg.model.base_filters * 2 ** cfg.model.depth
    if (keys != want or step != TRAIN_STEPS
            or stem != (3, 3, 3, 1, cfg.model.base_filters)
            or mid != (3, 3, 3, fb, fb)):
        raise AssertionError(f"3D checkpoint {ckpt}: step {step}, stem {stem}, "
                             f"mid {mid}; keys missing {sorted(want - keys)[:5]}, "
                             f"extra {sorted(keys - want)[:5]}")
    val_s = val[0]["wall_s"] - rows[-1]["wall_s"]
    print(f"[3d]      {TRAIN_STEPS} config-4 steps at {S}^3 batch 1 through "
          f"cli.train in {wall - val_s:.2f} s wall (incl. data generation, "
          f"loader start, first-step setup; without the val_exact validation, "
          f"{val_s:.2f} s by the logs' wall_s); losses "
          f"{[round(r['loss'], 4) for r in rows]} finite; val_exact over {n} "
          f"events: n_pixels {val[0]['n_pixels']:.0f}, miou "
          f"{val[0]['miou']:.6f}; checkpoint holds {len(keys)} leaves of the "
          f"JAX layout, 5-D kernels (stem {stem}, mid {mid}); fused launches "
          f"{counts} | {card}", flush=True)
    return ckpt, overrides


def vol_step(cfg_path, ckpt, overrides, B, remat, card, dev):
    """Phase 9c at one (batch, remat): train_step_light from the phase's
    checkpoint, timed by CUDA events (median of 5), its peak memory, its
    train-BN launches (without remat) and its layers; at batch 1 also the
    train forward's logits (f32, the f32 head's) and a profile of 3 steps.
    Returns (ms, peak GiB, launches)."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.engine.trainer import Trainer

    bcfg = load_config(cfg_path, overrides + [f"data.batch_size={B}",
                                              f"model.remat={remat}"])
    S = bcfg.data.image_size
    btr = Trainer(bcfg, device=dev)
    state = [btr.restore(ckpt)[0]]
    loader = btr.make_loader(train=True)
    loader.start()
    try:
        host = loader.next()
    finally:
        loader.stop()
        if hasattr(loader, "close"):
            loader.close()
    host.pop("cursor", None)
    batch = btr.device_batch(host)
    if B == 1:
        with torch.no_grad():
            logits, _ = state[0].model(btr._prepare(batch)["data"], train=True)
        if (logits.dtype != torch.float32
                or torch.equal(logits, logits.bfloat16().float())):
            raise AssertionError(f"train logits {logits.dtype}, not the f32 "
                                 f"head's")
        del logits

    def step(_=None):
        state[0], m = btr.train_step_light(state[0], batch)
        return m

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bn_zero()
    t_step = time_ms(step, reps=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(step()["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss} at batch {B}")
    # remat reruns the forward's kernels in the backward
    launches = (0 if remat else bn_main_path(
        state[0].model, 2 + 5 + 1, f"B={B} {S}^3 train_step_light", card))
    print(f"[3d]      B={B} remat={remat} {S}^3 bf16 train_step_light (sparse "
          f"batch, densify on device): {t_step:.2f} ms/step = "
          f"{B / t_step * 1e3:.3f} vol/s, peak memory {peak:.3f} GiB | {card}",
          flush=True)
    layer_times(btr, state[0], batch, card, reps=3, tag="3d")
    if B == 1:
        profile_forwards({"3d train step": step}, None,
                         os.path.join(WORK, "profile.txt"), card, unit="step",
                         append=True, top=12)
    del state, batch, btr
    torch.cuda.empty_cache()
    return t_step, peak, launches


def vol_ana(cfg_path, ckpt, fused_mod, card, dev):
    """Phase 9d-e: serving and every analysis mode from the 3D checkpoint
    through cli.infer, each with 0 fused launches; then the serving forward
    and the streamed sparse pass timed."""
    from uresnet_tpu_torch import generate_file, load_config
    from uresnet_tpu_torch.cli import infer
    from uresnet_tpu_torch.data import events as ev
    from uresnet_tpu_torch.data.loader import make_batch_loader
    from uresnet_tpu_torch.engine import evaluator
    from uresnet_tpu_torch.engine import metrics as tmetrics
    from uresnet_tpu_torch.engine.export import (build_logits_fn,
                                                 build_serving_fn)

    cfg = load_config(cfg_path)
    S, C, n = cfg.data.image_size, cfg.model.num_class, VOL_ANA_EVENTS
    events = generate_file(os.path.join(WORK, "vol_ana.usef"), n,
                           seed=SEED + 12, shape=(S,) * 3, planes=(0,))
    argv = [cfg_path, "--checkpoint", ckpt, "--input", events, "--device", DEVICE]
    out = {m: os.path.join(WORK, f"vol_{m}.npz")
           for m in ("sparse", "dense", "host", "f32")}
    z, st, cnt = {}, {}, {}
    for mode, extra in (("sparse", []), ("dense", ["--export", "dense"]),
                        ("f32", ["model.compute_dtype=float32"])):
        z[mode], st[mode], cnt[mode], _ = serve_counted(
            fused_mod, infer, argv + extra, out[mode], n, C, "tensor_core",
            per_batch=0, batch_events=1)
    tr, ts = ana_state(cfg_path, ckpt, dev)
    st["host"], cnt["host"], _ = counted(fused_mod, lambda: evaluator.run_inference(
        tr, ts, events, out["host"], streamed=False))
    expect_launches(cnt["host"], n, per_batch=0)
    z["host"] = check_export(out["host"], st["host"], n, C)
    usef = os.path.join(WORK, "vol_scores.usef")
    _, cnt["usef"], _ = counted(fused_mod, lambda: run_cli(
        infer, argv + ["--format", "usef", "--output", usef], tag="3d"))
    expect_launches(cnt["usef"], n, per_batch=0)
    for m in ("dense", "host"):
        identical(z[m], z["sparse"], f"3D {m} vs sparse export")
    if z["sparse"]["coords"].shape[1] != 3:
        raise AssertionError(f"3D export coords {z['sparse']['coords'].shape}")
    hits = check_usef(usef, events, z["sparse"], cfg)
    d, agree = agreement(z["f32"], z["sparse"], "3D f32 vs bf16 forward")
    print(f"[3d]      {n} events of {S}^3: sparse, dense, host exports of "
          f"{len(z['sparse']['scores'])} charge voxels bit-equal in every "
          f"column; usef writeback holds the npz scores at all {hits} voxels; "
          f"compute_dtype float32 vs bf16: max softmax diff {d:.3e} (tol "
          f"{FWD_MAX_SOFTMAX_DIFF}), argmax agreement {agree:.5f} (min "
          f"{FWD_MIN_AGREE}); fused launches "
          f"{ {m: sum(c.values()) for m, c in cnt.items()} }", flush=True)

    m, counts, _ = counted(fused_mod, lambda: run_cli(
        infer, argv + ["--metrics-only"], tag="3d"))
    expect_launches(counts, n, per_batch=0)
    if (m["n_events"] != n or m["n_pixels"] != n * S ** 3
            or abs(m["miou"] - st["sparse"]["miou"]) > 1e-9):
        raise AssertionError(f"3D --metrics-only {m} vs the sparse pass's "
                             f"miou {st['sparse']['miou']}")
    print(f"[3d]      --metrics-only: n_events {m['n_events']:.0f}, n_pixels "
          f"{m['n_pixels']:.0f} (= {n} x {S}^3), miou {m['miou']!r} (sparse "
          f"pass {st['sparse']['miou']!r}); launches {counts}", flush=True)

    nt, edge = VOL_TILED
    big = generate_file(os.path.join(WORK, "vol_tiled_in.usef"), nt,
                        seed=SEED + 13, shape=(edge,) * 3, planes=(0,))
    tiled = os.path.join(WORK, "vol_tiled.usef")
    mt, counts, wall = counted(fused_mod, lambda: run_cli(
        infer, [cfg_path, "--checkpoint", ckpt, "--input", big, "--tiled",
                "--format", "usef", "--output", tiled, "--device", DEVICE],
        tag="3d"))
    expect_launches(counts, 1, per_batch=0)
    per_event = (-(-edge // S)) ** 3
    n_pts = n_scored = 0
    for eo, ei in zip(ev.read_events(tiled), ev.read_events(big)):
        by_id = {p.plane_id: p for p in eo.planes}
        pin = ei.planes[0]
        sc = np.stack([by_id[c].values for c in range(C)], 1)
        if (not np.array_equal(by_id[0].coords, pin.coords)
                or not np.isfinite(sc).all()):
            raise AssertionError("3D tiled: a point is missing or not scored")
        n_pts += len(pin.values)
        n_scored += len(sc)
    if n_scored != n_pts or n_pts == 0 or mt["n_tiles"] != nt * per_event:
        raise AssertionError(f"3D tiled: {n_scored} of {n_pts} points scored, "
                             f"{mt['n_tiles']} tiles")
    print(f"[3d]      --tiled: {nt} events of {edge}^3, {int(mt['n_tiles'])} "
          f"clamped tiles ({per_event} each), all {n_pts} charge points "
          f"scored (finite, file order); launches {counts}; {wall:.2f} s wall",
          flush=True)

    # 9e. the serving forward, the sparse ana step and pass
    serve = build_serving_fn(tr.cfg, ts.model)
    x = torch.rand(1, S, S, S, 1, generator=torch.Generator().manual_seed(SEED))
    x = (x * (x > 0.999)).to(dev)  # ~0.1% charge voxels, as the events
    t_fwd = time_ms(lambda: serve(x), reps=7)
    print(f"[3d]      B=1 {S}^3 bf16 serving forward+softmax (BN folded, f32 "
          f"head): {t_fwd:.2f} ms = {1e3 / t_fwd:.3f} vol/s (CUDA events, "
          f"median of 7) | {card}", flush=True)
    profile_forwards({"3d serving": serve}, x, os.path.join(WORK, "profile.txt"),
                     card, append=True, top=12)
    dcfg = dataclasses.replace(
        cfg.data, input_files=(events,), synthetic=False, random_access=False,
        weight_mode="ones", transfer="sparse",
        max_points=max(cfg.data.max_points,
                       -(-ev.max_plane_points(events, (0,)) // 256) * 256))
    loader = make_batch_loader(dcfg, num_class=C, train=False, ndims=3)
    try:
        host = loader.next()
    finally:
        loader.stop()
        if hasattr(loader, "close"):
            loader.close()
    host.pop("cursor", None)
    batch = tr.device_batch(host)
    logits_fn = build_logits_fn(tr.cfg, ts.model)
    sparse = dict(batch, row_valid=torch.ones(1, device=dev))
    t_step = time_ms(lambda: evaluator._ana_step_sparse(tr.cfg, logits_fn,
                                                        sparse), reps=7)
    dense = evaluator._densify_ones(tr.cfg, batch)
    logits = logits_fn(dense["data"])
    t_counts = time_ms(lambda: tmetrics.segmentation_counts(
        logits, dense["label"], dense["data"], num_class=C), reps=7)

    def scatter_counts():  # the scatter_add_ form, for the record
        pred = torch.argmax(logits, dim=-1)
        idx = (pred * C + dense["label"]).reshape(1, -1)
        conf = torch.zeros(1, C * C, device=dev)
        conf.scatter_add_(1, idx, torch.ones(idx.shape, device=dev))
        return conf

    t_scatter = time_ms(scatter_counts, reps=7)
    walls = []
    o = os.path.join(WORK, "vol_timed.npz")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluator.run_inference(tr, ts, events, o)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"[3d]      device per volume (median of 7): sparse ana step "
          f"{t_step:.3f} ms (densify, forward, softmax, gather, counts); "
          f"segmentation_counts {t_counts:.3f} ms (its scatter_add_ form "
          f"{t_scatter:.3f} ms) | {card}", flush=True)
    for wall in walls:
        print(f"[3d]      streamed sparse analysis: {n} volumes in {wall:.3f} s "
              f"= {n / wall:.3f} events/s; device steps {n * t_step:.1f} ms "
              f"(share {n * t_step / (wall * 1e3):.3f}) | {card}", flush=True)


def vol_head(cfg, card, dev):
    """Phase 9c: the config-4 head (16 -> 3 channels at 192^3, bf16-rounded
    operands in f32) forward + weight gradient as the port runs it (TF32
    allowed, ops/conv.py ``_ConvTF32``) and in true f32, where stock
    autograd with the global flag off would take it."""
    from uresnet_tpu_torch.ops.conv import conv

    S, C = cfg.data.image_size, cfg.model.base_filters
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    h = torch.randn(1, S, S, S, C, generator=g, device=dev).bfloat16()
    w = (torch.randn(3, 3, 3, C, cfg.model.num_class, generator=g, device=dev)
         * 0.1).requires_grad_()
    port = conv(h, {"w": w}, dims=3, compute_dtype=torch.float32,
                precision=torch.bfloat16)
    gy = torch.randn_like(port)
    wr = w.detach().bfloat16().float().requires_grad_()
    t_port = time_ms(lambda: torch.autograd.grad(conv(
        h, {"w": w}, dims=3, compute_dtype=torch.float32,
        precision=torch.bfloat16), [w], gy))
    prev, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    try:
        t_f32 = time_ms(lambda: torch.autograd.grad(conv(
            h.float(), {"w": wr}, dims=3, compute_dtype=torch.float32), [wr],
            gy))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    print(f"[3d]      head {C}->{cfg.model.num_class} at {S}^3, forward + "
          f"weight gradient: {t_port:.3f} ms in TF32 (the port's), {t_f32:.3f} "
          f"ms in true f32 | {card}", flush=True)


def vol_phase(fused_mod, card, dev):
    """Phase 9: BASELINE config 4 (the 3D U-ResNet at 192^3) — card vs CPU,
    training, train step times and memory, serving and analysis. Returns
    the train-BN launches counted in its steps without remat."""
    t0 = time.time()
    from uresnet_tpu_torch import load_config

    cfg_path = os.path.join(WORK, "config4.json")
    with open(cfg_path, "w") as f:
        json.dump(CONFIG4, f)
    layout_line(load_config(cfg_path), "3d")
    vol_card_vs_cpu(load_config(cfg_path), card, dev)
    ckpt, overrides = vol_train(cfg_path, fused_mod, card, dev)
    launches = 0
    for B, remat in VOL_BATCHES:
        launches += vol_step(cfg_path, ckpt, overrides, B, remat, card, dev)[2]
    vol_head(load_config(cfg_path), card, dev)
    vol_ana(cfg_path, ckpt, fused_mod, card, dev)
    print(f"[3d]      phase 9 wall {time.time() - t0:.1f} s | {card}", flush=True)
    return launches


def dense_batches(cfg, events, tr, n_batches):
    """``n_batches`` batches of ``events`` as the analysis pass densifies
    them on the card (weights ones): (data, label) per batch."""
    from uresnet_tpu_torch.data import events as ev
    from uresnet_tpu_torch.data.loader import make_batch_loader
    from uresnet_tpu_torch.engine import evaluator

    dcfg = dataclasses.replace(
        cfg.data, input_files=(events,), synthetic=False, random_access=False,
        weight_mode="ones", transfer="sparse",
        max_points=max(cfg.data.max_points, -(-ev.max_plane_points(
            events, tuple(cfg.data.planes)) // 256) * 256))
    loader = make_batch_loader(dcfg, num_class=cfg.model.num_class,
                               train=False, ndims=cfg.model.dims)
    out = []
    try:
        for _ in range(n_batches):
            host = loader.next()
            host.pop("cursor", None)
            d = evaluator._densify_ones(cfg, tr.device_batch(host))
            out.append((d["data"], d["label"]))
    finally:
        loader.stop()
        if hasattr(loader, "close"):
            loader.close()
    return out


def export_cli(argv):
    """``python -m uresnet_tpu_torch.tools.export_serving`` in-process
    (`run_main`), its selftest required; returns its wall s."""
    from uresnet_tpu_torch.tools import export_serving

    t0 = time.perf_counter()
    out = run_main(export_serving, argv, "artifact")
    if "selftest OK" not in out:
        raise RuntimeError("export_serving ran no selftest")
    return time.perf_counter() - t0


def served_agreement(got, want, data, what):
    """Two softmax score batches of the same input: max |d| and argmax
    agreement over charge pixels, within the forward tolerances."""
    d = (got - want).abs().max().item()
    charge = data[..., 0] > 0
    agree = (got.argmax(-1) == want.argmax(-1))[charge].float().mean().item()
    if not (d <= FWD_MAX_SOFTMAX_DIFF and agree >= FWD_MIN_AGREE):
        raise AssertionError(f"{what}: max softmax diff {d} (tol "
                             f"{FWD_MAX_SOFTMAX_DIFF}), argmax agreement "
                             f"{agree} (min {FWD_MIN_AGREE})")
    return d, agree


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def artifact_phase(cfg_path, cfg, events, fused_mod, card, dev, t_fwd5):
    """Phase 10: the serving artifact and the checkpoint lifecycle (see the
    module docstring). ``t_fwd5`` is phase 5's forward time."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.cli import infer, train
    from uresnet_tpu_torch.engine.checkpoint import load_serving_state
    from uresnet_tpu_torch.engine.export import (build_logits_fn,
                                                 build_serving_fn,
                                                 load_serving)
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.models.convert import load_jax_params
    from uresnet_tpu_torch.models.uresnet import UResNet
    from uresnet_tpu_torch.tools import make_release_ckpt

    t_phase = time.time()
    default_flags = tf32_flags()
    if not default_flags[0]:
        raise AssertionError("cuDNN's allow_tf32 is off before phase 10: "
                             "something changed torch's default")
    S, B = cfg.data.image_size, cfg.data.batch_size
    ckpt = os.path.join(WORK, "train_ckpt", f"step_{TRAIN_STEPS:08d}.npz")
    tr = Trainer(cfg, device=dev)
    ts = tr.init_state()
    load_jax_params(ts.model, *load_serving_state(ckpt)[:2])
    batches = dense_batches(cfg, events, tr, N_EVENTS // B)

    # 10a-b. export, reload and serve the flagship in bf16 and f32
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    loaded = {}
    for name, c, extra, kernel in (
            ("bf16", cfg, [], "tensor_core"),
            ("f32", cfg32, ["model.compute_dtype=float32"], "f32_tensor_core")):
        out = os.path.join(WORK, f"flagship_{name}.uxm")
        wall = export_cli(["--config", cfg_path, "--checkpoint", ckpt,
                           "--output", out, "--batch", str(B), "--selftest",
                           "--device", DEVICE, *extra])
        t0 = time.perf_counter()
        fn, meta = load_serving(out, device=DEVICE)
        t_load = time.perf_counter() - t0
        serve = build_serving_fn(c, ts.model)
        scores, counts, _ = counted(fused_mod, lambda: [fn(x) for x, _ in batches])
        expect_launches(counts, len(batches), kernel)
        worst = [served_agreement(got, serve(x), x, f"{name} artifact")
                 for got, (x, _) in zip(scores, batches)]
        loaded[name] = fn
        print(f"[artifact] {name} flagship .uxm: {os.path.getsize(out)} bytes "
              f"({os.path.getsize(out) / 1e6:.3f} MB), export + selftest "
              f"{wall:.2f} s, load {t_load:.3f} s; {len(batches)} batches of "
              f"phase 4's events: launches {counts} (= 44 per batch on the "
              f"{kernel.replace('_', '-')} kernel); vs build_serving_fn max "
              f"softmax |d| {max(d for d, _ in worst):.3e}, argmax agreement "
              f"{min(a for _, a in worst):.5f} | {card}", flush=True)

    # 10c. true f32 with torch's default TF32 setting left in place
    cpu_model = UResNet(cfg.model, generator=torch.Generator())
    load_jax_params(cpu_model, *load_serving_state(ckpt)[:2])
    x2 = batches[0][0][:2]
    with torch.no_grad():
        want_logits = build_logits_fn(cfg32, cpu_model)(x2.cpu())
    errs = {}
    for backend in ("auto", "xla"):
        cb = dataclasses.replace(cfg32, model=dataclasses.replace(
            cfg32.model, kernel_backend=backend))
        got = build_logits_fn(cb, ts.model)(x2).cpu()
        errs[backend] = ((got - want_logits).abs().max()
                         / want_logits.abs().max()).item()
    got = loaded["f32"](batches[0][0])[:2].cpu()
    errs["artifact"] = (got - torch.softmax(want_logits, -1)).abs().max().item()
    # what the same check reads for a stock f32 conv under the default
    w = ts.model.enc0_b0.cb1.conv.w.detach()
    xs = torch.randn(2, S, S, w.shape[2], generator=torch.Generator().manual_seed(
        SEED), dtype=torch.float32)
    stock = torch.nn.functional.conv2d(
        xs.to(dev).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).cpu()
    ref = torch.nn.functional.conv2d(xs.permute(0, 3, 1, 2),
                                     w.cpu().permute(3, 2, 0, 1), padding=1)
    stock_err = ((stock - ref).abs().max() / ref.abs().max()).item()
    if max(errs.values()) > 1e-4 or tf32_flags() != default_flags:
        raise AssertionError(f"f32 card vs CPU {errs} (limit 1e-4 of the "
                             f"max), flags {tf32_flags()} vs {default_flags}")
    print(f"[artifact] f32 with cuDNN's allow_tf32 left {default_flags[0]} "
          f"(torch's default): card vs CPU at 2 rows of {S}^2, logits "
          f"'auto' {errs['auto']:.3e}, 'xla' {errs['xla']:.3e} of the max, "
          f"the f32 artifact's softmax {errs['artifact']:.3e} (limit 1e-4); "
          f"flags after {tf32_flags()}; a stock f32 conv "
          f"{w.shape[2]}->{w.shape[3]} @{S}^2 under the same default "
          f"{stock_err:.3e} of the max | {card}", flush=True)

    # 10d. config 4's volume artifact: the f32 head's TF32 travels with it
    vol_cfg_path = os.path.join(WORK, "config4.json")
    vol_cfg = load_config(vol_cfg_path)
    vol_ckpt = os.path.join(WORK, "vol_ckpt", f"step_{TRAIN_STEPS:08d}.npz")
    vol_out = os.path.join(WORK, "config4.uxm")
    wall = export_cli(["--config", vol_cfg_path, "--checkpoint", vol_ckpt,
                       "--output", vol_out, "--batch", "1", "--selftest",
                       "--device", DEVICE])
    vfn, _ = load_serving(vol_out, device=DEVICE)
    V = vol_cfg.data.image_size
    xv = torch.rand(1, V, V, V, 1, generator=torch.Generator().manual_seed(SEED))
    xv = (xv * (xv > 0.999)).to(dev)
    vtr = Trainer(vol_cfg, device=dev)
    vts = vtr.init_state()
    load_jax_params(vts.model, *load_serving_state(vol_ckpt)[:2])
    vserve = build_serving_fn(vol_cfg, vts.model)
    runs = {}
    for flag in (True, False):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
        try:
            runs[flag], counts, _ = counted(fused_mod, lambda: vfn(xv))
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = default_flags
        expect_launches(counts, 1, per_batch=0)
    if not torch.equal(runs[True], runs[False]):
        raise AssertionError("3D artifact: scores depend on the caller's "
                             "TF32 flags")
    d, agree = served_agreement(runs[True], vserve(xv), xv, "3D artifact")
    print(f"[artifact] config-4 .uxm (batch 1, {V}^3, f32 head): "
          f"{os.path.getsize(vol_out)} bytes, export + selftest {wall:.2f} s; "
          f"scores bit-equal under allow_tf32 True and False; vs "
          f"build_serving_fn max softmax |d| {d:.3e}, argmax agreement "
          f"{agree:.5f}; fused launches {counts} | {card}", flush=True)

    # 10e. the loaded forwards timed beside build_serving_fn, in turns
    x32 = batches[0][0]
    serve = build_serving_fn(cfg, ts.model)
    t = {k: [] for k in ("in-process", "artifact", "3d in-process", "3d artifact")}
    for k in ("in-process", "artifact", "artifact", "in-process"):
        fn = serve if k == "in-process" else loaded["bf16"]
        t[k].append(time_ms(lambda: fn(x32), reps=7))
    for k in ("3d in-process", "3d artifact", "3d artifact", "3d in-process"):
        fn = vserve if k == "3d in-process" else vfn
        t[k].append(time_ms(lambda: fn(xv), reps=5))
    print(f"[artifact] B={B} {S}^2 bf16 forward+softmax: loaded artifact "
          f"{t['artifact']} ms = {[round(B / v * 1e3, 1) for v in t['artifact']]} "
          f"img/s, build_serving_fn {t['in-process']} ms; phase 5's forward "
          f"through the op {t_fwd5:.2f} ms | {card}", flush=True)
    print(f"[artifact] B=1 {V}^3 forward+softmax: loaded artifact "
          f"{t['3d artifact']} ms = "
          f"{[round(1e3 / v, 3) for v in t['3d artifact']]} vol/s, "
          f"build_serving_fn {t['3d in-process']} ms | {card}", flush=True)
    del vfn, vserve, vts, vtr, runs
    torch.cuda.empty_cache()

    # 10f. a bf16 release checkpoint evaluates as the full one
    rel = os.path.join(WORK, "release", "flagship_bf16.npz")
    run_main(make_release_ckpt, [ckpt, rel, "--kernels-dtype", "bfloat16",
                                 "--force"], "artifact")
    argv = [cfg_path, "--metrics-only", "--input", events, "--device", DEVICE]
    m_full = run_cli(infer, argv + ["--checkpoint", ckpt], tag="artifact")
    m_rel = run_cli(infer, argv + [f"train.load_file={rel}",
                                   "train.load_params_only=true"],
                    tag="artifact")
    if m_rel != m_full or m_full["n_events"] != N_EVENTS:
        raise AssertionError(f"release --metrics-only {m_rel} != full {m_full}")
    print(f"[artifact] release checkpoint: {os.path.getsize(ckpt)} -> "
          f"{os.path.getsize(rel)} bytes; --metrics-only on {N_EVENTS} events "
          f"equal to the full checkpoint's in every key (miou "
          f"{m_rel['miou']!r})", flush=True)

    # 10g. cli.train --profile: one summary window of a short flagship run
    prof = os.path.join(WORK, "profile_trace")
    run_main(train, [
        cfg_path, f"data.input_files={os.path.join(WORK, 'train.usef')}",
        "data.synthetic=false", "train.summary_iter=2",
        "train.checkpoint_iter=0", "train.val_iter=0",
        f"train.checkpoint_dir={os.path.join(WORK, 'prof_ckpt')}",
        f"train.log_dir={os.path.join(WORK, 'prof_log')}",
        "--profile", prof, "--device", DEVICE], "artifact")
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    with open(traces[0]) as f:
        events_ = json.load(f)["traceEvents"]
    kernels = collections.Counter(e["name"] for e in events_
                                  if e.get("cat") == "kernel")
    if len(traces) != 1 or not kernels:
        raise AssertionError(f"--profile wrote {traces}, {len(kernels)} "
                             f"distinct CUDA kernels")
    print(f"[artifact] --profile: {os.path.basename(traces[0])}, "
          f"{os.path.getsize(traces[0])} bytes, {sum(kernels.values())} CUDA "
          f"kernel events of {len(kernels)} kernels; top: "
          f"{[k[:60] for k, _ in kernels.most_common(3)]}", flush=True)
    print(f"[artifact] phase 10 wall {time.time() - t_phase:.1f} s | {card}",
          flush=True)


# -- phase 11: data parallelism ---------------------------------------------------

# configs/train_2d_512_dp8.yaml at one card's share of its global batch (256
# over 8 cards: 32 rows, plane 2, class balance, augment, parallel.data 0 =
# every process), written out as FLAGSHIP is
DP_CFG = {
    "model": dict(FLAGSHIP["model"]),
    "data": {"image_size": 512, "batch_size": 32, "planes": [2],
             "weight_mode": "class_balance", "augment": True,
             "num_threads": 6, "backend": "auto"},
    "parallel": {"data": 0},
    "optim": {"lr": 2.0e-3, "schedule": "cosine", "decay_steps": 20000},
    "train": {"iterations": 20000, "summary_iter": 50,
              "checkpoint_iter": 1000, "val_iter": 500},
}
DP_STEPS = 10       # phase 11a: cli.train --distributed steps, then val_exact
DP_GLOO_STEPS = 4   # phase 11b: two ranks through gloo, global batch 32
# bf16 runs of the same seed and data, DP against one process: activations
# round to 2^-8, so a BN sum split across ranks (or packed for an
# all-reduce) moves some of the 8.4 M normalized pixels across a rounding
# boundary, and Adam's lr * g / |g| carries that into the next steps (in
# f32 on the CPU the state after three steps already differs by 1.3e-3,
# tests/test_torch_distributed.py). The per-step mean loss is held to:
DP_LOSS_RTOL = 1e-2
DP_EVAL_ATOL = 1e-4  # the same state's dataset metrics, 1 vs 2 ranks
# one step's gradient, 2 ranks vs 1, of its largest element: 8 bf16 ulps
# (2^-5). The batch statistics of a sum split across ranks differ in f32
# by ~1e-3 in the most cancelling channels, which moves 2^-8 roundings of
# the normalized bf16 activations; the card read 1.27e-2 for the first
# moment and 7.4e-3 for the second.
DP_MOMENT_TOL = 2.0 ** -5


def spawn_ranks(mode, spec, world, local_rank):
    """``world`` processes of ``chip_smoke.py --dp-worker mode spec`` in
    the torchrun environment (parallel/mesh.py ``launch_local``, rank r on
    ``cuda:local_rank(r)``); waits for all, echoes their output, raises
    if one fails; returns each rank's result dict."""
    from uresnet_tpu_torch.parallel.mesh import launch_local

    res = launch_local([sys.executable, os.path.abspath(__file__),
                        "--dp-worker", mode, spec], world, cwd=ROOT,
                       local_rank=local_rank, timeout=600)
    for rank, (rc, out) in enumerate(res):
        print("".join(f"[dp r{rank}]  {line}\n" for line in out.splitlines()),
              end="", flush=True)
        if rc != 0:
            raise RuntimeError(f"dp worker {mode} rank {rank} exited {rc}")
    with open(spec) as f:
        base = json.load(f)["out"]
    res = []
    for rank in range(world):
        with open(f"{base}.{rank}.json") as f:
            res.append(json.load(f))
    return res


def first_batch(tr):
    loader = tr.make_loader(train=True)
    loader.start()
    try:
        host = loader.next()
    finally:
        loader.stop()
        if hasattr(loader, "close"):
            loader.close()
    host.pop("cursor", None)
    return tr.device_batch(host)


def collective_counts(step, reps=3, warmup=2):
    """torch.profiler over ``reps`` steps: per step, the collectives the
    host issued (c10d's ``nccl:``/``gloo:`` ops) and the device kernels
    whose name says NCCL, each with its device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    # a collective's range is on the host timeline, the device's or both
    # (gloo between CUDA tensors mirrors it): count each name on the side
    # that shows it most often
    sides = collections.defaultdict(collections.Counter)
    for e in prof.events():
        if e.name.startswith(("nccl:", "gloo:")):
            sides[e.device_type == DeviceType.CPU][e.name] += 1
    ops = {k: max(c[k] for c in sides.values())
           for k in set().union(*sides.values())}
    kern, kern_us = collections.Counter(), 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower():
            kern[e.name[:60]] += 1
            kern_us += e.time_range.end - e.time_range.start
    return ({k: v / reps for k, v in ops.items()},
            {k: v / reps for k, v in kern.items()}, kern_us / 1e3 / reps)


def dp_worker(mode, spec_path):
    """One rank of phase 11 (``--dp-worker``): 'nccl' is cli.train
    --distributed at world 1 with the DP step timed and profiled first;
    'gloo' is a rank of the two-rank run on one card (gloo between CUDA
    tensors): fit, evaluate_dataset, the state's digest."""
    import torch.distributed as dist

    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.cli import train
    from uresnet_tpu_torch.engine.evaluator import evaluate_dataset
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.ops.cuda import conv2d as fused_mod
    from uresnet_tpu_torch.parallel import mesh

    with open(spec_path) as f:
        spec = json.load(f)
    cfg = load_config(spec["cfg"], spec["overrides"])
    # built before the group exists: the one-process step of this process
    plain = Trainer(cfg, device="cuda:0") if mode == "nccl" else None
    dev = mesh.init_distributed(
        "cuda", backend=None if mode == "nccl" else "gloo")
    rank = dist.get_rank()
    out = {"rank": rank, "pid": os.getpid(), "backend": dist.get_backend(),
           "device": str(dev)}
    tr = Trainer(cfg, device=dev)
    if mode == "nccl":
        steps = {}
        for name, t in (("plain", plain), ("dp", tr)):
            state, batch = [t.init_state()], first_batch(t)

            def step(_=None, t=t, state=state, batch=batch):
                state[0], m = t.train_step_light(state[0], batch)
                return m

            steps[name] = step
        # in turns: one process, DP, DP, one process
        times = collections.defaultdict(list)
        for name in ("plain", "dp", "dp", "plain"):
            times[name].append(time_ms(steps[name], reps=10, warmup=3))
        out["t_plain"], out["t_step"] = times["plain"], times["dp"]
        out["ops"], out["kernels"], out["kernel_ms"] = collective_counts(
            steps["dp"])
        del steps, plain
        torch.cuda.empty_cache()
        # the CLI joins the live group and shuts it down at its end
        _, out["launches"], _ = counted(fused_mod, lambda: run_main(
            train, [spec["cfg"], *spec["overrides"], *spec["cli"],
                    "--device", "cuda", "--distributed"], "dp"))
    else:
        ts, _ = tr.fit(iterations=DP_GLOO_STEPS, log=False)
        out["eval"], out["launches"], _ = counted(
            fused_mod, lambda: evaluate_dataset(tr, ts))
        out["digest"] = state_digest(ts)
        mesh.shutdown()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def log_rows(log_dir, name="train"):
    with open(os.path.join(log_dir, f"{name}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def losses_agree(got, want, what):
    """Per-step logged losses of two runs (same steps) within
    DP_LOSS_RTOL; returns the largest relative difference."""
    if [r["step"] for r in got] != [r["step"] for r in want]:
        raise AssertionError(f"{what}: logged steps {[r['step'] for r in got]}"
                             f" vs {[r['step'] for r in want]}")
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(got, want))
    if not (np.isfinite(rel) and rel <= DP_LOSS_RTOL):
        raise AssertionError(f"{what}: losses {[a['loss'] for a in got]} vs "
                             f"{[b['loss'] for b in want]} (rtol "
                             f"{DP_LOSS_RTOL})")
    return rel


def ckpt_diffs(path_a, path_b):
    """Two checkpoints of one model: the same leaves, shapes and dtypes,
    finite, the same step and key (raises otherwise); returns the largest
    difference per kind: params absolute, BN state of max(|leaf|, 1), Adam
    moments of the kind's largest element."""
    diffs, top = collections.defaultdict(float), collections.defaultdict(float)
    with np.load(path_a) as a, np.load(path_b) as b:
        if set(a.files) != set(b.files):
            raise AssertionError(f"{path_a}: checkpoint leaves differ")
        for k in a.files:
            if k == "meta/data_cursor":  # rank 0's own shard's position
                continue
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            if (a[k].shape != b[k].shape or a[k].dtype != b[k].dtype
                    or not np.isfinite(x).all()):
                raise AssertionError(f"checkpoint leaf {k}: {a[k].shape} "
                                     f"{a[k].dtype} vs {b[k].shape} "
                                     f"{b[k].dtype}, or not finite")
            if k.startswith(("meta/", "train_state/key")) or "opt/step" in k:
                if not np.array_equal(x, y):
                    raise AssertionError(f"{k}: {a[k]} vs {b[k]}")
                continue
            kind = "/".join(k.split("/")[1:3 if "/opt/" in k else 2])
            d = float(np.abs(x - y).max())
            if kind == "model_state":
                d /= max(np.abs(y).max(), 1.0)
            diffs[kind] = max(diffs[kind], d)
            top[kind] = max(top[kind], float(np.abs(y).max()))
    return {k: v / top[k] if k.startswith("opt/") else v
            for k, v in diffs.items()}


def dp_phase(fused_mod, card, dev, t_step7):
    """Phase 11: data parallelism at the flagship width (see the module
    docstring). Returns the world-1 DP step's ms."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.cli import train
    from uresnet_tpu_torch.data.loader import BatchLoader
    from uresnet_tpu_torch.engine.evaluator import evaluate_dataset
    from uresnet_tpu_torch.engine.trainer import Trainer

    t0 = time.time()
    torch.cuda.empty_cache()
    cfg_path = os.path.join(WORK, "dp.json")
    with open(cfg_path, "w") as f:
        json.dump(DP_CFG, f)
    layout_line(load_config(cfg_path), "dp")
    train_file = os.path.join(WORK, "train.usef")  # phase 7's 256 events
    n_val = TRAIN_EVENTS
    base = [f"data.input_files={train_file}", "data.synthetic=false"]

    def run_dirs(name):
        d = os.path.join(WORK, name)
        return [f"train.checkpoint_dir={d}/ckpt", f"train.log_dir={d}/log"], d

    # 11a. cli.train --distributed at world 1: NCCL on cuda:0
    cli = ["train.summary_iter=1", "train.checkpoint_iter=0",
           f"train.val_iter={DP_STEPS}", "train.val_exact=true",
           "--iterations", str(DP_STEPS)]
    dirs, d_nccl = run_dirs("dp_nccl")
    spec = os.path.join(WORK, "dp_nccl_spec.json")
    with open(spec, "w") as f:
        json.dump({"cfg": cfg_path, "overrides": base + dirs, "cli": cli,
                   "out": os.path.join(WORK, "dp_nccl")}, f)
    (w,) = spawn_ranks("nccl", spec, 1, lambda r: 0)
    if w["backend"] != "nccl" or w["device"] != "cuda:0":
        raise AssertionError(f"world-1 run on {w['backend']} {w['device']}")
    n_batches = -(-n_val // DP_CFG["data"]["batch_size"])
    expect_launches(w["launches"], n_batches)
    dirs1, d_one = run_dirs("dp_one")
    run_cli(train, [cfg_path, *base, *dirs1, *cli, "--device", DEVICE],
            tag="dp")
    rel = losses_agree(log_rows(f"{d_nccl}/log"), log_rows(f"{d_one}/log"),
                       "world-1 DP vs one process")
    val = log_rows(f"{d_nccl}/log", "val")
    if [v["n_events"] for v in val] != [n_val]:
        raise AssertionError(f"DP val_exact {val}")
    n_ar = w["ops"].get("nccl:all_reduce", 0)
    if n_ar < 1:
        raise AssertionError(f"no NCCL all-reduce in the DP step: {w['ops']}")
    print(f"[dp]      world 1, NCCL on {w['device']}: {DP_STEPS} cli.train "
          f"--distributed steps, losses within {rel:.2e} of the one-process "
          f"run (rtol {DP_LOSS_RTOL}); val_exact over {n_val} events with "
          f"{w['launches']['tensor_core']} tensor-core launches (= 44 x "
          f"{n_batches} local batches)", flush=True)
    print(f"[dp]      per DP step: host collectives {w['ops']}, NCCL device "
          f"kernels {w['kernels'] or 0} ({w['kernel_ms']:.3f} ms)", flush=True)
    t_dp, t_plain = np.median(w["t_step"]), np.median(w["t_plain"])
    print(f"[dp]      B=32 512^2 bf16 train_step_light under --distributed "
          f"(world 1), in turns with the same process's one-process step: "
          f"DP {w['t_step'][0]:.2f}, {w['t_step'][1]:.2f} ms; one process "
          f"{w['t_plain'][0]:.2f}, {w['t_plain'][1]:.2f} ms: the collectives "
          f"cost {t_dp - t_plain:+.2f} ms ({(t_dp / t_plain - 1) * 100:+.2f}%); "
          f"DP = {32 / t_dp * 1e3:.1f} img/s; phase 7's one-process step "
          f"{t_step7:.2f} ms | {card}", flush=True)

    # 11b. two ranks on this one card through gloo, global batch 32
    gl = ["train.summary_iter=1", "train.checkpoint_iter=1",
          "train.val_iter=0"]
    dirs, d_two = run_dirs("dp_gloo")
    spec = os.path.join(WORK, "dp_gloo_spec.json")
    with open(spec, "w") as f:
        json.dump({"cfg": cfg_path, "overrides": base + dirs + gl,
                   "out": os.path.join(WORK, "dp_gloo")}, f)
    r0, r1 = spawn_ranks("gloo", spec, 2, lambda r: 0)
    if r0["digest"] != r1["digest"]:
        raise AssertionError("the two ranks' train states differ")
    # one process on the rank-major concatenation of the two shards'
    # batches: the global batch whose rows the ranks' augmentation draws for
    dirs1, d_ref = run_dirs("dp_gloo_ref")
    tr1 = Trainer(load_config(cfg_path, base + dirs1 + gl), device=dev)
    ts1, ref_rows = tr1.init_state(), []
    shards = [BatchLoader(tr1.cfg.data, num_class=3, shard=(r, 2))
              for r in (0, 1)]
    for step in range(1, DP_GLOO_STEPS + 1):
        b = [s._make_batch() for s in shards]
        for x in b:
            x.pop("cursor")
        ts1, m = tr1.train_step(ts1, tr1.device_batch(
            {k: np.concatenate([b[0][k], b[1][k]]) for k in b[0]}))
        ref_rows.append({"step": step, "loss": float(m["loss"])})
        tr1.save(ts1, step)
    rel = losses_agree(log_rows(f"{d_two}/log"), ref_rows,
                       "two gloo ranks vs one process")
    # rank 0's checkpoints, leaf by leaf, against the one-process run's.
    # After the first step: BN running stats within 1e-3 of max(|leaf|, 1),
    # Adam's moments (the gradient and its square) within DP_MOMENT_TOL of
    # their largest element, params within 2 lr (Adam's first step moves
    # an element by lr * g / |g|, so a near-zero gradient element may go
    # either way). After the last the differences are reported:
    # DP_LOSS_RTOL's chaos.
    lr = DP_CFG["optim"]["lr"]
    first = ckpt_diffs(f"{d_two}/ckpt/step_{1:08d}.npz",
                       f"{d_ref}/ckpt/step_{1:08d}.npz")
    if (first["params"] > 2 * lr or first["model_state"] > 1e-3
            or first["opt/mu"] > DP_MOMENT_TOL
            or first["opt/nu"] > DP_MOMENT_TOL):
        raise AssertionError(f"rank 0's step-1 checkpoint vs one process: "
                             f"{first}")
    ck = f"step_{DP_GLOO_STEPS:08d}.npz"
    worst = ckpt_diffs(f"{d_two}/ckpt/{ck}", f"{d_ref}/ckpt/{ck}")
    # the same state evaluated by one process: rank 0's checkpoint
    ev1, c1, _ = counted(fused_mod, lambda: evaluate_dataset(
        tr1, tr1.restore(f"{d_two}/ckpt/{ck}")[0]))
    if r0["eval"] != r1["eval"]:
        raise AssertionError(f"ranks' evaluations differ: {r0['eval']} "
                             f"{r1['eval']}")
    S = DP_CFG["data"]["image_size"]
    for k in ("n_events", "n_pixels", "n_nonzero"):
        if r0["eval"][k] != ev1[k]:
            raise AssertionError(f"{k}: 2 ranks {r0['eval'][k]}, 1 rank {ev1[k]}")
    if r0["eval"]["n_events"] != n_val or r0["eval"]["n_pixels"] != n_val * S * S:
        raise AssertionError(f"two-rank evaluation {r0['eval']}")
    d_ev = max(abs(r0["eval"][k] - ev1[k]) for k in ev1)
    if d_ev > DP_EVAL_ATOL:
        raise AssertionError(f"two-rank vs one-rank evaluation: {d_ev}")
    # only rank 0 wrote: each step logged once, one checkpoint, its pid
    steps = [r["step"] for r in log_rows(f"{d_two}/log")]
    tb = [f for f in os.listdir(f"{d_two}/log") if f.startswith("events.")]
    if (steps != list(range(1, DP_GLOO_STEPS + 1))
            or sorted(os.listdir(f"{d_two}/ckpt")) != ["LATEST"] + [
                f"step_{i:08d}.npz" for i in range(1, DP_GLOO_STEPS + 1)]
            or not tb or any(f.split(".")[-2] != str(r0["pid"]) for f in tb)):
        raise AssertionError(f"writes: steps {steps}, tb {tb}, ckpt "
                             f"{os.listdir(f'{d_two}/ckpt')}")
    per_rank = -(-n_val // 2 // 16)
    for r in (r0, r1):
        expect_launches(r["launches"], per_rank)
    expect_launches(c1, n_batches)
    print(f"[dp]      two ranks on one card, gloo between CUDA tensors, "
          f"{DP_GLOO_STEPS} steps at global batch 32 (16 rows a rank): losses "
          f"within {rel:.2e} of one process; replicas bit-equal; rank 0's "
          f"checkpoints vs one process after step 1 "
          f"{({k: f'{v:.2e}' for k, v in first.items()})} and step "
          f"{DP_GLOO_STEPS} {({k: f'{v:.2e}' for k, v in worst.items()})} "
          f"(params abs, BN state of max(|leaf|, 1), moments of their "
          f"largest); evaluate_dataset equal "
          f"on both ranks, n_events {r0['eval']['n_events']:.0f}, n_pixels "
          f"{r0['eval']['n_pixels']:.0f}, within {d_ev:.2e} of one rank on the "
          f"same checkpoint; fused launches per rank "
          f"{[r['launches']['tensor_core'] for r in (r0, r1)]} (= 44 x "
          f"{per_rank}), one rank {c1['tensor_core']}; only rank 0 wrote",
          flush=True)
    print(f"[dp]      phase 11 wall {time.time() - t0:.1f} s | {card}",
          flush=True)
    return t_dp


# -- phase 12: multi-plane, BASELINE config 3 -------------------------------------

# configs/train_multiplane.yaml (BASELINE config 3): 30 rows = 10 events x
# 3 planes, augment, 512^2, bf16; it trains packed as shipped
CONFIG3 = {
    "model": dict(FLAGSHIP["model"]),
    "data": {"image_size": 512, "batch_size": 30, "planes": [0, 1, 2],
             "augment": True, "prefetch_depth": 2, "num_threads": 6,
             "backend": "auto"},
    "parallel": {"data": 1},
    "optim": {"lr": 1.0e-3},
    "train": {"iterations": 20000},
}
MP_EVENTS = 64       # the training file, also its val_exact set
MP_ANA_EVENTS = 20   # cli.infer: 2 batches of 10 events
MP_STEPS = 30
MP_MEM_LIMIT = 72.0  # GiB: run 96 rows without remat below it


def step_stats(cfg_path, overrides, card, dev, tag):
    """train_step_light at a config: (ms, img/s, peak GiB), median of 10."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.engine.trainer import Trainer

    tr = Trainer(load_config(cfg_path, overrides), device=dev)
    state = [tr.init_state()]
    batch = first_batch(tr)

    def step(_=None):
        state[0], m = tr.train_step_light(state[0], batch)
        return m

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time_ms(step, reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(step()["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"{tag}: non-finite loss {loss}")
    B = tr.cfg.data.batch_size
    print(f"[mp]      {tag}: B={B} rows, remat {tr.cfg.model.remat}: "
          f"{t:.2f} ms/step = {B / t * 1e3:.1f} img/s, peak memory "
          f"{peak:.3f} GiB | {card}", flush=True)
    del state, batch, tr
    torch.cuda.empty_cache()
    return t, peak


def mp_phase(fused_mod, card, dev):
    """Phase 12: BASELINE config 3 (see the module docstring)."""
    from uresnet_tpu_torch import generate_file, load_config
    from uresnet_tpu_torch.cli import infer, train

    t0 = time.time()
    cfg_path = os.path.join(WORK, "config3.json")
    with open(cfg_path, "w") as f:
        json.dump(CONFIG3, f)
    layout_line(load_config(cfg_path), "mp")
    S, planes = 512, (0, 1, 2)
    mp_file = generate_file(os.path.join(WORK, "mp.usef"), MP_EVENTS,
                            seed=SEED + 31, shape=(S, S), planes=planes)
    d = os.path.join(WORK, "mp")
    base = [f"data.input_files={mp_file}", "data.synthetic=false",
            f"train.checkpoint_dir={d}/ckpt", f"train.log_dir={d}/log"]
    _, counts, wall = counted(fused_mod, lambda: run_cli(train, [
        cfg_path, *base, "train.summary_iter=10", "train.checkpoint_iter=0",
        f"train.val_iter={MP_STEPS}", "train.val_exact=true", "--iterations",
        str(MP_STEPS), "--device", DEVICE], tag="mp"))
    rows = log_rows(f"{d}/log")
    val = log_rows(f"{d}/log", "val")
    n_val_batches = -(-MP_EVENTS // 10)
    if ([r["step"] for r in rows] != list(range(10, MP_STEPS + 1, 10))
            or not all(np.isfinite(r["loss"]) for r in rows)):
        raise AssertionError(f"config 3 training log {rows}")
    if (len(val) != 1 or val[0]["n_events"] != MP_EVENTS
            or val[0]["n_pixels"] != MP_EVENTS * 3 * S * S):
        raise AssertionError(f"config 3 val_exact {val}")
    expect_launches(counts, n_val_batches)
    print(f"[mp]      config 3: {MP_STEPS} cli.train steps of 30 rows (10 "
          f"events x 3 planes, augment) in {wall:.2f} s wall, losses "
          f"{[round(r['loss'], 4) for r in rows]}; val_exact n_events "
          f"{val[0]['n_events']:.0f}, n_pixels {val[0]['n_pixels']:.0f} "
          f"(= {MP_EVENTS} x 3 x {S}^2), miou {val[0]['miou']:.6f}, "
          f"{counts['tensor_core']} tensor-core launches (= 44 x "
          f"{n_val_batches})", flush=True)

    # step time and memory: 30 rows, the literal 96, and batch 64 of plane 2
    t30, p30 = step_stats(cfg_path, base, card, dev, "config 3")
    remat = "false" if p30 * 3.2 < MP_MEM_LIMIT else "block"
    step_stats(cfg_path, base + ["data.batch_size=96", f"model.remat={remat}"],
               card, dev, f"config 3 at 32 events (96 rows; 30-row peak x 3.2 "
               f"= {p30 * 3.2:.1f} GiB {'<' if remat == 'false' else '>='} "
               f"{MP_MEM_LIMIT})")
    step_stats(os.path.join(WORK, "flagship.json"),
               [f"data.input_files={os.path.join(WORK, 'train.usef')}",
                "data.synthetic=false", "data.batch_size=64"],
               card, dev, "plane 2 at batch 64")

    # serving 3-plane events from the trained checkpoint
    ckpt = os.path.join(d, "ckpt", f"step_{MP_STEPS:08d}.npz")
    ev3 = generate_file(os.path.join(WORK, "mp_ana.usef"), MP_ANA_EVENTS,
                        seed=SEED + 32, shape=(S, S), planes=planes)
    argv = [cfg_path, "--checkpoint", ckpt, "--input", ev3, "--device", DEVICE]
    z, st, cnt = {}, {}, {}
    for mode, extra in (("sparse", []), ("dense", ["--export", "dense"])):
        z[mode], st[mode], cnt[mode], _ = serve_counted(
            fused_mod, infer, argv + extra,
            os.path.join(WORK, f"mp_{mode}.npz"), MP_ANA_EVENTS, 3,
            "tensor_core", batch_events=10)
    identical(z["dense"], z["sparse"], "3-plane dense vs sparse export")
    if set(np.unique(z["sparse"]["plane_id"])) != set(planes):
        raise AssertionError("3-plane export misses a plane")
    m, c, _ = counted(fused_mod, lambda: run_cli(
        infer, argv + ["--metrics-only"], tag="mp"))
    expect_launches(c, -(-MP_ANA_EVENTS // 10))
    if (m["n_events"] != MP_ANA_EVENTS
            or m["n_pixels"] != MP_ANA_EVENTS * 3 * S * S
            or abs(m["miou"] - st["sparse"]["miou"]) > 1e-9):
        raise AssertionError(f"3-plane --metrics-only {m}")
    print(f"[mp]      cli.infer on {MP_ANA_EVENTS} 3-plane events: sparse and "
          f"dense exports of {len(z['sparse']['scores'])} charge pixels "
          f"bit-equal, --metrics-only n_pixels {m['n_pixels']:.0f} (= "
          f"{MP_ANA_EVENTS} x 3 x {S}^2), miou {m['miou']!r}; tensor-core "
          f"launches {[cnt['sparse']['tensor_core'], cnt['dense']['tensor_core'], c['tensor_core']]}"
          f" (= 44 x 2 each)", flush=True)
    print(f"[mp]      phase 12 wall {time.time() - t0:.1f} s | {card}",
          flush=True)
    return t30, p30


# -- phases 13-14: tensor parallelism and the spatial halo exchange --------------

# configs/train_2d_512_tp.yaml at one data shard's shape (its global batch of
# 128 over data 4: 32 rows) with its model axis of 2, written out as FLAGSHIP
TP_CFG = {
    "model": {"dims": 2, "num_class": 3, "base_filters": 16, "depth": 5,
              "compute_dtype": "bfloat16", "pack": False},
    "data": {"image_size": 512, "batch_size": 32, "planes": [2],
             "weight_mode": "class_balance", "augment": True,
             "num_threads": 6, "backend": "auto"},
    "parallel": {"data": 1, "model": 2},
    "optim": {"lr": 1.4e-3, "schedule": "cosine", "decay_steps": 20000},
    "train": {"iterations": 20000, "summary_iter": 50,
              "checkpoint_iter": 1000, "val_iter": 500},
}
# configs/train_3d_192_sp.yaml at one data group's shape (its global batch
# of 8 over data 4: 2 volumes) with its spatial axis of 2; its pack: true
# trains packed, the halos exchanged in packed rows (parallel/halo.py)
SP_CFG = {
    "model": {"dims": 3, "num_class": 3, "base_filters": 16, "depth": 4,
              "compute_dtype": "bfloat16", "pack": True, "remat": "block",
              "head_dtype": "float32"},
    "data": {"image_size": 192, "batch_size": 2, "planes": [0],
             "weight_mode": "class_balance", "backend": "auto"},
    "parallel": {"data": 1, "spatial": 2},
    "optim": {"lr": 5.0e-4},
    "train": {"iterations": 10000},
}
MESH_STEPS = 4     # cli.train --distributed steps of a leg, then val_exact
SP_EVENTS = 16     # phase 14's training file, also its val_exact set
# The 3D legs hold the first step's loss (one state, one batch: the sharded
# computation itself) to DP_LOSS_RTOL and report the later ones. The
# class-balance weights of sparse 192^3 volumes give a few voxels most of
# the loss, so bf16 rounding moves the first loss by ~1e-3, and Adam's
# first step (lr * g / |g|) turns order noise near zero gradients into
# +-lr moves that grow from step to step. Phase 14's f32 leg shows the
# mechanism exact: its first loss is held to SP_F32_RTOL.
SP_F32_RTOL = 1e-5
SP_F32_STEPS = 2
PARALLEL_ONLY = False  # phases 1-2 and 13-14 alone (--parallel-only)
PACKED_ONLY = False    # phases 1-2 and 15 alone (--packed-only)


def state_digest(ts) -> str:
    """sha256 of a train state's params, BN state and Adam moments."""
    import hashlib

    h = hashlib.sha256()
    for t in (*ts.model.parameters(), *ts.model.buffers(),
              *ts.opt.mu.values(), *ts.opt.nu.values()):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def state_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in (
        *ts.model.parameters(), *ts.opt.mu.values(), *ts.opt.nu.values()))


def mesh_worker(mode, spec_path):
    """One rank of a phase 13 ('tp') or 14 ('sp') leg (``--dp-worker``):
    on the spec's mesh, train_step_light timed, its peak memory, its
    collectives per step (profiler) unless the spec says ``timed: false``,
    the gathered state saved by rank 0 and its digest; then cli.train
    --distributed, counted."""
    import torch.distributed as dist

    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.cli import train
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.ops.cuda import conv2d as fused_mod
    from uresnet_tpu_torch.parallel import mesh

    with open(spec_path) as f:
        spec = json.load(f)
    dev = mesh.init_distributed("cuda", backend=spec["backend"])
    rank = dist.get_rank()
    tr = Trainer(load_config(spec["cfg"], spec["overrides"] + [
        f"train.checkpoint_dir={spec['out']}_gathered"]), device=dev)
    m = tr.mesh
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "mesh": [m.data, m.spatial, m.model]}
    state = [tr.init_state()]
    batch = first_batch(tr)

    def step(_=None):
        state[0], metrics = tr.train_step_light(state[0], batch)
        return metrics

    if spec["timed"]:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["ms"] = time_ms(step, reps=2, warmup=1)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["ops"], out["kernels"], out["kernel_ms"] = collective_counts(
            step, reps=1, warmup=0)
    ts = state[0]
    out["state_bytes"] = state_bytes(ts)
    out["stem_w"] = list(ts.model.stem.conv.w.shape)
    out["ckpt"] = tr.save(ts, ts.opt.step)  # gathered; rank 0 writes
    out["digest"] = state_digest(tr.gather_state(ts))
    del state, batch, ts, tr
    torch.cuda.empty_cache()
    # the CLI last: it joins the live group and shuts it down at its end
    _, out["launches"], _ = counted(fused_mod, lambda: run_main(
        train, [spec["cfg"], *spec["overrides"], *spec["cli"], "--device",
                "cuda", "--distributed"], mode))
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def mesh_reference(cfg_path, overrides, n_data, dims, dev, steps):
    """One process on the rank-major concatenation of the ``n_data``
    shards' batches (the global batch whose rows the mesh's data indices
    take), ``steps`` steps: the logged losses, the peak memory of the
    steps, the param + moment bytes; and the trainer, for restores."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.data.loader import BatchLoader
    from uresnet_tpu_torch.engine.trainer import Trainer

    tr = Trainer(load_config(cfg_path, overrides + [
        "parallel.data=1", "parallel.spatial=1", "parallel.model=1"]),
        device=dev)
    ts, rows = tr.init_state(), []
    shards = [BatchLoader(tr.cfg.data, num_class=3, ndims=dims,
                          shard=(r, n_data)) for r in range(n_data)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for step in range(1, steps + 1):
        b = [s._make_batch() for s in shards]
        for x in b:
            x.pop("cursor")
        ts, m = tr.train_step(ts, tr.device_batch(
            {k: np.concatenate([x[k] for x in b]) for k in b[0]}))
        rows.append({"step": step, "loss": float(m["loss"])})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nbytes = state_bytes(ts)
    del ts
    torch.cuda.empty_cache()
    return rows, peak, nbytes, tr


def mesh_losses(got, want, what, rtol, held):
    """Per-step relative differences of two runs' logged losses (the same
    steps); raises if one of the first ``held`` steps (None: all) exceeds
    ``rtol``."""
    if [r["step"] for r in got] != [r["step"] for r in want]:
        raise AssertionError(f"{what}: logged steps {[r['step'] for r in got]}"
                             f" vs {[r['step'] for r in want]}")
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(got, want)]
    if not all(np.isfinite(r) and r <= rtol for r in rel[:held]):
        raise AssertionError(f"{what}: losses {[a['loss'] for a in got]} vs "
                             f"{[b['loss'] for b in want]} (rtol {rtol} on "
                             f"the first {held or len(rel)} steps)")
    return rel


def mesh_leg(mode, cfg_path, base, shape, backend, world, n_val, dims,
             fused_mod, dev, tag, steps=None, rtol=DP_LOSS_RTOL, timed=True):
    """One leg of phase 13 or 14: ``world`` ranks of ``mesh_worker`` on the
    mesh ``shape`` = (data, spatial, model) (gloo: all on cuda:0; nccl:
    one card each) against `mesh_reference`. Checks the losses (2D: every
    step, 3D: the first), the exactly-once validation (0 or 44 fused
    launches per local batch of its rows), the gathered checkpoint
    restored in one process (digest equal); returns the ranks' results and
    the reference's. ``timed=False``: the ranks skip their timed and
    profiled steps (an exactness leg)."""
    nd, ns, nm = shape
    steps = steps or MESH_STEPS
    name = tag.replace(" ", "_")
    d = os.path.join(WORK, name)
    over = base + [f"train.checkpoint_dir={d}/ckpt", f"train.log_dir={d}/log",
                   f"parallel.data={nd}", f"parallel.spatial={ns}",
                   f"parallel.model={nm}"]
    rows_per_data = SP_CFG["data"]["batch_size"] if mode == "sp" else 32
    over.append(f"data.batch_size={rows_per_data * nd}")
    spec = os.path.join(WORK, f"{name}_spec.json")
    with open(spec, "w") as f:
        json.dump({"cfg": cfg_path, "overrides": over, "backend": backend,
                   "out": os.path.join(WORK, name), "timed": timed,
                   "cli": ["train.summary_iter=1", "train.checkpoint_iter=0",
                           f"train.val_iter={steps}",
                           "train.val_exact=true",
                           "--iterations", str(steps)]}, f)
    res = spawn_ranks(mode, spec, world,
                      (lambda r: 0) if backend == "gloo" else (lambda r: r))
    for r in res:
        if (r["backend"] != backend or r["mesh"] != list(shape)
                or r["device"] != f"cuda:{0 if backend == 'gloo' else r['rank']}"):
            raise AssertionError(f"{tag}: rank {r['rank']} on {r['backend']} "
                                 f"{r['device']} mesh {r['mesh']}")
    ref_rows, ref_peak, ref_bytes, tr1 = mesh_reference(cfg_path, over, nd,
                                                        dims, dev, steps)
    rel = mesh_losses(log_rows(f"{d}/log"), ref_rows, f"{tag} vs one process",
                      rtol, 1 if dims == 3 else None)
    val = log_rows(f"{d}/log", "val")
    if [v["n_events"] for v in val] != [n_val]:
        raise AssertionError(f"{tag} val_exact {val}")
    per_batch = 0 if dims == 3 else 44
    n_batches = -(-(-(-n_val // world)) // rows_per_data)
    for r in res:
        expect_launches(r["launches"], n_batches, per_batch=per_batch)
    digests = {r["digest"] for r in res}
    whole = tr1.restore(res[0]["ckpt"])[0]
    if digests != {state_digest(whole)}:
        raise AssertionError(f"{tag}: rank 0's checkpoint restored in one "
                             f"process differs from the gathered state")
    return res, rel, val[0], ref_peak, ref_bytes, n_batches


def held(rel, dims, rtol=DP_LOSS_RTOL):
    """The per-step loss differences of a leg, with what was held."""
    what = "the first step's" if dims == 3 else "every step's"
    return (f"{[f'{r:.2e}' for r in rel]} relative ({what} held to {rtol}"
            f"{'; the later ones Adam-amplified rounding' if dims == 3 else ''})")


def sp_f32_leg(cfg_path, base, fused_mod, dev, card):
    """Phase 14's exactness check: the same leg at compute_dtype float32
    (true f32, f32 head), SP_F32_STEPS steps, in both layouts: packed as
    shipped (the halos in packed rows) and canonical (``model.pack=false``:
    the canonical convs' halos, the transposed conv's among them); each
    first loss within SP_F32_RTOL of one process. Untimed: the ranks take
    no steps but the CLI's."""
    from uresnet_tpu_torch import load_config

    cfg = json.loads(json.dumps(SP_CFG))
    cfg["model"].update(compute_dtype="float32", head_dtype=None)
    path = os.path.join(WORK, "sp_f32.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    for layout, over in (("packed as shipped", []),
                         ("canonical", ["model.pack=false"])):
        layout_line(load_config(path, over), "sp")
        t0 = time.time()
        _, rel, _, _, _, _ = mesh_leg(
            "sp", path, base + over, (1, 2, 1), "gloo", 2, SP_EVENTS, 3,
            fused_mod, dev, f"sp f32 {layout.split()[0]}",
            steps=SP_F32_STEPS, rtol=SP_F32_RTOL, timed=False)
        print(f"[sp]      the same in true f32, {layout} (exactness): losses "
              f"against one process {held(rel, 3, SP_F32_RTOL)}; leg wall "
              f"{time.time() - t0:.1f} s | {card}", flush=True)


def gloo_leg(mode, cfg, cfg_path, base, shape, form, n_events, dims,
             fused_mod, dev, card):
    """A phase 13-14 leg as two gloo ranks on cuda:0, printed."""
    res, rel, val, ref_peak, ref_bytes, nb = mesh_leg(
        mode, cfg_path, base, shape, "gloo", 2, n_events, dims, fused_mod,
        dev, f"{mode} gloo")
    S, B = cfg["data"]["image_size"], cfg["data"]["batch_size"]
    what = ("the model's channels" if mode == "tp" else
            f"D ({S // 2} of {S} planes a rank), remat block")
    print(f"[{mode}]      {form} on one card, two ranks through gloo between "
          f"CUDA tensors, splitting {what}: {MESH_STEPS} cli.train "
          f"--distributed steps at batch {B}, {S}^{dims}, losses against one "
          f"process {held(rel, dims)}; val_exact over "
          f"{val['n_events']:.0f} events on the gathered state, the file over "
          f"both ranks: fused launches per rank "
          f"{[r['launches']['tensor_core'] for r in res]} (= "
          f"{0 if dims == 3 else 44} x {nb}); rank 0's checkpoint restores in "
          f"one process equal to the gathered state (stem kernel per rank "
          f"{res[0]['stem_w']})", flush=True)
    print(f"[{mode}]      per rank: peak "
          f"{[round(r['peak_gib'], 3) for r in res]} GiB against one "
          f"process's {ref_peak:.3f} GiB at the same batch; params + Adam "
          f"moments {[r['state_bytes'] for r in res]} bytes against "
          f"{ref_bytes}; collectives per step (profiler) {res[0]['ops']}; "
          f"train_step_light {[round(r['ms'], 2) for r in res]} ms/step "
          f"(through the host: a correctness run) | {card}", flush=True)


def nccl_leg(mode, cfg_path, base, shape, n_events, dims, fused_mod, dev,
             card, n_cards):
    """A phase 13-14 leg on NCCL, one card a rank: data 2 on 4 cards, data
    1 on 2-3; printed."""
    w = 4 if n_cards >= 4 else 2
    shape = (w // 2,) + tuple(shape[1:])
    res, rel, val, ref_peak, _, _ = mesh_leg(
        mode, cfg_path, base, shape, "nccl", w, n_events, dims, fused_mod,
        dev, f"{mode} nccl")
    print(f"[{mode}]      NCCL across {w} cards, mesh (data, spatial, model) "
          f"{shape}: ran; losses against one process on the rank-major "
          f"batch {held(rel, dims)}; val_exact {val['n_events']:.0f} events; peak "
          f"per rank {[round(r['peak_gib'], 3) for r in res]} GiB (one "
          f"process {ref_peak:.3f}); params + Adam moments per rank "
          f"{[r['state_bytes'] for r in res]} bytes; collectives per step "
          f"{res[0]['ops']}, NCCL kernels {res[0]['kernels']} "
          f"({res[0]['kernel_ms']:.3f} ms); "
          f"{[round(r['ms'], 2) for r in res]} ms/step | {card}", flush=True)


def parallel_phase(fused_mod, card, dev):
    """Phases 13 (tp) and 14 (sp): see the module docstring."""
    from uresnet_tpu_torch import generate_file, load_config

    n_cards = torch.cuda.device_count()
    for mode, cfg, events, n_events, dims, shape, form in (
            ("tp", TP_CFG, "train.usef", TRAIN_EVENTS, 2, (1, 1, 2),
             "data 1 x model 2"),
            ("sp", SP_CFG, "sp_train.usef", SP_EVENTS, 3, (1, 2, 1),
             "data 1 x spatial 2")):
        t0 = time.time()
        torch.cuda.empty_cache()
        cfg_path = os.path.join(WORK, f"{mode}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        layout_line(load_config(cfg_path), mode)
        S = cfg["data"]["image_size"]
        path = os.path.join(WORK, events)
        if not os.path.exists(path):  # phase 7 wrote the 2D one
            generate_file(path, n_events, seed=SEED + 41, shape=(S,) * dims,
                          planes=tuple(cfg["data"]["planes"]))
        base = [f"data.input_files={path}", "data.synthetic=false"]
        if PARALLEL_ONLY and n_cards >= 2:
            print(f"[{mode}]      {form} as two gloo ranks on one card: not "
                  f"run (--parallel-only on {n_cards} cards runs the NCCL "
                  f"legs alone)", flush=True)
        else:
            gloo_leg(mode, cfg, cfg_path, base, shape, form, n_events, dims,
                     fused_mod, dev, card)
            if mode == "sp":
                sp_f32_leg(cfg_path, base, fused_mod, dev, card)
        if n_cards < 2:
            print(f"[{mode}]      NCCL across cards (data 2 x "
                  f"{form.split(' x ')[1]} on 4 cards, data 1 on 2): not run "
                  f"({n_cards} device)", flush=True)
        else:
            nccl_leg(mode, cfg_path, base, shape, n_events, dims, fused_mod,
                     dev, card, n_cards)
        print(f"[{mode}]      phase {13 if mode == 'tp' else 14} wall "
              f"{time.time() - t0:.1f} s | {card}", flush=True)


# -- phase 15: the packed layout against the canonical one ------------------------

PACKED_CHECK_B = 4      # the card correctness check: flagship width, 512^2
PACKED_REL = 1e-4       # packed vs canonical: f32 logits of the max, f64 gradients of each leaf's
PACKED_LOSS_RTOL = 1e-2  # bf16 first-step loss, packed vs canonical
# config 2's legs: the shipped layout, canonical, and the packed loss
PACKED_LEGS_2D = (("packed", []), ("canonical", ["model.pack=false"]),
                  ("packed loss", ["train.packed_loss=true"]))
PACKED_LEGS_3D = (("packed", []), ("canonical", ["model.pack=false"]))
# profiler kernel-name fragments of the costs the packed layout moves: the
# f32 weight-gradient convs, cuDNN's tensor conversions, and the copies
# (the relayouts, the casts and the skip concats)
PACKED_KERNEL_GROUPS = (("wgrad", ("wgrad",)), ("convertTensor", ("converttensor",)),
                        ("copies", ("copy", "catarray")))


def packed_check(cfg_path, card, dev):
    """Phase 15a: at the flagship's width and depth, 512^2, batch 4, the
    packed train forward against the canonical one on the same weights:
    in f32 (true f32 convs, the packing's matmuls with TF32 off) the train
    and eval logits within PACKED_REL of the max; in float64 each
    parameter's gradient of the weighted xent within PACKED_REL of its
    leaf's max.

    The gradients are held in float64 because in f32 they are not
    continuous in the rounding at this depth and size: a ReLU whose input
    lies within f32 noise of 0 flips between two summation orders, and its
    gradient with it, so two f32 runs of the same net differ by up to ~1e-1
    in some leaves (PERF.md). A control then plants a backward
    fault confined to one small leaf (`stem_grad_fault`) and requires the
    same check to flag that leaf; it prints what the fault reads there and
    over all leaves together. The float64 check feeds f32 logits to the
    loss: the forward casts its logits to f32, as the JAX forward does."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.engine.losses import weighted_softmax_xent
    from uresnet_tpu_torch.models.uresnet import UResNet

    cfg = load_config(cfg_path, ["model.compute_dtype=float32"])
    S, B = cfg.data.image_size, PACKED_CHECK_B
    gx = torch.Generator().manual_seed(SEED + 51)
    x = torch.rand(B, S, S, 1, generator=gx)
    x = (x * (x > 0.9)).to(dev)
    label = torch.randint(0, 3, (B, S, S), generator=gx).to(dev)
    weight = (torch.rand(B, S, S, generator=gx) + 0.5).to(dev)
    g = torch.Generator().manual_seed(SEED + 50)
    ref = UResNet(cfg.model, generator=g)
    randomize_bn(ref, g)

    def model(pack, dtype):
        m = UResNet(dataclasses.replace(cfg.model, pack=pack,
                                        compute_dtype=dtype),
                    generator=torch.Generator().manual_seed(SEED + 50))
        m.load_state_dict(ref.state_dict())
        m.to(dev)
        return m.double() if dtype == torch.float64 else m

    logits = {}
    with torch.no_grad():
        for pack in (True, False):
            m = model(pack, "float32")
            logits[pack] = (m(x, train=True)[0], m(x, train=False)[0])
            del m
    d_logits = rel_err(logits[True][0], logits[False][0])
    d_eval = rel_err(logits[True][1], logits[False][1])
    del logits

    def grads(pack, fault=False):
        m = model(pack, torch.float64)
        with stem_grad_fault(m) if fault else contextlib.nullcontext():
            lg, _ = m(x.double(), train=True)
        loss = weighted_softmax_xent(lg, label, weight)
        params = dict(m.named_parameters())
        return dict(zip(params, torch.autograd.grad(loss,
                                                    list(params.values()))))

    gc = grads(False)
    leaf = {k: rel_err(v, gc[k]) for k, v in grads(True).items()}
    worst = max(leaf, key=leaf.get)
    if max(d_logits, d_eval, leaf[worst]) > PACKED_REL:
        raise AssertionError(
            f"packed vs canonical: f32 logits {d_logits:.3e}, eval "
            f"{d_eval:.3e}; f64 gradient of {worst} {leaf[worst]:.3e} of its "
            f"max (limit {PACKED_REL})")
    gf = grads(True, fault=True)
    bad = {k: rel_err(v, gc[k]) for k, v in gf.items()}
    flagged = sorted(k for k, v in bad.items() if v > PACKED_REL)
    if flagged != ["stem.conv.w"]:
        raise AssertionError(f"the planted stem fault flags {flagged} "
                             f"(readings {bad['stem.conv.w']:.3e} there)")
    l2 = (sum(((gf[k] - gc[k]) ** 2).sum() for k in gc)
          / sum((gc[k] ** 2).sum() for k in gc)).sqrt().item()
    print(f"[packed]  the flagship width and depth, {S}^2, batch {B}: "
          f"packed vs canonical f32 logits (TF32 off) train {d_logits:.3e}, "
          f"eval {d_eval:.3e} of the max; float64 gradients of the "
          f"{len(leaf)} leaves, worst {worst} {leaf[worst]:.3e} of its max "
          f"(limit {PACKED_REL} each); control, a backward fault in the "
          f"stem's packing alone: flags {flagged} at "
          f"{bad['stem.conv.w']:.3e}, the other leaves at most "
          f"{max(v for k, v in bad.items() if k != 'stem.conv.w'):.3e}, all "
          f"leaves together {l2:.3e} relative L2 | {card}", flush=True)
    del ref, gc, gf
    torch.cuda.empty_cache()


@contextlib.contextmanager
def stem_grad_fault(model):
    """The packed forward of ``model`` with a planted backward fault: the
    stem's packed kernel keeps its value but takes its gradient through
    the kernel with input and output phases transposed (the 0/1 table's
    p' and p swapped), so only ``stem.conv.w``'s gradient is wrong."""
    from uresnet_tpu_torch.models import packed

    pack_same_w = packed._pack_same_w

    def faulty(w, dims, *args):
        wp = pack_same_w(w, dims, *args)
        if w is not model.stem.conv.w:
            return wp
        k, ci, co = wp.shape[:dims], w.shape[-2], w.shape[-1]
        P = wp.shape[-1] // co
        wt = wp.reshape(k + (P, ci, P, co)).transpose(dims, dims + 2)
        wt = wt.reshape(wp.shape)
        return wt + (wp - wt).detach()

    packed._pack_same_w = faulty
    try:
        yield
    finally:
        packed._pack_same_w = pack_same_w


def packed_legs(cfg_path, overrides, legs, card, dev, tag, unit, reps):
    """train_step_light of each leg (its overrides) from one seeded initial
    state on one sparse batch, timed in turns (legs, then reversed) with
    CUDA events, median of ``reps`` per turn; per leg the first step's
    loss, ms/step, rate, peak GiB and the layers. Returns {leg: stats}."""
    from uresnet_tpu_torch import load_config
    from uresnet_tpu_torch.engine.trainer import Trainer

    trs, states, batch, res = {}, {}, None, {}
    for name, extra in legs:
        tr = Trainer(load_config(cfg_path, overrides + extra), device=dev)
        layout_line(tr.cfg, tag)
        trs[name] = tr
        states[name] = [tr.init_state()]
        if batch is None:
            batch = first_batch(tr)
        states[name][0], m = tr.train_step_light(states[name][0], batch)
        res[name] = {"loss0": float(m["loss"]), "ms": [], "peak": 0.0}
    for name, _ in legs + legs[::-1]:
        tr, st = trs[name], states[name]

        def step(_=None, tr=tr, st=st):
            st[0], m = tr.train_step_light(st[0], batch)
            return m

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res[name]["ms"].append(time_ms(step, reps=reps, warmup=2))
        res[name]["peak"] = max(res[name]["peak"],
                                torch.cuda.max_memory_allocated() / 2 ** 30)
    B = next(iter(trs.values())).cfg.data.batch_size
    for name, _ in legs:
        r = res[name]
        if not np.isfinite(r["loss0"]):
            raise AssertionError(f"{tag} {name}: first loss {r['loss0']}")
        r["layers"] = layer_times(trs[name], states[name][0], batch, card,
                                  reps=3, tag=tag)
        print(f"[{tag}]{' ' * (8 - len(tag))}{name}: {r['ms']} ms/step in turns "
              f"= {[round(B / t * 1e3, 3) for t in r['ms']]} {unit}/s, peak "
              f"{r['peak']:.3f} GiB, first-step loss {r['loss0']:.6f}; forward "
              f"{r['layers']['forward']:.2f} ms, backward "
              f"{r['layers']['backward']:.2f} ms | {card}", flush=True)
    ref = res[legs[0][0]]["loss0"]
    for name, _ in legs[1:]:
        rel = abs(res[name]["loss0"] - ref) / abs(ref)
        if rel > PACKED_LOSS_RTOL:
            raise AssertionError(f"{tag} {name}: first-step loss "
                                 f"{res[name]['loss0']} vs {ref} (rtol "
                                 f"{PACKED_LOSS_RTOL})")
        res[name]["loss_rel"] = rel
    return res, trs, states, batch


def packed_profile(trs, states, batch, card, tag, legs):
    """3 steps of each leg in ``legs`` under torch.profiler: the top
    kernels, and the f32 weight gradients, convertTensor and copies
    summed."""
    groups = {}
    for name in legs:
        tr = trs[name]
        st = states[name]

        def step(_=None, tr=tr, st=st):
            st[0], m = tr.train_step_light(st[0], batch)
            return m

        per = profile_forwards({f"{tag} {name} train step": step}, None,
                               os.path.join(WORK, "profile.txt"), card,
                               unit="step", append=True, top=12)
        per = next(iter(per.values()), {})
        groups[name] = {g: sum(ms for k, ms in per.items()
                               if any(f in k.lower() for f in frags))
                        for g, frags in PACKED_KERNEL_GROUPS}
        print(f"[packed]  {tag} {name}: per step "
              + ", ".join(f"{g} {ms:.3f} ms" for g, ms in groups[name].items())
              + f" | {card}", flush=True)
    return groups


def level0_wgrad(card, dev):
    """The level-0 f32 weight gradient of one 16 -> 16 3x3x3 conv of config
    4 at 192^3, batch 1, as the train step takes it (ops/conv.py
    _ConvF32WGrad: bf16 x and g upcast, TF32 conv), canonical (192^3 x 16)
    against packed (96^3 x 128, the packed kernel's gradient then through
    the packing): ms per conv, median of 5."""
    from uresnet_tpu_torch.ops.conv import conv_general
    from uresnet_tpu_torch.ops.pack import pack_weight_conv, space_to_depth

    S, C = CONFIG4["data"]["image_size"], CONFIG4["model"]["base_filters"]
    gx = torch.Generator(device=dev).manual_seed(SEED + 52)
    x = torch.randn(1, S, S, S, C, generator=gx, device=dev).bfloat16()
    w = (torch.randn(3, 3, 3, C, C, generator=gx, device=dev) * 0.05
         ).requires_grad_()
    out = {}
    for name, xin, fn in (("canonical", x, lambda: w),
                          ("packed", space_to_depth(x, dims=3),
                           lambda: pack_weight_conv(w, 3))):
        y = conv_general(xin, fn(), stride=1, compute_dtype=torch.bfloat16)
        g = torch.randn(y.shape, generator=gx, device=dev).bfloat16()
        out[name] = time_ms(lambda: torch.autograd.grad(y, [w], g,
                                                        retain_graph=True))
        del y, g
    print(f"[packed]  3d level-0 f32 weight gradient of one {C}->{C} conv at "
          f"{S}^3 (cast + TF32 conv, as the step takes it): canonical "
          f"{out['canonical']:.3f} ms, packed ({S // 2}^3 x {8 * C}, 8x the "
          f"MACs) {out['packed']:.3f} ms | {card}", flush=True)
    del x, w
    torch.cuda.empty_cache()
    return out


def packed_phase(fused_mod, card, dev):
    """Phase 15 (packed): the packed layout on the card (models/packed.py;
    no hand kernel: cuDNN's convs, torch's relayout copies and the packing
    matmuls, 0 fused launches) — a. the f32 and f64 check at the flagship
    width; b. config 2's train_step_light at batch 32, 512^2 in three legs
    (shipped packed, canonical, packed loss) in turns, the bf16 first-step
    losses within PACKED_LOSS_RTOL; c. config 4's at batch 1, 192^3,
    packed against canonical; for both configs the profiler's top kernels,
    the weight gradients, convertTensor and copies of each layout; one
    level-0 weight gradient of config 4 in each layout. The SP leg in
    packed f32 is phase 14's f32 leg."""
    from uresnet_tpu_torch import generate_file

    t0 = time.time()
    torch.cuda.empty_cache()
    cfg_path = os.path.join(WORK, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(FLAGSHIP, f)
    packed_check(cfg_path, card, dev)
    S = FLAGSHIP["data"]["image_size"]
    train_file = os.path.join(WORK, "train.usef")  # phase 7's
    if not os.path.exists(train_file):
        generate_file(train_file, FLAGSHIP["data"]["batch_size"], seed=SEED + 1,
                      shape=(S, S), planes=tuple(FLAGSHIP["data"]["planes"]))
    (r2, trs, states, batch), counts, _ = counted(fused_mod, lambda: packed_legs(
        cfg_path, [f"data.input_files={train_file}", "data.synthetic=false"],
        PACKED_LEGS_2D, card, dev, "packed", "img", 5))
    expect_launches(counts, 1, per_batch=0)
    groups2 = packed_profile(trs, states, batch, card, "2d",
                             ("packed", "canonical"))
    del trs, states, batch
    torch.cuda.empty_cache()
    v_path = os.path.join(WORK, "config4.json")
    with open(v_path, "w") as f:
        json.dump(CONFIG4, f)
    v_file = os.path.join(WORK, "vol_train.usef")  # phase 9's
    if not os.path.exists(v_file):
        generate_file(v_file, 2, seed=SEED + 11, shape=(192,) * 3, planes=(0,))
    (r4, trs, states, batch), counts, _ = counted(fused_mod, lambda: packed_legs(
        v_path, [f"data.input_files={v_file}", "data.synthetic=false"],
        PACKED_LEGS_3D, card, dev, "packed", "vol", 5))
    expect_launches(counts, 1, per_batch=0)
    groups = packed_profile(trs, states, batch, card, "3d",
                            [name for name, _ in PACKED_LEGS_3D])
    del trs, states, batch
    torch.cuda.empty_cache()
    w0 = level0_wgrad(card, dev)
    summary = {
        "config2": {k: {"ms": v["ms"], "peak_gib": round(v["peak"], 3),
                        "loss0": v["loss0"], "forward_ms": v["layers"]["forward"],
                        "backward_ms": v["layers"]["backward"],
                        **groups2.get(k, {})}
                    for k, v in r2.items()},
        "config4": {k: {"ms": v["ms"], "peak_gib": round(v["peak"], 3),
                        "loss0": v["loss0"], "forward_ms": v["layers"]["forward"],
                        "backward_ms": v["layers"]["backward"], **groups[k]}
                    for k, v in r4.items()},
        "level0_wgrad_ms": w0}
    with open(os.path.join(WORK, "packed.json"), "w") as f:
        json.dump(summary, f)
    ratio2 = np.median(r2["packed"]["ms"]) / np.median(r2["canonical"]["ms"])
    ratio4 = np.median(r4["packed"]["ms"]) / np.median(r4["canonical"]["ms"])
    print(f"[packed]  packed / canonical ms per step: config 2 {ratio2:.4f}, "
          f"config 4 {ratio4:.4f}; first-step bf16 losses against the packed "
          f"leg: {', '.join(f'{k} {v['loss_rel']:.2e}' for k, v in {**r2, **r4}.items() if 'loss_rel' in v)}"
          f" (limit {PACKED_LOSS_RTOL}); fused launches over every leg "
          f"{counts} (0: the JAX packed path calls no Pallas kernel either); "
          f"phase 15 wall "
          f"{time.time() - t0:.1f} s | {card}", flush=True)


# -- phase 16: the benchmark tool and the flagship reproducer --------------------

# the keys bench.py prints for a train step (the forward's lack the note)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "useful_tflops",
              "raw_tflops", "baseline_note"}
# (tag, bench arguments, keys): the default 2D train step (512^2, batch 32,
# packed), the eval forward, config 4's step at 192^3
BENCH_RUNS = (("train", ["--steps", "10"], BENCH_KEYS),
              ("infer", ["--infer", "--steps", "10"],
               BENCH_KEYS - {"baseline_note"}),
              ("3d", ["--dims", "3", "--steps", "5"], BENCH_KEYS))
# the bench's 2D train ms/step against phase 7's train_step_light median:
# the same packed step on a dense batch (phase 7's densifies a sparse one)
BENCH_STEP_REL = 0.15
# the flagship reproducer at reduced depth: the flagship config itself
# (the YAML, read by PyYAML) at its width, depth and batch, 30 iterations,
# 64 training and 64 held-out events
REPRO = dict(config="configs/train_2d_512.yaml", iterations=30,
             train_events=64, heldout_events=64, name="chip_smoke_repro")


def bench_runs(card, t_step7):
    """Phase 16a: ``python -m uresnet_tpu_torch.tools.bench`` in its three
    modes, each one JSON line with bench.py's keys; the 2D train rate held
    to phase 7's step."""
    out = {}
    for tag, argv, keys in BENCH_RUNS:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "uresnet_tpu_torch.tools.bench", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"bench {argv} exited {proc.returncode}:\n"
                               f"{proc.stderr[-4000:]}")
        lines = proc.stdout.splitlines()
        if len(lines) != 1:
            raise AssertionError(f"bench {argv} printed {len(lines)} lines: "
                                 f"{proc.stdout[-2000:]}")
        out[tag] = rec = json.loads(lines[0])
        if set(rec) != keys or not rec["value"] > 0:
            raise AssertionError(f"bench {argv}: {rec} (keys {sorted(keys)})")
        print(f"[bench]   {' '.join(argv)}: {lines[0]} ({time.time() - t0:.1f} "
              f"s wall) | {card}", flush=True)
    B = FLAGSHIP["data"]["batch_size"]
    ms = B / out["train"]["value"] * 1e3
    rel = ms / t_step7 - 1
    print(f"[bench]   2D train {ms:.2f} ms/step against phase 7's "
          f"train_step_light {t_step7:.2f} ms: {rel:+.2%} (limit "
          f"{BENCH_STEP_REL:.0%}) | {card}", flush=True)
    if abs(rel) > BENCH_STEP_REL:
        raise AssertionError(f"bench 2D train {ms:.2f} ms/step is {rel:+.2%} "
                             f"off phase 7's {t_step7:.2f} ms")


def repro_run(card):
    """Phase 16b: the port's reproduce_flagship in-process, at REPRO's
    iterations and events: exit 0, its OK line, stage 2's and stage 4's
    ``metrics:`` lines identical; each stage's wall time. What it wrote
    under ckpt/, log/ and artifacts/ is removed."""
    from uresnet_tpu_torch.tools import reproduce_flagship as rf

    name = REPRO["name"]
    rf.FLAGSHIPS["chip_smoke"] = dict(REPRO)
    parents = [os.path.join(rf.REPO, d) for d in ("ckpt", "log", "artifacts")]
    new_parents = [d for d in parents if not os.path.exists(d)]
    run, walls = rf.run, []

    def timed(cmd, **kw):
        t0 = time.time()
        result = run(cmd, **kw)
        walls.append((cmd[2], time.time() - t0))  # [python, -m, module, ...]
        return result

    rf.run = timed
    try:
        out = run_main(rf, ["chip_smoke"], "repro")
    finally:
        rf.run = run
        del rf.FLAGSHIPS["chip_smoke"]
        for d in parents[:2]:
            shutil.rmtree(os.path.join(d, name), ignore_errors=True)
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(parents[2], f"{name}_bf16.npz"))
        for d in new_parents:
            if os.path.isdir(d) and not os.listdir(d):
                os.rmdir(d)
    metrics = [ln for ln in out.splitlines() if ln.startswith("metrics: ")]
    if (len(metrics) != 2 or metrics[0] != metrics[1]
            or f"OK: artifacts/{name}_bf16.npz" not in out):
        raise AssertionError(f"reproduce_flagship: metrics lines {metrics}")
    stats = ast.literal_eval(metrics[0].split(": ", 1)[1])
    if stats["n_events"] != REPRO["heldout_events"]:
        raise AssertionError(f"held-out n_events {stats['n_events']}")
    for i, (what, wall) in enumerate(walls, 1):
        print(f"[repro]   stage {i} {what}: {wall:.1f} s wall", flush=True)
    print(f"[repro]   {REPRO['iterations']} iterations at the flagship's "
          f"width, depth and batch: stages 2 and 4 print the same metrics "
          f"(miou {stats['miou']:.6f}, n_events {stats['n_events']:.0f}) | "
          f"{card}", flush=True)


def tools_phase(card, t_step7):
    """Phase 16: the benchmark tool and the flagship reproducer."""
    t0 = time.time()
    torch.cuda.empty_cache()  # the tools' processes need the card's memory
    bench_runs(card, t_step7)
    repro_run(card)
    print(f"[tools]   phase 16 wall {time.time() - t0:.1f} s | {card}",
          flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"[device]  {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)

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
        if "registers" in line or "spill" in line or "wgmma" in line:
            print(f"[build]   ptxas: {line.strip()}", flush=True)
        elif line.startswith("nvcc "):  # each source's compile, run at once
            print(f"[build]   {line}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    if PARALLEL_ONLY:
        parallel_phase(fused_mod, card, dev)
        return
    if PACKED_ONLY:
        packed_phase(fused_mod, card, dev)
        return
    cfg_path = os.path.join(WORK, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(FLAGSHIP, f)
    cfg = load_config(cfg_path)
    g = torch.Generator().manual_seed(SEED)
    model = UResNet(cfg.model, generator=g)
    randomize_bn(model, g)
    model.to(dev)
    serve = build_serving_fn(cfg, model)
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    serve32 = build_serving_fn(cfg32, model)

    # 3. the kernels vs plain (f32 also vs float64); times at the main
    # paths' shapes; the channel-tail route's run; v1
    tc_rec, f16_rec, f32_worst = kernel_phase(fused_mod, fold, serve, serve32,
                                              cfg, dev, card)
    f32_rec = f32_phase(fused_mod, fold, serve32, cfg, dev, card, f32_worst)
    tail_rec = ragged_phase(fused_mod, cfg, dev, card)
    v1_rec = v1_phase(fused_mod, cfg, dev)
    # 3b. train BN's kernels
    bn_rec = bn_phase(dev, card)
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
    z, stats_auto, counts, wall = serve_counted(
        fused_mod, infer, argv, os.path.join(WORK, "scores_auto.npz"),
        N_EVENTS, cfg.model.num_class, "tensor_core", batch_events=batch_events)
    tc_rec["launches"] = counts["tensor_core"]
    print(f"[serve]   {N_EVENTS} events, {len(z['scores'])} charge pixels "
          f"exported, kernel launches {counts} (= 44 per batch, tensor-core "
          f"kernel), {wall:.2f} s wall incl. checkpoint restore, streamed "
          f"sparse export", flush=True)

    # 4b. the f32 serving path (f32 tensor-core kernel), held to the bf16 one
    z32, _, counts, wall = serve_counted(
        fused_mod, infer, argv + ["model.compute_dtype=float32"],
        os.path.join(WORK, "scores_f32.npz"), N_EVENTS, cfg.model.num_class,
        "f32_tensor_core", batch_events=batch_events)
    f32_rec["launches"] = counts["f32_tensor_core"]
    d, agree = agreement(z32, z, "f32 vs bf16 kernel path")
    print(f"[serve32] {N_EVENTS} events at compute_dtype float32: kernel "
          f"launches {counts} (= 44 per batch, f32 tensor-core kernel), {wall:.2f} s "
          f"wall; vs the bf16 kernel path: max softmax diff {d:.3e}, argmax "
          f"agreement {agree:.5f}", flush=True)

    # 4c. the f16 serving path (the f16 tensor-core kernel), held to the
    # bf16 one
    z16, _, counts, wall = serve_counted(
        fused_mod, infer, argv + ["model.compute_dtype=float16"],
        os.path.join(WORK, "scores_f16.npz"), N_EVENTS, cfg.model.num_class,
        "f16_tensor_core", batch_events=batch_events)
    f16_rec["launches"] = counts["f16_tensor_core"]
    d, agree = agreement(z16, z, "f16 vs bf16 kernel path")
    print(f"[serve16] {N_EVENTS} events at compute_dtype float16: kernel "
          f"launches {counts} (= 44 per batch, f16 tensor-core kernel), {wall:.2f} s "
          f"wall; vs the bf16 kernel path: max softmax diff {d:.3e}, argmax "
          f"agreement {agree:.5f}", flush=True)

    # 5. whole forward: kernel vs plain (cuDNN) path
    zx, _, _, _ = serve_counted(
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
    # the f16 forward on its kernel; the f32 forward on the f32 tensor-core
    # kernel and on the cuDNN true-f32 path
    serve16 = build_serving_fn(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float16")), model)
    t16 = time_ms(lambda: serve16(x), reps=7)
    print(f"[forward] B={B} {S}^2 f16 forward+softmax: kernel path "
          f"{t16:.2f} ms = {B / t16 * 1e3:.1f} img/s (bf16 {t_auto:.2f} ms); "
          f"f16 kernel {f16_rec['ms']:.2f} ms per forward (bf16 {k_ms:.2f}) | "
          f"{card}", flush=True)
    serve32_xla = build_serving_fn(dataclasses.replace(cfg32, model=dataclasses.replace(
        cfg32.model, kernel_backend="xla")), model)
    t32 = time_ms(lambda: serve32(x), reps=5)
    t32_xla = time_ms(lambda: serve32_xla(x), reps=5)
    print(f"[forward] B={B} {S}^2 f32 forward+softmax: f32 tensor-core kernel "
          f"path {t32:.2f} ms = {B / t32 * 1e3:.1f} img/s; cudnn true-f32 path "
          f"{t32_xla:.2f} ms = {B / t32_xla * 1e3:.1f} img/s; the bf16 kernel "
          f"path {B / t_auto * 1e3:.1f} img/s; f32 kernel {f32_rec['ms']:.2f} ms "
          f"per forward | {card}", flush=True)

    # 6. where the forward's time goes
    profile_forwards({"kernel path": serve, "cudnn path": serve_xla,
                      "f32 kernel path": serve32}, x,
                     os.path.join(WORK, "profile.txt"), card)

    # 7. the training path; 7b. the f32 weight gradient on the card
    t_step7, _, bn_rec["launches"] = train_phase(cfg_path, cfg, fused_mod,
                                                 card, dev)
    dw_phase(dev)

    # 8. the analysis surface on phase 4's checkpoint and events
    ana_phase(cfg_path, cfg, ckpt, events, fused_mod, card, dev)

    # 9. BASELINE config 4: the 3D U-ResNet at 192^3, no fused launch
    bn_rec["launches"] += vol_phase(fused_mod, card, dev)

    # 10. the serving artifact and the checkpoint lifecycle
    artifact_phase(cfg_path, cfg, events, fused_mod, card, dev, t_auto)

    # 11. data parallelism: world 1 on NCCL, two ranks through gloo
    dp_phase(fused_mod, card, dev, t_step7)

    # 12. BASELINE config 3, multi-plane
    mp_phase(fused_mod, card, dev)

    # 13-14. tensor parallelism and the spatial halo exchange
    parallel_phase(fused_mod, card, dev)

    # 15. the packed layout against the canonical one
    packed_phase(fused_mod, card, dev)

    # 16. the benchmark tool and the flagship reproducer
    tools_phase(card, t_step7)

    leaked = sorted(m for m in sys.modules if m in ("jax", "uresnet_tpu")
                    or m.startswith(("jax.", "jaxlib", "uresnet_tpu.")))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    src = "uresnet_tpu_torch/csrc/conv2d.cu"
    src32 = "uresnet_tpu_torch/csrc/conv2d_f32tc.cu"
    kernels = [
        dict(name="fused_conv3x3_bn_relu_v2 (tensor-core kernel, bf16)",
             replaces="uresnet_tpu/ops/pallas/conv2d.py:130", source=src, **tc_rec),
        dict(name="fused_conv3x3_bn_relu_v2 (tensor-core kernel, f16)",
             replaces="uresnet_tpu/ops/pallas/conv2d.py:130", source=src, **f16_rec),
        dict(name="fused_conv3x3_bn_relu_v2 (f32 tensor-core kernel, 3xTF32)",
             replaces="uresnet_tpu/ops/pallas/conv2d.py:130", source=src32, **f32_rec),
        dict(name="fused_conv3x3_bn_relu_v2 (tensor-core kernels' channel tails: "
                  "bf16 24->40, f32 20->36)",
             replaces="uresnet_tpu/ops/pallas/conv2d.py:130",
             source=f"{src}, {src32}", **tail_rec),
        dict(name="fused_conv3x3_bn_relu",
             replaces="uresnet_tpu/ops/pallas/conv2d.py:182", source=src, **v1_rec),
        dict(name="train BN: stats, apply, grad_reduce, grad_input (bf16, "
                  "the three BN_CASES)",
             replaces="none (XLA-generated train BN, uresnet_tpu/ops/norm.py)",
             source="uresnet_tpu_torch/csrc/bn_train.cu", **bn_rec)]
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
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
    if sys.argv[1:2] == ["--dp-worker"] and len(sys.argv) == 4:
        worker = mesh_worker if sys.argv[2] in ("tp", "sp") else dp_worker
        raise SystemExit(worker(*sys.argv[2:4]))
    KERNELS_ONLY = sys.argv[1:] == ["--kernels-only"]
    PARALLEL_ONLY = sys.argv[1:] == ["--parallel-only"]
    PACKED_ONLY = sys.argv[1:] == ["--packed-only"]
    if sys.argv[1:] not in ([], ["--kernels-only"], ["--parallel-only"],
                            ["--packed-only"]):
        raise SystemExit(f"usage: {sys.argv[0]} [--kernels-only | "
                         f"--parallel-only | --packed-only]")
    main()
