"""Strip a training checkpoint to a compact params-only RELEASE artifact
(port of tools/make_release_ckpt.py; the same file, bit for bit).

A full checkpoint (engine/checkpoint.py) carries params + BN stats + Adam
moments + PRNG + cursor — 3x the params it needs for inference/fine-tune.
This tool keeps only `train_state/params/*`, `train_state/model_state/*`
(the BN running stats — REQUIRED for eval) and `meta/step`, optionally
casting conv KERNELS to bfloat16.

The bf16 kernel cast is BIT-EXACT for `compute_dtype: bfloat16` models:
every conv consumption casts the stored f32 kernel to bf16 (ops/conv.py
conv_general, models/fold.py — including the raised-dtype f32 head, whose
operands are rounded to bf16), and bf16(bf16(x)) == bf16(x). Only ndim>=3
leaves (kernels) are cast; BN scale/bias/running stats and any bias
vectors stay f32 because they enter f32 arithmetic. For `compute_dtype:
float32` models the cast would CHANGE results — the tool refuses unless
--force. The cast rounds to nearest even, as the JAX tool's does, so the
stored bits are equal (tests/test_torch_release.py).

Consume the artifact via the fine-tune restore path:

    python -m uresnet_tpu_torch.cli.infer cfg.yaml --metrics-only \\
        train.load_file=ckpt/release/q20k.npz train.load_params_only=true

Usage:
    python -m uresnet_tpu_torch.tools.make_release_ckpt \\
        ckpt/q20k/step_00020000.npz ckpt/release/q20k.npz \\
        --kernels-dtype bfloat16 --force
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np
import torch

KEEP_PREFIXES = ("train_state/params/", "train_state/model_state/")


def strip(in_path: str, out_path: str, *, kernels_dtype: str = "keep"):
    """Returns (kept_keys, in_bytes, out_bytes, sha256 of the output)."""
    with np.load(in_path) as z:
        stored = {k: z[k] for k in z.files}
    out = {}
    bf16_keys = []
    for k, v in stored.items():
        if k == "meta/step":
            out[k] = v
            continue
        if not any(k.startswith(p) for p in KEEP_PREFIXES):
            continue  # Adam moments, PRNG key, data cursor
        if (kernels_dtype == "bfloat16"
                and k.startswith("train_state/params/") and v.ndim >= 3):
            # conv kernels only; vectors (BN affine/stats, biases) stay f32.
            # npz has no bfloat16 dtype, so kernels are stored as uint16 BIT
            # PATTERNS listed in the __kernels_bf16__ manifest;
            # engine/checkpoint.py re-views them as bf16 on load.
            v = (torch.from_numpy(np.ascontiguousarray(v))
                 .to(torch.bfloat16).view(torch.int16).numpy()
                 .view(np.uint16))
            bf16_keys.append(k)
        out[k] = v
    if bf16_keys:
        out["__kernels_bf16__"] = np.asarray(bf16_keys)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **out)
    os.replace(tmp, out_path)
    h = hashlib.sha256()
    with open(out_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return (sorted(out), os.path.getsize(in_path), os.path.getsize(out_path),
            h.hexdigest())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="full checkpoint (step_*.npz)")
    p.add_argument("output", help="release artifact path")
    p.add_argument("--kernels-dtype", default="keep",
                   choices=("keep", "bfloat16"),
                   help="cast conv kernels (ndim>=3 param leaves) to bf16 — "
                        "bit-exact ONLY for compute_dtype=bfloat16 models "
                        "(see module docstring)")
    p.add_argument("--force", action="store_true",
                   help="allow the bf16 cast without confirmation that the "
                        "model computes in bf16")
    args = p.parse_args(argv)

    if args.kernels_dtype == "bfloat16" and not args.force:
        print("NOTE: --kernels-dtype bfloat16 is bit-exact only for "
              "compute_dtype=bfloat16 models (every conv casts its kernel "
              "to bf16 anyway). Pass --force to confirm.", file=sys.stderr)
        return 2
    keys, in_b, out_b, sha = strip(args.input, args.output,
                                   kernels_dtype=args.kernels_dtype)
    n_params = len([k for k in keys if k.startswith("train_state/params/")])
    print(f"wrote {args.output}: {len(keys)} leaves ({n_params} param), "
          f"{in_b/1e6:.1f} MB -> {out_b/1e6:.1f} MB, sha256={sha}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
