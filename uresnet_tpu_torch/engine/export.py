"""The serving function and its serialized artifact (port of
uresnet_tpu/engine/export.py).

``build_serving_fn`` is the BN-folded forward + f32 softmax over classes;
``build_logits_fn``, the folded logits function it is made of, is shared
with the analysis pass (engine/evaluator.py).

``export_serving`` / ``save_serving`` / ``load_serving`` package that
function as one ``.uxm`` file: the ``torch.export`` program of the serving
function at a fixed input shape, the folded weights held as its constants,
behind a JSON metadata header (architecture, preprocessing constants, class
count). File layout, as the JAX package's: 8-byte magic ``URESNETX`` + u32
little-endian JSON length + UTF-8 JSON metadata (sorted keys) + the payload
(``torch.export.save`` of the program). The input is the normalized dense
batch ``(B, *spatial, in_channels)`` float32 recorded in
``meta['input_shape']``; the output float32 per-pixel softmax scores
``(B, *spatial, num_class)``.

Unlike the JAX package's StableHLO artifact, a ``.uxm`` of the port is not
self-contained: its graph calls the fused conv op
``uresnet_tpu_torch::fused_conv3x3_bn_relu_v2`` at every eligible conv
(ops/cuda/conv2d.py), so it loads only in a process where
``uresnet_tpu_torch`` is importable; `load_serving` imports the op's module
first. The metadata's ``format`` is ``uresnet_tpu_torch-serving``, so a
JAX artifact is refused by name, and ``platforms`` lists torch device types.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import struct
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

# registers the fused conv ops the exported graph calls
from uresnet_tpu_torch.ops.cuda import conv2d as _fused_ops  # noqa: F401
from uresnet_tpu_torch.config import Config, ModelConfig, is_sparse
from uresnet_tpu_torch.models.convert import (flatten_tree, trees,
                                              unflatten_tree)
from uresnet_tpu_torch.models import sparse_uresnet
from uresnet_tpu_torch.models.fold import (fold_batchnorm, kernel_operands,
                                            uresnet_apply_folded)
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops.conv import head_precision
from uresnet_tpu_torch.utils.dtypes import canonical_dtype

_MAGIC = b"URESNETX"
FORMAT_VERSION = 1
FORMAT = "uresnet_tpu_torch-serving"


def _folded(cfg: Config, model: UResNet) -> Tuple[ModelConfig, Dict[str, Any]]:
    """The serving model config and the folded params with their kernel
    operands made once. Serving is canonical: ``pack`` is a TPU
    lane-filling training layout with identical outputs. Unlike the JAX
    package, which forces ``kernel_backend='xla'`` here because XLA beat its
    Pallas kernel on the TPU, the configured backend is kept: that
    measurement does not carry over to Hopper, so 'auto' runs the
    hand-written kernel."""
    mcfg = dataclasses.replace(cfg.model, pack=False, remat=False)
    with torch.no_grad():
        return mcfg, kernel_operands(fold_batchnorm(*trees(model), mcfg), mcfg)


def build_logits_fn(cfg: Config,
                    model: UResNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (B, *S, C_in) normalized charge image or volume (S = (H, W) or
    (D, H, W)), on the model's device -> f32 logits (B, *S, num_class) of
    the BN-folded forward.

    BN is folded and the kernel operands are made once, here: call this
    once per pass over the data, not per batch. The fold equals the eval
    forward (tests/test_torch_model.py).

    The sparse U-ResNet (``model.arch`` 'sparse_uresnet') has no fold: its
    BN runs before a ReLU and a conv. Its logits function takes a
    `SparseBatch` with its rulebook (ops/sparse.py) and gives the f32
    logits (n_0, num_class) of its sites, in eval mode."""
    if is_sparse(cfg.model):
        @torch.inference_mode()
        def sparse_logits(batch) -> torch.Tensor:
            return model(batch, train=False)[0]

        return sparse_logits
    mcfg, folded = _folded(cfg, model)

    @torch.inference_mode()
    def logits_fn(x: torch.Tensor) -> torch.Tensor:
        return uresnet_apply_folded(folded, x, cfg=mcfg)

    return logits_fn


def _dense_only(cfg: Config, what: str) -> None:
    if is_sparse(cfg.model):
        sparse_uresnet.refuse(what, hint=": it scores point batches "
                              "(engine/evaluator.py)")


def build_serving_fn(cfg: Config,
                     model: UResNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (B, *S, C_in) normalized charge image or volume, on the model's
    device -> f32 per-pixel softmax scores (B, *S, num_class)."""
    _dense_only(cfg, "a dense serving function")
    logits_fn = build_logits_fn(cfg, model)

    @torch.inference_mode()
    def serve(x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(logits_fn(x), dim=-1)

    return serve


class _Serving(nn.Module):
    """`build_serving_fn`'s function as a module for ``torch.export``: the
    folded operands are buffers, so they become constants of the program."""

    def __init__(self, mcfg: ModelConfig, folded: Dict[str, Any]):
        super().__init__()
        self.mcfg = mcfg
        self.names = {}
        for key, v in flatten_tree(folded).items():
            name = key.replace(".", "__")
            self.register_buffer(name, v.detach())
            self.names[key] = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded = unflatten_tree({k: getattr(self, n)
                                 for k, n in self.names.items()})
        return torch.softmax(uresnet_apply_folded(folded, x, cfg=self.mcfg),
                             dim=-1)


def _allows_tf32(model: Dict[str, Any]) -> bool:
    """The TF32 setting a model's f32 convs need, from its config: allowed
    where the only f32 conv is a raised head over bf16-rounded operands
    (ops/conv.py ``_ConvTF32``), off where f32 is the compute dtype (true
    f32, ``_ConvTrueF32``)."""
    cd = canonical_dtype(model["compute_dtype"])
    hd = canonical_dtype(model["head_dtype"]) if model["head_dtype"] else cd
    return cd != torch.float32 and head_precision(hd, cd) is not None


@contextlib.contextmanager
def _tf32(allow: bool):
    """cuDNN's and cuBLAS's ``allow_tf32`` set to ``allow`` for the enclosed
    calls, then put back."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = allow
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def export_serving(
    cfg: Config,
    model: UResNet,
    *,
    batch_size: Optional[int] = None,
    image_size: Optional[int] = None,
    platforms: Sequence[str] = ("cuda", "cpu"),
    step: int = 0,
) -> Tuple[bytes, Dict[str, Any]]:
    """Export the model's serving function, traced on the model's device,
    as (payload_bytes, metadata_dict). The metadata equals the JAX
    package's for the same config, weights and step, but for ``format``
    and ``platforms`` (torch device types the artifact may be loaded on)."""
    _dense_only(cfg, "a .uxm serving artifact")
    B = batch_size or cfg.data.batch_size
    S = image_size or cfg.data.image_size
    in_shape = (B,) + (S,) * cfg.model.dims + (cfg.model.in_channels,)
    device = next(model.parameters()).device
    program = torch.export.export(
        _Serving(*_folded(cfg, model)),
        (torch.zeros(in_shape, dtype=torch.float32, device=device),))
    # torch.export.save would keep the example input: 33.5 MB at the
    # flagship's (32, 512, 512, 1)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)

    meta = {
        "format": FORMAT,
        "version": FORMAT_VERSION,
        "platforms": list(platforms),
        "input_shape": list(in_shape),
        "input_dtype": "float32",
        "output": "softmax_scores",
        "output_shape": (list(in_shape[:-1]) + [cfg.model.num_class]),
        "trained_step": int(step),
        "model": dataclasses.asdict(cfg.model),
        "preprocess": {
            "normalize_scale": cfg.data.normalize_scale,
            "normalize_clip": cfg.data.normalize_clip,
            "image_size": S,
            "planes": list(cfg.data.planes),
        },
    }
    return buf.getvalue(), meta


def save_serving(path: str, payload: bytes, meta: Dict[str, Any]) -> None:
    blob = json.dumps(meta, sort_keys=True).encode()
    with open(path + ".tmp", "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        f.write(payload)
    os.replace(path + ".tmp", path)


def load_serving(path: str, device="cuda") -> Tuple[
        Callable[[Any], torch.Tensor], Dict[str, Any]]:
    """Deserialize a ``.uxm`` artifact onto ``device`` -> (callable,
    metadata).

    The callable takes the normalized dense batch of ``meta['input_shape']``
    (a numpy array or a tensor) and returns float32 softmax scores on
    ``device``; another shape raises (the exported program's input guard).
    It runs the program with TF32 set as the model's convs need it
    (`_allows_tf32`) and leaves the caller's flags as it found them: the
    graph keeps no flag of its own. Loads only where ``uresnet_tpu_torch``
    imports (the module docstring)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path!r} is not a uresnet serving artifact "
                             f"(bad magic {magic!r})")
        (n,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(n).decode())
        payload = f.read()
    if meta.get("version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"artifact version {meta['version']} is newer than this "
            f"reader ({FORMAT_VERSION})")
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path!r} holds a {meta.get('format')!r} artifact; this reader "
            f"loads {FORMAT!r} (a 'uresnet_tpu-serving' file is a StableHLO "
            f"artifact of the JAX package)")
    device = torch.device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path!r} was exported for {meta['platforms']}, "
                         f"not {device.type!r}")
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(io.BytesIO(payload)),
                                  device)
    module = program.module()
    tf32 = _allows_tf32(meta["model"])

    def serve(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.no_grad(), _tf32(tf32):
            return module(x)

    return serve, meta
