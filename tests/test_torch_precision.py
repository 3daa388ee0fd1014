"""True f32 is a property of the port's conv, not of the process.

JAX runs every f32-compute conv at ``Precision.HIGHEST``
(uresnet_tpu/ops/conv.py ``_precision``). The port's f32 convs run with
cuDNN's TF32 off for their own forward and gradients (ops/conv.py
``_ConvTrueF32``), the raised f32 head with TF32 allowed (``_ConvTF32``),
and no conv, Trainer or serving function changes the process's flags. On
the CPU TF32 does not exist, so these tests read the flags themselves: the
flag a conv sees inside its scope, and the flags after it.
"""

import contextlib

import numpy as np
import pytest
import torch

from uresnet_tpu_torch.config import Config, ModelConfig
from uresnet_tpu_torch.engine.export import build_logits_fn
from uresnet_tpu_torch.engine.trainer import Trainer
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops import conv as tconv

FLAGS = ((True, False), (False, True))  # (cudnn, matmul) as the caller set them


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def caller_flags(monkeypatch, request):
    cudnn, matmul = request.param
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
    return cudnn, matmul


def _operands(dims=2, c=8, co=4):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1,) + (6,) * dims + (c,))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3,) * dims + (c, co)) * 0.2)
                         .astype(np.float32))
    return x, w


@pytest.mark.parametrize("caller_flags", FLAGS, indirect=True)
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "head"])
def test_conv_general_leaves_flags(caller_flags, kind):
    """Forward and backward of an f32, a bf16 and a raised-head conv leave
    cuDNN's and cuBLAS's TF32 flags as the caller set them."""
    x, w = _operands()
    cd = torch.bfloat16 if kind == "bfloat16" else torch.float32
    precision = torch.bfloat16 if kind == "head" else None
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = tconv.conv_general(xa, wa, stride=1, compute_dtype=cd,
                           precision=precision)
    assert _flags() == caller_flags
    y.float().sum().backward()
    assert _flags() == caller_flags
    assert xa.grad is not None and wa.grad is not None


@pytest.mark.parametrize("kind,stride", [("conv", 1), ("conv", 2),
                                         ("convt", 2)])
def test_f32_conv_sees_tf32_off(monkeypatch, kind, stride):
    """With torch's default (TF32 allowed) left in place, an f32 conv runs
    its forward and both gradients with TF32 off, then puts the flag back."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    real = tconv.true_f32

    @contextlib.contextmanager
    def recording():
        with real():
            seen.append(torch.backends.cudnn.allow_tf32)
            yield

    monkeypatch.setattr(tconv, "true_f32", recording)
    x, w = _operands(dims=3)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = tconv.conv_general(xa, wa, stride=stride, compute_dtype=torch.float32,
                           kind=kind)
    g = torch.randn_like(y)
    y.backward(g)
    assert seen == [False, False] and torch.backends.cudnn.allow_tf32
    assert xa.grad is not None and wa.grad is not None


@pytest.mark.parametrize("caller_flags", FLAGS, indirect=True)
def test_f32_trainer_and_logits_fn_leave_flags(tmp_path, caller_flags):
    """Building a Trainer or a serving function for an f32 model, and
    running them, no longer changes the process's TF32 flags."""
    cfg = Config()
    cfg.model = ModelConfig(depth=2, base_filters=4, compute_dtype="float32")
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    cfg.train.log_dir = str(tmp_path / "log")
    tr = Trainer(cfg, device="cpu")
    assert _flags() == caller_flags
    ts = tr.init_state()
    model = UResNet(cfg.model, generator=torch.Generator().manual_seed(0))
    logits_fn = build_logits_fn(cfg, model)
    assert _flags() == caller_flags
    logits_fn(torch.rand(1, 16, 16, 1))
    assert _flags() == caller_flags
    batch = {"data": torch.rand(2, 16, 16, 1),
             "label": torch.randint(0, 3, (2, 16, 16)),
             "weight": torch.ones(2, 16, 16)}
    tr.train_step(ts, batch)
    assert _flags() == caller_flags
