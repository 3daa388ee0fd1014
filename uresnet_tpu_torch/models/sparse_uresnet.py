"""The submanifold sparse U-ResNet (Domine and Terao, arXiv:1903.05663;
submanifold sparse convolutions of Graham, Engelcke and van der Maaten,
arXiv:1711.10275), the segmentation network of DeepLearnPhysics'
lartpc_mlreco3d, on point rows: it never builds a dense grid.

Its input is a `SparseBatch` (ops/sparse.py): one row per active voxel,
the normalized charge as the one feature, and the rulebook of each level.
With m = ``base_filters``, L = ``depth + 1`` levels and C_i = m (i + 1)
channels at level i (linear, not doubling):

    SC(a->b)   submanifold conv, kernel 3^D, stride 1, no bias: each output
               site (the input sites) sums W[o] x over the offsets o whose
               neighbour is active
    BNR(c)     BatchNorm over the active sites, then ReLU
    Res(a->b)  pre-activation residual block:
               y = s(x) + SC(b->b)(BNR(b)(SC(a->b)(BNR(a)(x)))), s the
               identity for a = b, else a 1x1 linear map a->b, no bias
    Down       kernel 2, stride 2: sites unique(x // 2), each fine site
               feeds one coarse site
    Up         its transpose onto the finer level's own sites: each fine
               site gets W[x mod 2] (its parent's feature)

    stem       SC(1->m)
    level i    blocks_per_level x Res(C_i->C_i); skip_i; for i < L-1:
               BNR(C_i), Down(C_i->C_{i+1})
    level i    from L-2 down to 0: BNR(C_{i+1}), Up(C_{i+1}->C_i),
               concat [skip_i, up], Res(2C_i->C_i), then
               (blocks_per_level - 1) x Res(C_i->C_i)
    head       BNR(m), a linear map m->num_class with a bias

Every conv and linear map runs through ops/cuda/sparse_conv.py (the card's
kernels in bf16), each BN through ops/norm.py (train BN's kernels on the
card). Operands are in ``compute_dtype``; the logits are f32 sums of its
products, plus the f32 bias. Leaves follow the JAX naming of the dense
model's checkpoints: kernels ``…w`` laid out (*k, C_in, C_out), BN
``…scale``/``…bias`` and buffers ``…mean``/``…var``, the head's bias
``head.b``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uresnet_tpu_torch.config import ModelConfig
from uresnet_tpu_torch.models.blocks import BatchNorm, BlockCtx, Conv
from uresnet_tpu_torch.ops.cuda.sparse_conv import sparse_conv
from uresnet_tpu_torch.ops.sparse import IDENTITY, SparseBatch
from uresnet_tpu_torch.utils.dtypes import canonical_dtype


def refuse(*modes: str, hint: str = "") -> None:
    """Raise the ValueError that names the ``modes`` the sparse net does
    not run; nothing when none is named."""
    if modes:
        raise ValueError(f"the sparse U-ResNet (model.arch "
                         f"'sparse_uresnet') does not run "
                         f"{', '.join(modes)}{hint}")


def refuse_train_modes(cfg, *, n_model: int, n_spatial: int) -> None:
    """The training modes of ``cfg`` (a Config) that the sparse net has
    no form of, refused."""
    refuse(*[name for name, on in (
        ("model.pack", cfg.model.pack), ("model.remat", cfg.model.remat),
        ("data.augment", cfg.data.augment),
        ("data.transfer: dense", cfg.data.transfer == "dense"),
        ("tensor parallelism (parallel.model > 1)", n_model > 1),
        ("spatial parallelism (parallel.spatial > 1)", n_spatial > 1))
        if on])


def planes(cfg: ModelConfig):
    """C_i of each level."""
    return [cfg.base_filters * (i + 1) for i in range(cfg.depth + 1)]


def conv_launches(model: nn.Module):
    """(forward, input-gradient, weight-gradient) launches of the sparse
    conv ops in one train step: every conv and linear map once each way,
    but the stem's input gradient (its input is the data)."""
    n = sum(isinstance(m, Conv) for m in model.modules()) + 1  # + the head
    return n, n - 1, n


def _kernel(w: torch.Tensor) -> torch.Tensor:
    """(*k, C_in, C_out) -> (K, C_in, C_out)."""
    return w.reshape((-1,) + tuple(w.shape[-2:]))


class SparseResBlock(nn.Module):
    def __init__(self, a: int, b: int, **kw):
        super().__init__()
        pd, dev = kw["param_dtype"], kw.get("device")
        self.bn1 = BatchNorm(a, param_dtype=pd, device=dev)
        self.conv1 = Conv(3, a, b, use_bias=False, **kw)
        self.bn2 = BatchNorm(b, param_dtype=pd, device=dev)
        self.conv2 = Conv(3, b, b, use_bias=False, **kw)
        self.proj = Conv(1, a, b, use_bias=False, **kw) if a != b else None

    def forward(self, x, ctx: BlockCtx, level):
        h, s1 = self.bn1(x, ctx, relu=True)
        h = sparse_conv(h, _kernel(self.conv1.w), level.nbr, mirror=True)
        h, s2 = self.bn2(h, ctx, relu=True)
        short = x if self.proj is None else sparse_conv(
            x, _kernel(self.proj.w), IDENTITY)
        y = sparse_conv(h, _kernel(self.conv2.w), level.nbr, mirror=True,
                        residual=short)
        return y, {"bn1": s1, "bn2": s2}


class SparseBNConv(nn.Module):
    """BNR then a strided conv (kernel 2): ``down`` or, transposed,
    ``up``."""

    def __init__(self, a: int, b: int, **kw):
        super().__init__()
        self.bn = BatchNorm(a, param_dtype=kw["param_dtype"],
                            device=kw.get("device"))
        self.conv = Conv(2, a, b, use_bias=False, **kw)

    def forward(self, x, ctx: BlockCtx, rule, back):
        h, s = self.bn(x, ctx, relu=True)
        return sparse_conv(h, _kernel(self.conv.w), rule, back), {"bn": s}


class SparseHead(nn.Module):
    def __init__(self, a: int, num_class: int, **kw):
        super().__init__()
        self.bn = BatchNorm(a, param_dtype=kw["param_dtype"],
                            device=kw.get("device"))
        for k, v in Conv(1, a, num_class, use_bias=True, **kw).params().items():
            self.register_parameter(k, nn.Parameter(v.detach()))

    def forward(self, x, ctx: BlockCtx):
        h, s = self.bn(x, ctx, relu=True)
        return sparse_conv(h, _kernel(self.w), IDENTITY, bias=self.b,
                           out_f32=True), {"bn": s}


class SparseUResNet(nn.Module):
    """``forward(batch, train)``: a `SparseBatch` with its rulebook ->
    (float32 logits (n_0, num_class) at its level-0 sites, new BN-state
    tree), as UResNet's forward returns them."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, dims=cfg.dims,
                  param_dtype=canonical_dtype(cfg.param_dtype), device=device)
        C, L = planes(cfg), cfg.depth + 1
        self.stem = Conv(3, cfg.in_channels, C[0], use_bias=False, **kw)
        for i in range(L):
            for b in range(cfg.blocks_per_level):
                self.add_module(f"enc{i}_b{b}", SparseResBlock(C[i], C[i], **kw))
            if i < L - 1:
                self.add_module(f"down{i}", SparseBNConv(C[i], C[i + 1], **kw))
        for i in reversed(range(L - 1)):
            self.add_module(f"up{i}", SparseBNConv(C[i + 1], C[i], **kw))
            for b in range(cfg.blocks_per_level):
                self.add_module(f"dec{i}_b{b}", SparseResBlock(
                    2 * C[i] if b == 0 else C[i], C[i], **kw))
        self.head = SparseHead(C[0], cfg.num_class, **kw)

    def forward(self, batch: SparseBatch, train: bool = False, mesh=None):
        cfg = self.cfg
        cd = canonical_dtype(cfg.compute_dtype)
        ctx = BlockCtx(dims=cfg.dims, compute_dtype=cd, bn_eps=cfg.bn_eps,
                       bn_momentum=cfg.bn_momentum, train=train, mesh=mesh)
        rb, L = batch.rules, cfg.depth + 1
        unit = self.get_submodule
        state = {}
        h = sparse_conv(batch.feats.to(cd), _kernel(self.stem.w),
                        rb.levels[0].nbr, mirror=True)
        skips = []
        for i in range(L):
            for b in range(cfg.blocks_per_level):
                name = f"enc{i}_b{b}"
                h, state[name] = unit(name)(h, ctx, rb.levels[i])
            if i < L - 1:
                skips.append(h)
                h, state[f"down{i}"] = unit(f"down{i}")(
                    h, ctx, rb.down[i], rb.up[i])
        for i in reversed(range(L - 1)):
            h, state[f"up{i}"] = unit(f"up{i}")(h, ctx, rb.up[i], rb.down[i])
            h = torch.cat([skips[i], h], dim=-1)
            for b in range(cfg.blocks_per_level):
                name = f"dec{i}_b{b}"
                h, state[name] = unit(name)(h, ctx, rb.levels[i])
        logits, state["head"] = self.head(h, ctx)
        return logits, {k: state[k] for k in self._unit_order}

    @property
    def _unit_order(self):
        """Units with BN state, in module order (the stem has none)."""
        return [n for n, _ in self.named_children() if n != "stem"]
