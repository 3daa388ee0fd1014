"""Adam / RMSProp and LR schedules, written out (port of
uresnet_tpu/engine/optim.py; not ``torch.optim``, so the formulas are the
JAX package's own).

Params, gradients and moments are flat dicts keyed by the dotted leaf
names of ``UResNet.named_parameters()``; ``leaf_path`` gives the JAX
checkpoint path of a name (``stem.conv.w`` -> ``stem/conv/w``), which is
what ``freeze`` patterns are matched against. The step counter lives on
the host, so the learning rate and bias corrections are host scalars
computed in float32 as the JAX package computes them on the device; the
moment and parameter updates are multi-tensor (``torch._foreach_*``)
elementwise passes over the trainable leaves.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from uresnet_tpu_torch.config import OptimConfig

Leaves = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: int                 # updates taken
    mu: Leaves                # first moments (unused by RMSProp)
    nu: Leaves                # second moments


def leaf_path(name: str) -> str:
    """Dotted parameter name -> the JAX checkpoint leaf path."""
    return name.replace(".", "/")


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """step -> learning rate, in float32 arithmetic."""
    f32 = np.float32

    def sched(step: int) -> float:
        s = f32(step)
        lr = f32(cfg.lr)
        if cfg.schedule == "cosine":
            total = f32(max(cfg.decay_steps, 1))
            frac = np.clip((s - f32(cfg.warmup_steps)) / total, f32(0), f32(1))
            lr = lr * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        elif cfg.schedule == "exponential":
            total = f32(max(cfg.decay_steps, 1))
            lr = lr * f32(cfg.decay_rate) ** ((s - f32(cfg.warmup_steps)) / total)
        elif cfg.schedule != "constant":
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        if cfg.warmup_steps > 0:
            lr = lr * np.clip((s + f32(1)) / f32(cfg.warmup_steps), f32(0), f32(1))
        return float(f32(lr))

    return sched


def freeze_mask(names: Sequence[str], patterns: Sequence[str]) -> Dict[str, bool]:
    """{name: frozen} from regexes ``re.search``-ed against each leaf's JAX
    path (``stem/conv/w``, ``enc0_b1/cb1/bn/scale``, ``head/b``). A pattern
    matching no leaf raises, and so does freezing every leaf."""
    compiled = [(p, re.compile(p)) for p in patterns]
    hits = {p: 0 for p in patterns}
    mask = {}
    for name in names:
        frozen = False
        for p, rx in compiled:
            if rx.search(leaf_path(name)):
                frozen = True
                hits[p] += 1
        mask[name] = frozen
    dead = [p for p, n in hits.items() if n == 0]
    if dead:
        raise ValueError(
            f"optim.freeze patterns {dead} match no param leaf; available "
            f"paths (first 10): {[leaf_path(n) for n in names][:10]}")
    if mask and all(mask.values()):
        raise ValueError(
            "optim.freeze freezes EVERY param leaf — nothing would train")
    return mask


def adam_init(params: Leaves) -> AdamState:
    return AdamState(step=0,
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def adam_update(grads: Leaves, opt: AdamState, params: Leaves,
                cfg: OptimConfig, freeze: Optional[Dict[str, bool]] = None
                ) -> Tuple[Leaves, AdamState]:
    """Adam or RMSProp (cfg.optimizer) -> (new params, new state), new
    tensors for the trainable leaves. Frozen leaves are left out: their
    params, ``mu`` and ``nu`` come back as the very tensors given, and
    their grads are not in the global norm of ``grad_clip_norm``. Weight
    decay is added to the update direction ``u``, as the JAX package does."""
    names = [k for k in params if not (freeze and freeze[k])]
    g = [grads[k] for k in names]
    p = [params[k] for k in names]
    step = opt.step + 1
    lr = make_schedule(cfg)(step)
    if cfg.grad_clip_norm > 0:
        sq = torch.stack([torch.sum(torch.square(x.float())) for x in g])
        gnorm = torch.sqrt(torch.sum(sq))
        scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        g = [x * scale for x in g]
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    nu = torch._foreach_add(torch._foreach_mul([opt.nu[k] for k in names], b2),
                            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
    if cfg.optimizer == "rmsprop":
        # TF1 RMSPropOptimizer: decay b2, no momentum term
        mu = [opt.mu[k] for k in names]
        u = torch._foreach_div(g, torch._foreach_add(torch._foreach_sqrt(nu), eps))
    elif cfg.optimizer == "adam":
        mu = torch._foreach_add(torch._foreach_mul([opt.mu[k] for k in names], b1),
                                torch._foreach_mul(g, 1 - b1))
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        u = torch._foreach_div(
            torch._foreach_div(mu, bc1),
            torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                               eps))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.weight_decay > 0:
        u = torch._foreach_add(u, torch._foreach_mul(p, cfg.weight_decay))
    new_p = torch._foreach_sub(p, torch._foreach_mul(u, lr))
    upd = lambda old, new: {**old, **dict(zip(names, new))}  # noqa: E731
    return upd(params, new_p), AdamState(step=step, mu=upd(opt.mu, mu),
                                         nu=upd(opt.nu, nu))
