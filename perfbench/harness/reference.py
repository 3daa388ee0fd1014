"""The plain reference of the U-ResNet cells: float32 PyTorch, TF32 off.

Written from the architecture, not from the program: it imports nothing
of ``uresnet_tpu_torch`` (nor JAX) and takes nothing the program made.

    stem: conv3 - BN - ReLU
    level l < depth: residual blocks at f = base * 2^l, skip, stride-2
        conv3 - BN - ReLU to 2f
    bottleneck: residual blocks at base * 2^depth
    level l descending: stride-2 transposed conv3 - BN - ReLU to f,
        concat(up, skip), residual blocks (the first projects 2f -> f)
    head: conv(final_kernel) + bias -> num_class logits
    residual block: conv3-BN-ReLU, conv3-BN, + shortcut (1x1 conv on a
        channel change), ReLU

Parameters are one flat dict keyed by the checkpoint leaf names
(``enc0_b0.cb1.conv.w``; kernels laid out (*k, C_in, C_out)), BN running
statistics a second one (``stem.bn.mean``, ``stem.bn.var``). Activations
are channels-first (B, C, *S) inside; the entry points take and give
channels-last tensors (B, *S, C). SAME padding is XLA's: stride s pads
each axis by max((ceil(S/s) - 1) s + k - S, 0), split (floor, ceil). The
transposed conv is ``lax.conv_transpose``'s SAME: the input dilated by 2,
padded (2, 1) and correlated with the kernel as it is.

``quant`` (the lower-precision control): a function applied wherever the
program rounds to its compute dtype in the forward (every conv operand,
activation and kernel, every conv, BN, residual and ReLU output; the
logits unless the head is raised to float32) and, in training, to the
gradient that reaches each conv's output.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
_CONV = {2: F.conv2d, 3: F.conv3d}


@contextlib.contextmanager
def true_f32():
    """float32 matmuls and convs without TF32 for the enclosed code."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# -- the leaves ------------------------------------------------------------------


def units(m: dict) -> List[tuple]:
    """(unit name, kind, C_in, C_out) in the order of the checkpoint's
    leaves: kind 'cbr' (conv-BN-ReLU), 'up' (transposed), 'block',
    'head'."""
    f, depth, nb = m["base_filters"], m["depth"], m["blocks_per_level"]
    out = [("stem", "cbr", m["in_channels"], f)]
    for lvl in range(depth):
        fl = f * 2 ** lvl
        out += [(f"enc{lvl}_b{b}", "block", fl, fl) for b in range(nb)]
        out.append((f"down{lvl}", "cbr", fl, 2 * fl))
    fb = f * 2 ** depth
    out += [(f"mid_b{b}", "block", fb, fb) for b in range(nb)]
    for lvl in reversed(range(depth)):
        fl = f * 2 ** lvl
        out.append((f"up{lvl}", "up", 2 * fl, fl))
        out += [(f"dec{lvl}_b{b}", "block", 2 * fl if b == 0 else fl, fl)
                for b in range(nb)]
    out.append(("head", "head", f, m["num_class"]))
    return out


def leaf_shapes(m: dict) -> Dict[str, tuple]:
    """{leaf name: shape} of the parameters, then of the BN statistics
    (names ending in ``.mean`` / ``.var``)."""
    n = m["dims"]
    params, stats = {}, {}

    def conv_bn(prefix, k, ci, co):
        params[f"{prefix}.conv.w"] = (k,) * n + (ci, co)
        params[f"{prefix}.bn.scale"] = (co,)
        params[f"{prefix}.bn.bias"] = (co,)
        stats[f"{prefix}.bn.mean"] = (co,)
        stats[f"{prefix}.bn.var"] = (co,)

    for name, kind, ci, co in units(m):
        if kind in ("cbr", "up"):
            conv_bn(name, 3, ci, co)
        elif kind == "block":
            conv_bn(f"{name}.cb1", 3, ci, co)
            conv_bn(f"{name}.cb2", 3, co, co)
            if ci != co:
                params[f"{name}.proj.w"] = (1,) * n + (ci, co)
        else:
            k = m["final_kernel"]
            params["head.w"] = (k,) * n + (ci, co)
            params["head.b"] = (co,)
    return {**params, **stats}


def is_stat(name: str) -> bool:
    return name.endswith((".mean", ".var"))


# -- the layers ------------------------------------------------------------------


def _kernel(w: torch.Tensor) -> torch.Tensor:
    """(*k, C_in, C_out) -> torch's (C_out, C_in, *k)."""
    n = w.dim() - 2
    return w.permute(n + 1, n, *range(n))


def conv_same(x, w, stride=1):
    n = x.dim() - 2
    k = w.shape[0]
    pads = []
    for d in range(n):
        size = x.shape[2 + d]
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads.append((total // 2, total - total // 2))
    x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    return _CONV[n](x, _kernel(w), stride=stride)


def conv_transpose_same(x, w):
    """Stride-2 SAME transposed conv: dilate by 2, pad (2, 1), correlate."""
    n = x.dim() - 2
    dil = x.new_zeros(x.shape[:2] + tuple(2 * s - 1 for s in x.shape[2:]))
    dil[(slice(None), slice(None)) + (slice(None, None, 2),) * n] = x
    return _CONV[n](F.pad(dil, [2, 1] * n), _kernel(w))


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448 (the format's largest), back in float32; the
    gradient passes straight through. The control's precision: the one
    below the configuration's bfloat16."""
    with torch.no_grad():
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach() if t.requires_grad else q


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, back in float32: the yardstick of how far
    a seed's logits move when the configuration's own precision rounds
    the reference's operands (harness/checks.py ``logit_error``)."""
    q = t.detach().to(torch.bfloat16).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


def _grad_hook(y: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is not None and y.requires_grad:
        y.register_hook(lambda g: quant(g))
    return y


def forward(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
            x: torch.Tensor, m: dict, *, mode: str = "eval",
            quant: Quant = None) -> torch.Tensor:
    """(B, *S, C_in) -> float32 logits (B, *S, num_class).

    ``mode``: 'train' normalizes with the batch's biased statistics,
    'eval' with ``stats``, 'calibrate' writes the batch's statistics into
    ``stats`` and normalizes with them (the running statistics of a model
    trained to this data)."""
    n = m["dims"]
    eps = m["bn_eps"]
    q = quant or (lambda t: t)
    h = x.permute(0, n + 1, *range(1, n + 1))

    def conv(h, w, stride=1, transpose=False):
        y = (conv_transpose_same(q(h), q(w)) if transpose
             else conv_same(q(h), q(w), stride))
        return _grad_hook(y, quant)

    def bn(y, unit):
        y = q(y)
        scale, bias = params[f"{unit}.scale"], params[f"{unit}.bias"]
        if mode == "train":
            return q(F.batch_norm(y, None, None, scale, bias, training=True,
                                  eps=eps))
        if mode == "calibrate":
            dims = [0] + list(range(2, y.dim()))
            stats[f"{unit}.mean"] = y.mean(dims)
            stats[f"{unit}.var"] = y.var(dims, unbiased=False)
        return q(F.batch_norm(y, stats[f"{unit}.mean"], stats[f"{unit}.var"],
                              scale, bias, training=False, eps=eps))

    def cbr(unit, h, stride=1, transpose=False, relu=True):
        y = bn(conv(h, params[f"{unit}.conv.w"], stride, transpose),
               f"{unit}.bn")
        return F.relu(y) if relu else y

    def block(unit, h):
        y = cbr(f"{unit}.cb1", h)
        y = cbr(f"{unit}.cb2", y, relu=False)
        proj = params.get(f"{unit}.proj.w")
        return q(F.relu(y + (h if proj is None else q(conv(h, proj)))))

    skips = []
    for name, kind, _, _ in units(m):
        if name == "stem":
            h = cbr(name, h)
        elif name.startswith("down"):
            skips.append(h)
            h = cbr(name, h, stride=2)
        elif kind == "up":
            h = torch.cat([cbr(name, h, transpose=True), skips.pop()], 1)
        elif kind == "block":
            h = block(name, h)
    logits = conv(h, params["head.w"]) + params["head.b"].view(
        (1, -1) + (1,) * n)
    if m.get("head_dtype") != "float32":
        logits = q(logits)
    return logits.permute(0, *range(2, n + 2), 1)


def weighted_xent(logits, label, weight):
    """mean over pixels of weight * (logsumexp - the true class's logit)."""
    true = logits.gather(-1, label[..., None])[..., 0]
    return torch.mean(weight * (torch.logsumexp(logits, -1) - true))


@torch.no_grad()
def train_logits(m: dict, params: Dict[str, torch.Tensor], dense: dict, *,
                 device, quant: Quant = None) -> torch.Tensor:
    """The train-mode forward's logits of one densified batch, on the
    host."""
    with true_f32():
        x = torch.as_tensor(dense["data"], device=device)
        p = {k: v.float() for k, v in params.items()}
        return forward(p, {}, x, m, mode="train", quant=quant).cpu()


# -- the optimizer ---------------------------------------------------------------


def learning_rate(o: dict, step: int) -> float:
    """The schedule at 1-based ``step``, in float32: constant or cosine
    decay over ``decay_steps`` after ``warmup_steps``, times the linear
    warm-up ramp (step + 1) / warmup_steps."""
    f32 = np.float32
    lr = f32(o["lr"])
    if o["schedule"] == "cosine":
        frac = np.clip((f32(step) - f32(o["warmup_steps"]))
                       / f32(max(o["decay_steps"], 1)), f32(0), f32(1))
        lr = lr * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
    elif o["schedule"] != "constant":
        raise ValueError(f"the reference has no schedule {o['schedule']!r}")
    if o["warmup_steps"] > 0:
        lr = lr * np.clip((f32(step) + f32(1)) / f32(o["warmup_steps"]),
                          f32(0), f32(1))
    return float(f32(lr))


@torch.no_grad()
def adam(params, grads, mu, nu, step: int, o: dict):
    """One Adam update in place, after clipping the global gradient norm
    at ``grad_clip_norm`` (0: no clip). Returns the clipped gradients."""
    if o["optimizer"] != "adam" or o["weight_decay"]:
        raise ValueError("the reference implements plain Adam only")
    if o["grad_clip_norm"] > 0:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(o["grad_clip_norm"] / torch.clamp(norm, min=1e-12),
                            max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
    lr = learning_rate(o, step)
    b1, b2 = o["b1"], o["b2"]
    c1 = 1.0 - float(np.float32(b1) ** np.float32(step))
    c2 = 1.0 - float(np.float32(b2) ** np.float32(step))
    for k, g in grads.items():
        mu[k].mul_(b1).add_(g, alpha=1 - b1)
        nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
        params[k].sub_(lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + o["eps"]))
    return grads


# -- the data --------------------------------------------------------------------


def crop_origin(coords, values, npoints, shape, size: int) -> np.ndarray:
    """(B, D) window origins: the charge-weighted centroid (the plain mean
    without charge, the image centre without points), rounded half up to
    a window of ``size``, moved to keep the highest-charge point (the
    first point without charge), then clamped into the image."""
    B, _, D = coords.shape
    out = np.zeros((B, D), np.int64)
    for r in range(B):
        n = int(npoints[r])
        c = coords[r, :n].astype(np.float64)
        v = values[r, :n].astype(np.float64)
        ext = shape[r].astype(np.int64)
        if n == 0:
            lo = np.floor(ext / 2.0 - size / 2.0 + 0.5).astype(np.int64)
        else:
            if v.sum() > 0:
                center = (c * (v / v.sum())[:, None]).sum(0)
                anchor = coords[r, int(np.argmax(values[r, :n]))]
            else:
                center = c.mean(0)
                anchor = coords[r, 0]
            anchor = anchor.astype(np.int64)
            lo = np.floor(center - size / 2.0 + 0.5).astype(np.int64)
            lo = np.minimum(np.maximum(lo, anchor - size + 1), anchor)
        out[r] = np.minimum(np.maximum(lo, 0), np.maximum(ext - size, 0))
    return out


def densify(batch: dict, *, size: int, scale: float, clip: float,
            weight_mode: str, num_class: int) -> dict:
    """A padded sparse batch (coords, values, labels, npoints, shape) ->
    numpy images: data (B, *S, 1) f32 = clip(value * scale, 0, clip) at
    each point in its window (the last of points sharing a pixel wins),
    label (B, *S), weight (B, *S) ('ones', or 'class_balance': npix /
    (num_class * pixels of the class), 0 for an absent class); and each
    point's flat pixel and whether it counts (``flat``, ``valid``)."""
    coords, values = batch["coords"], batch["values"]
    labels, npoints = batch["labels"], batch["npoints"]
    B, P, D = coords.shape
    npix = size ** D
    origin = crop_origin(coords, values, npoints, batch["shape"], size)
    data = np.zeros((B, npix), np.float32)
    label = np.zeros((B, npix), np.int64)
    flat = np.zeros((B, P), np.int64)
    valid = np.zeros((B, P), bool)
    for r in range(B):
        n = int(npoints[r])
        c = coords[r, :n].astype(np.int64) - origin[r]
        ok = np.all((c >= 0) & (c < size), axis=1)
        f = np.ravel_multi_index(np.clip(c, 0, size - 1).T, (size,) * D)
        flat[r, :n], valid[r, :n] = f, ok
        data[r, f[ok]] = np.clip(values[r, :n][ok] * np.float32(scale),
                                 np.float32(0), np.float32(clip))
        label[r, f[ok]] = labels[r, :n][ok]
    if weight_mode == "ones":
        weight = np.ones((B, npix), np.float32)
    elif weight_mode == "class_balance":
        weight = np.zeros((B, npix), np.float32)
        for r in range(B):
            cnt = np.bincount(label[r], minlength=num_class).astype(np.float32)
            w = np.where(cnt > 0, np.float32(npix)
                         / (np.float32(num_class) * np.maximum(cnt, 1)), 0)
            weight[r] = w.astype(np.float32)[label[r]]
    else:
        raise ValueError(f"the reference has no weight mode {weight_mode!r}")
    img = (B,) + (size,) * D
    return {"data": data.reshape(img + (1,)), "label": label.reshape(img),
            "weight": weight.reshape(img), "origin": origin, "flat": flat,
            "valid": valid}


# -- the two cells' computations ---------------------------------------------------


def _tensors(d: dict, device, keys: Sequence[str]):
    return [torch.as_tensor(d[k], device=device) for k in keys]


def train_steps(m: dict, o: dict, params: Dict[str, torch.Tensor],
                dense: List[dict], *, device, quant: Quant = None) -> dict:
    """Adam steps from ``params`` (not modified), one per densified batch
    of ``dense``: each step's loss, the first step's logits (on the host),
    the per-leaf norms of its clipped gradient, and the per-leaf norms of
    the parameters' change over all the steps."""
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first, first_logits = [], None, None
    with true_f32():
        for step, d in enumerate(dense, 1):
            x, label, weight = _tensors(d, device, ("data", "label", "weight"))
            logits = forward(p, {}, x, m, mode="train", quant=quant)
            if step == 1:
                first_logits = logits.detach().cpu()
            loss = weighted_xent(logits, label, weight)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            del logits
            losses.append(float(loss.detach()))
            g = adam(p, grads, mu, nu, step, o)
            if first is None:
                first = {k: float(torch.linalg.vector_norm(v.double()))
                         for k, v in g.items()}
            del grads, g
    change = {k: float(torch.linalg.vector_norm(
        p[k].detach().double() - params[k].double())) for k in p}
    return {"losses": losses, "logits": first_logits, "grad_norms": first,
            "change_norms": change}


@torch.no_grad()
def analyse(m: dict, params, stats, dense: dict, *, device,
            quant: Quant = None) -> dict:
    """The analysis of one densified batch (weight_mode 'ones'): softmax
    scores at the points (B, P, num_class), the per-batch confusion
    counts over every pixel, the pixels counted, the charged pixels and
    those of them whose prediction is right."""
    with true_f32():
        x, label = _tensors(dense, device, ("data", "label"))
        logits = forward(params, stats, x, m, mode="eval", quant=quant)
        B, K = logits.shape[0], logits.shape[-1]
        scores = torch.softmax(logits.reshape(B, -1, K), -1)
        flat = torch.as_tensor(dense["flat"], device=device)
        pscores = scores.gather(1, flat[..., None].expand(-1, -1, K))
        pred = logits.argmax(-1).reshape(B, -1)
        lab = label.reshape(B, -1)
        conf = torch.bincount((pred * K + lab).reshape(-1), minlength=K * K)
        charged = x.reshape(B, -1) > 0
        out = {"pscores": pscores.cpu().numpy(),
               "conf": conf.reshape(K, K).cpu().numpy().astype(np.float64),
               "n_pixels": float(pred.numel()),
               "n_nonzero": charged.sum(1).cpu().numpy().astype(np.float64),
               "correct_nonzero": float(((pred == lab) & charged).sum())}
    return out
