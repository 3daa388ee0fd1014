"""A plain reference of the submanifold sparse U-ResNet (Domine and Terao,
arXiv:1903.05663, on the submanifold sparse convolutions of Graham,
Engelcke and van der Maaten, arXiv:1711.10275): float32 PyTorch, TF32 off
in every entry point, written from the layer equations. It imports nothing
of ``uresnet_tpu_torch`` nor JAX and takes nothing the program made: it
builds its own sites and rulebooks, by ``unique`` and ``searchsorted``
over packed coordinate keys, and runs each convolution as index_select,
mm and index_add over its pairs. One copy lives in tests/ for the tier-1
tests and one beside perfbench/archs/sparse_uresnet.py for the benchmark;
perfbench/tests/test_perfbench_sparse.py holds the two equal.

    SC(a->b)   submanifold conv, kernel 3^D, stride 1, no bias
    BNR(c)     BatchNorm over the active sites (biased batch variance in
               training), then ReLU
    Res(a->b)  y = s(x) + SC(b->b)(BNR(b)(SC(a->b)(BNR(a)(x)))), s the
               identity for a = b, else a 1x1 map a->b, no bias
    Down       kernel 2, stride 2 onto unique(x // 2); Up its transpose
    stem SC(1->m); level i (C_i = m (i + 1), L = depth + 1 levels): blocks
    Res(C_i->C_i), skip, then BNR, Down for i < L-1; level i from L-2 to 0:
    BNR, Up, concat [skip, up], Res(2C_i->C_i), further Res(C_i->C_i);
    head BNR(m), linear m->num_class with a bias.

Leaves are named as the program's checkpoint names them (``stem.w``,
``enc0_b0.bn1.scale``, ``enc0_b0.conv1.w``, ``dec0_b0.proj.w``,
``down0.bn.mean``, ``up0.conv.w``, ``head.w``, ``head.b``), kernels laid
out (*k, C_in, C_out) with the 3^D offsets in C order of {-1, 0, 1}^D and
the 2^D octants in C order of x mod 2.

The input is a padded sparse batch (coords (B, P, D), values, labels,
npoints): a site per distinct voxel of an event inside [0, extent)^D,
whose feature is clip(value * scale, 0, clip) and label that of its last
point (a later point of the same voxel wins). The loss is the mean over
the active sites of weight * softmax cross-entropy, the class-balance
weight n / (num_class * sites of the class) over each event's sites.
Adam clips the global gradient norm and follows the constant or cosine
schedule with a linear warm-up. Departures from the published net: none
in the equations; the level count, BN constants and class weights are the
configuration's.

``quant`` (a rounding; None: float32): applied where a bf16 program rounds
to its compute dtype: the stem's input, every conv's kernel, every conv's
output (after the residual it adds, once), every BN + ReLU output, and in
training the gradient that reaches each conv's output. The head's logits
are not rounded (the program sums them in f32).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def true_f32():
    """float32 matmuls without TF32 for the enclosed code."""
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


def planes(m: dict) -> List[int]:
    return [m["base_filters"] * (i + 1) for i in range(m["depth"] + 1)]


def leaf_shapes(m: dict) -> Dict[str, tuple]:
    """{leaf: shape}: the parameters, then the BN statistics."""
    D, nb, C = m["dims"], m["blocks_per_level"], planes(m)
    L = len(C)
    params, stats = {}, {}

    def bn(name, c):
        params[f"{name}.scale"] = (c,)
        params[f"{name}.bias"] = (c,)
        stats[f"{name}.mean"] = (c,)
        stats[f"{name}.var"] = (c,)

    def block(name, a, b):
        bn(f"{name}.bn1", a)
        params[f"{name}.conv1.w"] = (3,) * D + (a, b)
        bn(f"{name}.bn2", b)
        params[f"{name}.conv2.w"] = (3,) * D + (b, b)
        if a != b:
            params[f"{name}.proj.w"] = (1,) * D + (a, b)

    params["stem.w"] = (3,) * D + (m["in_channels"], C[0])
    for i in range(L):
        for b in range(nb):
            block(f"enc{i}_b{b}", C[i], C[i])
        if i < L - 1:
            bn(f"down{i}.bn", C[i])
            params[f"down{i}.conv.w"] = (2,) * D + (C[i], C[i + 1])
    for i in reversed(range(L - 1)):
        bn(f"up{i}.bn", C[i + 1])
        params[f"up{i}.conv.w"] = (2,) * D + (C[i + 1], C[i])
        for b in range(nb):
            block(f"dec{i}_b{b}", 2 * C[i] if b == 0 else C[i], C[i])
    bn("head.bn", C[0])
    params["head.w"] = (1,) * D + (C[0], m["num_class"])
    params["head.b"] = (m["num_class"],)
    return {**params, **stats}


def is_stat(name: str) -> bool:
    return name.endswith((".mean", ".var"))


# -- sites and rulebooks -----------------------------------------------------------


def _key(event, coords, extent: int):
    """Packed keys: the event, then the coordinates, row-major."""
    key = event.clone()
    for d in range(coords.shape[1]):
        key = key * extent + coords[:, d]
    return key


def rulebook(batch: dict, extent: int, levels: int, *, scale: float,
             clip: float, device) -> dict:
    """The sites and pairs of one padded sparse batch: ``feat`` (n_0, 1),
    ``label`` (n_0,), ``event`` (n_0,), ``point_site`` (B, P) (-1 where a
    point is padding or outside the extent), and per level ``sc`` (the
    submanifold pairs (in, out) of each offset), between levels ``down``
    and ``up`` (the pairs of each octant), ``n`` the sites."""
    coords = torch.as_tensor(np.asarray(batch["coords"]), device=device).long()
    B, P, D = coords.shape
    npts = torch.as_tensor(np.asarray(batch["npoints"]), device=device).long()
    valid = ((torch.arange(P, device=device)[None] < npts[:, None])
             & ((coords >= 0) & (coords < extent)).all(-1)).view(-1)
    event = torch.arange(B, device=device)[:, None].expand(B, P).reshape(-1)
    pts = torch.nonzero(valid)[:, 0]
    c0, e0 = coords.view(-1, D)[pts], event[pts]
    out = {"sc": [], "down": [], "up": [], "n": []}
    prev = None
    for lvl in range(levels):
        ext = -(-extent // (1 << lvl))
        c = c0 >> lvl
        keys, inv = torch.unique(_key(e0, c, ext), return_inverse=True)
        n = len(keys)
        site_c = torch.zeros((n, D), dtype=torch.long, device=device)
        site_c[inv] = c
        site_e = torch.zeros(n, dtype=torch.long, device=device)
        site_e[inv] = e0
        out["n"].append(n)
        pairs = []
        for delta in itertools.product((-1, 0, 1), repeat=D):
            nc = site_c + torch.tensor(delta, device=device)
            inside = ((nc >= 0) & (nc < ext)).all(-1)
            want = _key(site_e, nc.clamp(0, ext - 1), ext)
            pos = torch.searchsorted(keys, want).clamp(max=n - 1)
            hit = inside & (keys[pos] == want)
            rows = torch.nonzero(hit)[:, 0]
            pairs.append((pos[rows], rows))         # (in, out)
        out["sc"].append(pairs)
        if lvl == 0:
            # the last point of each voxel wins
            last = torch.full((n,), -1, dtype=torch.long, device=device)
            last.scatter_reduce_(0, inv, pts, reduce="amax")
            v = torch.as_tensor(np.asarray(batch["values"]),
                                device=device).float().view(-1)[last]
            lab = torch.as_tensor(np.asarray(batch["labels"]),
                                  device=device).long().view(-1)[last]
            out["feat"] = torch.clamp(v * scale, 0.0, clip)[:, None]
            out["label"], out["event"] = lab, site_e
            ps = torch.full((B * P,), -1, dtype=torch.long, device=device)
            ps[pts] = inv
            out["point_site"] = ps.view(B, P)
        else:
            # each finer site's parent and octant
            fc, fe, fn = prev
            parent = torch.searchsorted(keys, _key(fe, fc >> 1, ext))
            octant = torch.zeros(fn, dtype=torch.long, device=device)
            for d in range(D):
                octant = octant * 2 + (fc[:, d] & 1)
            rows = torch.arange(fn, device=device)
            sel = [octant == o for o in range(1 << D)]
            out["down"].append([(rows[s], parent[s]) for s in sel])
            out["up"].append([(parent[s], rows[s]) for s in sel])
        prev = (site_c, site_e, n)
    return out


# -- the net ---------------------------------------------------------------------


def _pairs_conv(x, w, pairs, n_out: int) -> torch.Tensor:
    y = x.new_zeros((n_out, w.shape[-1]))
    for k, (src, dst) in enumerate(pairs):
        if len(src):
            y.index_add_(0, dst, x.index_select(0, src) @ w[k])
    return y


def conv(x: torch.Tensor, w: torch.Tensor, pairs, n_out: int) -> torch.Tensor:
    """sum over offsets k of x[in] @ w[k] into the rows ``out`` of an
    (n_out, C_out) output; ``pairs`` None: the 1x1 map. Under autograd the
    gathered rows are not kept: the backward recomputes them
    (torch.utils.checkpoint), so that three training steps at 768^3 fit on
    one card beside the float8 control's."""
    w = w.reshape((-1,) + tuple(w.shape[-2:]))
    if pairs is None:
        return x @ w[0]
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return torch.utils.checkpoint.checkpoint(
            _pairs_conv, x, w, pairs, n_out, use_reentrant=False)
    return _pairs_conv(x, w, pairs, n_out)


def forward(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
            rb: dict, m: dict, *, mode: str = "train",
            quant: Quant = None) -> torch.Tensor:
    """The site logits (n_0, num_class). ``mode``: 'train' normalizes with
    the batch's biased statistics, 'eval' with ``stats``, 'calibrate'
    writes the batch's statistics into ``stats`` and normalizes with
    them."""
    q = quant or (lambda t: t)
    eps, nb, C = m["bn_eps"], m["blocks_per_level"], planes(m)
    L = len(C)

    def hooked(y):
        if quant is not None and y.requires_grad:
            y.register_hook(lambda g: quant(g))
        return y

    def sc(x, name, lvl, residual=None):
        y = conv(x, q(params[name]), rb["sc"][lvl], rb["n"][lvl])
        return q(hooked(y if residual is None else y + residual))

    def bnr(x, name):
        scale, bias = params[f"{name}.scale"], params[f"{name}.bias"]
        if mode == "calibrate":
            stats[f"{name}.mean"] = x.mean(0)
            stats[f"{name}.var"] = x.var(0, unbiased=False)
        if mode == "train":
            y = F.batch_norm(x, None, None, scale, bias, training=True,
                             eps=eps)
        else:
            y = F.batch_norm(x, stats[f"{name}.mean"], stats[f"{name}.var"],
                             scale, bias, training=False, eps=eps)
        return q(F.relu(y))

    def block(x, name, lvl):
        h = sc(bnr(x, f"{name}.bn1"), f"{name}.conv1.w", lvl)
        h = bnr(h, f"{name}.bn2")
        proj = params.get(f"{name}.proj.w")
        short = x if proj is None else q(hooked(conv(x, q(proj), None, 0)))
        return sc(h, f"{name}.conv2.w", lvl, residual=short)

    h = sc(q(rb["feat"]), "stem.w", 0)
    skips = []
    for i in range(L):
        for b in range(nb):
            h = block(h, f"enc{i}_b{b}", i)
        if i < L - 1:
            skips.append(h)
            h = q(hooked(conv(bnr(h, f"down{i}.bn"), q(params[f"down{i}.conv.w"]),
                              rb["down"][i], rb["n"][i + 1])))
    for i in reversed(range(L - 1)):
        h = q(hooked(conv(bnr(h, f"up{i}.bn"), q(params[f"up{i}.conv.w"]),
                          rb["up"][i], rb["n"][i])))
        h = torch.cat([skips[i], h], -1)
        for b in range(nb):
            h = block(h, f"dec{i}_b{b}", i)
    h = bnr(h, "head.bn")
    return hooked(conv(h, q(params["head.w"]), None, 0)) + params["head.b"]


def at_points(rows: torch.Tensor, point_site: torch.Tensor) -> torch.Tensor:
    """Site rows (n, C) -> (B, P, C) at the points, zeros elsewhere."""
    idx = point_site.reshape(-1)
    out = rows[idx.clamp(min=0)] * (idx >= 0)[:, None].to(rows.dtype)
    return out.reshape(point_site.shape + (rows.shape[-1],))


def class_weights(label, event, B: int, num_class: int, mode: str):
    if mode == "ones":
        return torch.ones(len(label), device=label.device)
    if mode != "class_balance":
        raise ValueError(f"the reference has no weight mode {mode!r}")
    counts = torch.zeros((B, num_class), device=label.device)
    counts.index_put_((event, label), torch.ones(len(label),
                                                 device=label.device),
                      accumulate=True)
    n = counts.sum(1, keepdim=True)
    w = torch.where(counts > 0, n / (num_class * counts.clamp(min=1)),
                    torch.zeros_like(counts))
    return w[event, label]


def weighted_xent(logits, label, weight):
    true = logits.gather(-1, label[:, None])[:, 0]
    return torch.mean(weight * (torch.logsumexp(logits, -1) - true))


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


# -- the computations of a cell -----------------------------------------------------


def build(conf: dict, batch: dict, device) -> dict:
    d, m = conf["data"], conf["model"]
    return rulebook(batch, d["image_size"], m["depth"] + 1,
                    scale=d["normalize_scale"], clip=d["normalize_clip"],
                    device=device)


def train_steps(conf: dict, params: Dict[str, torch.Tensor],
                batches: List[dict], *, device, quant: Quant = None) -> dict:
    """Adam steps from ``params`` (not modified), one per padded sparse
    batch: each step's loss, the first step's logits at the points (B, P,
    num_class) on the host, the per-leaf norms of its clipped gradient,
    and the per-leaf norms of the parameters' change over all steps."""
    m, o = conf["model"], conf["optim"]
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first, first_logits = [], None, None
    with true_f32():
        for step, batch in enumerate(batches, 1):
            rb = build(conf, batch, device)
            logits = forward(p, {}, rb, m, mode="train", quant=quant)
            if step == 1:
                first_logits = at_points(logits.detach(),
                                         rb["point_site"]).cpu()
            w = class_weights(rb["label"], rb["event"], len(batch["npoints"]),
                              m["num_class"], batch.get(
                                  "weight_mode", conf["data"]["weight_mode"]))
            loss = weighted_xent(logits, rb["label"], w)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            del logits, rb
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
def train_logits(conf: dict, params, batch: dict, *, device,
                 quant: Quant = None) -> torch.Tensor:
    """The train-mode forward's logits at the points, on the host."""
    with true_f32():
        rb = build(conf, batch, device)
        p = {k: v.float() for k, v in params.items()}
        return at_points(forward(p, {}, rb, conf["model"], mode="train",
                                 quant=quant), rb["point_site"]).cpu()


@torch.no_grad()
def calibrate(conf: dict, params, stats, batch: dict, *, device) -> None:
    """``stats`` from the float32 forward's batch statistics over
    ``batch``."""
    with true_f32():
        forward(params, stats, build(conf, batch, device), conf["model"],
                mode="calibrate")


@torch.no_grad()
def analyse(conf: dict, params, stats, batch: dict, *, device,
            quant: Quant = None) -> dict:
    """The analysis of one batch: softmax scores at the points (B, P,
    num_class), the confusion counts over the active sites, the sites
    counted, the charged sites of each event and those of them whose
    prediction is right."""
    K = conf["model"]["num_class"]
    with true_f32():
        rb = build(conf, batch, device)
        logits = forward(params, stats, rb, conf["model"], mode="eval",
                         quant=quant)
        pred = logits.argmax(-1)
        lab = rb["label"]
        conf_m = torch.bincount(pred * K + lab, minlength=K * K)
        charged = rb["feat"][:, 0] > 0
        B = rb["point_site"].shape[0]
        n_nonzero = torch.zeros(B, device=pred.device).index_add_(
            0, rb["event"], charged.float())
        return {"pscores": at_points(torch.softmax(logits, -1),
                                     rb["point_site"]).cpu().numpy(),
                "conf": conf_m.reshape(K, K).cpu().numpy().astype(np.float64),
                "n_pixels": float(len(pred)),
                "n_nonzero": n_nonzero.cpu().numpy().astype(np.float64),
                "correct_nonzero": float(((pred == lab) & charged).sum())}


def pair_counts(conf: dict, batch: dict, *, device="cpu") -> dict:
    """The pairs of each convolution kind of one batch: ``sc`` per level,
    ``down`` per level below the last, and the sites ``n`` per level."""
    rb = build(conf, batch, device)
    return {"sc": [sum(len(s) for s, _ in pairs) for pairs in rb["sc"]],
            "down": [sum(len(s) for s, _ in pairs) for pairs in rb["down"]],
            "n": rb["n"]}


def step_flops(conf: dict, batch: dict, *, train: bool, device="cpu") -> int:
    """Useful FLOPs of one batch (2 x pairs x C_in x C_out a conv, each
    way): the forward of every conv and linear map, and with ``train``
    their weight gradients and the input gradient of all but the stem."""
    m = conf["model"]
    C, nb, D = planes(m), m["blocks_per_level"], m["dims"]
    L = len(C)
    pc = pair_counts(conf, batch, device=device)
    macs = pc["sc"][0] * m["in_channels"] * C[0]      # the stem
    stem = macs
    for i in range(L):
        macs += nb * 2 * pc["sc"][i] * C[i] * C[i]     # encoder blocks
        if i < L - 1:
            macs += pc["down"][i] * C[i] * C[i + 1]    # Down
            macs += pc["down"][i] * C[i + 1] * C[i]    # Up: one pair a site
            a = 2 * C[i]
            macs += pc["sc"][i] * (a * C[i] + C[i] * C[i])  # first block
            macs += pc["n"][i] * a * C[i]              # its 1x1 map
            macs += (nb - 1) * 2 * pc["sc"][i] * C[i] * C[i]
    macs += pc["n"][0] * C[0] * m["num_class"]         # the head
    if not train:
        return 2 * macs
    return 2 * (3 * macs - stem)
