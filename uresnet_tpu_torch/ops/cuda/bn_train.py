"""Train-mode BatchNorm as four CUDA kernels, with their plain versions,
registered as PyTorch operators (csrc/bn_train.cu).

ops/norm.py's ``batch_norm_train`` runs on these four ops: the statistics
and the affine (+ residual) (+ ReLU) forward, the gradient sums and the
input gradient backward. An activation is contiguous and seen as
(rows, W), W = phases * C: column j is channel j % C, so a space-to-depth
packed tensor's phases are summed into the per-channel sums.

* ``bn_train_stats(x, C, eps, running_mean, running_var, momentum)``:
  (7C + 1,) ``[sum x | sum x^2 | count | mean | var | rstd | new running
  mean | new running var]``, count = rows * phases, the elements of each
  channel, var the biased E[x^2] - mean^2, rstd = 1 / sqrt(var + eps)
  (`moments`), a running stat moved as ``state * momentum + stat * (1 -
  momentum)`` (`running`).
* ``bn_train_apply(x, residual, mean, rstd, scale, bias, relu)``:
  ``relu?(x * g + b [+ residual])``, g = scale * rstd, b = bias - mean * g.
* ``bn_train_grad_reduce(dout, x, out, mean, rstd, scale, bias, relu)``:
  (2C,) ``[sum dy' | sum dy' * xhat]``, xhat = (x - mean) * rstd, dy' =
  dout where the ReLU passed (``out > 0`` where ``out`` is given, else
  ``x * g + b > 0``), dout without the ReLU.
* ``bn_train_grad_input(dout, x, out, mean, rstd, scale, bias, sums,
  count, relu, residual)``: (dx, dres), dx = g * (dy' - sums[:C] / n -
  xhat * sums[C:] / n), n = count, and dres = dy' when ``residual`` (else
  an empty tensor).

Per-channel vectors and sums are in the statistics' dtype: f32, or f64 for
f64 activations. The kernels take f32, bf16, f16 and f64 activations.

Each is an operator of the ``uresnet_tpu_torch`` torch.library namespace:
on CUDA one launch of its kernel (or it raises: nothing falls back), on
the CPU its plain version, and a fake implementation for tracing; the
profiler records each call by name. The launch geometry comes from the
input alone (`geometry`). The two reductions of a stream share one
workspace (`_workspace`): their partial sums and a ticket that each
launch leaves at 0. A counter per kernel, bumped where it launches (the
plain versions count nothing): ``launches_bn_train_stats``,
``launches_bn_train_apply``, ``launches_bn_train_grad_reduce``,
``launches_bn_train_grad_input``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

launches_bn_train_stats = 0
launches_bn_train_apply = 0
launches_bn_train_grad_reduce = 0
launches_bn_train_grad_input = 0

THREADS = 256  # a block's threads (csrc/bn_train.cu kThreads)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}
_STATS_DTYPE = {dt: torch.promote_types(dt, torch.float32)
                for dt in _DTYPE_CODE}


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the statistics and of every per-channel vector."""
    return torch.promote_types(dtype, torch.float32)


# -- the plain versions ------------------------------------------------------


def _channels(x: torch.Tensor, C: int) -> torch.Tensor:
    """(rows, W) in the statistics' dtype, seen as (rows * phases, C)."""
    return x.to(stats_dtype(x.dtype)).reshape(-1, C)


def _affine(mean, rstd, scale, bias):
    g = scale * rstd
    return g, bias - mean * g


def _grad_out(dout, x, out, mean, rstd, scale, bias, relu):
    """(dy', xhat), each (rows * phases, C) in the statistics' dtype."""
    C = mean.shape[0]
    xs = _channels(x, C)
    dy = _channels(dout, C)
    if relu:
        if out is not None:
            keep = _channels(out, C) > 0
        else:
            g, b = _affine(mean, rstd, scale, bias)
            keep = xs * g + b > 0
        dy = torch.where(keep, dy, torch.zeros((), dtype=dy.dtype))
    return dy, (xs - mean) * rstd


def moments(sums: torch.Tensor, C: int, eps: float):
    """(mean, var, rstd) from ``[sum x | sum x^2 | count]``: the biased
    variance E[x^2] - mean^2, rstd = 1 / sqrt(var + eps)."""
    n = sums[2 * C]
    mean = sums[:C] / n
    var = sums[C:2 * C] / n - mean.square()
    return mean, var, torch.rsqrt(var + eps)


def running(state: torch.Tensor, stat: torch.Tensor,
            momentum: float) -> torch.Tensor:
    """A running stat moved by the batch's."""
    return state * momentum + stat * (1.0 - momentum)


def bn_train_stats_reference(x: torch.Tensor, C: int, eps: float,
                             running_mean: torch.Tensor,
                             running_var: torch.Tensor,
                             momentum: float) -> torch.Tensor:
    xs = _channels(x, C)
    sums = torch.cat([xs.sum(0), xs.square().sum(0),
                      xs.new_full((1,), xs.shape[0])])
    mean, var, rstd = moments(sums, C, eps)
    return torch.cat([sums, mean, var, rstd,
                      running(running_mean, mean, momentum),
                      running(running_var, var, momentum)])


def bn_train_apply_reference(x, residual, mean, rstd, scale, bias,
                             relu: bool) -> torch.Tensor:
    g, b = _affine(mean, rstd, scale, bias)
    z = _channels(x, mean.shape[0]) * g + b
    if residual is not None:
        z = z + _channels(residual, mean.shape[0])
    if relu:
        z = torch.relu(z)
    return z.to(x.dtype).reshape(x.shape)


def bn_train_grad_reduce_reference(dout, x, out, mean, rstd, scale, bias,
                                   relu: bool) -> torch.Tensor:
    dy, xhat = _grad_out(dout, x, out, mean, rstd, scale, bias, relu)
    return torch.cat([dy.sum(0), (dy * xhat).sum(0)])


def bn_train_grad_input_reference(dout, x, out, mean, rstd, scale, bias,
                                  sums, count, relu: bool, residual: bool
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    C = mean.shape[0]
    dy, xhat = _grad_out(dout, x, out, mean, rstd, scale, bias, relu)
    inv_n = 1.0 / count
    dx = (scale * rstd) * (dy - sums[:C] * inv_n - xhat * (sums[C:] * inv_n))
    dres = (dy.to(x.dtype, copy=True).reshape(x.shape) if residual
            else x.new_empty((0,)))
    return dx.to(x.dtype).reshape(x.shape), dres


# -- the kernels -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with the C signatures of csrc/bn_train.cu."""
    from uresnet_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    geom = [ctypes.c_int] * 5  # dtype, vec, tx, gx, gy
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {
        "uresnet_bn_train_stats": geom + [ptr] * 6 + [
            i64, i32, i32] + [ctypes.c_double] * 3 + [ptr],
        "uresnet_bn_train_apply": geom + [ptr] * 7 + [i64, i32, i32, i32, ptr],
        "uresnet_bn_train_grad_reduce": geom + [ptr] * 10 + [i64, i32, i32,
                                                             i32, ptr],
        "uresnet_bn_train_grad_input": geom + [ptr] * 11 + [i64, i32, i32,
                                                            i32, ptr],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.uresnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.uresnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def geometry(rows: int, W: int, C: int, itemsize: int, aligned: bool,
             sms: int, reduce: bool) -> Tuple[int, int, int, int]:
    """(vec, tx, gx, gy) of a launch over a (rows, W) activation of C
    channels.

    vec: elements a thread loads at once, 16 bytes where W and every
    pointer allow, else 1. tx: threads along a row (all of it up to
    THREADS vectors; wider rows take gy column tiles); each block walks
    THREADS // tx rows at a time, gx blocks down the rows, up to 4 blocks
    an SM. A reduction's blocks write 2 * C partial sums each (2 * W with
    column tiles), which its last block sums alone: it takes no more
    blocks than keep them within 32 Ki values (on the H100 that block's
    time grows with them; at C = 512, 16-64 blocks gave the least time)."""
    vec = 16 // itemsize
    if not aligned or W % vec:
        vec = 1
    nv = W // vec
    tx = min(nv, THREADS)
    gy = -(-nv // tx)
    per = max(1, 4 * sms // gy)
    if reduce:
        per = min(per, max(1, 16384 // (C if gy == 1 else W)))
    return vec, tx, min(max(1, -(-rows // (THREADS // tx))), per), gy


def _check(x: torch.Tensor, C: int, acts=(), vecs=()):
    """Raise on operands the kernels do not take: activations (rows, W)
    like ``x``; ``vecs``, (tensor, length) pairs, per-channel vectors and
    sums in the statistics' dtype; all contiguous on ``x``'s device."""
    dt = x.dtype
    if dt not in _DTYPE_CODE or x.dim() != 2 or C < 1 or x.shape[1] % C:
        raise (TypeError if dt not in _DTYPE_CODE else ValueError)(
            f"bn_train takes (rows, W) float32, bfloat16, float16 or float64 "
            f"activations, W a multiple of C = {C}: got {dt} "
            f"{tuple(x.shape)}")
    dev, sd, shape = x.get_device(), _STATS_DTYPE[dt], x.shape
    ok = x.is_contiguous()
    for t in acts:
        ok = (ok and t.dtype is dt and t.get_device() == dev
              and t.shape == shape and t.is_contiguous())
    for t, n in vecs:
        ok = (ok and t.dtype is sd and t.get_device() == dev and t.dim() == 1
              and t.shape[0] == n and t.is_contiguous())
    if not ok:
        raise ValueError(
            f"bn_train operands must be contiguous on {x.device}: "
            f"activations {dt} {tuple(shape)}, per-channel operands {sd}; "
            f"got {[(t.dtype, tuple(t.shape), t.device) for t in acts]}, "
            f"{[(t.dtype, tuple(t.shape), t.device, n) for t, n in vecs]}")


def _geometry_of(x, C, acts, reduce: bool):
    rows, W = x.shape
    aligned = x.data_ptr() % 16 == 0
    for t in acts:
        aligned = aligned and t.data_ptr() % 16 == 0
    return geometry(rows, W, C, x.element_size(), aligned,
                    _sms(x.device.index), reduce)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on_device(fn):
    """Run a CUDA implementation with its first operand's device current,
    where the kernel launches."""
    @functools.wraps(fn)
    def run(*args):
        index = args[0].device.index
        if index == torch._C._cuda_getDevice():
            return fn(*args)
        with torch.cuda.device(index):
            return fn(*args)
    return run


def _stream(x) -> int:
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _raise_if(err: int, kernel: str):
    if err != 0:
        msg = _lib().uresnet_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


# (device index, stream, stats dtype) -> (ticket, partial sums): the
# reductions' workspace, one a stream, since a stream runs its launches one
# after another. Each launch leaves its ticket at 0; partials grow as
# needed (a freed buffer goes back to the caching allocator on the stream).
_WORKSPACE: Dict[Tuple[int, int, torch.dtype],
                 Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(x, stream: int, gx: int) -> Tuple[int, int]:
    """(partials pointer, ticket pointer) of room for gx * 2 * W partial
    sums on x's device and ``stream``."""
    key = (x.device.index, stream, stats_dtype(x.dtype))
    need = gx * 2 * x.shape[1]
    ws = _WORKSPACE.get(key)
    if ws is None or ws[1].numel() < need:
        ticket = (ws[0] if ws is not None else
                  torch.zeros((1,), dtype=torch.int32, device=x.device))
        ws = _WORKSPACE[key] = (ticket, torch.empty(
            (max(need, 1 << 16),), dtype=key[2], device=x.device))
    return ws[1].data_ptr(), ws[0].data_ptr()


@_on_device
def _stats_cuda(x, C, eps, running_mean, running_var, momentum):
    global launches_bn_train_stats
    _check(x, C, (), ((running_mean, C), (running_var, C)))
    rows, W = x.shape
    if x.numel() == 0:
        return bn_train_stats_reference(x, C, eps, running_mean, running_var,
                                        momentum)
    sums = torch.empty((7 * C + 1,), dtype=_STATS_DTYPE[x.dtype],
                       device=x.device)
    vec, tx, gx, gy = _geometry_of(x, C, (), reduce=True)
    stream = _stream(x)
    p_part, p_ticket = _workspace(x, stream, gx)
    _raise_if(_lib().uresnet_bn_train_stats(
        _DTYPE_CODE[x.dtype], vec, tx, gx, gy, x.data_ptr(), p_part, p_ticket,
        sums.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), rows,
        W, C, float(rows * (W // C)), float(eps), float(momentum), stream),
        "bn_train_stats")
    launches_bn_train_stats += 1
    return sums


@_on_device
def _apply_cuda(x, residual, mean, rstd, scale, bias, relu):
    global launches_bn_train_apply
    C = mean.shape[0]
    acts = () if residual is None else (residual,)
    _check(x, C, acts, ((mean, C), (rstd, C), (scale, C), (bias, C)))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows, W = x.shape
    vec, tx, gx, gy = _geometry_of(x, C, acts + (out,), reduce=False)
    _raise_if(_lib().uresnet_bn_train_apply(
        _DTYPE_CODE[x.dtype], vec, tx, gx, gy, x.data_ptr(), _ptr(residual),
        mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), rows, W, C, int(relu), _stream(x)), "bn_train_apply")
    launches_bn_train_apply += 1
    return out


@_on_device
def _grad_reduce_cuda(dout, x, out, mean, rstd, scale, bias, relu):
    global launches_bn_train_grad_reduce
    C = mean.shape[0]
    acts = (dout,) if out is None else (dout, out)
    _check(x, C, acts, ((mean, C), (rstd, C), (scale, C), (bias, C)))
    sums = torch.empty((2 * C,), dtype=mean.dtype, device=x.device)
    if x.numel() == 0:
        return sums.zero_()
    rows, W = x.shape
    vec, tx, gx, gy = _geometry_of(x, C, acts, reduce=True)
    stream = _stream(x)
    p_part, p_ticket = _workspace(x, stream, gx)
    _raise_if(_lib().uresnet_bn_train_grad_reduce(
        _DTYPE_CODE[x.dtype], vec, tx, gx, gy, dout.data_ptr(), x.data_ptr(),
        _ptr(out), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), p_part, p_ticket, sums.data_ptr(), rows, W, C,
        int(relu), stream), "bn_train_grad_reduce")
    launches_bn_train_grad_reduce += 1
    return sums


@_on_device
def _grad_input_cuda(dout, x, out, mean, rstd, scale, bias, sums, count,
                     relu, residual):
    global launches_bn_train_grad_input
    C = mean.shape[0]
    acts = (dout,) if out is None else (dout, out)
    _check(x, C, acts, ((mean, C), (rstd, C), (scale, C), (bias, C),
                        (sums, 2 * C), (count, 1)))
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual else x.new_empty((0,))
    if x.numel() == 0:
        return dx, dres
    rows, W = x.shape
    outs = (dx, dres) if residual else (dx,)
    vec, tx, gx, gy = _geometry_of(x, C, acts + outs, reduce=False)
    _raise_if(_lib().uresnet_bn_train_grad_input(
        _DTYPE_CODE[x.dtype], vec, tx, gx, gy, dout.data_ptr(), x.data_ptr(),
        _ptr(out), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), sums.data_ptr(), count.data_ptr(), dx.data_ptr(),
        dres.data_ptr() if residual else None, rows, W, C, int(relu),
        _stream(x)), "bn_train_grad_input")
    launches_bn_train_grad_input += 1
    return dx, dres


# -- the operators -----------------------------------------------------------


def _stats_fake(x, C, eps, running_mean, running_var, momentum):
    return x.new_empty((7 * C + 1,), dtype=stats_dtype(x.dtype))


def _apply_fake(x, residual, mean, rstd, scale, bias, relu):
    return torch.empty_like(x)


def _grad_reduce_fake(dout, x, out, mean, rstd, scale, bias, relu):
    return mean.new_empty((2 * mean.shape[0],))


def _grad_input_fake(dout, x, out, mean, rstd, scale, bias, sums, count, relu,
                     residual):
    return (torch.empty_like(x),
            torch.empty_like(x) if residual else x.new_empty((0,)))


# Defined with torch.library.Library, not custom_op: a 2D train step calls
# these 220 times, and custom_op's Python layers add more host time to each
# call than the dispatcher itself takes.
_LIB = torch.library.Library("uresnet_tpu_torch", "FRAGMENT")
for _name, _schema, _cpu, _cuda, _fake in (
        ("bn_train_stats", "(Tensor x, int C, float eps, Tensor running_mean, "
         "Tensor running_var, float momentum) -> Tensor",
         bn_train_stats_reference, _stats_cuda, _stats_fake),
        ("bn_train_apply", "(Tensor x, Tensor? residual, Tensor mean, "
         "Tensor rstd, Tensor scale, Tensor bias, bool relu) -> Tensor",
         bn_train_apply_reference, _apply_cuda, _apply_fake),
        ("bn_train_grad_reduce", "(Tensor dout, Tensor x, Tensor? out, "
         "Tensor mean, Tensor rstd, Tensor scale, Tensor bias, bool relu) -> "
         "Tensor", bn_train_grad_reduce_reference, _grad_reduce_cuda,
         _grad_reduce_fake),
        ("bn_train_grad_input", "(Tensor dout, Tensor x, Tensor? out, "
         "Tensor mean, Tensor rstd, Tensor scale, Tensor bias, Tensor sums, "
         "Tensor count, bool relu, bool residual) -> (Tensor, Tensor)",
         bn_train_grad_input_reference, _grad_input_cuda, _grad_input_fake)):
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"uresnet_tpu_torch::{_name}", _fake,
                                lib=_LIB)
_ops = torch.ops.uresnet_tpu_torch
_stats_op = _ops.bn_train_stats.default
_apply_op = _ops.bn_train_apply.default
_grad_reduce_op = _ops.bn_train_grad_reduce.default
_grad_input_op = _ops.bn_train_grad_input.default


def bn_train_stats(x: torch.Tensor, C: int, eps: float,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   momentum: float) -> torch.Tensor:
    """(7C + 1,) ``[sum x | sum x^2 | count | mean | var | rstd | new
    running mean | new running var]`` of a (rows, W) activation over its
    rows and phases, in the statistics' dtype (module docstring)."""
    return _stats_op(x, C, eps, running_mean, running_var, momentum)


def bn_train_apply(x, residual, mean, rstd, scale, bias, *,
                   relu: bool) -> torch.Tensor:
    """relu?(x * (scale * rstd) + (bias - mean * scale * rstd)
    [+ residual]) in x's dtype, rounded once."""
    return _apply_op(x, residual, mean, rstd, scale, bias, relu)


def bn_train_grad_reduce(dout, x, out, mean, rstd, scale, bias, *,
                         relu: bool) -> torch.Tensor:
    """(2C,) ``[sum dy' | sum dy' * xhat]`` (module docstring)."""
    return _grad_reduce_op(dout, x, out, mean, rstd, scale, bias, relu)


def bn_train_grad_input(dout, x, out, mean, rstd, scale, bias, sums, count,
                        *, relu: bool, residual: bool):
    """(dx, dres) from the gradient sums ``sums`` over ``count`` elements
    of a channel (module docstring)."""
    return _grad_input_op(dout, x, out, mean, rstd, scale, bias, sums, count,
                          relu, residual)
