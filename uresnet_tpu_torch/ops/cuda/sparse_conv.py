"""Sparse convolutions over a rulebook as CUDA kernels, with their plain
versions, registered as PyTorch operators (csrc/sparse_conv.cu).

A convolution of the sparse U-ResNet (models/sparse_uresnet.py) is a
`Rule` of ops/sparse.py: a table (K, n_out) int32 whose entry k, j is the
input row that offset k brings to output row j, or -1 (None: the identity,
K = 1, the 1x1 maps), and the table's pairs listed offset-major in runs of
32 for the weight gradient. Three ops:

* ``sparse_conv_fwd(x, w, table, residual, bias, out_f32)``: out[j] =
  sum_k x[table[k, j]] @ w[k] (+ residual[j]) (+ bias), summed in f32 and
  rounded once to x's dtype, or kept in f32 with ``out_f32``.
* ``sparse_conv_dgrad(dy, w, table, mirror)``: dx[i] = sum_k
  dy[table[k, i]] @ w[k']^T, k' = K - 1 - k with ``mirror`` (the
  submanifold convolution's own table: its offsets are symmetric), else k
  (the other table of a strided pair: ``up`` for ``down`` and back).
* ``sparse_conv_wgrad(x, dy, table, pairs, chunk_k, K)``: dw[k] = sum_j
  x[table[k, j]]^T dy[j], f32 (f64 for f64 operands).

Each is an operator of the ``uresnet_tpu_torch`` torch.library namespace:
on CUDA, bf16 operands, one launch of its kernel (other dtypes raise:
nothing falls back); on the CPU its plain version, any float dtype. The
forward and the input gradient are csrc's ``sparse_gemm_kernel``, the
weight gradient its ``sparse_wgrad_kernel``. A counter per op, bumped
where its kernel launches (the plain versions count nothing):
``launches_sparse_conv_fwd``, ``launches_sparse_conv_dgrad``,
``launches_sparse_conv_wgrad``. `sparse_conv` is the convolution as an
autograd function over the three.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

launches_sparse_conv_fwd = 0
launches_sparse_conv_dgrad = 0
launches_sparse_conv_wgrad = 0

CHUNK = 32   # pairs a weight-gradient step (csrc/sparse_conv.cu kWR)
TILES = (16, 32, 48, 64, 96)  # the kernels' channel tiles


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _gather(x: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    """x's rows at ``rows`` (int, -1: a zero row); all of x without."""
    if rows is None:
        return x
    rows = rows.long()
    return x[rows.clamp(min=0)] * (rows >= 0)[:, None].to(x.dtype)


# -- the plain versions ------------------------------------------------------


def sparse_conv_fwd_reference(x, w, table, residual, bias,
                              out_f32: bool) -> torch.Tensor:
    acc = _acc(x.dtype)
    xs, ws = x.to(acc), w.to(acc)
    n = x.shape[0] if table is None else table.shape[1]
    y = xs.new_zeros((n, w.shape[2]))
    for k in range(w.shape[0]):
        y += _gather(xs, None if table is None else table[k]) @ ws[k]
    if residual is not None:
        y += residual.to(acc)
    if bias is not None:
        y += bias.to(acc)
    return y if out_f32 else y.to(x.dtype)


def sparse_conv_dgrad_reference(dy, w, table, mirror: bool) -> torch.Tensor:
    acc = _acc(dy.dtype)
    ds, ws = dy.to(acc), w.to(acc)
    K = w.shape[0]
    n = dy.shape[0] if table is None else table.shape[1]
    dx = ds.new_zeros((n, w.shape[1]))
    for k in range(K):
        g = _gather(ds, None if table is None else table[k])
        dx += g @ ws[K - 1 - k if mirror else k].T
    return dx.to(dy.dtype)


def sparse_conv_wgrad_reference(x, dy, table, pairs, chunk_k,
                                K: int) -> torch.Tensor:
    acc = _acc(x.dtype)
    xs, ds = x.to(acc), dy.to(acc)
    return torch.stack([_gather(xs, None if table is None else table[k]).T
                        @ ds for k in range(K)])


# -- the kernels -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with the C signatures of csrc/sparse_conv.cu."""
    from uresnet_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.uresnet_sparse_gemm.argtypes = ([i32, i32] + [ptr] * 6
                                        + [i64] + [i32] * 6 + [ptr])
    lib.uresnet_sparse_wgrad.argtypes = ([i32] + [ptr] * 6 + [i64, i64]
                                         + [i32] * 5 + [ptr])
    for fn in (lib.uresnet_sparse_gemm, lib.uresnet_sparse_wgrad):
        fn.restype = ctypes.c_int
    lib.uresnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.uresnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile(cout: int) -> int:
    """The kernels' output-channel tile for ``cout`` channels: the least of
    TILES that holds them, else the largest (with more tiles)."""
    return next((t for t in TILES if t >= cout), TILES[-1])


def wgrad_share(n_chunks: int, tiles: int, sms: int) -> int:
    """Chunks a weight-gradient block takes: about 8 blocks an SM."""
    return max(1, -(-n_chunks * tiles // (8 * sms)))


def _vec(*ts) -> int:
    """Whether rows of every tensor can be read 16 bytes at a time."""
    return int(all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
                   for t in ts))


def _check(what: str, bf16=(), tables=(), f32=()):
    dev = None
    for t in (*bf16, *tables, *f32):
        dev = dev or t.device
        ok = t.device == dev and t.is_contiguous()
        if not ok:
            raise ValueError(f"{what}: operands must be contiguous on one "
                             f"device, got {t.device} {tuple(t.shape)}")
    for t in bf16:
        if t.dtype is not torch.bfloat16:
            raise TypeError(f"{what} runs bfloat16 operands on the card, "
                            f"got {t.dtype}")
    for t in tables:
        if t.dtype is not torch.int32:
            raise TypeError(f"{what}: tables are int32, got {t.dtype}")
    for t in f32:
        if t.dtype is not torch.float32:
            raise TypeError(f"{what}: a bias is float32, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(x) -> int:
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _raise_if(err: int, kernel: str):
    if err != 0:
        msg = _lib().uresnet_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def _on_device(fn):
    """Run a CUDA implementation with its first operand's device current."""
    @functools.wraps(fn)
    def run(*args):
        index = args[0].device.index
        if index == torch._C._cuda_getDevice():
            return fn(*args)
        with torch.cuda.device(index):
            return fn(*args)
    return run


def _gemm(x, w, table, residual, bias, out, transpose: bool, mirror: bool):
    """One launch of sparse_gemm_kernel: out (n, cout) from x (m, cin)."""
    K = w.shape[0]
    cin = x.shape[1]
    n, cout = out.shape
    if table is None and K != 1:
        raise ValueError(f"the identity table has one offset, w has {K}")
    if table is not None and table.shape[0] != K:
        raise ValueError(f"table of {table.shape[0]} offsets, w of {K}")
    _raise_if(_lib().uresnet_sparse_gemm(
        tile(cout), int(out.dtype is torch.float32), x.data_ptr(),
        w.data_ptr(), _ptr(table), _ptr(residual), _ptr(bias),
        out.data_ptr(), n, cin, cout, K, int(transpose), int(mirror),
        _vec(x), _stream(x)), "sparse_gemm_kernel")


@_on_device
def _fwd_cuda(x, w, table, residual, bias, out_f32):
    global launches_sparse_conv_fwd
    _check("sparse_conv_fwd", (x, w) + (() if residual is None else
                                         (residual,)),
           () if table is None else (table,), () if bias is None else (bias,))
    n = x.shape[0] if table is None else table.shape[1]
    out = x.new_empty((n, w.shape[2]),
                      dtype=torch.float32 if out_f32 else x.dtype)
    if n:
        _gemm(x, w, table, residual, bias, out, False, False)
        launches_sparse_conv_fwd += 1
    return out


@_on_device
def _dgrad_cuda(dy, w, table, mirror):
    global launches_sparse_conv_dgrad
    _check("sparse_conv_dgrad", (dy, w), () if table is None else (table,))
    n = dy.shape[0] if table is None else table.shape[1]
    dx = dy.new_empty((n, w.shape[1]))
    if n:
        _gemm(dy, w, table, None, None, dx, True, mirror)
        launches_sparse_conv_dgrad += 1
    return dx


@_on_device
def _wgrad_cuda(x, dy, table, pairs, chunk_k, K):
    global launches_sparse_conv_wgrad
    tables = tuple(t for t in (table, pairs, chunk_k) if t is not None)
    _check("sparse_conv_wgrad", (x, dy), tables)
    if (table is None) != (pairs is None) or (pairs is None) != (
            chunk_k is None):
        raise ValueError("sparse_conv_wgrad takes a table with its pairs "
                         "and chunks, or none of them")
    cin, cout = x.shape[1], dy.shape[1]
    dw = torch.zeros((K, cin, cout), dtype=torch.float32, device=x.device)
    n_rows = dy.shape[0]
    n_chunks = (-(-n_rows // CHUNK) if pairs is None
                else chunk_k.shape[0])
    if n_chunks:
        bn = tile(cout)
        tiles = -(-cin // 64) * -(-cout // bn)
        _raise_if(_lib().uresnet_sparse_wgrad(
            bn, x.data_ptr(), dy.data_ptr(), _ptr(table), _ptr(pairs),
            _ptr(chunk_k), dw.data_ptr(), n_rows, n_chunks,
            wgrad_share(n_chunks, tiles, _sms(x.device.index)), cin, cout,
            _vec(x), _vec(dy), _stream(x)), "sparse_wgrad_kernel")
        launches_sparse_conv_wgrad += 1
    return dw


# -- the operators -----------------------------------------------------------


def _fwd_fake(x, w, table, residual, bias, out_f32):
    n = x.shape[0] if table is None else table.shape[1]
    return x.new_empty((n, w.shape[2]),
                       dtype=_acc(x.dtype) if out_f32 else x.dtype)


def _dgrad_fake(dy, w, table, mirror):
    n = dy.shape[0] if table is None else table.shape[1]
    return dy.new_empty((n, w.shape[1]))


def _wgrad_fake(x, dy, table, pairs, chunk_k, K):
    return x.new_empty((K, x.shape[1], dy.shape[1]), dtype=_acc(x.dtype))


_LIB = torch.library.Library("uresnet_tpu_torch", "FRAGMENT")
for _name, _schema, _cpu, _cuda, _fake in (
        ("sparse_conv_fwd", "(Tensor x, Tensor w, Tensor? table, "
         "Tensor? residual, Tensor? bias, bool out_f32) -> Tensor",
         sparse_conv_fwd_reference, _fwd_cuda, _fwd_fake),
        ("sparse_conv_dgrad", "(Tensor dy, Tensor w, Tensor? table, "
         "bool mirror) -> Tensor",
         sparse_conv_dgrad_reference, _dgrad_cuda, _dgrad_fake),
        ("sparse_conv_wgrad", "(Tensor x, Tensor dy, Tensor? table, "
         "Tensor? pairs, Tensor? chunk_k, int K) -> Tensor",
         sparse_conv_wgrad_reference, _wgrad_cuda, _wgrad_fake)):
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"uresnet_tpu_torch::{_name}", _fake,
                                lib=_LIB)
_ops = torch.ops.uresnet_tpu_torch
_fwd_op = _ops.sparse_conv_fwd.default
_dgrad_op = _ops.sparse_conv_dgrad.default
_wgrad_op = _ops.sparse_conv_wgrad.default


def sparse_conv_fwd(x, w, table, residual=None, bias=None, *,
                    out_f32: bool = False) -> torch.Tensor:
    """(n_out, C_out) = sum_k x[table[k]] @ w[k] (+ residual) (+ bias)."""
    return _fwd_op(x, w, table, residual, bias, out_f32)


def sparse_conv_dgrad(dy, w, table, *, mirror: bool) -> torch.Tensor:
    """The input gradient over ``table`` (module docstring)."""
    return _dgrad_op(dy, w, table, mirror)


def sparse_conv_wgrad(x, dy, table, pairs, chunk_k, K: int) -> torch.Tensor:
    """(K, C_in, C_out) f32: dw[k] = sum_j x[table[k, j]]^T dy[j]."""
    return _wgrad_op(x, dy, table, pairs, chunk_k, K)


class _SparseConv(torch.autograd.Function):
    """y = sparse_conv_fwd(x, w as x's dtype, rule) (+ residual) (+ bias);
    the backward: the input gradient over ``back`` (the mirrored rule, or
    the strided pair's other table), the f32 weight gradient over
    ``rule``'s pairs, the residual's gradient dy, the bias's dy summed. The
    output gradient is rounded to x's dtype for the two kernels, as every
    operand of a conv."""

    @staticmethod
    def forward(ctx, x, w, rule, back, mirror, residual, bias, out_f32):
        wc = w.to(x.dtype)
        y = sparse_conv_fwd(x, wc, rule.table, residual, bias,
                            out_f32=out_f32)
        ctx.save_for_backward(x, wc)
        ctx.rule, ctx.back, ctx.mirror = rule, back, mirror
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dyc = dy.to(x.dtype).contiguous()
        rule = ctx.rule
        dx = dres = db = None
        if ctx.needs_input_grad[0]:
            dx = sparse_conv_dgrad(dyc, wc, ctx.back.table, mirror=ctx.mirror)
        dw = sparse_conv_wgrad(x, dyc, rule.table, rule.pairs, rule.chunk_k,
                               wc.shape[0])
        if ctx.res_dtype is not None:
            dres = dy.to(ctx.res_dtype)
        if ctx.has_bias:
            db = dy.sum(0, dtype=_acc(dy.dtype))
        return dx, dw, None, None, None, dres, db, None


def sparse_conv(x: torch.Tensor, w: torch.Tensor, rule, back=None, *,
                mirror: bool = False, residual: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                out_f32: bool = False) -> torch.Tensor:
    """The convolution of ``rule`` (ops/sparse.py `Rule`) with the kernel
    ``w`` (K, C_in, C_out) (any float dtype: cast to x's, its gradient in
    its own), differentiable in x, w, residual and bias. ``back``: the
    rule of the input gradient (default ``rule``), ``mirror`` its offsets
    mirrored."""
    return _SparseConv.apply(x, w, rule, rule if back is None else back,
                             mirror, residual, bias, out_f32)
