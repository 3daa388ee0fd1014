"""Import reference TF1 U-ResNet checkpoints into uresnet_tpu_torch trees
(the port's own copy of uresnet_tpu/models/import_tf.py).

Capability parity (SURVEY.md §5 checkpoint row: the reference checkpoints
via `tf.train.Saver` .ckpt files [K:high]): a user migrating from the
reference brings a *trained* network, not just configs and data. This module
maps a dumped TF1 checkpoint — a flat ``{variable_name: np.ndarray}`` dict,
produced by ``uresnet_tpu_torch/tools/import_tf_ckpt.py dump`` inside any
TF environment — onto the ``(params, state)`` trees of the JAX checkpoint
layout (the port's ``UResNet`` names its parameters and buffers by the
same paths) and writes a restorable step-0 checkpoint (pair with
``train.load_file=... train.load_params_only=true`` to fine-tune, or point
``cli/infer.py`` at it directly).

Nothing here imports TensorFlow: the dump is plain numpy, the mapping is
pure index math, and every assignment is shape-validated against the
architecture the config describes (fail loudly, never guess silently).

Layout/semantics transforms (each pinned by tests/test_import_tf.py and,
for this copy, tests/test_torch_import_tf.py):

* forward convs: TF stores HWIO / DHWIO — identical to ours; copied as-is.
* transpose convs: TF `conv2d_transpose` kernels are (k, k, C_out, C_in)
  with gradient-of-conv (spatially flipped) semantics, while ops/conv.py
  `conv_transpose` correlates an UNFLIPPED (k, k, C_in, C_out) kernel over
  the zero-stuffed input (see tests/test_torch_oracle.py). The exact
  equivalence is ``w_ours = flip(w_tf, spatial_axes).swapaxes(-1, -2)`` —
  verified against `jax.vjp` of the strided SAME conv (the definition of
  TF's op) in the tests.
* conv biases feeding a BatchNorm: our conv+BN units are bias-free (BN
  absorbs any additive constant). A TF bias ``b`` is folded EXACTLY into
  the BN running mean, ``mean' = mean - b``: inference applies the same
  affine, and in training the batch statistics of ``conv(x) + b`` subtract
  ``b`` right back out, so the forward is unchanged in both modes.
* a residual-projection bias (our `proj` is bias-free and feeds the
  shortcut add, not a BN) folds into the SAME block's cb2 BN beta:
  ``relu(bn2(..) + proj(x) + b) == relu((bn2 + b)(..) + proj(x))``.
* BN gamma/beta may be absent in TF graphs built with scale=False /
  center=False — they default to ones/zeros, matching TF.

Variable-name strategy: the reference mount is empty (SURVEY.md §0), so the
exact TF scope names are unverifiable. Instead of hard-coding guessed names
the importer matches **units in graph-construction order** (the order
`UResNet` builds them — stem, enc blocks, downsamples, bottleneck,
upsamples, dec blocks, head), with three orderings for the TF side:

* ``numbered`` — tf.layers auto-numbered scopes (`conv2d_17`,
  `conv2d_transpose_3`, `batch_normalization_9`) encode creation order in
  their integer suffix; sorted per type.
* ``natural``  — digit-aware sort of full scope names (slim-style
  hierarchical scopes normally sort structurally).
plus an explicit ``--spec`` ``{our_unit_path: tf_scope}`` mapping (YAML/
JSON) overlaid on either mode — the always-sufficient escape hatch for any
unit the automatic ordering gets wrong (``enc0_b0/cb1``-style keys for
convs, ``enc0_b0/cb1/bn`` for their BatchNorms).

``auto`` picks ``numbered`` when every conv scope looks auto-numbered, else
``natural``. Every unit is shape-checked at assignment (kernel size, C_in,
C_out, BN width), residual 1×1 projections are disambiguated from 3×3
block convs by shape inside each block group, and the report (``--report``)
prints the full mapping table for human review before any training run.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from uresnet_tpu_torch.config import ModelConfig

# -- TF variable classification ----------------------------------------------

# optimizer slot / bookkeeping variables dropped before mapping
_SLOT_SUFFIXES = {
    "Adam", "Adam_1", "RMSProp", "RMSProp_1", "Momentum", "momentum",
    "ExponentialMovingAverage", "accumulator",
}
_GLOBAL_VARS = {"global_step", "beta1_power", "beta2_power", "save_counter"}

_KERNEL_LEAVES = {"kernel", "weights", "w", "weight", "filter"}
_BIAS_LEAVES = {"bias", "biases", "b"}
# TF BN leaf -> our leaf; both tf.layers and slim use the gamma/beta names
_BN_PARAM_LEAVES = {"gamma": "scale", "beta": "bias"}
_BN_STATE_LEAVES = {"moving_mean": "mean", "moving_variance": "var"}

_NUMBERED_RE = re.compile(
    r"^(conv\d?d?(_transpose)?|convolution|deconv(olution)?\d*d?"
    r"|batch_?norm(alization)?)(_(\d+))?$")


class TFImportError(ValueError):
    """Raised on any mapping failure: wrong counts, wrong shapes, unknown
    spec keys. The message names the unit so the fix is actionable."""


@dataclasses.dataclass
class TFUnit:
    """One TF conv or BN scope: the variables grouped under one module."""

    scope: str
    kind: str                    # 'conv' | 'tconv' | 'bn'
    arrays: Dict[str, np.ndarray]  # canonical leaf -> value
    order: Tuple[Any, ...] = ()  # sort key within its kind


@dataclasses.dataclass
class Unit:
    """One unit of OUR architecture, in graph-construction order."""

    path: Tuple[str, ...]        # e.g. ('enc0_b0', 'cb1') or ('head',)
    kind: str                    # 'conv' | 'tconv'
    kernel: int
    in_ch: int
    out_ch: int
    bn: bool                     # followed by a BatchNorm
    own_bias: bool = False       # our unit keeps a bias leaf (head only)
    bias_to_beta_of: Optional[Tuple[str, ...]] = None  # proj -> cb2 bn path


def unit_sequence(cfg: ModelConfig) -> List[List[Unit]]:
    """Units in `UResNet` construction order, grouped per module.

    Groups bound the window in which automatic modes may reorder TF convs
    (a residual block's 1×1 projection may have been built before or after
    its 3×3 convs in the reference graph — shapes disambiguate within the
    group; nothing reorders across groups)."""
    f0, d, bpl = cfg.base_filters, cfg.depth, cfg.blocks_per_level
    groups: List[List[Unit]] = []
    groups.append([Unit(("stem",), "conv", 3, cfg.in_channels, f0, True)])

    def resblock(name: str, in_ch: int, out_ch: int) -> List[Unit]:
        g = [
            Unit((name, "cb1"), "conv", 3, in_ch, out_ch, True),
            Unit((name, "cb2"), "conv", 3, out_ch, out_ch, True),
        ]
        if in_ch != out_ch:
            g.append(Unit((name, "proj"), "conv", 1, in_ch, out_ch, False,
                          bias_to_beta_of=(name, "cb2", "bn")))
        return g

    for lvl in range(d):
        fl = f0 * (2 ** lvl)
        for b in range(bpl):
            groups.append(resblock(f"enc{lvl}_b{b}", fl, fl))
        groups.append([Unit((f"down{lvl}",), "conv", 3, fl, 2 * fl, True)])
    fb = f0 * (2 ** d)
    for b in range(bpl):
        groups.append(resblock(f"mid_b{b}", fb, fb))
    for lvl in reversed(range(d)):
        fl = f0 * (2 ** lvl)
        groups.append([Unit((f"up{lvl}",), "tconv", 3, 2 * fl, fl, True)])
        for b in range(bpl):
            groups.append(resblock(f"dec{lvl}_b{b}",
                                   2 * fl if b == 0 else fl, fl))
    groups.append([Unit(("head",), "conv", cfg.final_kernel, f0,
                        cfg.num_class, False, own_bias=True)])
    return groups


# -- TF dump grouping ---------------------------------------------------------


def _natural_key(s: str) -> Tuple[Any, ...]:
    return tuple(int(p) if p.isdigit() else p
                 for p in re.split(r"(\d+)", s))


def _is_slot(name: str) -> bool:
    parts = name.split("/")
    return (parts[-1] in _SLOT_SUFFIXES or parts[0] in ("training", "save")
            or name in _GLOBAL_VARS or parts[-1] in _GLOBAL_VARS)


def group_tf_dump(dump: Dict[str, np.ndarray],
                  dims: int) -> Tuple[List[TFUnit], List[TFUnit], List[TFUnit]]:
    """Group a flat TF variable dict into (convs, tconvs, bns) scope units.

    Scopes whose last component says transpose/deconv go to the tconv list;
    plain conv scopes whose kernels are actually transpose kernels (the
    reference may use bare `tf.nn.conv2d_transpose` under a generic scope)
    are caught later by shape at their `up{l}` position."""
    scopes: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in dump.items():
        if _is_slot(name):
            continue
        parts = name.split("/")
        leaf = parts[-1]
        scope = "/".join(parts[:-1]) or leaf
        scopes.setdefault(scope, {})[leaf] = np.asarray(arr)

    convs: List[TFUnit] = []
    tconvs: List[TFUnit] = []
    bns: List[TFUnit] = []
    for scope, leaves in scopes.items():
        canon: Dict[str, np.ndarray] = {}
        is_bn = any(k in leaves for k in _BN_STATE_LEAVES)
        if is_bn:
            for tf_leaf, ours in {**_BN_PARAM_LEAVES, **_BN_STATE_LEAVES}.items():
                if tf_leaf in leaves:
                    canon[ours] = leaves[tf_leaf]
            if "mean" not in canon or "var" not in canon:
                raise TFImportError(
                    f"BN scope {scope!r} lacks moving_mean/moving_variance")
            bns.append(TFUnit(scope, "bn", canon))
            continue
        kern = next((leaves[k] for k in _KERNEL_LEAVES if k in leaves), None)
        if kern is None:
            continue  # unrelated variable (e.g. a counter) — ignored
        if kern.ndim != dims + 2:
            raise TFImportError(
                f"conv scope {scope!r}: kernel rank {kern.ndim} != {dims + 2}"
                f" (model.dims={dims})")
        canon["w"] = kern
        b = next((leaves[k] for k in _BIAS_LEAVES if k in leaves), None)
        if b is not None:
            canon["b"] = b
        last = scope.split("/")[-1]
        kind = "tconv" if ("transpose" in last or "deconv" in last) else "conv"
        (tconvs if kind == "tconv" else convs).append(TFUnit(scope, kind, canon))
    return convs, tconvs, bns


def _order_units(units: List[TFUnit], mode: str) -> List[TFUnit]:
    if mode == "numbered":
        def key(u: TFUnit):
            m = _NUMBERED_RE.match(u.scope.split("/")[-1])
            if not m:
                raise TFImportError(
                    f"scope {u.scope!r} is not tf.layers auto-numbered; use "
                    f"--mode natural or an explicit --spec mapping")
            return int(m.group(6) or 0)
        return sorted(units, key=key)
    if mode == "natural":
        return sorted(units, key=lambda u: _natural_key(u.scope))
    raise TFImportError(f"unknown ordering mode {mode!r}")


def _resolve_mode(mode: str, convs: List[TFUnit]) -> str:
    if mode != "auto":
        return mode
    numbered = all(_NUMBERED_RE.match(u.scope.split("/")[-1]) for u in convs)
    return "numbered" if numbered else "natural"


# -- transforms ---------------------------------------------------------------


def tconv_kernel_from_tf(w_tf: np.ndarray) -> np.ndarray:
    """(k.., C_out, C_in) gradient-semantics TF kernel -> our (k.., C_in,
    C_out) unflipped-correlation kernel. Exact (tests pin vs jax.vjp)."""
    spatial = tuple(range(w_tf.ndim - 2))
    return np.flip(w_tf, axis=spatial).swapaxes(-1, -2)


# -- the mapper ---------------------------------------------------------------


def _expected_tf_shape(u: Unit, dims: int) -> Tuple[int, ...]:
    if u.kind == "tconv":  # TF layout: (k.., C_out, C_in)
        return (u.kernel,) * dims + (u.out_ch, u.in_ch)
    return (u.kernel,) * dims + (u.in_ch, u.out_ch)


def map_tf_dump(
    dump: Dict[str, np.ndarray],
    cfg: ModelConfig,
    *,
    mode: str = "auto",
    spec: Optional[Dict[str, str]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any], List[Tuple[str, str, str]]]:
    """Map a TF checkpoint dump onto (params, state) numpy trees.

    Returns ``(params, state, report)`` where report rows are
    ``(our_unit_path, tf_scope, transform_note)``. Raises
    :class:`TFImportError` on any count/shape mismatch.
    """
    groups = unit_sequence(cfg)
    convs, tconvs, bns = group_tf_dump(dump, cfg.dims)
    by_scope = {u.scope: u for u in convs + tconvs + bns}
    spec = dict(spec or {})

    mode = _resolve_mode(mode, convs)
    conv_q = [u for u in _order_units(convs, mode)]
    tconv_q = [u for u in _order_units(tconvs, mode)]
    bn_q = [u for u in _order_units(bns, mode)]

    # spec-pinned scopes never participate in automatic ordering
    pinned = set()
    for scope in spec.values():
        if scope not in by_scope and scope + "/bn" not in by_scope:
            raise TFImportError(f"--spec names unknown TF scope {scope!r}")
        pinned.add(scope)
    conv_q = [u for u in conv_q if u.scope not in pinned]
    tconv_q = [u for u in tconv_q if u.scope not in pinned]
    bn_q = [u for u in bn_q if u.scope not in pinned]

    n_expected = sum(len(g) for g in groups)
    n_have = len(convs) + len(tconvs)
    if n_have != n_expected:
        raise TFImportError(
            f"checkpoint has {n_have} conv kernels but the architecture "
            f"(depth={cfg.depth}, blocks_per_level={cfg.blocks_per_level}) "
            f"needs {n_expected} — wrong config or wrong checkpoint")

    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    report: List[Tuple[str, str, str]] = []
    pending_beta: Dict[Tuple[str, ...], np.ndarray] = {}

    def set_leaf(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(value)

    def pop_conv(u: Unit, pool: List[TFUnit], group_pool: List[TFUnit]):
        path_str = "/".join(u.path)
        if path_str in spec:
            tf_u = by_scope[spec[path_str]]
        elif group_pool:
            # within a block group, match by shape (proj vs cb disambiguation)
            want = _expected_tf_shape(u, cfg.dims)
            hit = next((t for t in group_pool if t.arrays["w"].shape == want),
                       None)
            if hit is None:
                raise TFImportError(
                    f"unit {path_str}: no TF kernel of shape {want} in block "
                    f"group {[t.scope for t in group_pool]}")
            group_pool.remove(hit)
            tf_u = hit
        else:
            if not pool:
                raise TFImportError(f"unit {path_str}: TF checkpoint ran out "
                                    f"of {u.kind} kernels")
            tf_u = pool.pop(0)
        want = _expected_tf_shape(u, cfg.dims)
        got = tf_u.arrays["w"].shape
        if got != want:
            raise TFImportError(
                f"unit {path_str}: TF kernel {tf_u.scope!r} has shape {got}, "
                f"expected {want}")
        return tf_u

    def pop_bn(u: Unit):
        path_str = "/".join(u.path)
        key = path_str + "/bn"
        scope = spec.get(key) or spec.get(path_str + ".bn")
        if scope is not None:
            tf_u = by_scope[scope]
        else:
            if not bn_q:
                raise TFImportError(f"unit {path_str}: TF checkpoint ran out "
                                    f"of BatchNorm scopes")
            tf_u = bn_q.pop(0)
        if tf_u.arrays["mean"].shape != (u.out_ch,):
            raise TFImportError(
                f"unit {path_str}: BN scope {tf_u.scope!r} has width "
                f"{tf_u.arrays['mean'].shape}, expected ({u.out_ch},)")
        return tf_u

    for group in groups:
        # take this group's conv kernels from the queue head so shape-based
        # proj disambiguation stays local to the block
        n_group_convs = sum(1 for u in group
                            if u.kind == "conv"
                            and "/".join(u.path) not in spec)
        group_pool = conv_q[:n_group_convs]
        del conv_q[:n_group_convs]
        for u in group:
            notes = []
            if u.kind == "tconv":
                pool = tconv_q if tconv_q or "/".join(u.path) in spec else conv_q
                tf_u = pop_conv(u, pool, [])
                w = tconv_kernel_from_tf(tf_u.arrays["w"])
                notes.append("tconv: spatial flip + IO swap")
            else:
                tf_u = pop_conv(u, conv_q, group_pool)
                w = tf_u.arrays["w"]
            bias = tf_u.arrays.get("b")
            tf_names = tf_u.scope

            if u.bn:
                # conv(+bias) -> BN unit: {conv: {w}, bn: {scale, bias}}
                tf_bn = pop_bn(u)
                tf_names = f"{tf_u.scope} + {tf_bn.scope}"
                mean = tf_bn.arrays["mean"].astype(np.float32)
                if bias is not None:
                    mean = mean - bias  # exact conv-bias fold (docstring)
                    notes.append("conv bias folded into BN mean")
                set_leaf(params, u.path + ("conv", "w"), w)
                set_leaf(params, u.path + ("bn", "scale"),
                         tf_bn.arrays.get("scale",
                                          np.ones((u.out_ch,), np.float32)))
                set_leaf(params, u.path + ("bn", "bias"),
                         tf_bn.arrays.get("bias",
                                          np.zeros((u.out_ch,), np.float32)))
                set_leaf(state, u.path + ("bn", "mean"), mean)
                set_leaf(state, u.path + ("bn", "var"),
                         tf_bn.arrays["var"].astype(np.float32))
            else:
                # bare conv unit (proj / head): {w[, b]} directly
                set_leaf(params, u.path + ("w",), w)
                if u.own_bias:
                    set_leaf(params, u.path + ("b",),
                             bias if bias is not None
                             else np.zeros((u.out_ch,), np.float32))
                elif bias is not None:
                    if u.bias_to_beta_of is None:
                        raise TFImportError(
                            f"unit {'/'.join(u.path)}: TF bias present but "
                            f"our unit has no bias slot and no fold target")
                    pending_beta[u.bias_to_beta_of] = bias
                    notes.append("proj bias folded into cb2 BN beta")
            report.append(("/".join(u.path), tf_names,
                           "; ".join(notes) or "copied"))

    for bn_path, b in pending_beta.items():
        node = params
        for p in bn_path:
            node = node[p]
        node["bias"] = np.ascontiguousarray(node["bias"] + b)

    if conv_q or tconv_q:
        leftover = [u.scope for u in conv_q + tconv_q]
        raise TFImportError(f"unmapped TF conv scopes remain: {leftover}")
    if bn_q:
        raise TFImportError(
            f"unmapped TF BatchNorm scopes remain: {[u.scope for u in bn_q]}")
    return params, state, report


# -- checkpoint writer --------------------------------------------------------


def validate_against_init(params: Dict[str, Any], state: Dict[str, Any],
                          cfg: ModelConfig) -> None:
    """Assert the mapped trees are leaf-for-leaf compatible with the port's
    `UResNet` (same paths, same shapes) — the restore template."""
    import torch

    from uresnet_tpu_torch.models.convert import flatten_tree, trees
    from uresnet_tpu_torch.models.uresnet import UResNet

    ref_p, ref_s = trees(UResNet(cfg, generator=torch.Generator(),
                                 device=torch.device("meta")))
    for got, want, label in ((params, ref_p, "params"), (state, ref_s, "state")):
        g = {k.replace(".", "/"): v for k, v in flatten_tree(got).items()}
        w = {k.replace(".", "/"): v for k, v in flatten_tree(want).items()}
        if set(g) != set(w):
            missing = sorted(set(w) - set(g))
            extra = sorted(set(g) - set(w))
            raise TFImportError(
                f"{label} tree mismatch: missing {missing}, extra {extra}")
        for k in w:
            if tuple(np.shape(g[k])) != tuple(w[k].shape):
                raise TFImportError(
                    f"{label} leaf {k}: shape {np.shape(g[k])} != "
                    f"{tuple(w[k].shape)}")


def write_import_checkpoint(out_dir: str, params: Dict[str, Any],
                            state: Dict[str, Any], cfg: ModelConfig,
                            *, seed: int = 123) -> str:
    """Write a restorable step-0 checkpoint in the JAX npz layout: imported
    params (in ``param_dtype``) + BN stats (f32), fresh Adam moments and the
    port's key ``(seed, 0)``. Restores through the standard Trainer.restore
    / infer path of either package (use train.load_params_only=true to
    fine-tune — semantics identical to the reference's
    restore-then-train)."""
    import torch

    from uresnet_tpu_torch.engine import checkpoint as ckpt
    from uresnet_tpu_torch.engine.optim import adam_init
    from uresnet_tpu_torch.models.convert import (jax_train_state,
                                                  load_jax_params)
    from uresnet_tpu_torch.models.uresnet import UResNet

    validate_against_init(params, state, cfg)
    model = UResNet(cfg, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        load_jax_params(model, params, state)
    opt = adam_init({k: v.detach() for k, v in model.named_parameters()})
    key = np.array([seed & 0xFFFFFFFF, 0], np.uint32)
    tree = {"train_state": jax_train_state(model, opt, key),
            "meta": {"step": np.int64(0), "data_cursor": np.int64(0)}}
    return ckpt.save_checkpoint(out_dir, 0, tree)


def load_spec(path: str) -> Dict[str, str]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        d = yaml.safe_load(text)
    else:
        d = json.loads(text)
    if not isinstance(d, dict):
        raise TFImportError("--spec file must be a flat mapping "
                            "{our_unit_path: tf_scope}")
    return {str(k): str(v) for k, v in d.items()}


def format_report(report: Sequence[Tuple[str, str, str]]) -> str:
    wid = max((len(r[0]) for r in report), default=4)
    wid2 = max((len(r[1]) for r in report), default=8)
    lines = [f"{'unit':<{wid}}  {'tf scope(s)':<{wid2}}  transform"]
    for ours, theirs, note in report:
        lines.append(f"{ours:<{wid}}  {theirs:<{wid2}}  {note}")
    return "\n".join(lines)
