"""Weights and BN state between a JAX param/state tree and a UResNet module.

The JAX package keeps params and BN running stats as nested dicts keyed
by unit name (``params['enc0_b0']['cb1']['conv']['w']``,
``state['enc0_b0']['cb1']['bn']['mean']``). The module names its
parameters and buffers the same way with dots, so the mapping is the key
path: parameters <-> params tree, buffers <-> state tree. A whole train
state adds the JAX ``AdamState`` (``opt.step``, ``opt.mu``, ``opt.nu`` —
moments keyed like the params tree) and the uint32[2] ``key``. Under
tensor parallelism a module holds one model rank's channel slices; the
loaders slice the whole JAX leaves for it (``tp``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from uresnet_tpu_torch.engine.optim import AdamState
from uresnet_tpu_torch.parallel.mesh import Axis
from uresnet_tpu_torch.parallel.tp import shard_state

Tree = Dict[str, Any]


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Tree:
    tree: Tree = {}
    for dotted, v in flat.items():
        *parents, leaf = dotted.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def trees(model: nn.Module) -> Tuple[Tree, Tree]:
    """(params, state) trees of the module's own tensors (no copies)."""
    return (unflatten_tree({k: v.detach() for k, v in model.named_parameters()}),
            unflatten_tree(dict(model.named_buffers())))


def jax_params(model: nn.Module) -> Tuple[Tree, Tree]:
    """(params, state) as trees of numpy arrays: the JAX package's
    ``uresnet_init`` layout, ready for its checkpoint or apply."""
    return tuple(unflatten_tree({k: v.cpu().numpy() for k, v in flatten_tree(t).items()})
                 for t in trees(model))


def _local(flat: Dict[str, Any], tp: Optional[Axis]) -> Dict[str, Any]:
    """Whole leaves -> this model rank's slices (parallel/tp.py)."""
    return flat if tp is None or tp.size == 1 else shard_state(flat, tp)


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Tree, state: Tree, *,
                    tp: Optional[Axis] = None) -> None:
    """Copy a JAX (params, state) tree — numpy arrays or tensors — into the
    module, cast to each destination's dtype. Every parameter and buffer
    must be given, with its shape; extra or missing leaves raise. ``tp``
    (the mesh's model axis): the module holds this rank's channel slices
    (parallel/tp.py) and the tree the whole leaves, which are sliced."""
    for kind, src, dst in (("param", _local(flatten_tree(params), tp),
                            dict(model.named_parameters())),
                           ("state", _local(flatten_tree(state), tp),
                            dict(model.named_buffers()))):
        if src.keys() != dst.keys():
            missing = sorted(dst.keys() - src.keys())
            extra = sorted(src.keys() - dst.keys())
            raise KeyError(f"{kind} tree does not match the model: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}")
        for k, t in dst.items():
            v = src[k]
            if not torch.is_tensor(v):
                v = torch.from_numpy(np.array(v))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{kind} {k!r}: shape {tuple(v.shape)} != "
                                 f"model {tuple(t.shape)}")
            t.copy_(v)


def _fields(obj) -> Dict[str, Any]:
    """A NamedTuple's (JAX TrainState / AdamState) or a dict's fields."""
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def jax_train_state(model: nn.Module, opt: AdamState,
                    key: np.ndarray) -> Dict[str, Any]:
    """The fields of a JAX ``TrainState`` as numpy trees: params, BN state,
    ``opt`` {step int32, mu, nu} and ``key`` uint32[2] — what its
    checkpoint stores under ``train_state/``."""
    params, state = jax_params(model)
    moments = {name: unflatten_tree({k: v.detach().cpu().numpy()
                                     for k, v in getattr(opt, name).items()})
               for name in ("mu", "nu")}
    return {"params": params, "model_state": state,
            "opt": {"step": np.int32(opt.step), **moments},
            "key": np.asarray(key, np.uint32)}


def load_jax_train_state(model: nn.Module, ts: Any, *,
                         tp: Optional[Axis] = None
                         ) -> Tuple[AdamState, np.ndarray]:
    """Load a JAX ``TrainState`` (or its fields as a dict, numpy or tensor
    leaves) into ``model``; returns its Adam state, with the moments as
    f32 tensors on the model's device keyed by parameter name, and its key.
    ``tp``: as `load_jax_params`; the moments are sliced as their params.
    (The way back is `jax_train_state` of the gathered state,
    engine/trainer.py ``Trainer.gather_state``.)"""
    f = _fields(ts)
    load_jax_params(model, f["params"], f["model_state"], tp=tp)
    opt = _fields(f["opt"])
    names = dict(model.named_parameters())
    moments = {}
    for kind in ("mu", "nu"):
        flat = _local(flatten_tree(opt[kind]), tp)
        if flat.keys() != names.keys():
            raise KeyError(f"opt.{kind} does not match the model's params")
        moments[kind] = {k: (v if torch.is_tensor(v) else torch.from_numpy(
            np.array(v))).to(device=names[k].device, dtype=names[k].dtype)
            for k, v in flat.items()}
    return (AdamState(step=int(np.asarray(opt["step"])), **moments),
            np.asarray(f["key"], np.uint32))
