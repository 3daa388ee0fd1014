"""Checkpoints in the JAX package's npz layout (port of
uresnet_tpu/engine/checkpoint.py).

A checkpoint is one ``step_<N>.npz`` holding every leaf of a nested-dict
tree keyed by its '/'-joined path, written to a temp file and atomically
renamed, with a ``LATEST`` marker and retention. A JAX training
checkpoint stores ``train_state/params/...``, ``train_state/model_state/...``
(BN running stats), ``train_state/opt/...``, ``train_state/key`` and
``meta/{step,data_cursor}``; serving reads the first two and ignores the
optimizer and PRNG leaves, training reads them all (`load_checkpoint`).
Release artifacts (tools/make_release_ckpt.py) store bf16 kernels as
uint16 bit patterns listed in ``__kernels_bf16__``; they are re-viewed as
bfloat16 by torch, without ml_dtypes.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from uresnet_tpu_torch.models.convert import flatten_tree, unflatten_tree

PARAMS_PREFIX = "train_state/params/"
STATE_PREFIX = "train_state/model_state/"
MAX_TO_KEEP = 5  # checkpoints kept in a directory, as the JAX default


def train_state_tree(params: Dict[str, Any], state: Dict[str, Any],
                     step: int) -> Dict[str, Any]:
    """The serving part of a JAX train-state checkpoint tree: params, BN
    state and meta, with data cursor 0 (JAX ``load_checkpoint(partial=True)``
    fills the rest)."""
    return {"train_state": {"params": params, "model_state": state},
            "meta": {"step": np.int64(step),
                     "data_cursor": np.int64(0)}}


def save_checkpoint(directory: str, step: int, tree: Dict[str, Any]) -> str:
    """Write a nested dict of numpy arrays as ``step_<N>.npz``, keeping the
    newest `MAX_TO_KEEP`."""
    os.makedirs(directory, exist_ok=True)
    arrays = {k.replace(".", "/"): np.asarray(v)
              for k, v in flatten_tree(tree).items()}
    final = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    cands = sorted(f for f in os.listdir(directory)
                   if re.fullmatch(r"step_\d+\.npz", f))
    for old in cands[:-MAX_TO_KEEP]:
        try:
            os.remove(os.path.join(directory, old))
        except OSError:
            pass
    return final


def latest_checkpoint(directory: str) -> Optional[str]:
    marker = os.path.join(directory, "LATEST")
    if os.path.exists(marker):
        with open(marker) as f:
            name = f.read().strip()
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return path
    if not os.path.isdir(directory):
        return None
    cands = sorted(f for f in os.listdir(directory)
                   if re.fullmatch(r"step_\d+\.npz", f))
    return os.path.join(directory, cands[-1]) if cands else None


def checkpoint_step(path: str) -> int:
    m = re.search(r"step_(\d+)\.npz$", path)
    if not m:
        raise ValueError(f"not a checkpoint path: {path}")
    return int(m.group(1))


def _read(path: str) -> Dict[str, Any]:
    """Every leaf of a checkpoint npz by its '/' path: numpy arrays, and
    bfloat16 CPU tensors for the keys of the bf16 release manifest."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}
    bf16_keys = {str(k) for k in stored.pop("__kernels_bf16__", ())}
    return {k: (torch.from_numpy(np.array(v)).view(torch.bfloat16)
                if k in bf16_keys else v) for k, v in stored.items()}


def _as_tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.from_numpy(np.array(v))


def load_checkpoint(path: str, template: Dict[str, Any], *,
                    partial: bool = False) -> Dict[str, Any]:
    """Restore a nested dict with the structure, shapes and dtypes of
    ``template``, as the JAX package's ``load_checkpoint`` does: leaves are
    found by their '/' path and cast to the template leaf's dtype; a missing
    leaf raises — or, with ``partial=True`` (params-only release files),
    keeps the template's value. Tensor leaves come back as CPU tensors,
    numpy leaves as numpy arrays."""
    stored = _read(path)
    out = {}
    for dotted, leaf in flatten_tree(template).items():
        key = dotted.replace(".", "/")
        if key not in stored:
            if not partial:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            out[dotted] = leaf.cpu() if torch.is_tensor(leaf) else np.asarray(leaf)
            continue
        got = stored[key]
        if tuple(got.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape "
                             f"{tuple(got.shape)} != template {tuple(leaf.shape)}")
        if torch.is_tensor(leaf):
            out[dotted] = _as_tensor(got).to(leaf.dtype)
        elif torch.is_tensor(got):  # a bf16 release kernel: numpy has no bf16
            out[dotted] = got.float().numpy().astype(np.asarray(leaf).dtype)
        else:
            out[dotted] = np.asarray(got).astype(np.asarray(leaf).dtype)
    return unflatten_tree(out)


def load_serving_state(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """Read the params and BN-state leaves of a JAX checkpoint npz as
    (params, state) trees of CPU tensors (for models/convert.py
    ``load_jax_params``), and its ``meta/step`` (0 when absent)."""
    stored = _read(path)
    step = int(stored.get("meta/step", 0))
    params, state = {}, {}
    for key, v in stored.items():
        for prefix, dst in ((PARAMS_PREFIX, params), (STATE_PREFIX, state)):
            if key.startswith(prefix):
                dst[key[len(prefix):].replace("/", ".")] = _as_tensor(v)
    if not params:
        raise KeyError(f"{path!r} holds no {PARAMS_PREFIX}* leaves")
    return unflatten_tree(params), unflatten_tree(state), step
