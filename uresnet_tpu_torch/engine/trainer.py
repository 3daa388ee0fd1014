"""The training engine (port of uresnet_tpu/engine/trainer.py).

A train step densifies a sparse batch on the device (with the in-scatter
flips/rot90 when ``data.augment``), runs the U-ResNet forward in train mode
(packed with ``model.pack``, models/packed.py), the pixel-weighted softmax
cross-entropy, the backward with f32
weight gradients (ops/conv.py) and the hand-written Adam (engine/optim.py).
Frozen parameters (``optim.freeze``) do not require grad, so autograd
computes no weight gradient for them; Adam leaves them, and their moments,
untouched. New BN running stats are copied into the buffers after the
backward.

The train state's ``key`` is the uint32[2] ``(train.seed, step)``: each
step seeds its augmentation generator from it, so a resumed run draws the
same flips as an uninterrupted one. The JAX package keeps a threefry key in
that leaf; a JAX checkpoint resumes here exactly in params, BN state and
Adam, but draws its own augmentation stream.

Validation samples ``val_batches`` held-out batches through ``eval_step``
over the BN-folded forward, or with ``train.val_exact`` runs the
exactly-once ``evaluate_dataset`` (engine/evaluator.py). 2D and 3D
(``model.dims``) train alike. ``train.packed_loss`` takes the packed
head's logits and targets in the same layout (a sparse batch's label and
weight scattered straight into it), as the JAX trainer does; evaluation
and the serving export stay canonical in both packages.
``steps_per_dispatch = K`` runs K plain steps per loop turn.

``model.arch = "sparse_uresnet"`` trains the submanifold sparse U-ResNet
(models/sparse_uresnet.py) on the same loop: its step turns the padded
sparse batch into point rows with their labels and class weights
(ops/sparse.py ``prepare``, span ``uresnet.train.densify``, though nothing
is densified) and builds the batch's rulebook (``uresnet.train.rulebook``);
the loss is over the active voxels, and ``_loss_fn`` hands its logits in
the batch's padded layout (B, P, K), zeros at padding. Under data
parallelism the ranks hold unequal numbers of sites, so a rank's loss
divides by the global batch's site count or weight sum. It refuses what
it has no form of (models/sparse_uresnet.py ``refuse_train_modes``):
``model.pack``, ``model.remat``, ``data.augment``, a dense transfer, and
tensor or spatial parallelism.

Data parallelism (parallel/mesh.py): one process per device, each with a
replica of the train state and ``1/world`` of the global batch
(``data.batch_size`` stays the global size; the loader reads every
world-th event). A DP step equals the one-process step on the rank-major
concatenation of the ranks' batches: BN statistics are the global
batch's, the augmentation decisions are drawn for the global batch and
each rank applies its rows, the gradients (and the logged loss) are
averaged over the ranks before the clip and Adam, and the summary and
eval metrics come from confusion counts summed over the ranks. Rank 0
alone writes logs, checkpoints and traces; a SIGTERM on any rank stops
every rank after the same step.

Spatial and tensor parallelism (parallel/halo.py, parallel/tp.py) add the
mesh's other two axes; the data index ``d`` of a rank takes the place of
its rank above. Under a spatial axis every rank of a data index densifies
that index's whole batch, with the same augmentation, and keeps its own H
(2D) or D (3D) rows. Under a model axis the ranks of a data index read
the same batch and hold channel slices of the params, BN state and Adam
moments. Either way the BN statistics, the gradients, the loss and the
counts are reduced over the mesh's batch group (data x spatial of this
model index): a rank's loss is its term of the global loss, exactly as a
data-parallel rank's. ``save`` gathers the slices before rank 0 writes the
JAX layout; ``restore`` slices the whole file. Evaluation runs on the
gathered state, the file sharded over the whole world
(engine/evaluator.py). Spatial x model meshes, and tensor parallelism with
``model.pack``, are refused as the JAX trainer refuses them.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import signal
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from uresnet_tpu_torch.config import Config, is_sparse
from uresnet_tpu_torch.data.loader import make_batch_loader
from uresnet_tpu_torch.engine.logging import MetricsLogger, NullLogger
from uresnet_tpu_torch.data.device_pipeline import (densify_on_device,
                                                    draw_decisions)
from uresnet_tpu_torch.data.prefetch import device_prefetch
from uresnet_tpu_torch.engine import checkpoint as ckpt
from uresnet_tpu_torch.engine.augment import augment_batch
from uresnet_tpu_torch.engine.export import build_logits_fn
from uresnet_tpu_torch.engine.losses import (softmax_xent_per_pixel,
                                             weighted_softmax_xent)
from uresnet_tpu_torch.engine.metrics import (loss_from_counts,
                                              metrics_from_counts,
                                              reduce_counts, site_counts,
                                              segmentation_counts,
                                              segmentation_metrics)
from uresnet_tpu_torch.engine.optim import (AdamState, adam_init, adam_update,
                                            freeze_mask)
from uresnet_tpu_torch.engine.profiling import annotate
from uresnet_tpu_torch.models.convert import (flatten_tree, jax_train_state,
                                              load_jax_train_state)
from uresnet_tpu_torch.models.fold import KERNEL_BACKENDS
from uresnet_tpu_torch.models.packed import (_hpack_level, loss_layout_phases,
                                             pack_like_logits)
from uresnet_tpu_torch.models import sparse_uresnet
from uresnet_tpu_torch.models.sparse_uresnet import SparseUResNet
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops import sparse as sparse_ops
from uresnet_tpu_torch.parallel import tp
from uresnet_tpu_torch.parallel.mesh import (Mesh, all_reduce_counts,
                                             all_reduce_max, all_reduce_mean,
                                             all_reduce_sum, broadcast,
                                             make_mesh)


@dataclasses.dataclass
class TrainState:
    model: UResNet            # params (parameters) and BN running stats (buffers)
    opt: AdamState
    key: np.ndarray           # uint32[2]: (train.seed, step)


def _key_seed(key: np.ndarray) -> int:
    return (int(key[0]) << 32) | int(key[1])


def _next_key(key: np.ndarray) -> np.ndarray:
    return np.array([key[0], (int(key[1]) + 1) & 0xFFFFFFFF], np.uint32)


_IMAGE_KEYS = ("data", "label", "weight")


class Trainer:
    def __init__(self, cfg: Config, *, device="cuda",
                 mesh: Optional[Mesh] = None):
        # the process group, if any, is the caller's: cli.train
        # --distributed joins it (parallel/mesh.py init_distributed)
        n_spatial = mesh.spatial if mesh else max(1, cfg.parallel.spatial)
        n_model = mesh.model if mesh else max(1, cfg.parallel.model)
        arch = getattr(cfg.model, "arch", "uresnet")
        if arch not in ("uresnet", "sparse_uresnet"):
            raise ValueError(f"unknown model.arch {arch!r}: 'uresnet' or "
                             f"'sparse_uresnet'")
        self.sparse = is_sparse(cfg.model)
        self._net = SparseUResNet if self.sparse else UResNet
        if self.sparse:
            # the architecture's steps are chosen here; only _loss_fn, which
            # perfbench's harness wraps on the instance, tests it again
            sparse_uresnet.refuse_train_modes(cfg, n_model=n_model,
                                              n_spatial=n_spatial)
            self._train_step = self._train_step_sparse
            self._eval_step = self._eval_step_sparse
        if n_model > 1 and cfg.model.pack:
            raise ValueError(
                "parallel.model > 1 (tensor parallelism) requires the "
                "canonical layout — set model.pack: false (the JAX "
                "package's packed space-to-depth kernels are derived by "
                "channel-phase relabeling gathers, which contradict a "
                "channel sharding; the port keeps its refusal)")
        if n_model > 1 and n_spatial > 1:
            raise ValueError(
                "parallel.spatial > 1 and parallel.model > 1 cannot be "
                "combined: XLA's SPMD partitioner miscompiles convs that "
                "are both spatially and output-feature partitioned, so the "
                "JAX package refuses the combination (tests/test_tp.py::"
                "test_spatial_x_model_conv_miscompile) and the port keeps "
                "the refusal. Use data x spatial or data x model meshes.")
        if cfg.model.base_filters % n_model:
            raise ValueError(
                f"model.base_filters ({cfg.model.base_filters}) must be "
                f"divisible by parallel.model ({n_model}): every conv but "
                f"the head is column-parallel over the model axis")
        edge = n_spatial * 2 ** cfg.model.depth
        if n_spatial > 1 and cfg.data.image_size % edge:
            raise ValueError(
                f"data.image_size ({cfg.data.image_size}) must be a "
                f"multiple of parallel.spatial x 2^model.depth ({edge}): "
                f"every shard's rows must halve evenly at each level")
        self.mesh = mesh or make_mesh(cfg.parallel.data, n_spatial, n_model)
        if cfg.data.batch_size % self.mesh.data:
            raise ValueError(
                f"data.batch_size ({cfg.data.batch_size}) must be divisible "
                f"by the mesh data-axis size ({self.mesh.data}); raise the "
                f"batch size or set parallel.data to a divisor (e.g. "
                f"parallel.data=1 for single-device runs)")
        # The JAX trainer's warning for 3D without model.pack is not ported:
        # it is about an XLA tile-padding blowup on the TPU; on the card the
        # canonical 3D layout fits (PERF.md measures both layouts).
        if cfg.model.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"model.kernel_backend must be one of {KERNEL_BACKENDS}, got "
                f"{cfg.model.kernel_backend!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self._freeze = None
        if cfg.optim.freeze:  # validate the patterns before any training
            names = [n for n, _ in self._new_model(torch.device("meta"))
                     .named_parameters()]
            self._freeze = freeze_mask(names, cfg.optim.freeze)
        # {leaf: dim} of the channel-sliced leaves (parallel/tp.py)
        self._tp_dims = {}
        if self.mesh.model > 1:
            meta = self._new_model(torch.device("meta"))
            self._tp_dims = tp.shard_dims(
                {k: v.shape for k, v in itertools.chain(
                    meta.named_parameters(), meta.named_buffers())},
                self.mesh.model)
        self.loader = None
        self.val_loader = None

    # -- state ---------------------------------------------------------------

    def _new_model(self, device, seed: Optional[int] = None) -> UResNet:
        seed = self.cfg.train.seed if seed is None else seed
        return self._net(self.cfg.model,
                         generator=torch.Generator().manual_seed(seed),
                         device=device)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """The seed's initial state; under a model axis, this rank's
        channel slices of the whole model's."""
        seed = self.cfg.train.seed if seed is None else seed
        model = self._new_model(self.device, seed)
        if self._tp_dims:
            with torch.no_grad():
                tensors = dict(itertools.chain(model.named_parameters(),
                                               model.named_buffers()))
                for k, v in tp.shard_state({k: t.data for k, t in
                                            tensors.items()},
                                           self.mesh.model_axis).items():
                    tensors[k].data = v
        for name, p in model.named_parameters():
            p.requires_grad_(not (self._freeze and self._freeze[name]))
        params = {k: v.detach() for k, v in model.named_parameters()}
        return TrainState(model=model, opt=adam_init(params),
                          key=np.array([seed & 0xFFFFFFFF, 0], np.uint32))

    def gather_state(self, ts: TrainState) -> TrainState:
        """The whole train state on every rank: under a model axis a new
        model and moments gathered from the ranks' slices (a collective:
        every rank of the model axis calls it); else ``ts`` itself."""
        if not self._tp_dims:
            return ts
        axis = self.mesh.model_axis
        m = ts.model
        tensors = tp.gather_state(
            {k: v.detach() for k, v in itertools.chain(
                m.named_parameters(), m.named_buffers())},
            self._tp_dims, axis)
        moments = {kind: tp.gather_state(getattr(ts.opt, kind),
                                         self._tp_dims, axis)
                   for kind in ("mu", "nu")}
        whole = self._new_model(self.device)
        with torch.no_grad():
            for k, t in itertools.chain(whole.named_parameters(),
                                        whole.named_buffers()):
                t.copy_(tensors[k])
        return TrainState(model=whole, opt=ts.opt._replace(**moments),
                          key=ts.key)

    # -- step functions ------------------------------------------------------

    def _local_rows(self, batch: Dict) -> Dict:
        """Under a spatial axis, this rank's rows (dim 1: H in 2D, D in
        3D) of a dense batch's images."""
        axis = self.mesh.spatial_axis
        if axis.size == 1:
            return batch
        return {k: tp.local_slice(v, 1, axis) if k in _IMAGE_KEYS else v
                for k, v in batch.items()}

    @property
    def _loss_phases(self) -> int:
        """Phases per logit of the packed train loss (``train.packed_loss``
        on a packed level 0), else 1."""
        if not self.cfg.train.packed_loss:
            return 1
        return loss_layout_phases(self.cfg.model)

    def _prepare(self, batch: Dict, decisions=None,
                 packed_targets: bool = False) -> Dict:
        """A sparse batch is densified on the device; ``decisions`` apply
        the flips/rot90 inside the scatter; ``packed_targets`` scatters the
        label and weight into the packed loss layout. Dense batches pass
        through."""
        if "coords" not in batch:
            return batch
        d = self.cfg.data
        return densify_on_device(
            batch, image_size=d.image_size, num_class=self.cfg.model.num_class,
            normalize_scale=d.normalize_scale,
            normalize_clip=d.normalize_clip, weight_mode=d.weight_mode,
            nonzero_boost=d.weight_nonzero_boost, decisions=decisions,
            target_phases=self._loss_phases if packed_targets else 1,
            target_hpack=packed_targets and _hpack_level(self.cfg.model, 0))

    def _pack_target(self, x: torch.Tensor) -> torch.Tensor:
        """(B, *S[, K]) per-pixel target -> the packed-head layout
        (B, *S', phases[, K]), in the packed logits' phase order."""
        k = None if x.dim() == self.cfg.model.dims + 1 else x.shape[-1]
        p = pack_like_logits(x[..., None] if k is None else x,
                             self.cfg.model)
        return p if k is None else p.reshape(p.shape[:-1]
                                             + (self._loss_phases, k))

    def _targets(self, batch: Dict, logits: torch.Tensor):
        """(label, weight, data) of ``batch`` in the layout of ``logits``:
        canonical, or the packed loss layout (B, *S', phases[, K]), where
        the label and weight may arrive packed from the densify."""
        if logits.dim() == batch["data"].dim():
            return batch["label"], batch["weight"], batch["data"]
        if batch["label"].dim() == self.cfg.model.dims + 2:  # arrived packed
            label, weight = batch["label"], batch["weight"]
        else:
            label = self._pack_target(batch["label"])
            weight = self._pack_target(batch["weight"])
        return label, weight, self._pack_target(batch["data"])

    def _loss_fn(self, model: UResNet, batch: Dict):
        """(loss, logits, new BN state) of one batch in train mode; the
        logits in the loss layout: canonical (B, *S, K) or, on the packed
        train path, (B, *S', phases, K) (`_targets`).

        Each rank of the mesh's batch group (data x spatial, size n) holds
        an equal share of the global batch's pixels, and its loss is its
        term of n times the global batch's loss, so that the mean of the
        ranks' losses and gradients is the global loss and its gradient:
        with 'mean' the local mean, with 'weight_sum' the local sum over the
        global batch's weight sum. The ranks of a model axis compute the
        same loss."""
        if self.sparse:
            return self._loss_fn_sparse(model, batch)
        group = self.mesh.batch.group
        normalize = self.cfg.train.loss_normalize
        ph = self._loss_phases
        packed = (ph > 1
                  or batch["label"].dim() == self.cfg.model.dims + 2)
        with annotate("uresnet.train.forward"):
            logits, new_state = model(batch["data"], train=True,
                                      mesh=self.mesh, packed_logits=packed)
            if packed:
                logits = logits.reshape(logits.shape[:-1]
                                        + (ph, self.cfg.model.num_class))
        with annotate("uresnet.train.loss"):
            label, weight, _ = self._targets(batch, logits)
            if group is not None and normalize == "weight_sum":
                w = weight.float()
                den = all_reduce_sum(w.sum(), group)
                loss = (torch.sum(w * softmax_xent_per_pixel(logits, label))
                        * self.mesh.batch.size / torch.clamp(den, min=1e-6))
            else:
                loss = weighted_softmax_xent(logits, label, weight,
                                             normalize=normalize)
        return loss, logits, new_state

    def _loss_fn_sparse(self, model, batch: sparse_ops.SparseBatch):
        """(loss, logits, new BN state) of the sparse net: the weighted
        softmax cross-entropy over the batch's active sites, the logits at
        the batch's points (B, P, K), zeros at padding. Under a batch group
        the ranks hold unequal numbers of sites, so a rank's loss is its
        sum over the global batch's site count ('mean') or weight sum
        ('weight_sum'), times the group's size: `_loss_fn`'s contract."""
        group = self.mesh.batch.group
        normalize = self.cfg.train.loss_normalize
        with annotate("uresnet.train.forward"):
            rows, new_state = model(batch, train=True, mesh=self.mesh)
        with annotate("uresnet.train.loss"):
            if group is None:
                loss = weighted_softmax_xent(rows, batch.label, batch.weight,
                                             normalize=normalize)
            else:
                w = batch.weight.float()
                if normalize == "weight_sum":
                    den = w.sum()
                elif normalize == "mean":
                    den = w.new_tensor(float(w.numel()))
                else:
                    raise ValueError(f"unknown normalize mode {normalize!r}")
                den = all_reduce_sum(den, group)
                loss = (torch.sum(w * softmax_xent_per_pixel(rows, batch.label))
                        * self.mesh.batch.size / torch.clamp(den, min=1e-6))
            logits = batch.at_points(rows)
        return loss, logits, new_state

    def _global_counts(self, logits, batch, group, *, loss_sums=False
                       ) -> Dict[str, np.ndarray]:
        """The batch's confusion counts (and with ``loss_sums`` the masked
        xent sums of engine/evaluator.py), summed over ``group``."""
        counts = segmentation_counts(logits, batch["label"], batch["data"],
                                     num_class=self.cfg.model.num_class)
        if loss_sums:
            w = batch["weight"].float()
            counts["loss_num"] = torch.sum(
                w * softmax_xent_per_pixel(logits, batch["label"]))
            counts["weight_sum"] = torch.sum(w)
        return self._summed(counts, group)

    def _summed(self, counts: Dict[str, torch.Tensor], group
                ) -> Dict[str, np.ndarray]:
        """Device count leaves reduced on the host, summed over ``group``."""
        return all_reduce_counts(reduce_counts(
            {k: v.cpu() for k, v in counts.items()}), group, self.device)

    def _train_step(self, ts: TrainState, batch: Dict,
                    with_metrics: bool = True) -> Tuple[TrainState, Dict]:
        cfg = self.cfg
        mesh = self.mesh
        with annotate("uresnet.train.densify"):
            decisions = None
            if cfg.data.augment:
                # drawn for the global batch; this data index applies its
                # rows
                gen = torch.Generator(device=self.device)
                gen.manual_seed(_key_seed(ts.key))
                B = next(v for v in batch.values()
                         if torch.is_tensor(v)).shape[0]
                d = mesh.index[0]
                decisions = draw_decisions(gen, B * mesh.data,
                                           cfg.model.dims)
                decisions = decisions[:, d * B:(d + 1) * B]
            sparse = "coords" in batch
            batch = self._prepare(
                batch, decisions if sparse else None,
                packed_targets=sparse and self._loss_phases > 1)
            if decisions is not None and not sparse:
                batch = augment_batch(batch, dims=cfg.model.dims,
                                      decisions=decisions)
            batch = self._local_rows(batch)
        group = mesh.batch.group
        loss, logits, opt = self._update(ts, batch)
        metrics = {"loss": loss}
        if with_metrics:
            with annotate("uresnet.train.metrics"):
                # the targets and the charge in the loss layout: the
                # per-pixel metrics are layout-invariant
                label, weight, data = self._targets(batch, logits)
                if group is not None:
                    tb = {"label": label, "weight": weight, "data": data}
                    metrics.update(metrics_from_counts(
                        self._global_counts(logits.detach(), tb, group)))
                else:
                    metrics.update(segmentation_metrics(
                        logits.detach(), label, data,
                        num_class=cfg.model.num_class))
        return TrainState(model=ts.model, opt=opt, key=_next_key(ts.key)), \
            metrics

    def _update(self, ts: TrainState, batch):
        """The forward, loss, backward, gradient all-reduce, Adam and the
        write-back of the params and BN state of one prepared batch:
        (loss, the loss's logits, the new Adam state). The model of ``ts``
        is updated in place."""
        cfg = self.cfg
        mesh = self.mesh
        group = mesh.batch.group
        model = ts.model
        params = dict(model.named_parameters())
        trainable = [k for k, p in params.items() if p.requires_grad]
        with torch.enable_grad():
            loss, logits, new_state = self._loss_fn(model, batch)
            with annotate("uresnet.train.backward"):
                grads = torch.autograd.grad(loss,
                                            [params[k] for k in trainable])
        loss = loss.detach()
        if group is not None:
            # one bucket: the gradients and the logged loss, averaged
            with annotate("uresnet.train.allreduce"):
                loss = loss.reshape(1).clone()
                all_reduce_mean([*grads, loss], group)
                loss = loss[0]
        with annotate("uresnet.train.optim"):
            new_params, opt = adam_update(
                dict(zip(trainable, grads)), ts.opt,
                {k: p.detach() for k, p in params.items()}, cfg.optim,
                freeze=self._freeze, norm_axis=mesh.model_axis,
                sliced=self._tp_dims)
            with torch.no_grad():
                for k, p in params.items():
                    p.data = new_params[k]
                flat = dict(model.named_buffers())
                for k, v in flatten_tree(new_state).items():
                    flat[k].data = v
        return loss, logits, opt

    def _sparse_rows(self, batch: Dict) -> sparse_ops.SparseBatch:
        """The sparse net's point rows of a padded sparse batch, with
        their labels and loss weights, sorted for the rulebook."""
        if "coords" not in batch:
            raise ValueError("the sparse U-ResNet takes sparse batches "
                             "(data.transfer: sparse), got a dense one")
        return sparse_ops.prepare_for(self.cfg, batch)

    def _sparse_batch(self, batch: Dict) -> sparse_ops.SparseBatch:
        """`_sparse_rows` with the rulebook."""
        rows = self._sparse_rows(batch)
        rows.rules = sparse_ops.rulebook(rows)
        return rows

    def _train_step_sparse(self, ts: TrainState, batch: Dict,
                           with_metrics: bool) -> Tuple[TrainState, Dict]:
        # the densify phase of the dense step: here the point rows, their
        # labels and class weights (nothing is densified)
        with annotate("uresnet.train.densify"):
            batch = self._sparse_rows(batch)
        with annotate("uresnet.train.rulebook"):
            batch.rules = sparse_ops.rulebook(batch)
        loss, logits, opt = self._update(ts, batch)
        metrics = {"loss": loss}
        if with_metrics:
            with annotate("uresnet.train.metrics"):
                K = self.cfg.model.num_class
                rows = logits.detach().reshape(-1, K)[batch.site_point]
                group = self.mesh.batch.group
                if group is not None:
                    metrics.update(metrics_from_counts(self._summed(
                        site_counts(rows, batch, num_class=K), group)))
                else:
                    metrics.update(segmentation_metrics(
                        rows, batch.label, batch.feats, num_class=K))
        return TrainState(model=ts.model, opt=opt, key=_next_key(ts.key)), \
            metrics

    def train_step(self, ts: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        """One step with the summary metrics. The model in ``ts`` is updated
        in place; use the returned state."""
        return self._train_step(ts, batch, with_metrics=True)

    def train_step_light(self, ts: TrainState, batch: Dict
                         ) -> Tuple[TrainState, Dict]:
        """The hot-loop step: loss only in the metrics."""
        return self._train_step(ts, batch, with_metrics=False)

    @torch.no_grad()
    def eval_step(self, ts: TrainState, batch: Dict, logits_fn=None) -> Dict:
        """The eval metrics and loss of one batch over the BN-folded forward
        (equal to the eval forward). A pass over several batches folds once
        and passes its ``logits_fn`` (engine/export.py ``build_logits_fn``);
        without one, the gathered model of ``ts`` is folded here (a
        collective under a model axis). ``batch`` is this data index's
        whole batch; the metrics are the global batch's, from counts summed
        over the data axis (host floats)."""
        if logits_fn is None:
            logits_fn = build_logits_fn(self.cfg, self.gather_state(ts).model)
        return self._eval_step(batch, logits_fn)

    def _eval_step(self, batch: Dict, logits_fn) -> Dict:
        """`eval_step` of the dense net, after the fold."""
        batch = self._prepare(batch)
        logits = logits_fn(batch["data"])
        group = self.mesh.data_axis.group
        if group is not None:
            counts = self._global_counts(logits, batch, group, loss_sums=True)
            metrics = metrics_from_counts(counts)
            metrics["loss"] = loss_from_counts(
                counts, self.cfg.train.loss_normalize)
            return metrics
        metrics = segmentation_metrics(logits, batch["label"], batch["data"],
                                       num_class=self.cfg.model.num_class)
        metrics["loss"] = weighted_softmax_xent(
            logits, batch["label"], batch["weight"],
            normalize=self.cfg.train.loss_normalize)
        return metrics

    def _eval_step_sparse(self, batch: Dict, logits_fn) -> Dict:
        """`eval_step` of the sparse net, over the batch's active sites."""
        prep = self._sparse_batch(batch)
        logits = logits_fn(prep)
        K = self.cfg.model.num_class
        normalize = self.cfg.train.loss_normalize
        group = self.mesh.data_axis.group
        if group is not None:
            counts = self._summed(site_counts(logits, prep, num_class=K,
                                              loss_sums=True), group)
            metrics = metrics_from_counts(counts)
            metrics["loss"] = loss_from_counts(counts, normalize)
            return metrics
        metrics = segmentation_metrics(logits, prep.label, prep.feats,
                                       num_class=K)
        metrics["loss"] = weighted_softmax_xent(logits, prep.label,
                                                prep.weight,
                                                normalize=normalize)
        return metrics

    @torch.no_grad()
    def forward(self, ts: TrainState, data) -> torch.Tensor:
        """Inference forward: per-pixel softmax scores (f32, B x *S x
        num_class) of the channels-last ``data`` (B, *S, C_in; numpy or a
        tensor) on the trainer's device. The unfolded eval forward (BN in
        eval mode, packed with ``model.pack``), as the JAX trainer's
        ``forward``: not the BN-folded ``build_logits_fn`` that serving and
        evaluation run. Under a model axis it runs on the gathered state
        (a collective)."""
        if self.sparse:
            sparse_uresnet.refuse("Trainer.forward", hint=": it takes dense "
                                  "images; the sparse net scores point "
                                  "batches through engine/evaluator.py "
                                  "(run_inference, evaluate_dataset)")
        x = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        logits, _ = self.gather_state(ts).model(x, train=False)
        return torch.softmax(logits, dim=-1)

    # -- data -----------------------------------------------------------------

    def make_loader(self, *, train: bool = True, start_event: int = 0,
                    world: bool = False):
        """The loader of this rank's data index: every ``data``-th event,
        ``data.batch_size / data`` rows a batch. ``world``: every rank its
        own share of the events, at the same rows a batch (the evaluation
        of engine/evaluator.py ``evaluate_dataset``)."""
        dcfg = self.cfg.data
        if not train and dcfg.synthetic and not dcfg.input_files:
            # held-out synthetic validation: another generator seed
            dcfg = dataclasses.replace(dcfg, seed=dcfg.seed + 10007)
        shard = (self.mesh.index[0], self.mesh.data)
        if world:
            shard = (self.mesh.rank, self.mesh.world)
            dcfg = dataclasses.replace(dcfg, batch_size=dcfg.batch_size
                                       // self.mesh.data * self.mesh.world)
        return make_batch_loader(dcfg, num_class=self.cfg.model.num_class,
                                 train=train, ndims=self.cfg.model.dims,
                                 start_event=start_event, shard=shard)

    def device_batch(self, batch: Dict) -> Dict:
        """Host batch (numpy) -> tensors on the trainer's device."""
        return next(device_prefetch(iter([batch]), device=self.device, depth=0))

    # -- checkpoint -----------------------------------------------------------

    def save(self, ts: TrainState, step: int, data_cursor: int = 0) -> str:
        """Rank 0 writes the whole state in the JAX layout; every rank
        calls it (under a model axis it gathers the slices first) and gets
        the path."""
        ts = self.gather_state(ts)
        if not self.mesh.leader:
            return os.path.join(self.cfg.train.checkpoint_dir,
                                f"step_{step:08d}.npz")
        tree = {"train_state": jax_train_state(ts.model, ts.opt, ts.key),
                "meta": {"step": np.int64(step),
                         "data_cursor": np.int64(data_cursor)}}
        return ckpt.save_checkpoint(self.cfg.train.checkpoint_dir, step, tree)

    def restore(self, path: Optional[str] = None) -> Tuple[TrainState, int, int]:
        """(state, step, data cursor) from ``path``, ``train.load_file`` or
        the latest checkpoint of ``train.checkpoint_dir``. The pretrained
        ``load_file`` with ``train.load_params_only`` restores params and BN
        stats only, with a fresh optimizer and key at step 0."""
        path = path or self.cfg.train.load_file or None
        if path is None:
            path = ckpt.latest_checkpoint(self.cfg.train.checkpoint_dir)
        if path is None:
            hint = ""
            if self.mesh.world > 1:
                # rank 0 alone writes checkpoints, so the other ranks find
                # them only on a filesystem they share with it
                hint = (" — distributed runs write checkpoints from rank 0"
                        " only, so train.checkpoint_dir must be on a"
                        " filesystem shared by all ranks")
            raise FileNotFoundError(
                f"no checkpoint in {self.cfg.train.checkpoint_dir!r}{hint}")
        ts = self.init_state()
        params_only = self._params_only_path(path)
        whole = ts
        if self._tp_dims:  # the file holds whole leaves: a whole template
            model = self._new_model(torch.device("cpu"))
            whole = TrainState(model=model, opt=adam_init(dict(
                model.named_parameters())), key=ts.key)
        template = {"train_state": jax_train_state(whole.model, whole.opt,
                                                   whole.key),
                    "meta": {"step": np.int64(0), "data_cursor": np.int64(0)}}
        tree = ckpt.load_checkpoint(path, template, partial=params_only)
        opt, key = load_jax_train_state(ts.model, tree["train_state"],
                                        tp=self.mesh.model_axis)
        if params_only:
            return ts, 0, 0
        return (TrainState(model=ts.model, opt=opt, key=key),
                int(tree["meta"]["step"]), int(tree["meta"]["data_cursor"]))

    @torch.no_grad()
    def _sync_state(self, ts: TrainState, start_step: int, cursor: int
                    ) -> Tuple[TrainState, int, int]:
        """Rank 0's params, BN state, Adam state, key, step and data cursor
        on every rank (after init and after restore), so the replicas start
        equal whatever each rank found on its disk: the tensors from the
        first rank of each batch group (each model index its own slices),
        the counters from rank 0."""
        m = ts.model
        if self.mesh.batch.group is not None:
            broadcast([*m.parameters(), *m.buffers(), *ts.opt.mu.values(),
                       *ts.opt.nu.values()], self.mesh.batch.group,
                      src=self.mesh.batch_root)
        meta = torch.tensor([ts.opt.step, int(ts.key[0]), int(ts.key[1]),
                             start_step, cursor], dtype=torch.int64,
                            device=self.device)
        broadcast([meta], self.mesh.group)
        step, k0, k1, start_step, cursor = meta.tolist()
        return (TrainState(model=m, opt=ts.opt._replace(step=step),
                           key=np.array([k0, k1], np.uint32)),
                start_step, cursor)

    def _params_only_path(self, path: str) -> bool:
        lf = self.cfg.train.load_file
        return (self.cfg.train.load_params_only and bool(lf)
                and os.path.abspath(path) == os.path.abspath(lf))

    # -- fit loop ---------------------------------------------------------------

    def fit(self, iterations: Optional[int] = None, *, resume: bool = False,
            log: bool = True) -> Tuple[TrainState, Dict[str, float]]:
        cfg = self.cfg
        iters = iterations if iterations is not None else cfg.train.iterations
        start_step, cursor = 0, 0
        if resume or cfg.train.load_file:
            try:
                # --resume prefers the run's own latest checkpoint over
                # train.load_file, so a restarted fine-tune keeps its steps
                path = (ckpt.latest_checkpoint(cfg.train.checkpoint_dir)
                        if resume else None)
                ts, start_step, cursor = self.restore(path)
            except FileNotFoundError:
                ts = self.init_state()
        else:
            ts = self.init_state()
        mesh = self.mesh
        if mesh.group is not None:
            ts, start_step, cursor = self._sync_state(ts, start_step, cursor)
        K = max(1, int(cfg.train.steps_per_dispatch))
        for name, period in (("summary_iter", cfg.train.summary_iter),
                             ("val_iter", cfg.train.val_iter),
                             ("checkpoint_iter", cfg.train.checkpoint_iter),
                             ("iterations", iters)):
            if K > 1 and period and period % K:
                raise ValueError(
                    f"train.{name} ({period}) must be a multiple of "
                    f"train.steps_per_dispatch ({K})")

        loader = self.make_loader(train=True, start_event=cursor)
        loader.start()
        self.loader = loader
        # rank 0 alone writes: the metrics are equal on every rank, and
        # writers on shared paths would interleave
        if mesh.leader:
            logger = MetricsLogger(cfg.train.log_dir, name="train", echo=log)
            val_logger = MetricsLogger(cfg.train.log_dir, name="val", echo=log)
        else:
            logger, val_logger = NullLogger(), NullLogger()
        it = device_prefetch(iter(loader), device=self.device,
                             depth=cfg.data.prefetch_depth)
        # SIGTERM (preemption): finish the step, checkpoint, leave the loop;
        # --resume continues exactly. Off the main thread no handler is
        # installed (signal.signal raises there). Each rank receives its own
        # SIGTERM; with more than one rank a MAX all-reduce of the flag per
        # step makes every rank leave after the same step (a rank that left
        # alone would leave the others waiting in a collective).
        sync_preempt = cfg.train.preempt_save and mesh.world > 1
        preempted = {"flag": False}
        installed, prev_sigterm = False, None
        if cfg.train.preempt_save:
            def _on_sigterm(signum, frame):
                preempted["flag"] = True

            try:
                prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
                installed = True
            except ValueError:
                pass
        last: Dict[str, float] = {}
        t_last = time.time()
        cursor_now = cursor
        try:
            for step in range(start_step + K, start_step + iters + 1, K):
                summary = (step % cfg.train.summary_iter == 0
                           or step == start_step + iters)
                for j in range(K):
                    batch = next(it)
                    cursor_now = int(batch.pop("cursor", 0))
                    with_metrics = summary and j == K - 1
                    ts, metrics = self._train_step(ts, batch,
                                                   with_metrics=with_metrics)
                if summary:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_last
                    n_img = cfg.data.batch_size * cfg.train.summary_iter
                    m["images_per_sec"] = n_img / max(dt, 1e-9)
                    q = getattr(loader, "_q", None)
                    if q is not None:
                        m["decode_queue_depth"] = float(q.qsize())
                    t_last = time.time()
                    logger.log(step, m)
                    last = m
                if cfg.train.val_iter and step % cfg.train.val_iter == 0:
                    val_logger.log(step, self.validate(
                        ts, num_batches=cfg.train.val_batches))
                if (cfg.train.checkpoint_iter
                        and step % cfg.train.checkpoint_iter == 0):
                    self.save(ts, step, cursor_now)
                hit = preempted["flag"]
                if sync_preempt:
                    hit = bool(all_reduce_max(
                        torch.tensor([float(hit)], device=self.device),
                        mesh.group).item())
                if hit:
                    path = self.save(ts, step, cursor_now)
                    if mesh.leader:
                        print(f"[uresnet_tpu_torch] SIGTERM: checkpoint saved "
                              f"at step {step} -> {path}; resume with "
                              f"--resume", flush=True)
                    last["preempted_at_step"] = float(step)
                    break
            else:
                self.save(ts, start_step + iters, cursor_now)
        finally:
            if installed:
                # a None handler was installed from C: restore the default
                signal.signal(signal.SIGTERM, prev_sigterm
                              if prev_sigterm is not None else signal.SIG_DFL)
            for ld in (loader, self.val_loader):
                if ld is not None:
                    ld.stop()
                    if hasattr(ld, "close"):
                        ld.close()
            self.loader = self.val_loader = None
            logger.close()
            val_logger.close()
        return ts, last

    def validate(self, ts: TrainState, *, num_batches: int = 8) -> Dict[str, float]:
        """In-loop validation: means of the metrics over ``num_batches``
        sampled held-out batches; with ``train.val_exact``, the
        exactly-once pass over the held-out set (``evaluate_dataset``).
        Under a mesh every rank runs it on the gathered state (its metrics
        are all-reduced)."""
        if self.cfg.train.val_exact:
            from uresnet_tpu_torch.engine.evaluator import evaluate_dataset

            return evaluate_dataset(self, ts)
        if self.val_loader is None:
            self.val_loader = self.make_loader(train=False)
        logits_fn = build_logits_fn(self.cfg, self.gather_state(ts).model)
        agg: Dict[str, float] = {}
        for _ in range(num_batches):
            batch = self.val_loader.next()
            batch.pop("cursor", None)
            m = self.eval_step(ts, self.device_batch(batch), logits_fn)
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v) / num_batches
        return agg

