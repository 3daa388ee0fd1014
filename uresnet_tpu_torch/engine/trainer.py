"""The training engine (port of uresnet_tpu/engine/trainer.py), one device.

A train step densifies a sparse batch on the device (with the in-scatter
flips/rot90 when ``data.augment``), runs the canonical U-ResNet forward in
train mode, the pixel-weighted softmax cross-entropy, the backward with f32
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

Not ported (they raise): data/spatial/model parallelism, ``val_exact``
(the exactly-once ``evaluate_dataset``) and 3D — ROADMAP.md. The packed
TPU layouts (``model.pack``, ``train.packed_loss``) are accepted and run
canonical; ``steps_per_dispatch = K`` runs K plain steps per loop turn.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from uresnet_tpu_torch.config import Config
from uresnet_tpu_torch.data.loader import make_batch_loader
from uresnet_tpu_torch.engine.logging import MetricsLogger
from uresnet_tpu_torch.data.device_pipeline import (densify_on_device,
                                                    draw_decisions)
from uresnet_tpu_torch.data.prefetch import device_prefetch
from uresnet_tpu_torch.engine import checkpoint as ckpt
from uresnet_tpu_torch.engine.augment import augment_batch
from uresnet_tpu_torch.engine.losses import weighted_softmax_xent
from uresnet_tpu_torch.engine.metrics import segmentation_metrics
from uresnet_tpu_torch.engine.optim import (AdamState, adam_init, adam_update,
                                            freeze_mask)
from uresnet_tpu_torch.models.convert import (flatten_tree, jax_train_state,
                                              load_jax_train_state)
from uresnet_tpu_torch.models.fold import KERNEL_BACKENDS
from uresnet_tpu_torch.models.uresnet import UResNet
from uresnet_tpu_torch.ops.conv import check_dims

_NOT_PORTED = "is not ported yet (ROADMAP.md, modules to port)"


@dataclasses.dataclass
class TrainState:
    model: UResNet            # params (parameters) and BN running stats (buffers)
    opt: AdamState
    key: np.ndarray           # uint32[2]: (train.seed, step)


def _key_seed(key: np.ndarray) -> int:
    return (int(key[0]) << 32) | int(key[1])


class Trainer:
    def __init__(self, cfg: Config, *, device="cuda"):
        for axis in ("data", "spatial", "model"):
            if getattr(cfg.parallel, axis) > 1:
                raise NotImplementedError(
                    f"parallel.{axis} > 1: parallelism {_NOT_PORTED}")
        if cfg.train.val_exact:
            raise NotImplementedError(
                f"train.val_exact (evaluate_dataset) {_NOT_PORTED}")
        check_dims(cfg.model.dims)
        if cfg.model.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"model.kernel_backend must be one of {KERNEL_BACKENDS}, got "
                f"{cfg.model.kernel_backend!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.model.compute_dtype == "float32":
            # f32 means true f32, as JAX's Precision.HIGHEST: no TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._freeze = None
        if cfg.optim.freeze:  # validate the patterns before any training
            names = [n for n, _ in self._new_model(torch.device("meta"))
                     .named_parameters()]
            self._freeze = freeze_mask(names, cfg.optim.freeze)
        self.loader = None
        self.val_loader = None

    # -- state ---------------------------------------------------------------

    def _new_model(self, device, seed: Optional[int] = None) -> UResNet:
        seed = self.cfg.train.seed if seed is None else seed
        return UResNet(self.cfg.model,
                       generator=torch.Generator().manual_seed(seed),
                       device=device)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        seed = self.cfg.train.seed if seed is None else seed
        model = self._new_model(self.device, seed)
        for name, p in model.named_parameters():
            p.requires_grad_(not (self._freeze and self._freeze[name]))
        params = {k: v.detach() for k, v in model.named_parameters()}
        return TrainState(model=model, opt=adam_init(params),
                          key=np.array([seed & 0xFFFFFFFF, 0], np.uint32))

    # -- step functions ------------------------------------------------------

    def _prepare(self, batch: Dict, decisions=None) -> Dict:
        """A sparse batch is densified on the device; ``decisions`` apply
        the flips/rot90 inside the scatter. Dense batches pass through."""
        if "coords" not in batch:
            return batch
        d = self.cfg.data
        return densify_on_device(
            batch, image_size=d.image_size, num_class=self.cfg.model.num_class,
            normalize_scale=d.normalize_scale,
            normalize_clip=d.normalize_clip, weight_mode=d.weight_mode,
            nonzero_boost=d.weight_nonzero_boost, decisions=decisions)

    def _loss_fn(self, model: UResNet, batch: Dict, train: bool):
        """(loss, logits, new BN state) of one batch."""
        logits, new_state = model(batch["data"], train=train)
        loss = weighted_softmax_xent(logits, batch["label"], batch["weight"],
                                     normalize=self.cfg.train.loss_normalize)
        return loss, logits, new_state

    def _train_step(self, ts: TrainState, batch: Dict,
                    with_metrics: bool = True) -> Tuple[TrainState, Dict]:
        cfg = self.cfg
        decisions = None
        if cfg.data.augment:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_key_seed(ts.key))
            B = next(v for v in batch.values() if torch.is_tensor(v)).shape[0]
            decisions = draw_decisions(gen, B, cfg.model.dims)
        sparse = "coords" in batch
        batch = self._prepare(batch, decisions if sparse else None)
        if decisions is not None and not sparse:
            batch = augment_batch(batch, dims=cfg.model.dims,
                                  decisions=decisions)
        model = ts.model
        params = dict(model.named_parameters())
        trainable = [k for k, p in params.items() if p.requires_grad]
        with torch.enable_grad():
            loss, logits, new_state = self._loss_fn(model, batch, True)
            grads = torch.autograd.grad(loss, [params[k] for k in trainable])
        new_params, opt = adam_update(
            dict(zip(trainable, grads)), ts.opt,
            {k: p.detach() for k, p in params.items()}, cfg.optim,
            freeze=self._freeze)
        with torch.no_grad():
            for k, p in params.items():
                p.data = new_params[k]
            flat = dict(model.named_buffers())
            for k, v in flatten_tree(new_state).items():
                flat[k].data = v
        metrics = {"loss": loss.detach()}
        if with_metrics:
            metrics.update(segmentation_metrics(
                logits.detach(), batch["label"], batch["data"],
                num_class=cfg.model.num_class))
        key = np.array([ts.key[0], (int(ts.key[1]) + 1) & 0xFFFFFFFF], np.uint32)
        return TrainState(model=model, opt=opt, key=key), metrics

    @torch.no_grad()
    def _eval_step(self, ts: TrainState, batch: Dict) -> Dict:
        batch = self._prepare(batch)
        loss, logits, _ = self._loss_fn(ts.model, batch, False)
        metrics = segmentation_metrics(logits, batch["label"], batch["data"],
                                       num_class=self.cfg.model.num_class)
        metrics["loss"] = loss
        return metrics

    def train_step(self, ts: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        """One step with the summary metrics. The model in ``ts`` is updated
        in place; use the returned state."""
        return self._train_step(ts, batch, with_metrics=True)

    def train_step_light(self, ts: TrainState, batch: Dict
                         ) -> Tuple[TrainState, Dict]:
        """The hot-loop step: loss only in the metrics."""
        return self._train_step(ts, batch, with_metrics=False)

    def eval_step(self, ts: TrainState, batch: Dict) -> Dict:
        return self._eval_step(ts, batch)

    # -- data -----------------------------------------------------------------

    def make_loader(self, *, train: bool = True, start_event: int = 0):
        dcfg = self.cfg.data
        if not train and dcfg.synthetic and not dcfg.input_files:
            # held-out synthetic validation: another generator seed
            dcfg = dataclasses.replace(dcfg, seed=dcfg.seed + 10007)
        return make_batch_loader(dcfg, num_class=self.cfg.model.num_class,
                                 train=train, ndims=self.cfg.model.dims,
                                 start_event=start_event)

    def device_batch(self, batch: Dict) -> Dict:
        """Host batch (numpy) -> tensors on the trainer's device."""
        return next(device_prefetch(iter([batch]), device=self.device, depth=0))

    # -- checkpoint -----------------------------------------------------------

    def save(self, ts: TrainState, step: int, data_cursor: int = 0) -> str:
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
            raise FileNotFoundError(
                f"no checkpoint in {self.cfg.train.checkpoint_dir!r}")
        ts = self.init_state()
        params_only = self._params_only_path(path)
        template = {"train_state": jax_train_state(ts.model, ts.opt, ts.key),
                    "meta": {"step": np.int64(0), "data_cursor": np.int64(0)}}
        tree = ckpt.load_checkpoint(path, template, partial=params_only)
        opt, key = load_jax_train_state(ts.model, tree["train_state"])
        if params_only:
            return ts, 0, 0
        return (TrainState(model=ts.model, opt=opt, key=key),
                int(tree["meta"]["step"]), int(tree["meta"]["data_cursor"]))

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
        logger = MetricsLogger(cfg.train.log_dir, name="train", echo=log)
        val_logger = MetricsLogger(cfg.train.log_dir, name="val", echo=log)
        it = device_prefetch(iter(loader), device=self.device,
                             depth=cfg.data.prefetch_depth)
        # SIGTERM (preemption): finish the step, checkpoint, leave the loop;
        # --resume continues exactly. Off the main thread no handler is
        # installed (signal.signal raises there).
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
                if cfg.train.checkpoint_iter and step % cfg.train.checkpoint_iter == 0:
                    self.save(ts, step, cursor_now)
                if preempted["flag"]:
                    path = self.save(ts, step, cursor_now)
                    print(f"[uresnet_tpu_torch] SIGTERM: checkpoint saved at "
                          f"step {step} -> {path}; resume with --resume",
                          flush=True)
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
        sampled held-out batches."""
        if self.val_loader is None:
            self.val_loader = self.make_loader(train=False)
        agg: Dict[str, float] = {}
        for _ in range(num_batches):
            batch = self.val_loader.next()
            batch.pop("cursor", None)
            m = self.eval_step(ts, self.device_batch(batch))
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v) / num_batches
        return agg

