"""uresnet_tpu_torch — the PyTorch/CUDA port of uresnet_tpu for NVIDIA Hopper.

The JAX package ``uresnet_tpu`` is the reference this port is held against
(tests/test_torch_*.py). The port is self-contained: it imports neither jax
nor anything of ``uresnet_tpu``. The jax-free host modules it needs — the
typed config, the sparse-event data plane and loaders, the metrics logger
(``config``, ``data.{events,pipeline,synthetic,loader,pset_compat,
cxx_decoder}``, ``engine.{logging,tb_writer}``) — are the port's own copies,
held equal to the JAX package's by tests/test_torch_data.py. The ones its
callers need are re-exported here, so a user of the port imports one
package.

Ported so far:

* the BN-folded serving and analysis path (``cli/infer.py`` ->
  ``engine/evaluator.py``: streamed sparse, dense and tiled score exports
  in npz or USEF, the host-densify oracle, the exactly-once
  ``evaluate_dataset`` -> ``engine/export.py`` -> ``models/fold.py``),
  whose 3x3 residual-block convs run through a hand-written CUDA kernel
  (``csrc/conv2d.cu``, ``ops/cuda/conv2d.py``, bound to both Pallas entry
  points);
* the training path (``cli/train.py`` -> ``engine/trainer.py``):
  sparse batches staged by ``data/prefetch.py`` and densified on the device
  (``data/device_pipeline.py``, ``engine/augment.py``), the train-mode
  forward with TF1 BatchNorm and activation checkpointing
  (``models/uresnet.py``, ``ops/norm.py``; train BN with its residual add
  and ReLU as hand-written CUDA kernels, ``csrc/bn_train.cu``,
  ``ops/cuda/bn_train.py``), f32 weight gradients of the
  bf16 convs (``ops/conv.py``), the weighted cross-entropy and metrics
  (``engine/losses.py``, ``engine/metrics.py``), Adam/RMSProp
  (``engine/optim.py``), and checkpoints of the whole train state in the
  JAX layout (``engine/checkpoint.py``, ``models/convert.py``);
* 3D models (``model.dims: 3``, BASELINE config 4) on both paths: every
  conv op is N-D (``ops/conv.py``); in 3D the only hand kernels are train
  BN's, the fused conv being 2D only.
"""

__version__ = "0.1.0"

from uresnet_tpu_torch.config import Config, load_config  # noqa: F401
from uresnet_tpu_torch.data.synthetic import generate_file  # noqa: F401
