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

* the BN-folded serving path (``cli/infer.py`` -> ``engine/evaluator.py``
  -> ``engine/export.py`` -> ``models/fold.py``), whose 3x3 residual-block
  convs run through a hand-written CUDA kernel (``csrc/conv2d.cu``,
  ``ops/cuda/conv2d.py``, bound to both Pallas entry points);
* the 2D training path (``cli/train.py`` -> ``engine/trainer.py``):
  sparse batches staged by ``data/prefetch.py`` and densified on the device
  (``data/device_pipeline.py``, ``engine/augment.py``), the train-mode
  forward with TF1 BatchNorm and activation checkpointing
  (``models/uresnet.py``, ``ops/norm.py``), f32 weight gradients of the
  bf16 convs (``ops/conv.py``), the weighted cross-entropy and metrics
  (``engine/losses.py``, ``engine/metrics.py``), Adam/RMSProp
  (``engine/optim.py``), and checkpoints of the whole train state in the
  JAX layout (``engine/checkpoint.py``, ``models/convert.py``).
"""

__version__ = "0.1.0"

from uresnet_tpu_torch.config import Config, load_config  # noqa: F401
from uresnet_tpu_torch.data.synthetic import generate_file  # noqa: F401
