"""uresnet_tpu_torch — the PyTorch/CUDA port of uresnet_tpu for NVIDIA Hopper.

The JAX package ``uresnet_tpu`` is the reference this port is held against
(tests/test_torch_*.py). The port reuses the JAX package's jax-free host
modules by import — the typed config and the sparse-event data plane
(``uresnet_tpu.config``, ``uresnet_tpu.data.{events,pipeline,synthetic}``) —
and re-exports the ones its callers need here, so a user of the port
imports one package. Nothing in this package imports jax.

Ported so far: the BN-folded serving path (``cli/infer.py`` ->
``engine/evaluator.py`` -> ``engine/export.py`` -> ``models/fold.py``), whose
3x3 residual-block convs run through a hand-written CUDA kernel
(``csrc/conv2d.cu``, ``ops/cuda/conv2d.py``).
"""

__version__ = "0.1.0"

from uresnet_tpu.config import Config, load_config  # noqa: F401
from uresnet_tpu.data.synthetic import generate_file  # noqa: F401
