"""The port never imports jax: importing the package and every module of
the serving and training slices, in a fresh interpreter, leaves jax out of
sys.modules."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "uresnet_tpu_torch",
    "uresnet_tpu_torch.utils.dtypes",
    "uresnet_tpu_torch.ops.conv",
    "uresnet_tpu_torch.ops.norm",
    "uresnet_tpu_torch.ops.cuda.build",
    "uresnet_tpu_torch.ops.cuda.conv2d",
    "uresnet_tpu_torch.models.blocks",
    "uresnet_tpu_torch.models.uresnet",
    "uresnet_tpu_torch.models.convert",
    "uresnet_tpu_torch.models.fold",
    "uresnet_tpu_torch.engine.checkpoint",
    "uresnet_tpu_torch.engine.metrics",
    "uresnet_tpu_torch.engine.export",
    "uresnet_tpu_torch.engine.evaluator",
    "uresnet_tpu_torch.cli.infer",
    "uresnet_tpu_torch.data.device_pipeline",
    "uresnet_tpu_torch.data.prefetch",
    "uresnet_tpu_torch.engine.losses",
    "uresnet_tpu_torch.engine.optim",
    "uresnet_tpu_torch.engine.augment",
    "uresnet_tpu_torch.engine.trainer",
    "uresnet_tpu_torch.cli.train",
]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
