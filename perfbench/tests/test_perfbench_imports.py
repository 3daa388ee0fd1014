"""The import check compares whole top-level names."""

import subprocess
import sys

from harness import imports


def test_whole_names():
    assert imports.forbidden(["uresnet_tpu_torch", "uresnet_tpu_torch.x",
                              "torch", "jaxtyping"]) == []
    assert imports.forbidden(["uresnet_tpu.x"]) == ["uresnet_tpu.x"]
    assert imports.forbidden(["jax.numpy", "jaxlib", "flax.linen",
                              "uresnet_tpu"]) == ["flax.linen", "jax.numpy",
                                                  "jaxlib", "uresnet_tpu"]


def test_harness_and_port_load_no_jax():
    code = ("import sys; sys.path[:0] = ['perfbench', '.'];"
            "import harness.main, harness.loops, readings;"
            "import uresnet_tpu_torch.engine.trainer,"
            " uresnet_tpu_torch.engine.evaluator;"
            "from harness import imports; print(imports.forbidden())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=imports.__file__.rsplit(
                             "/perfbench/", 1)[0], timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
