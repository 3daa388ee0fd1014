"""The port's integration hooks (uresnet_tpu_torch/graft_entry.py),
mirroring tests/test_graft_entry.py: ``dryrun_multichip(n, "cpu")`` from
a fresh interpreter with no launch in its environment provisions n gloo
CPU ranks itself and runs every parallel leg against one process; inside
a launch of n processes it joins it; on the card (its default) it needs n
cards and says so; ``entry()``'s flagship forward has the JAX hook's
output shape."""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGS = ("DP loss=", "2D DPxTP loss=", "2D DPxSP loss=", "3D DPxSP loss=",
        "3D DPxTP loss=", "exactly-once eval on the DP mesh",
        "spatial halo-exchange conv OK")
CLEARED = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
           "XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")


def _dryrun(n, env):
    return subprocess.run(
        [sys.executable, "-c",
         f"from uresnet_tpu_torch import graft_entry as g; "
         f"g.dryrun_multichip({n}, device='cpu')"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def _clean_env():
    return {k: v for k, v in os.environ.items() if k not in CLEARED}


def test_dryrun_multichip_4_self_provisions():
    """Four ranks: every leg matches one process, and the spatial x model
    mesh is refused as the JAX trainer refuses it."""
    proc = _dryrun(4, _clean_env())
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for leg in LEGS + ("spatial x model mesh REJECTED",):
        assert f"dryrun_multichip(4): {leg}" in proc.stdout, (leg, proc.stdout)
    assert proc.stdout.count(", match)") == 5


def test_dryrun_multichip_2_self_provisions():
    """Two ranks: the legs of a (1, 1, 2) and a (1, 2, 1) mesh; a spatial
    x model mesh needs four."""
    proc = _dryrun(2, _clean_env())
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for leg in LEGS:
        assert f"dryrun_multichip(2): {leg}" in proc.stdout, (leg, proc.stdout)
    assert "REJECTED" not in proc.stdout


def test_dryrun_joins_a_launch():
    """Called in each process of a launch of n, it joins the launch (one
    rank per process) instead of starting ranks of its own."""
    from uresnet_tpu_torch.parallel.mesh import launch_local

    env = dict(_clean_env(), OMP_NUM_THREADS="1")
    res = launch_local(
        [sys.executable, "-c", "from uresnet_tpu_torch import graft_entry "
         "as g; g.dryrun_multichip(2, device='cpu')"], 2, env=env, cwd=ROOT,
        timeout=300)
    for rank, (rc, out) in enumerate(res):
        assert rc == 0, out[-3000:]
    assert "dryrun_multichip(2): DP loss=" in res[0][1]
    assert "dryrun_multichip" not in res[1][1]  # rank 0 reports


def test_dryrun_on_the_card_needs_n_cards(monkeypatch):
    """The card is the default: with fewer cards than ranks it raises
    before it starts any process, and names the CPU form."""
    import pytest

    from uresnet_tpu_torch import graft_entry
    from uresnet_tpu_torch.parallel import mesh

    for k in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(mesh, "launch_local", None)  # never reached
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"needs {have + 1} cards .*"
                       f"have {have}; pass device='cpu'"):
        graft_entry.dryrun_multichip(have + 1)


def test_entry_traces():
    """The flagship eval forward traced on the meta device: the JAX hook's
    shape contract, float32 logits."""
    from uresnet_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="meta")
    out = fn(*args)
    assert out.shape == (2, 256, 256, 3)
    assert out.dtype == torch.float32 and out.device.type == "meta"
