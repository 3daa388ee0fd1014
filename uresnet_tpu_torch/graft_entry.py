"""Integration hooks of the port: the counterpart of the repository's
``__graft_entry__.py``, which stays the JAX package's.

entry(device)       -> (fn, example_args): the flagship 2D U-ResNet's eval
                       forward (base 16, depth 5, 3 classes, bf16) and a
                       2 x 256^2 x 1 input; with its ``model.pack`` the
                       packed eval forward (models/packed.py), as the JAX
                       hook's.
dryrun_multichip(n, device)
                    -> one train step of every parallel leg over n ranks
                       on tiny shapes, each against one process: data
                       parallelism, 2D and 3D tensor parallelism (data x
                       model), 2D and 3D spatial partitioning (data x
                       spatial); the spatial x model refusal; the
                       exactly-once evaluation on the data-parallel mesh;
                       the standalone halo conv against the unsharded conv.

Where the JAX hook runs on n devices of one process, this one runs on n
processes, one per device, on the card unless the caller asks for the CPU.
Inside a launch of n processes (``torchrun --nproc-per-node n``) it joins
it: NCCL on ``cuda:LOCAL_RANK``, or gloo for ``device="cpu"``. Run outside
a launch it starts the n ranks itself (``python -m
uresnet_tpu_torch.graft_entry --dryrun n --device D`` in the torchrun
environment, parallel/mesh.py ``launch_local``): one card each, which needs
n cards, or n gloo CPU ranks for ``device="cpu"``; it prints rank 0's
report and raises if a rank fails.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

LOSS_RTOL, LOSS_ATOL = 5e-4, 1e-5  # the JAX dryrun's match


def _flagship_cfg():
    from uresnet_tpu_torch.config import ModelConfig

    return ModelConfig(dims=2, num_class=3, base_filters=16, depth=5,
                       compute_dtype="bfloat16", pack=True, pack_extra_h=True)


def entry(device="cuda"):
    """The flagship eval forward and its example input, on ``device``
    (the card unless the caller asks for another; ``meta`` traces shapes
    only)."""
    from uresnet_tpu_torch.models.uresnet import UResNet

    model = UResNet(_flagship_cfg(),
                    generator=torch.Generator().manual_seed(0),
                    device=torch.device(device))
    x = torch.zeros((2, 256, 256, 1), device=device)

    @torch.no_grad()
    def fn(x):
        return model(x)[0]

    return fn, (x,)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One train step of each parallel leg over ``n_devices`` ranks on
    ``device`` (see the module docstring); raises if a leg disagrees with
    one process, or if ``device`` is the card and fewer than
    ``n_devices`` cards are visible."""
    from uresnet_tpu_torch.parallel import mesh

    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"dryrun_multichip runs on cuda or cpu, not "
                         f"{device!r}")
    if os.environ.get("WORLD_SIZE") == str(n_devices) and all(
            k in os.environ for k in mesh.TORCHRUN_ENV):
        dev = mesh.init_distributed(kind)
        try:
            return _dryrun_impl(n_devices, dev)
        finally:
            mesh.shutdown()
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) on the card needs "
                f"{n_devices} cards (one rank each), have {have}; pass "
                f"device='cpu' for gloo ranks on the CPU")
        from uresnet_tpu_torch.ops.cuda.build import build

        build()  # once here, not once per rank
    env = {k: v for k, v in os.environ.items() if k not in mesh.TORCHRUN_ENV}
    env["OMP_NUM_THREADS"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in (env.get("PYTHONPATH"),) if p])
    res = mesh.launch_local(
        [sys.executable, "-m", "uresnet_tpu_torch.graft_entry", "--dryrun",
         str(n_devices), "--device", kind], n_devices, env=env, cwd=root)
    print(res[0][1], end="", flush=True)
    for rank, (rc, out) in enumerate(res):
        if rc != 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}) rank {rank} "
                               f"exited {rc}:\n{out[-4000:]}")


def _config(dims, batch, augment):
    from uresnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          TrainConfig)

    return Config(
        model=ModelConfig(dims=dims, num_class=3, depth=2,
                          base_filters=4 if dims == 2 else 2,
                          compute_dtype="float32"),
        data=DataConfig(image_size=32 if dims == 2 else 16, batch_size=batch,
                        planes=(0,), synthetic=True, augment=augment),
        train=TrainConfig(seed=0))


def _host_batch(cfg, rng):
    shape = (cfg.data.batch_size,) + (cfg.data.image_size,) * cfg.model.dims
    return {"data": rng.random(shape + (1,), np.float32),
            "label": rng.integers(0, 3, shape).astype(np.int64),
            "weight": np.ones(shape, np.float32)}


def _dryrun_impl(n: int, dev: torch.device) -> None:
    import torch.distributed as dist

    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.parallel.mesh import Mesh, make_mesh

    rank = dist.get_rank()
    lead = rank == 0
    one = Mesh(rank=0, world=1, data=1)  # rank 0's one-process references

    def say(msg):
        if lead:
            print(f"dryrun_multichip({n}): {msg}", flush=True)

    def step(cfg, shape, batch):
        """This rank's train step of its share of ``batch`` on a mesh of
        ``shape``; the logged (global) loss."""
        tr = Trainer(cfg, device=dev, mesh=make_mesh(*shape))
        d, rows = tr.mesh.index[0], cfg.data.batch_size // tr.mesh.data
        ts = tr.init_state()
        _, m = tr.train_step(ts, tr.device_batch(
            {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}))
        if tr._tp_dims:  # channel-sliced storage
            assert (ts.model.stem.conv.w.shape[-1]
                    == cfg.model.base_filters // 2)
        loss = float(m["loss"])
        assert np.isfinite(loss), loss
        return loss, tr.mesh

    def reference(cfg, batch):
        tr = Trainer(cfg, device=dev, mesh=one)
        _, m = tr.train_step(tr.init_state(), tr.device_batch(batch))
        return float(m["loss"])

    def check(leg, result, want):
        loss, mesh = result
        if lead and not np.isclose(loss, want, rtol=LOSS_RTOL, atol=LOSS_ATOL):
            raise AssertionError(f"{leg} loss {loss} != one-process {want}")
        say(f"{leg} loss={loss:.4f} (one process {want if lead else 0:.4f}, "
            f"match), one train step on the mesh (data, spatial, model) = "
            f"({mesh.data}, {mesh.spatial}, {mesh.model})")

    rng = np.random.default_rng(0)
    cfg = _config(2, 2 * n, augment=True)
    batch = _host_batch(cfg, rng)
    loss1 = reference(cfg, batch) if lead else None
    check("DP", step(cfg, (n, 1, 1), batch), loss1)
    if n >= 2:
        check("2D DPxTP", step(cfg, (n // 2, 1, 2), batch), loss1)
        check("2D DPxSP", step(cfg, (n // 2, 2, 1), batch), loss1)
        cfg3 = _config(3, n, augment=False)
        batch3 = _host_batch(cfg3, rng)
        loss3 = reference(cfg3, batch3) if lead else None
        check("3D DPxSP", step(cfg3, (n // 2, 2, 1), batch3), loss3)
        check("3D DPxTP", step(cfg3, (n // 2, 1, 2), batch3), loss3)
    if n >= 4:
        try:
            Trainer(cfg, device=dev, mesh=make_mesh(n // 4, 2, 2))
        except ValueError as e:
            say(f"spatial x model mesh REJECTED by the Trainer, as the JAX "
                f"trainer rejects it: {e}")
        else:
            raise AssertionError("spatial x model mesh was NOT rejected")
    if n >= 2:
        _eval_leg(n, cfg, one, dev, say)
        _halo_leg(n, rng, dev, say)


def _eval_leg(n, cfg, one, dev, say):
    """The exactly-once evaluation on the data-parallel mesh."""
    import dataclasses

    from uresnet_tpu_torch.data.synthetic import generate_file
    from uresnet_tpu_torch.engine.evaluator import evaluate_dataset
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory() as td:  # every rank its own copy
        f_eval = generate_file(os.path.join(td, "eval.usef"), 5, seed=41,
                               shape=(64, 64), planes=(0,))
        cfg_e = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, input_files=(f_eval,), synthetic=False,
            random_access=False, augment=False))
        tr = Trainer(cfg_e, device=dev, mesh=make_mesh(n, 1, 1))
        m_dp = evaluate_dataset(tr, tr.init_state())
        if tr.mesh.leader:
            tr1 = Trainer(cfg_e, device=dev, mesh=one)
            m_1 = evaluate_dataset(tr1, tr1.init_state())
            assert m_dp["n_events"] == m_1["n_events"] == 5
            assert m_dp["n_pixels"] == m_1["n_pixels"] == 5 * 32 * 32
            assert m_dp["n_nonzero"] == m_1["n_nonzero"]
            say(f"exactly-once eval on the DP mesh: n_nonzero="
                f"{int(m_dp['n_nonzero'])} miou={m_dp['miou']:.4f} "
                f"(one process {m_1['miou']:.4f})")


def _halo_leg(n, rng, dev, say):
    """parallel/halo.py's sharded conv over (data n/2, spatial 2) equals
    the unsharded SAME conv."""
    from uresnet_tpu_torch.ops.conv import conv_general
    from uresnet_tpu_torch.parallel.halo import sharded_conv
    from uresnet_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh(n // 2, 2, 1)
    x = torch.from_numpy(
        rng.standard_normal((2, 16, 16, 4)).astype(np.float32)).to(dev)
    w = torch.from_numpy(
        rng.standard_normal((3, 3, 4, 4)).astype(np.float32)).to(dev)
    s, rows = m.index[1], 16 // 2
    got = sharded_conv(x[:, s * rows:(s + 1) * rows], w, axis=m.spatial_axis)
    want = conv_general(x, w, stride=1, compute_dtype=torch.float32)
    torch.testing.assert_close(got, want[:, s * rows:(s + 1) * rows],
                               rtol=1e-5, atol=1e-5)
    say(f"spatial halo-exchange conv OK on (data, spatial, model) = "
        f"({m.data}, {m.spatial}, {m.model})")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the port's integration hooks: "
                                 "entry()'s forward, or the multichip dry run")
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="dryrun_multichip(N, device)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
    else:
        fn, example = entry(args.device)
        out = fn(*example)
        print("entry forward:", tuple(out.shape), out.dtype)
