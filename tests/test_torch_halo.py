"""The port's spatial partitioning in four real processes on the CPU
(gloo), against the JAX package and against one process.

Mirrors tests/test_halo.py and tests/test_trainer.py::
test_spatial_dp_equals_single_device. The module launches four ``--device
cpu`` ranks once (the worker is this file's own ``__main__``); each rank
holds its shard of every case's input, made from a numpy seed, and saves
its shard of the outputs and gradients:

  * ``sharded_conv`` (parallel/halo.py) of H-sharded inputs at spatial 4:
    2D at stride 1/2 x k 1/3/5, 3D, a data x spatial (2 x 2) mesh, and the
    transposed conv at stride 2 in 2D and 3D; the output against
    ``uresnet_tpu.parallel.halo.sharded_conv`` (or the JAX transposed
    conv) and the unsharded conv (in float64), at 1e-5 of the max; the
    input and weight gradients of a fixed cotangent against the unsharded
    conv's;
  * a halo wider than the shard raises the JAX package's ValueError;
  * one train step of the tiny U-ResNet at (data 2, spatial 2) in 2D and
    3D from the port's seeded initial state: loss, per-leaf gradients and
    the new BN state against the JAX package's one-device step from the
    same state (carried across in the shared checkpoint layout) and the
    port's one-process step, at test_spatial_dp_equals_single_device's
    tolerances (loss rtol 1e-4, gradients rtol 1e-2 / atol 2e-3, BN state
    rtol 1e-4 / atol 1e-6).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
REL = 1e-5  # of the max, f32
N_CLI = 8    # the events of the cli.train run
# the packed layout at (data 2, spatial 2): in 2D with the resident H pack
# (its level-0 convs exchange packed, H-packed rows) and the packed loss; in
# 3D as configs/train_3d_192_sp.yaml ships it
PACKED = {2: dict(pack=True, pack_extra_h=True), 3: dict(pack=True)}

# name: (x shape, w shape, stride, kind, (data, spatial))
CONVS = {
    **{f"2d_s{s}_k{k}": ((2, 32, 16, 3), (k, k, 3, 4), s, "conv", (1, 4))
       for s in (1, 2) for k in (1, 3, 5)},
    "3d": ((1, 16, 8, 8, 2), (3, 3, 3, 2, 3), 1, "conv", (1, 4)),
    "2d_data_spatial": ((4, 16, 8, 2), (3, 3, 2, 2), 1, "conv", (2, 2)),
    "convt_2d": ((2, 16, 8, 3), (3, 3, 3, 4), 2, "convt", (1, 4)),
    "convt_3d": ((1, 8, 4, 4, 2), (3, 3, 3, 2, 3), 2, "convt", (1, 4)),
}


def _conv_inputs(name):
    xs, ws, stride, kind, _ = CONVS[name]
    rng = np.random.default_rng(sorted(CONVS).index(name))
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    out = list(xs)
    out[1:-1] = [n * stride if kind == "convt" else n // stride
                 for n in xs[1:-1]]
    out[-1] = ws[-1]
    g = rng.standard_normal(out).astype(np.float32)
    return x, w, g


def _shard(a, mesh_shape, d, s):
    """The (d, s) shard of a global batch: rows of the batch by d, of
    dim 1 by s."""
    nd, ns = mesh_shape
    b, h = a.shape[0] // nd, a.shape[1] // ns
    return a[d * b:(d + 1) * b, s * h:(s + 1) * h]


def _cfg(dims, outdir, name, spatial=1, packed=False):
    """tests/test_trainer.py's tiny config (2D) and tests/test_tp.py's 3D
    one (base 4, 16^3, batch 2), f32, on a (data 2, spatial) mesh. (At the
    dryrun's 3D base 2 the 2-channel BN statistics are ill-conditioned:
    XLA's CPU f32 stem gradient lies 2.7e-3 off a float64 port step, the
    port's f32 2.5e-4.) ``packed``: the layout of ``PACKED``."""
    from uresnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          OptimConfig, ParallelConfig,
                                          TrainConfig)

    return Config(
        model=ModelConfig(dims=dims, depth=2, num_class=3,
                          base_filters=4, compute_dtype="float32",
                          **(PACKED[dims] if packed else {})),
        data=DataConfig(image_size=32 if dims == 2 else 16,
                        batch_size=4 if dims == 2 else 2, planes=(0,),
                        synthetic=True, augment=False),
        optim=OptimConfig(lr=3e-3),
        train=TrainConfig(seed=11, packed_loss=packed and dims == 2,
                          checkpoint_dir=os.path.join(
            outdir, name, "ckpt"), log_dir=os.path.join(outdir, name, "log")),
        parallel=ParallelConfig(data=2 if spatial > 1 else 1,
                                spatial=spatial))


def _host_batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    shape = (cfg.data.batch_size,) + (cfg.data.image_size,) * cfg.model.dims
    return {"data": rng.random(shape + (1,), np.float32),
            "label": rng.integers(0, 3, shape).astype(np.int64),
            "weight": np.ones(shape, np.float32)}


def _step_grads(tr, ts, batch):
    """Loss, per-leaf gradients and new BN state of one step on this
    rank's share of ``batch`` (the global batch), reduced over the mesh's
    batch group as Trainer._train_step reduces them."""
    from uresnet_tpu_torch.models.convert import flatten_tree
    from uresnet_tpu_torch.parallel.mesh import all_reduce_mean

    m = tr.mesh
    d = m.index[0]
    rows = batch["data"].shape[0] // m.data
    local = tr._local_rows({k: torch.from_numpy(v[d * rows:(d + 1) * rows])
                            for k, v in batch.items()})
    params = dict(ts.model.named_parameters())
    with torch.enable_grad():
        loss, _, state = tr._loss_fn(ts.model, local)
        grads = list(torch.autograd.grad(loss, list(params.values())))
    loss = loss.detach().reshape(1).clone()
    if m.batch.group is not None:
        all_reduce_mean([*grads, loss], m.batch.group)
    out = {"loss": loss.numpy()}
    out.update({f"grad.{k}": g.numpy() for k, g in zip(params, grads)})
    out.update({f"state.{k}": v.numpy()
                for k, v in flatten_tree(state).items()})
    return out


# -- the worker (one rank) ------------------------------------------------------


def _worker(outdir, usef):
    import dataclasses

    import torch.distributed as dist

    from uresnet_tpu_torch.cli import train as cli_train
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.parallel import mesh
    from uresnet_tpu_torch.parallel.halo import sharded_conv

    mesh.init_distributed("cpu")
    rank = dist.get_rank()

    def save(name, **arrays):
        np.savez(os.path.join(outdir, f"{name}.{rank}.npz"), **arrays)

    for name, (_, _, stride, kind, shape) in CONVS.items():
        m = mesh.make_mesh(*shape)
        d, s, _ = m.index
        x, w, g = _conv_inputs(name)
        xt = torch.tensor(_shard(x, shape, d, s), requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        y = sharded_conv(xt, wt, axis=m.spatial_axis, stride=stride,
                         kind=kind, compute_dtype=torch.float32)
        dx, dw = torch.autograd.grad(
            (y * torch.from_numpy(_shard(g, shape, d, s))).sum(), [xt, wt])
        dist.all_reduce(dw)
        save(name, y=y.detach().numpy(), dx=dx.numpy(), dw=dw.numpy())
    m = mesh.make_mesh(1, 4)
    x = torch.zeros((1, 8, 8, 2))
    try:  # 2-row shards; k = 9 needs 4-row halos
        sharded_conv(x[:, :2], torch.zeros((9, 9, 2, 2)), axis=m.spatial_axis)
        error = ""
    except ValueError as e:
        error = str(e)
    with open(os.path.join(outdir, f"halo_error.{rank}.json"), "w") as f:
        json.dump(error, f)

    for dims in (2, 3):
        for name, packed in ((f"sp{dims}d", False),
                             (f"sp{dims}d_packed", True)):
            cfg = _cfg(dims, outdir, name, spatial=2, packed=packed)
            tr = Trainer(cfg, device="cpu")
            save(name, **_step_grads(tr, tr.init_state(), _host_batch(cfg)))
    # last: the CLI joins the live group and shuts it down at its end
    cfg = _cfg(2, os.path.join(outdir, "cli"), "sp", spatial=2)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, input_files=(usef,), synthetic=False, random_access=False))
    cli_cfg = os.path.join(outdir, f"cli.{rank}.json")
    with open(cli_cfg, "w") as f:
        json.dump(cfg.to_dict(), f)
    return cli_train.main([cli_cfg, "train.iterations=2",
                           "train.summary_iter=1", "train.checkpoint_iter=2",
                           "train.val_iter=2", "train.val_exact=true",
                           "--device", "cpu", "--distributed"])


# -- the tests ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from uresnet_tpu_torch.parallel.mesh import launch_local

    from uresnet_tpu_torch.data.synthetic import generate_file

    outdir = str(tmp_path_factory.mktemp("halo"))
    usef = generate_file(os.path.join(outdir, "sp.usef"), N_CLI, seed=3,
                         shape=(64, 64), planes=(0,))
    res = launch_local([sys.executable, os.path.abspath(__file__), outdir,
                        usef], WORLD, env=dict(os.environ, OMP_NUM_THREADS="1"),
                       cwd=ROOT, timeout=300)
    for rank, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        with open(os.path.join(outdir, f"log.{rank}.txt"), "w") as f:
            f.write(out)
    return outdir


def _gathered(outdir, name, shape, key):
    """The ranks' shards of one output, as the global array."""
    nd, ns = shape
    shards = []
    for r in range(WORLD):
        with np.load(os.path.join(outdir, f"{name}.{r}.npz")) as z:
            shards.append(z[key])
    return np.concatenate([np.concatenate(shards[d * ns:(d + 1) * ns], 1)
                           for d in range(nd)], 0)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=REL,
                               err_msg=what)


def test_same_and_transpose_halo_values():
    from uresnet_tpu_torch.parallel.halo import same_halo, transpose_halo

    assert same_halo(3, 1) == (1, 1)
    assert same_halo(3, 2) == (0, 1)
    assert same_halo(1, 1) == (0, 0)
    assert same_halo(5, 1) == (2, 2)
    # the model's up convs: one row from the previous shard
    assert transpose_halo(3, 2) == (1, 0)
    assert transpose_halo(1, 2) == (0, 0)


def _unsharded(name):
    """The port's unsharded conv of the global input, in float64: output
    and the gradients of the case's cotangent. (In f32 with jax loaded in
    the process, torch's CPU weight gradient of the 1x1 stride-2 conv
    sometimes hangs or crashes; float64 takes another CPU kernel.)"""
    from uresnet_tpu_torch.ops.conv import conv_general

    x, w, g = (torch.from_numpy(a.astype(np.float64))
               for a in _conv_inputs(name))
    _, _, stride, kind, _ = CONVS[name]
    xt, wt = x.requires_grad_(), w.requires_grad_()
    y = conv_general(xt, wt, stride=stride, compute_dtype=torch.float64,
                     kind=kind)
    dx, dw = torch.autograd.grad((y * g).sum(), [xt, wt])
    return y.detach().numpy(), dx.numpy(), dw.numpy()


def _jax(name):
    """The JAX package on the same global input: its sharded conv on its
    virtual CPU mesh (a transposed conv has no sharded form there: its
    unsharded one)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uresnet_tpu.ops.conv import conv_transpose
    from uresnet_tpu.parallel.halo import sharded_conv
    from uresnet_tpu.parallel.mesh import make_mesh

    x, w, _ = _conv_inputs(name)
    xs, _, stride, kind, (nd, ns) = CONVS[name]
    dims = len(xs) - 2
    if kind == "convt":
        return np.asarray(conv_transpose(jnp.asarray(x), {"w": jnp.asarray(w)},
                                         stride=stride, dims=dims,
                                         compute_dtype=jnp.float32))
    mesh = make_mesh(nd, ns)
    xj = jnp.asarray(x)
    if nd > 1:
        import jax

        xj = jax.device_put(xj, NamedSharding(mesh, P("data", "spatial")))
    return np.asarray(sharded_conv(xj, jnp.asarray(w), mesh=mesh,
                                   stride=stride, dims=dims, spatial_dim=1,
                                   data_sharded=nd > 1))


@pytest.mark.parametrize("name", sorted(CONVS))
def test_sharded_conv_matches(ranks, name):
    """Each case's sharded output against the JAX package's and the
    unsharded conv; its input gradient (the shards') and weight gradient
    (summed over the ranks) against the unsharded conv's."""
    shape = CONVS[name][-1]
    y, dx, dw = _unsharded(name)
    got = _gathered(ranks, name, shape, "y")
    _close(got, _jax(name), f"{name}: vs JAX")
    _close(got, y, f"{name}: vs unsharded")
    _close(_gathered(ranks, name, shape, "dx"), dx, f"{name}: dx")
    with np.load(os.path.join(ranks, f"{name}.0.npz")) as z:
        _close(z["dw"], dw, f"{name}: dw")


def test_halo_wider_than_shard_raises(ranks):
    """A receptive field beyond the immediate neighbour shard fails loudly
    on every rank (multi-hop halos are unsupported, not silently wrong)."""
    for r in range(WORLD):
        with open(os.path.join(ranks, f"halo_error.{r}.json")) as f:
            msg = json.load(f)
        assert "halo (4,4) exceeds the local shard extent 2" in msg, msg


def _jax_cfg(cfg, path):
    """The port's config as the JAX package's (through its JSON form)."""
    from uresnet_tpu.config import load_config

    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    return load_config(path)


def _jax_step(cfg, ckpt):
    """The JAX package's one-device loss, gradients and new BN state from
    the checkpoint's state, on the global batch."""
    import jax

    from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
    from uresnet_tpu.parallel.mesh import make_mesh

    tr = JaxTrainer(_jax_cfg(cfg, ckpt + ".json"), mesh=make_mesh(1))
    ts, _, _ = tr.restore(path=ckpt)
    (loss, (_, state)), grads = jax.jit(
        lambda p, s, b: jax.value_and_grad(tr._loss_fn, has_aux=True)(
            p, s, b, True))(ts.params, ts.model_state,
                            tr._device_batch(_host_batch(cfg)))
    return float(loss), jax.device_get(grads), jax.device_get(state)


@pytest.mark.parametrize("dims", [2, 3])
def test_spatial_dp_equals_single_device(ranks, tmp_path, dims):
    """(data 2, spatial 2): H (2D) or D (3D) over 'spatial', batch over
    'data'; the step's loss, gradients and BN state equal the JAX
    package's one-device step and the port's one process."""
    _check_spatial_step(ranks, tmp_path, dims, f"sp{dims}d", False)


@pytest.mark.parametrize("dims", [2, 3])
def test_spatial_dp_packed_equals_single_device(ranks, tmp_path, dims):
    """The same with the packed layout (``PACKED``; 2D also with the
    packed loss): the packed convs' halos are their explicit pads on the
    shards' packed rows, the relayouts local; the step equals the JAX
    package's one-device packed step and the port's one process."""
    _check_spatial_step(ranks, tmp_path, dims, f"sp{dims}d_packed", True)


def _check_spatial_step(ranks, tmp_path, dims, name, packed):
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.models.convert import flatten_tree

    cfg = _cfg(dims, str(tmp_path), name, packed=packed)
    one = Trainer(cfg, device="cpu")
    ts = one.init_state()
    want = _step_grads(one, ts, _host_batch(cfg))
    ckpt = one.save(ts, 0)
    jloss, jgrads, jstate = _jax_step(cfg, ckpt)
    shards = []
    for r in range(WORLD):
        with np.load(os.path.join(ranks, f"{name}.{r}.npz")) as z:
            shards.append({k: z[k] for k in z.files})
    for r in range(1, WORLD):  # the reduced values are the same everywhere
        for k, v in shards[0].items():
            np.testing.assert_array_equal(shards[r][k], v, err_msg=k)
    got = shards[0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["loss"][0], jloss, rtol=1e-4)
    jax_flat = {**{f"grad.{k}": v for k, v in flatten_tree(jgrads).items()},
                **{f"state.{k}": v for k, v in flatten_tree(jstate).items()}}
    assert set(jax_flat) == set(got) - {"loss"}
    for k, v in jax_flat.items():
        tol = (dict(rtol=1e-2, atol=2e-3) if k.startswith("grad.")
               else dict(rtol=1e-4, atol=1e-6))
        np.testing.assert_allclose(got[k], v, err_msg=f"vs JAX: {k}", **tol)
        np.testing.assert_allclose(got[k], want[k],
                                   err_msg=f"vs one process: {k}", **tol)


def test_cli_train_distributed_sp(ranks):
    """cli.train --distributed with parallel.spatial 2 runs the whole (data
    2, spatial 2) mesh: every rank reports its place, rank 0 alone writes,
    and the exactly-once validation counts every event once."""
    for rank in range(WORLD):
        with open(os.path.join(ranks, f"log.{rank}.txt")) as f:
            log = f.read()
        assert (f"device: cpu rank: {rank} world: 4 mesh (data, spatial, "
                f"model): 2x2x1") in log, log
    d = os.path.join(ranks, "cli", "sp")
    assert sorted(os.listdir(os.path.join(d, "ckpt"))) == [
        "LATEST", "step_00000002.npz"]
    with open(os.path.join(d, "log", "val_metrics.jsonl")) as f:
        (val,) = [json.loads(line) for line in f]
    assert val["n_events"] == N_CLI and val["n_pixels"] == N_CLI * 32 * 32
    with open(os.path.join(d, "log", "train_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    raise SystemExit(_worker(*sys.argv[1:3]))
