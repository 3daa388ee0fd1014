"""The port's tensor parallelism and mesh in four real processes on the
CPU (gloo), against the JAX package and against one process.

Mirrors tests/test_tp.py on its configs. The module launches four
``--device cpu`` ranks once (the worker is this file's own ``__main__``):

  * ``conv_col`` -> ReLU -> ``conv_row`` at model 4 (parallel/tp.py)
    against the JAX package's pair and the unsharded pair (1e-5), and the
    pair's input and weight gradients against the unsharded pair's;
  * the (data, spatial, model) layout of every 4-rank mesh, and the mesh
    error for a product other than the world;
  * full-model TP at (data 2, model 2): storage genuinely sharded (the stem
    kernel holds Cout/2, BN vectors and Adam moments C/2, the num_class
    head whole); one step's loss (rtol 1e-4) and per-leaf gradients (rtol
    1e-2 / atol 5e-3) against the JAX package's TP trainer and the port's
    one process from the same state (carried across in the shared
    checkpoint layout); 2 steps at loss rtol 5e-4; an eval step; save,
    restore bit-exact, and the TP-written file restored into one process
    bit-exact; the 3D TP step's loss; ``evaluate_dataset`` and
    ``run_inference`` equal to one process;
  * the refusals: a spatial x model mesh and TP with ``model.pack``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = [(4, 1, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2), (1, 1, 4)]
N_EVAL = 6
# cli.train --distributed at (data 2, model 2): 2 steps, a checkpoint and
# one exactly-once validation
CLI_ARGS = ["train.iterations=2", "train.summary_iter=1",
            "train.checkpoint_iter=2", "train.val_iter=2",
            "train.val_exact=true"]


def _pair_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 4, 8)) * .2).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 8, 4)) * .2).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return x, w1, w2, g


def _cfg(outdir, name, dims=2, model=2, **model_kw):
    """tests/test_tp.py's tiny configs: 2D base 4 depth 2 at 32^2, batch 4;
    3D at 16^3, batch 2; f32, Adam eps 1e-3."""
    from uresnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          OptimConfig, ParallelConfig,
                                          TrainConfig)

    model_kw.setdefault("pack", False)
    return Config(
        model=ModelConfig(dims=dims, num_class=3, base_filters=4, depth=2,
                          compute_dtype="float32", **model_kw),
        data=DataConfig(image_size=32 if dims == 2 else 16,
                        batch_size=4 if dims == 2 else 2, planes=(0,),
                        synthetic=True, augment=False),
        train=TrainConfig(seed=0, checkpoint_dir=os.path.join(
            outdir, name, "ckpt"), log_dir=os.path.join(outdir, name, "log")),
        optim=OptimConfig(eps=1e-3),
        parallel=ParallelConfig(data=2 if model > 1 else 1, model=model))


def _eval_cfg(outdir, usef, model=2):
    """tests/test_tp.py::test_tp_evaluator_paths' config."""
    import dataclasses

    cfg = _cfg(outdir, "eval", model=model)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, input_files=(usef,), synthetic=False, random_access=False))


def _host_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.data.batch_size,) + (cfg.data.image_size,) * cfg.model.dims
    return {"data": rng.random(shape + (1,), np.float32),
            "label": rng.integers(0, 3, shape).astype(np.int64),
            "weight": np.ones(shape, np.float32)}


def _rows(tr, batch):
    """This rank's data index's rows of a global host batch, as tensors."""
    d, n = tr.mesh.index[0], tr.mesh.data
    rows = batch["data"].shape[0] // n
    return {k: torch.from_numpy(v[d * rows:(d + 1) * rows])
            for k, v in batch.items()}


def _step_grads(tr, ts, batch):
    """Loss and whole per-leaf gradients of one step on the global batch,
    reduced as Trainer._train_step reduces them."""
    from uresnet_tpu_torch.parallel import tp
    from uresnet_tpu_torch.parallel.mesh import all_reduce_mean

    m = tr.mesh
    params = dict(ts.model.named_parameters())
    with torch.enable_grad():
        loss, _, _ = tr._loss_fn(ts.model, _rows(tr, batch))
        grads = list(torch.autograd.grad(loss, list(params.values())))
    loss = loss.detach().reshape(1).clone()
    if m.batch.group is not None:
        all_reduce_mean([*grads, loss], m.batch.group)
    whole = tp.gather_state(dict(zip(params, grads)), tr._tp_dims,
                            m.model_axis)
    return {"loss": loss.numpy(),
            **{f"grad.{k}": v.numpy() for k, v in whole.items()}}


def _whole_params(tr, ts):
    return {k: v.detach().numpy().copy() for k, v in
            tr.gather_state(ts).model.named_parameters()}


# -- the worker (one rank) ------------------------------------------------------


def _worker(outdir, usef):
    import torch.distributed as dist

    from uresnet_tpu_torch.engine.evaluator import (evaluate_dataset,
                                                    run_inference)
    from uresnet_tpu_torch.cli import train as cli_train
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.parallel import mesh
    from uresnet_tpu_torch.parallel.tp import conv_col, conv_row, local_slice

    mesh.init_distributed("cpu")
    rank = dist.get_rank()
    out = {}

    def save(name, **arrays):
        np.savez(os.path.join(outdir, f"{name}.{rank}.npz"), **arrays)

    # the explicit pair at model 4
    m = mesh.make_mesh(1, 1, 4)
    x, w1, w2, g = _pair_inputs()
    xt = torch.tensor(x, requires_grad=True)
    w1t = torch.tensor(local_slice(w1, 3, m.model_axis), requires_grad=True)
    w2t = torch.tensor(local_slice(w2, 2, m.model_axis), requires_grad=True)
    h = torch.relu(conv_col(xt, w1t, m.model_axis))
    y = conv_row(h, w2t, m.model_axis)
    dx, dw1, dw2 = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                       [xt, w1t, w2t])
    save("pair", y=y.detach().numpy(), dx=dx.numpy(), dw1=dw1.numpy(),
         dw2=dw2.numpy())

    # the layout of every mesh of 4
    out["meshes"] = []
    for shape in MESHES:
        m = mesh.make_mesh(*shape)
        out["meshes"].append({
            "index": m.index, "data": m.data, "spatial": m.spatial,
            "model": m.model, **{name: [ax.size, ax.index] for name, ax in (
                ("batch", m.batch), ("data_axis", m.data_axis),
                ("spatial_axis", m.spatial_axis),
                ("model_axis", m.model_axis))}})
    try:
        mesh.make_mesh(3, 1, 1)
    except ValueError as e:
        out["mesh_error"] = str(e)

    # full-model TP at (data 2, model 2)
    cfg = _cfg(outdir, "tp")
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    out["shapes"] = {
        "stem.conv.w": ts.model.stem.conv.w.shape,
        "stem.bn.scale": ts.model.stem.bn.scale.shape,
        "stem.bn.mean": ts.model.stem.bn.mean.shape,
        "mu.stem.conv.w": ts.opt.mu["stem.conv.w"].shape,
        "nu.enc1_b0.cb2.bn.bias": ts.opt.nu["enc1_b0.cb2.bn.bias"].shape,
        "head.w": ts.model.head.w.shape, "head.b": ts.model.head.b.shape}
    save("tp_grads", **_step_grads(tr, ts, _host_batch(cfg)))
    out["losses"] = []
    for step in range(2):
        ts, metrics = tr.train_step(ts, _rows(tr, _host_batch(cfg, step)))
        out["losses"].append(float(metrics["loss"]))
    out["shapes"]["stem.conv.w after"] = ts.model.stem.conv.w.shape
    out["eval_loss"] = float(tr.eval_step(ts, _rows(tr, _host_batch(cfg, 9)))[
        "loss"])
    before = _whole_params(tr, ts)
    if rank == 0:
        save("tp_params", **before)
    out["ckpt"] = tr.save(ts, step=2)
    dist.barrier()  # rank 0's file is written
    ts_r, out["restored_step"], _ = tr.restore()
    out["restore_sliced"] = tuple(ts_r.model.stem.conv.w.shape)
    after = _whole_params(tr, ts_r)
    out["restore_exact"] = all(np.array_equal(before[k], after[k])
                               for k in before)

    # 3D
    cfg3 = _cfg(outdir, "tp3d", dims=3)
    tr3 = Trainer(cfg3, device="cpu")
    ts3 = tr3.init_state()
    out["shapes"]["3d stem.conv.w"] = ts3.model.stem.conv.w.shape
    _, m3 = tr3.train_step(ts3, _rows(tr3, _host_batch(cfg3, 7)))
    out["loss3d"] = float(m3["loss"])

    # evaluation on the gathered state, the file over the whole world
    tre = Trainer(_eval_cfg(outdir, usef), device="cpu")
    tse = tre.init_state()
    out["evaluate"] = evaluate_dataset(tre, tse)
    out["inference"] = run_inference(
        tre, tse, usef, os.path.join(outdir, f"scores.{rank}.npz"))

    # the refusals, on real meshes of 4
    for name, shape, kw in (("spatial_x_model", (1, 2, 2), {}),
                            ("pack", (2, 1, 2), {"pack": True})):
        try:
            Trainer(_cfg(outdir, name, **kw), device="cpu",
                    mesh=mesh.make_mesh(*shape))
        except ValueError as e:
            out[f"refused_{name}"] = str(e)
    # last: the CLI joins the live group and shuts it down at its end
    with open(os.path.join(outdir, f"out.{rank}.json"), "w") as f:
        json.dump(out, f)
    cli_cfg = os.path.join(outdir, f"cli.{rank}.json")
    with open(cli_cfg, "w") as f:
        json.dump(_eval_cfg(os.path.join(outdir, "cli"), usef).to_dict(), f)
    return cli_train.main([cli_cfg, *CLI_ARGS, "--device", "cpu",
                           "--distributed"])


# -- the tests ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from uresnet_tpu_torch.data.synthetic import generate_file
    from uresnet_tpu_torch.parallel.mesh import launch_local

    outdir = str(tmp_path_factory.mktemp("tp"))
    usef = generate_file(os.path.join(outdir, "tp_ana.usef"), N_EVAL, seed=5,
                         shape=(64, 64), planes=(0,))
    res = launch_local([sys.executable, os.path.abspath(__file__), outdir,
                        usef], WORLD, env=dict(os.environ, OMP_NUM_THREADS="1"),
                       cwd=ROOT, timeout=300)
    for rank, (rc, log) in enumerate(res):
        assert rc == 0, f"rank {rank} failed:\n{log}"
    outs = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"out.{r}.json")) as f:
            outs.append(json.load(f))
    return {"dir": outdir, "usef": usef, "out": outs,
            "logs": [log for _, log in res]}


def _npz(ranks, name, rank=0):
    with np.load(os.path.join(ranks["dir"], f"{name}.{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def test_col_row_pair_matches_unsharded(ranks):
    """conv_col -> ReLU -> conv_row over 4 model ranks equals the JAX
    package's pair and the unsharded pair; the input gradient (whole on
    every rank) and each rank's weight-gradient slices equal the unsharded
    pair's."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from uresnet_tpu.parallel.mesh import make_mesh
    from uresnet_tpu.parallel.tp import conv_col as jcol, conv_row as jrow

    from uresnet_tpu_torch.ops.conv import conv

    x, w1, w2, g = _pair_inputs()
    hi = lax.Precision.HIGHEST
    jmesh = make_mesh(n_data=1, n_spatial=1, n_model=4)
    jax_y = np.asarray(jrow(jax.nn.relu(jcol(jnp.asarray(x), jnp.asarray(w1),
                                             mesh=jmesh, precision=hi)),
                            jnp.asarray(w2), mesh=jmesh, precision=hi))
    t = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
         for a in (x, w1, w2)]
    f64 = dict(compute_dtype=torch.float64)
    y = conv(torch.relu(conv(t[0], {"w": t[1]}, **f64)), {"w": t[2]}, **f64)
    dx, dw1, dw2 = (a.numpy() for a in torch.autograd.grad(
        (y * torch.from_numpy(g.astype(np.float64))).sum(), t))
    y = y.detach().numpy()
    for r in range(WORLD):
        got = _npz(ranks, "pair", r)
        for k, a, b in (("y", got["y"], y), ("y vs JAX", got["y"], jax_y),
                        ("dx", got["dx"], dx),
                        ("dw1", got["dw1"], dw1[..., 2 * r:2 * r + 2]),
                        ("dw2", got["dw2"], dw2[:, :, 2 * r:2 * r + 2])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r}: {k}")


def test_mesh_three_axes(ranks):
    """Row-major (data, spatial, model) layout, as JAX's device grid: the
    rank at (d, s, m) is (d * spatial + s) * model + m; each axis group
    runs through the rank along one axis, the batch group over data x
    spatial; a product other than the world raises the JAX mesh error."""
    for r, out in enumerate(ranks["out"]):
        for shape, got in zip(MESHES, out["meshes"]):
            nd, ns, nm = shape
            d, s, m = r // (ns * nm), r // nm % ns, r % nm
            assert got["index"] == [d, s, m], (shape, got)
            assert [got["data"], got["spatial"], got["model"]] == list(shape)
            assert got["data_axis"] == [nd, d]
            assert got["spatial_axis"] == [ns, s]
            assert got["model_axis"] == [nm, m]
            assert got["batch"] == [nd * ns, d * ns + s]
        assert out["mesh_error"].startswith("mesh 3x1x1 needs 3 devices, "
                                            "have 4")


def test_full_model_tp_storage_is_sharded(ranks):
    """Kernels on Cout, BN vectors and running stats on C, Adam moments
    mirroring the params, the num_class head (Cout 3) whole; still so
    after the optimizer steps and after a restore."""
    for out in ranks["out"]:
        sh = out["shapes"]
        assert sh["stem.conv.w"] == [3, 3, 1, 2]
        assert sh["stem.bn.scale"] == sh["stem.bn.mean"] == [2]
        assert sh["mu.stem.conv.w"] == [3, 3, 1, 2]
        assert sh["nu.enc1_b0.cb2.bn.bias"] == [4]
        assert sh["head.w"] == [3, 3, 4, 3] and sh["head.b"] == [3]
        assert sh["stem.conv.w after"] == [3, 3, 1, 2]
        assert sh["3d stem.conv.w"] == [3, 3, 3, 1, 2]
        assert out["restore_sliced"] == [3, 3, 1, 2]


def _jax_cfg(cfg, path):
    from uresnet_tpu.config import load_config

    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    return load_config(path)


def test_full_model_tp_train_equals_single_device(ranks, tmp_path):
    """One step's loss and per-leaf gradients at (data 2, model 2) against
    the JAX package's TP trainer and the port's one process from the same
    state; the two steps' losses against one process. (The TP re-blocks
    every conv's Cin sum: JAX measured 2.6e-3 gradient shifts; a missing
    reduction is O(1).)"""
    import jax

    from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
    from uresnet_tpu.parallel.mesh import make_mesh

    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.models.convert import flatten_tree

    cfg = _cfg(str(tmp_path), "one", model=1)
    one = Trainer(cfg, device="cpu")
    ts = one.init_state()
    want = _step_grads(one, ts, _host_batch(cfg))
    ckpt = one.save(ts, 0)
    jtr = JaxTrainer(_jax_cfg(_cfg(str(tmp_path), "jax"), ckpt + ".json"),
                     mesh=make_mesh(n_data=2, n_spatial=1, n_model=2))
    jts, _, _ = jtr.restore(path=ckpt)
    (jloss, _), jgrads = jax.jit(
        lambda p, s, b: jax.value_and_grad(jtr._loss_fn, has_aux=True)(
            p, s, b, True), out_shardings=jtr._rep)(
        jts.params, jts.model_state, jtr._device_batch(_host_batch(cfg)))
    jflat = {f"grad.{k}": v for k, v in flatten_tree(
        jax.device_get(jgrads)).items()}
    grads = [_npz(ranks, "tp_grads", r) for r in range(WORLD)]
    for r in range(1, WORLD):
        for k, v in grads[0].items():
            np.testing.assert_array_equal(grads[r][k], v, err_msg=k)
    got = grads[0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["loss"][0], float(jloss), rtol=1e-4)
    assert set(jflat) == set(got) - {"loss"}
    for k, v in jflat.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-2, atol=5e-3,
                                   err_msg=f"vs JAX TP: {k}")
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, atol=5e-3,
                                   err_msg=f"vs one process: {k}")
    for step in range(2):
        ts, m = one.train_step(ts, one.device_batch(_host_batch(cfg, step)))
        for out in ranks["out"]:
            np.testing.assert_allclose(out["losses"][step], float(m["loss"]),
                                       rtol=5e-4)
    for out in ranks["out"]:
        assert np.isfinite(out["eval_loss"])


def test_tp_checkpoint_restores_bit_exact(ranks, tmp_path):
    """save gathers the slices and rank 0 writes; restore re-slices them
    bit-exactly on every rank; the TP-written file restores bit-exactly
    into a one-process trainer."""
    from uresnet_tpu_torch.engine.trainer import Trainer

    for out in ranks["out"]:
        assert out["restored_step"] == 2 and out["restore_exact"]
    path = ranks["out"][0]["ckpt"]
    assert os.path.exists(path)
    one = Trainer(_cfg(str(tmp_path), "one", model=1), device="cpu")
    ts, step, _ = one.restore(path=path)
    assert step == 2
    want = _npz(ranks, "tp_params")
    for k, v in ts.model.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), want[k], err_msg=k)


def test_full_model_tp_3d_loss_matches(ranks, tmp_path):
    """3D (NDHWC) under full-model TP: the same sharding rule, the same
    loss as one process."""
    from uresnet_tpu_torch.engine.trainer import Trainer

    cfg = _cfg(str(tmp_path), "one3d", dims=3, model=1)
    one = Trainer(cfg, device="cpu")
    _, m = one.train_step(one.init_state(),
                          one.device_batch(_host_batch(cfg, 7)))
    for out in ranks["out"]:
        np.testing.assert_allclose(out["loss3d"], float(m["loss"]), rtol=5e-4)


def test_tp_evaluator_paths(ranks, tmp_path):
    """evaluate_dataset (exactly once, on the gathered state, the file over
    the whole world) and run_inference (the whole file on each rank)
    under (data 2, model 2) equal one process."""
    from uresnet_tpu_torch.engine.evaluator import (evaluate_dataset,
                                                    run_inference)
    from uresnet_tpu_torch.engine.trainer import Trainer

    one = Trainer(_eval_cfg(str(tmp_path), ranks["usef"], model=1),
                  device="cpu")
    ts = one.init_state()
    want = evaluate_dataset(one, ts)
    inf = run_inference(one, ts, ranks["usef"], str(tmp_path / "one.npz"))
    assert want["n_events"] == N_EVAL
    with np.load(str(tmp_path / "one.npz")) as z:
        scores = z["scores"]
    for r, out in enumerate(ranks["out"]):
        got = out["evaluate"]
        assert got.keys() == want.keys()
        for k in ("n_events", "n_pixels", "n_nonzero"):
            assert got[k] == want[k], k
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=k)
        for k, v in inf.items():
            np.testing.assert_allclose(out["inference"][k], v, rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        with np.load(os.path.join(ranks["dir"], f"scores.{r}.npz")) as z:
            np.testing.assert_allclose(z["scores"], scores, rtol=1e-5,
                                       atol=1e-6)


def test_spatial_x_model_and_pack_are_refused(ranks):
    """On real meshes: spatial x model is refused as the JAX trainer
    refuses it (kept for parity), and TP needs the canonical layout."""
    for out in ranks["out"]:
        assert "cannot be combined" in out["refused_spatial_x_model"]
        assert "requires the canonical layout" in out["refused_pack"]


def test_cli_train_distributed_tp(ranks, tmp_path):
    """cli.train --distributed with parallel.model 2 runs the whole (data
    2, model 2) mesh: every rank reports its place, rank 0 alone writes
    the logs and the checkpoint, the validation counts every event once,
    and the checkpoint restores in one process."""
    from uresnet_tpu_torch.engine.trainer import Trainer

    for rank, log in enumerate(ranks["logs"]):
        assert (f"device: cpu rank: {rank} world: 4 mesh (data, spatial, "
                f"model): 2x1x2") in log, log
    d = os.path.join(ranks["dir"], "cli", "eval")
    assert sorted(os.listdir(os.path.join(d, "ckpt"))) == [
        "LATEST", "step_00000002.npz"]
    with open(os.path.join(d, "log", "val_metrics.jsonl")) as f:
        (val,) = [json.loads(line) for line in f]
    assert val["n_events"] == N_EVAL and val["n_pixels"] == N_EVAL * 32 * 32
    with open(os.path.join(d, "log", "train_metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    one = Trainer(_eval_cfg(str(tmp_path), ranks["usef"], model=1),
                  device="cpu")
    _, step, _ = one.restore(os.path.join(d, "ckpt", "step_00000002.npz"))
    assert step == 2


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    raise SystemExit(_worker(*sys.argv[1:3]))
