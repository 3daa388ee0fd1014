"""The port's data parallelism in two real processes on the CPU (gloo),
against one process and against the JAX package.

Mirrors tests/test_distributed.py on its config (tests/_dist_common.py:
base 4, depth 2, f32, 64^2, batch 8, 16 events in one USEF file, 4
iterations). The module spawns two ``--device cpu`` ranks once, in the
torchrun environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); the worker is this file's own ``__main__``. Each rank runs
``Trainer.fit`` (augment off, augment on, ``weight_sum`` loss), the exact
and the sampled ``evaluate_dataset``, a global-batch ``batch_norm_train``
forward and backward, and last ``cli.train --distributed``. A second launch
trains until rank 1 alone gets SIGTERM.

Train states are compared as test_torch_train_engine.py's three-step
parity is (params and BN state at 1e-4 of max(|leaf|, 1), Adam moments at
1e-4 of their largest element), on its dense clouds at 16^2 (ROADMAP.md
§3), after one step. A DP step sums its gradients and BN moments in
another order than one process; Adam's first step is lr * g / |g|, so an
element whose gradient is near zero moves by +-lr on either side of that
noise, and the later steps carry it on. One step's gradients of the DP and
the one-process run agree with a float64 run to 4e-7 of the largest, yet
after three steps the two states differ by 1.3e-3. So the 4-step runs of
tests/_dist_common.py's config are compared as tests/test_distributed.py
compares them: the logged loss and metrics (rtol 1e-5), replicas
bit-equal, evaluation counts exact (integers). The BN forward and backward
are compared at 1e-5 (f32).
"""

import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
BN_SHAPE = (16, 8, 8, 6)  # the global batch of the BN check, 8 rows a rank
PHASES = 2  # its packed form: 2 phases of 3 channels
SIGTERM_ITERS = 100000


def _port_cfg(path, overrides=()):
    from uresnet_tpu_torch.config import load_config

    return load_config(path, list(overrides))


def _variant(outdir, name, extra=()):
    """Overrides that put a run's checkpoints and logs under outdir/name."""
    return [f"train.checkpoint_dir={os.path.join(outdir, name, 'ckpt')}",
            f"train.log_dir={os.path.join(outdir, name, 'log')}", *extra]


# 'weight_sum' with nonzero-boost weights: under class-balance weights
# every row's weights sum to its pixel count, where 'weight_sum' is 'mean'
# 'packed': the flagship's packed layout (resident H pack) with the packed
# loss, its targets scattered into the packed layout, and augment
VARIANTS = {"plain": (), "aug": ("data.augment=true",),
            "ws": ("train.loss_normalize=weight_sum",
                   "data.weight_mode=nonzero"),
            "packed": ("model.pack=true", "model.pack_extra_h=true",
                       "train.packed_loss=true", "data.augment=true")}
N_EVENTS, SIZE = 16, 64
PARITY_SIZE, PARITY_STEPS = 16, 1


def _dense_cloud_file(path):
    """16 events of 216 points on 60% of a 20x18 plane: the clouds of
    test_torch_train_engine.py's parity run (ROADMAP.md §3)."""
    from uresnet_tpu.data.events import SparseEvent, SparsePlane, write_events

    rng = np.random.default_rng(11)
    pix = np.stack(np.meshgrid(np.arange(20), np.arange(18), indexing="ij"),
                   -1).reshape(-1, 2)
    events = []
    for _ in range(N_EVENTS):
        c = pix[rng.permutation(len(pix))[:216]].astype(np.int32)
        events.append(SparseEvent([SparsePlane(
            0, (20, 18), c, rng.uniform(1, 500, len(c)).astype(np.float32),
            rng.integers(0, 3, len(c)).astype(np.uint8))]))
    write_events(path, events)
    return path


def _parity_config(usef, outdir):
    """tests/_dist_common.py's config on the dense clouds at 16^2."""
    import dataclasses

    from _dist_common import dist_config

    cfg = dist_config(usef, outdir)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, image_size=PARITY_SIZE, max_points=256))


def _state_leaves(ts) -> dict:
    from uresnet_tpu_torch.models.convert import flatten_tree, jax_train_state

    return {k: np.asarray(v) for k, v in flatten_tree(
        jax_train_state(ts.model, ts.opt, ts.key)).items()}


def _bn_inputs():
    g = np.random.default_rng(7)
    x = g.normal(1.0, 2.0, BN_SHAPE).astype(np.float32)
    r = g.normal(size=BN_SHAPE).astype(np.float32)
    params = {"scale": g.uniform(0.5, 1.5, BN_SHAPE[-1]).astype(np.float32),
              "bias": g.normal(size=BN_SHAPE[-1]).astype(np.float32)}
    state = {"mean": g.normal(size=BN_SHAPE[-1]).astype(np.float32),
             "var": g.uniform(0.5, 2.0, BN_SHAPE[-1]).astype(np.float32)}
    return x, r, params, state


def _bn_run(x, r, params, state, group=None, phases=1):
    """y, new state and the gradients of sum(y * r) w.r.t. x, scale, bias;
    ``phases``: x packed, (..., phases * C) for the (C,) params. Also the
    all-reduces the forward and the backward issued."""
    import torch.distributed as dist

    from uresnet_tpu_torch.ops.norm import batch_norm_train

    C = x.shape[-1] // phases
    params = {k: v[:C] for k, v in params.items()}
    state = {k: v[:C] for k, v in state.items()}
    xt = torch.tensor(x, requires_grad=True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    calls = []
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls.append(1)
        return all_reduce(*a, **kw)

    dist.all_reduce = counted
    try:
        y, new = batch_norm_train(xt, pt, {k: torch.tensor(v) for k, v in
                                           state.items()}, group=group,
                                  phases=phases)
        n_forward = len(calls)
        gx, gs, gb = torch.autograd.grad((y * torch.tensor(r)).sum(),
                                         [xt, pt["scale"], pt["bias"]])
    finally:
        dist.all_reduce = all_reduce
    return {"y": y.detach().numpy(), "mean": new["mean"].numpy(),
            "var": new["var"].numpy(), "dx": gx.numpy(), "dscale": gs.numpy(),
            "dbias": gb.numpy(), "allreduce_forward": n_forward,
            "allreduce_backward": len(calls) - n_forward}


# -- the worker (one rank) ------------------------------------------------------


def _worker(mode, cfg_path, parity_path, outdir):
    import torch.distributed as dist

    from uresnet_tpu_torch.cli import train as cli_train
    from uresnet_tpu_torch.engine.evaluator import evaluate_dataset
    from uresnet_tpu_torch.engine.trainer import Trainer
    from uresnet_tpu_torch.parallel import mesh

    mesh.init_distributed("cpu")
    rank = dist.get_rank()
    out = {"rank": rank, "pid": os.getpid()}
    if mode == "sigterm":
        cfg = _port_cfg(cfg_path, _variant(outdir, "sigterm", (
            "train.preempt_save=true", "train.summary_iter=1",
            "train.checkpoint_iter=0", f"train.iterations={SIGTERM_ITERS}")))
        _, last = Trainer(cfg, device="cpu").fit(log=False)
        out["last"] = last
    else:
        for name, extra in VARIANTS.items():
            tr = Trainer(_port_cfg(parity_path, _variant(outdir, name, extra)),
                         device="cpu")
            ts, last = tr.fit(log=False, iterations=PARITY_STEPS)
            out[name] = {"last": last}
            np.savez(os.path.join(outdir, f"{name}_state{rank}.npz"),
                     **_state_leaves(ts))
        tr = Trainer(_port_cfg(cfg_path, _variant(outdir, "fit")),
                     device="cpu")
        ts, out["last"] = tr.fit(log=False)
        np.savez(os.path.join(outdir, f"fit_state{rank}.npz"),
                 **_state_leaves(ts))
        out["eval"] = evaluate_dataset(tr, ts)
        out["eval_sampled"] = evaluate_dataset(tr, ts, num_batches=2)
        try:  # 3 rows over 2 ranks
            Trainer(_port_cfg(cfg_path, ["data.batch_size=3"]), device="cpu")
        except ValueError as e:
            out["batch_error"] = str(e)
        x, r, params, state = _bn_inputs()
        half = slice(rank * BN_SHAPE[0] // 2, (rank + 1) * BN_SHAPE[0] // 2)
        for name, phases in (("bn", 1), ("bnp", PHASES)):
            np.savez(os.path.join(outdir, f"{name}{rank}.npz"),
                     **_bn_run(x[half], r[half], params, state,
                               group=dist.group.WORLD, phases=phases))
        # last: the CLI joins the live group and shuts it down at its end
        cli_cfg = _variant(outdir, "cli", ("train.iterations=2",
                                            "train.checkpoint_iter=0"))
        out["cli_rc"] = cli_train.main([cfg_path, *cli_cfg, "--device", "cpu",
                                        "--distributed"])
    with open(os.path.join(outdir, f"{mode}{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.shutdown()
    return 0


# -- the tests ------------------------------------------------------------------


def _spawn(mode, dist_run):
    from uresnet_tpu_torch.parallel.mesh import start_local

    return start_local(
        [sys.executable, os.path.abspath(__file__), mode, dist_run["cfg"],
         dist_run["parity"], dist_run["outdir"]], 2,
        env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT)


def _join(procs, timeout=300):
    from uresnet_tpu_torch.parallel.mesh import join_local

    res = join_local(procs, timeout)
    for rank, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {rank} failed:\n{out}"
    return [out for _, out in res]


def _load(outdir, mode):
    res = []
    for rank in (0, 1):
        with open(os.path.join(outdir, f"{mode}{rank}.json")) as f:
            res.append(json.load(f))
    return res


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    from uresnet_tpu.data.synthetic import generate_file

    from _dist_common import dist_config

    tmp = tmp_path_factory.mktemp("tdist")
    run = {"tmp": tmp, "outdir": str(tmp / "out"),
           "cfg": str(tmp / "cfg.json"), "parity": str(tmp / "parity.json"),
           "usef": generate_file(str(tmp / "events.usef"), N_EVENTS, seed=11,
                                 shape=(SIZE, SIZE), planes=(0,)),
           "parity_usef": _dense_cloud_file(str(tmp / "dense.usef"))}
    os.makedirs(run["outdir"])
    for key, cfg in (("cfg", dist_config(run["usef"], run["outdir"])),
                     ("parity", _parity_config(run["parity_usef"],
                                               run["outdir"]))):
        with open(run[key], "w") as f:
            json.dump(cfg.to_dict(), f)
    run["stdout"] = _join(_spawn("main", run))
    run["results"] = _load(run["outdir"], "main")
    return run


def _one_process(dist_run, name):
    """The same run in this process, no process group: a parity variant
    steps on the rank-major concatenation of the two shards' batches (the
    global batch of the DP run); the 4-step fit reads the file in order."""
    from uresnet_tpu_torch.data.loader import BatchLoader
    from uresnet_tpu_torch.engine.trainer import Trainer

    if name not in VARIANTS:
        tr = Trainer(_port_cfg(dist_run["cfg"], _variant(
            str(dist_run["tmp"] / "ref"), name)), device="cpu")
        return tr, *tr.fit(log=False)
    cfg = _port_cfg(dist_run["parity"], _variant(
        str(dist_run["tmp"] / "ref"), name, VARIANTS[name]))
    tr = Trainer(cfg, device="cpu")
    ts = tr.init_state()
    shards = [BatchLoader(cfg.data, num_class=3, ndims=2, shard=(r, 2))
              for r in (0, 1)]
    for _ in range(PARITY_STEPS):
        b0, b1 = (s._make_batch() for s in shards)
        b0.pop("cursor"), b1.pop("cursor")
        ts, m = tr.train_step(ts, tr.device_batch(
            {k: np.concatenate([b0[k], b1[k]]) for k in b0}))
    return tr, ts, {k: float(v) for k, v in m.items()}


def _assert_states_close(got, want, what):
    assert got.keys() == want.keys(), what
    moment_max = {kind: max(np.abs(v).max() for k, v in want.items()
                            if k.startswith(f"opt.{kind}."))
                  for kind in ("mu", "nu")}
    for k, v in want.items():
        kind = k.split(".")[1] if k.startswith("opt.") else None
        scale = moment_max.get(kind, max(np.abs(v).max(), 1.0))
        np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0,
                                   atol=TOL, err_msg=f"{what}: {k}")


def _rank_state(dist_run, name, rank=0):
    with np.load(os.path.join(dist_run["outdir"],
                              f"{name}_state{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def test_two_process_step_matches_one_process_and_jax(dist_run, tmp_path):
    """Rank 0's params, BN state and Adam moments after a DP step equal the
    one-process port step on the same global batch, and the JAX package's
    one-process Trainer.fit from the same initial state (the port's,
    carried across in the shared checkpoint layout); both ranks hold the
    same state."""
    import dataclasses

    import jax

    from uresnet_tpu.engine.trainer import Trainer as JaxTrainer
    from uresnet_tpu.parallel.mesh import make_mesh

    from uresnet_tpu_torch.models.convert import flatten_tree

    s0 = _rank_state(dist_run, "plain", 0)
    s1 = _rank_state(dist_run, "plain", 1)
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    tr, ts, _ = _one_process(dist_run, "plain")
    _assert_states_close(s0, _state_leaves(ts), "DP vs one process")

    init = tr.init_state()
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, checkpoint_dir=str(tmp_path / "init")))
    init_ckpt = tr.save(init, 0)
    jcfg = _parity_config(dist_run["parity_usef"], str(tmp_path / "jax"))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, load_file=init_ckpt))
    jts = jax.device_get(JaxTrainer(jcfg, mesh=make_mesh(1)).fit(
        iterations=PARITY_STEPS, log=False)[0])
    want = {k: np.asarray(v) for k, v in flatten_tree(
        {"params": jts.params, "model_state": jts.model_state,
         "opt": jts.opt._asdict()}).items()}
    _assert_states_close({k: v for k, v in s0.items() if k != "key"}, want,
                         "DP vs JAX")


def test_two_process_fit_matches_one_process(dist_run):
    """The 4-step DP fit: replicas bit-equal on both ranks, and its logged
    loss and metrics those of the one-process fit on the same events."""
    s0 = _rank_state(dist_run, "fit", 0)
    s1 = _rank_state(dist_run, "fit", 1)
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    _, _, last = _one_process(dist_run, "fit")
    r0, r1 = dist_run["results"]
    for k in ("loss", "acc_all", "acc_nonzero", "miou"):
        assert r0["last"][k] == r1["last"][k], k
        assert np.isclose(r0["last"][k], last[k], rtol=1e-5, atol=1e-7), (
            k, r0["last"], last)


def test_two_process_eval_is_replicated_and_exact(dist_run):
    """Both ranks report the same dataset-global evaluation, every event
    and pixel counted once; the sampled spot check is the same on both."""
    r0, r1 = dist_run["results"]
    assert r0["eval"] == r1["eval"]
    assert r0["eval"]["n_pixels"] == N_EVENTS * SIZE * SIZE
    assert r0["eval"]["n_events"] == N_EVENTS
    assert r0["eval_sampled"] == r1["eval_sampled"]
    assert all(np.isfinite(v) for v in r0["eval_sampled"].values())


def test_two_process_eval_counts_match_one_process(dist_run):
    """Rank 0's final checkpoint evaluated in one process: the confusion
    metrics equal the two-rank evaluation exactly; the loss (an f32 sum in
    another order) to 1e-5."""
    from uresnet_tpu_torch.engine.evaluator import evaluate_dataset
    from uresnet_tpu_torch.engine.trainer import Trainer

    tr = Trainer(_port_cfg(dist_run["cfg"], _variant(dist_run["outdir"],
                                                     "fit")), device="cpu")
    ts, step, _ = tr.restore()
    assert step == 4
    ev = evaluate_dataset(tr, ts)
    dist_ev = dist_run["results"][0]["eval"]
    assert ev.keys() == dist_ev.keys()
    for k, v in ev.items():
        if k == "loss":
            assert np.isclose(v, dist_ev[k], rtol=1e-5), (v, dist_ev[k])
        else:
            assert v == dist_ev[k], (k, v, dist_ev[k])


def test_two_process_leader_gated_writes(dist_run):
    """Only rank 0 writes: each logged step once, one checkpoint tree, and
    every TensorBoard file named with rank 0's pid."""
    r0, r1 = dist_run["results"]
    last_step = {"fit": 4, "cli": 2,
                 **{name: PARITY_STEPS for name in VARIANTS}}
    for name, last in last_step.items():
        d = os.path.join(dist_run["outdir"], name)
        with open(os.path.join(d, "log", "train_metrics.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f]
        assert steps == list(range(2, last + 1, 2)) or steps == [last], (
            name, steps)
        assert len(steps) == len(set(steps)), (name, steps)
        assert sorted(os.listdir(os.path.join(d, "ckpt"))) == [
            "LATEST", f"step_{last:08d}.npz"], name
        tb = [f for f in os.listdir(os.path.join(d, "log"))
              if f.startswith("events.out.tfevents")]
        assert tb and all(f.split(".")[-2] == str(r0["pid"]) for f in tb), tb
    assert str(r1["pid"]) not in " ".join(os.listdir(
        os.path.join(dist_run["outdir"], "fit", "log")))


def test_two_process_cli_train_distributed(dist_run):
    """cli.train --distributed in the live group: rank and world printed,
    exit 0 on both ranks, rank 0's final line only from rank 0's log."""
    for rank, (res, out) in enumerate(zip(dist_run["results"],
                                          dist_run["stdout"])):
        assert res["cli_rc"] == 0
        assert f"device: cpu rank: {rank} world: 2" in out, out


def test_two_process_augment_equals_rank_major_batch(dist_run):
    """With augment on, DP equals one process stepping on the rank-major
    concatenation of the two shards' batches: each rank applies its rows
    of decisions drawn for the global batch."""
    _, ts, _ = _one_process(dist_run, "aug")
    _assert_states_close(_rank_state(dist_run, "aug"), _state_leaves(ts),
                         "DP augment vs rank-major one process")
    # and the augmentation did something: the gradients differ
    plain = _rank_state(dist_run, "plain")
    aug = _rank_state(dist_run, "aug")
    assert not np.allclose(plain["opt.mu.stem.conv.w"],
                           aug["opt.mu.stem.conv.w"])


def test_two_process_weight_sum_loss(dist_run):
    """loss_normalize 'weight_sum' under DP: the denominator is the global
    batch's weight sum, so a step's state and loss equal one process's."""
    _, ts, last = _one_process(dist_run, "ws")
    _assert_states_close(_rank_state(dist_run, "ws"), _state_leaves(ts),
                         "DP weight_sum vs one process")
    got = dist_run["results"][0]["ws"]["last"]["loss"]
    assert np.isclose(got, last["loss"], rtol=1e-5), (got, last["loss"])


def test_two_process_batch_norm_train(dist_run):
    """A two-rank batch_norm_train, forward and backward, equals one
    process on the concatenated batch: each rank's y and dx are its rows,
    the running stats are equal on both ranks and to one process's, and
    the scale and bias gradients sum to one process's. Each rank issues
    one all-reduce forward and one backward."""
    _check_bn(dist_run, "bn", 1)


def test_two_process_packed_batch_norm_train(dist_run):
    """The same on a packed tensor (2 phases of 3 channels): the phases
    are summed into the per-channel sums before the one all-reduce, so the
    two ranks equal one process, and one process equals BN of the unpacked
    tensor."""
    _check_bn(dist_run, "bnp", PHASES)
    x, r, params, state = _bn_inputs()
    C = x.shape[-1] // PHASES
    unpacked = lambda a: a.reshape(a.shape[:-1] + (PHASES, C)).transpose(  # noqa: E731
        0, 1, 3, 2, 4).reshape(a.shape[0], a.shape[1], a.shape[2] * PHASES, C)
    want = _bn_run(unpacked(x), unpacked(r), params, state)
    got = _bn_run(x, r, params, state, phases=PHASES)
    for k in ("y", "dx"):
        np.testing.assert_allclose(unpacked(got[k]), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("mean", "var", "dscale", "dbias"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _check_bn(dist_run, name, phases):
    x, r, params, state = _bn_inputs()
    want = _bn_run(x, r, params, state, phases=phases)
    got = []
    for rank in (0, 1):
        with np.load(os.path.join(dist_run["outdir"], f"{name}{rank}.npz")) as z:
            got.append({k: z[k] for k in z.files})
    for k in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([got[0][k], got[1][k]]),
                                   want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_allclose(got[0][k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ("dscale", "dbias"):
        np.testing.assert_allclose(got[0][k] + got[1][k], want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # one SUM all-reduce of the statistics forward, one of their gradients
    # backward, on each rank; none in one process
    for g in got:
        assert (int(g["allreduce_forward"]), int(g["allreduce_backward"])) \
            == (1, 1)
    assert (want["allreduce_forward"], want["allreduce_backward"]) == (0, 0)


def test_two_process_packed_step_matches_one_process(dist_run):
    """A DP step of the packed layout with the packed loss (targets
    scattered into the packed layout, augment on): replicas bit-equal, and
    the state equals one process's on the rank-major batch."""
    s0 = _rank_state(dist_run, "packed", 0)
    s1 = _rank_state(dist_run, "packed", 1)
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    tr, ts, last = _one_process(dist_run, "packed")
    assert tr._loss_phases == 8
    _assert_states_close(s0, _state_leaves(ts), "packed DP vs one process")
    got = dist_run["results"][0]["packed"]["last"]["loss"]
    assert np.isclose(got, last["loss"], rtol=1e-5), (got, last["loss"])


def test_two_process_batch_divisibility_error(dist_run):
    """A global batch the world does not divide raises the JAX trainer's
    error on every rank."""
    for res in dist_run["results"]:
        assert "must be divisible by the mesh data-axis size (2)" in \
            res["batch_error"]


def test_sigterm_on_one_rank_stops_both(dist_run):
    """SIGTERM to rank 1 alone: both ranks leave after the same step (the
    flag's MAX all-reduce), and rank 0 checkpoints that step."""
    outdir = dist_run["outdir"]
    procs = _spawn("sigterm", dist_run)
    log = os.path.join(outdir, "sigterm", "log", "train_metrics.jsonl")
    try:
        deadline = time.time() + 120
        while not (os.path.exists(log) and len(open(log).readlines()) >= 2):
            assert all(p.poll() is None for p in procs), "a rank exited early"
            assert time.time() < deadline, "no training progress in 120 s"
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _join(procs, timeout=120)
    r0, r1 = _load(outdir, "sigterm")
    step = r0["last"]["preempted_at_step"]
    assert r1["last"]["preempted_at_step"] == step
    assert 2 <= step < SIGTERM_ITERS
    ckpts = sorted(os.listdir(os.path.join(outdir, "sigterm", "ckpt")))
    assert ckpts == ["LATEST", f"step_{int(step):08d}.npz"], ckpts


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    raise SystemExit(_worker(*sys.argv[1:5]))
