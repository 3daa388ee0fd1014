"""The general driver: one run of one cell, as its traffic mix says.

Both loops are closed, one client: the next batch is sent when the last
is done. A run makes its pool of sparse batches and its weights from the
seed, builds the program from the cell's configuration, loads the weights
through the program's checkpoint loader, warms up every shape the window
uses, and then measures:

  train   ``Trainer.train_step_light`` on ``Trainer.device_batch`` of the
          pool's batches in turn. The first ``check_steps`` steps, on
          distinct batches, are the ones the reference follows; they are
          set-up. The window then runs steps until ``--seconds`` have
          passed and waits for the card: train_samples_s is the samples
          of every step in the window over its seconds.
  ana     the analysis step of ``engine/evaluator.run_inference``'s
          streamed sparse mode (``evaluator._ana_step_sparse`` with
          ``row_valid``, over ``engine/export.build_logits_fn``'s folded
          forward), each batch's scores, origins and counts read back to
          the host before the next is sent. Each batch's latency runs from
          the hand-over of its sparse arrays to its results on the host.

``--trace 1`` runs, in place of the timed window, ``trace_steps`` steps
or batches untraced (the time base of the ``mfu.*`` readers) and as many
again under ``torch.profiler``.

What the harness knows of the model (its leaves, its plain reference and
the reference's view of a batch, its FLOPs) it asks of the cell's
architecture module, ``cell.arch`` (archs/<arch>.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from harness import checks, events, quant, spec, trace, weights


# intra-op threads of a run's process, whose closed loop stages each batch
# on its critical path: with torch's default pool (a thread a core) waking
# for each batch's pinned copies, 5-22% of 3D analysis batches took ~5 ms
# more to stage, and a run's p95 fell on that tail or beside it; with one
# thread none did. Training's host keeps at most a step ahead of the card:
# on a host whose cores were busy, 3D training rates spread 2.0% with the
# default pool and 1.1% with one thread (PERF.md section 2)
HOST_THREADS = 1


def log(*args) -> None:
    print("[perfbench]", *args, file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_config(conf: dict):
    """The program's Config of a configuration file's sections."""
    from uresnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          OptimConfig, TrainConfig)

    def section(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items()})

    return Config(model=section(ModelConfig, conf["model"]),
                  data=section(DataConfig, conf["data"]),
                  optim=section(OptimConfig, conf["optim"]),
                  train=section(TrainConfig, conf["train"]))


class Program:
    """The system under test: a Trainer of the cell's configuration whose
    train state holds the given leaves, loaded as a checkpoint's."""

    def __init__(self, cell: spec.Cell, leaves: Dict[str, torch.Tensor],
                 device):
        from uresnet_tpu_torch.engine.trainer import Trainer, TrainState
        from uresnet_tpu_torch.models.convert import (load_jax_train_state,
                                                      unflatten_tree)

        self.cfg = port_config(cell.config)
        self.trainer = Trainer(self.cfg, device=device)
        ts = self.trainer.init_state()
        params, stats = weights.split(cell, leaves)
        zeros = unflatten_tree({k: torch.zeros_like(v)
                                for k, v in params.items()})
        opt, key = load_jax_train_state(ts.model, {
            "params": unflatten_tree(params),
            "model_state": unflatten_tree(stats),
            "opt": {"step": 0, "mu": zeros, "nu": zeros}, "key": ts.key})
        self.state = TrainState(model=ts.model, opt=opt, key=key)


@dataclasses.dataclass
class Traced:
    """What a per-layer reader (metrics/<name>.py) is given."""
    kind: str               # the mix's loop: 'train' or 'ana'
    trace: trace.Trace
    plain_s: float          # seconds of as many steps untraced, before it
    steps: int              # steps or batches in the traced window
    batch: int
    size: int
    model: dict
    itemsize: int           # bytes of the compute dtype
    launches: int           # the fused conv's launch counter over the window
    # the architecture's useful FLOPs of the steps that plain_s timed
    # (None: not counted)
    flops: Optional[int] = None


def _timed(step: Callable, seconds: float, device) -> tuple:
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        step()
        n += 1
    sync(device)
    return n, time.perf_counter() - t0


def _plain(step: Callable, n: int, device) -> float:
    """Seconds of ``n`` steps untraced, from a wait for the card to the
    next."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    sync(device)
    return time.perf_counter() - t0


def _traced(step: Callable, n: int, device, shapes: bool, turn: List[int]):
    """``n`` steps under the profiler, first ``n`` untraced, twice: (the
    trace, the second untraced pass's seconds, the fused conv's launches
    in the trace, the turns that pass ran). The first pass warms the loop:
    right after set-up, 40 3D analysis batches took 1.54-2.19 s in it.
    ``shapes``: record the ops' operand shapes. ``turn``: the loop's count
    of steps, which ``step`` advances."""
    from torch.profiler import ProfilerActivity, profile

    _plain(step, n, device)
    timed = range(turn[0], turn[0] + n)
    plain_s = _plain(step, n, device)
    before = _launches()
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=shapes) as prof:
        with record_function(trace.WINDOW):
            for _ in range(n):
                step()
            sync(device)
    launches = _launches() - before
    got = trace.read(prof)
    log(f"traced window {got.window_s!r} s, the same {n} steps untraced "
        f"{plain_s!r} s")
    return got, plain_s, launches, timed


def _flops(cell: spec.Cell, pool: List[dict], turns, train: bool) -> int:
    """The architecture's useful FLOPs of the pool batches of ``turns``."""
    return sum(cell.arch.batch_flops(cell.config, pool[t % len(pool)],
                                     train=train) for t in turns)


def _launches() -> int:
    from uresnet_tpu_torch.ops.cuda import conv2d

    return conv2d.launches


@contextlib.contextmanager
def _kept_logits(tr, keep: bool):
    """With ``keep``, the logits that the train step's own loss takes, on
    the host, in a list: the step's forward read where its loss reads it."""
    kept: List[torch.Tensor] = []
    if not keep:
        yield kept
        return
    loss_fn = tr._loss_fn

    def keeping(model, batch):
        loss, logits, state = loss_fn(model, batch)
        kept.append(logits.detach().float().cpu())
        return loss, logits, state

    tr._loss_fn = keeping
    try:
        yield kept
    finally:
        del tr._loss_fn


def _pool(cell: spec.Cell, seed: int) -> List[dict]:
    m, d = cell.model, cell.data
    return events.make_pool(seed, batches=cell.mix["pool_batches"],
                            batch_size=d["batch_size"],
                            shape=(d["image_size"],) * m["dims"],
                            max_points=d["max_points"])


def _view(cell: spec.Cell, batch: dict, weight_mode: str) -> dict:
    """The plain reference's view of one pool batch."""
    return cell.arch.view(cell.config, batch, weight_mode)


def _free(device) -> int:
    """The peak device memory so far; then the program's memory freed."""
    peak = 0
    if torch.device(device).type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return peak


def run_train(cell: spec.Cell, seed: int, seconds: float, traced: bool,
              device, t0: float) -> dict:
    if torch.device(device).type == "cuda":
        # on the CPU the pool computes the step itself
        torch.set_num_threads(HOST_THREADS)
    mix, m = cell.mix, cell.model
    B = cell.data["batch_size"]
    pool = _pool(cell, seed)
    leaves = weights.make(cell, seed, device, serve=False)
    params0, _ = weights.split(cell, leaves)
    prog = Program(cell, leaves, device)
    tr = prog.trainer
    turn = [0]

    def step():
        with record_function("bench.stage"):
            batch = tr.device_batch(pool[turn[0] % len(pool)])
        with record_function("bench.step"):
            prog.state, met = tr.train_step_light(prog.state, batch)
        turn[0] += 1
        return met

    # the first steps, which the reference follows
    b1 = cell.optim["b1"]
    out = {"losses": []}
    for i in range(mix["check_steps"]):
        with _kept_logits(tr, i == 0) as kept:
            out["losses"].append(float(step()["loss"]))
        if i == 0:
            out["logits"] = kept[0]
            out["grad_norms"] = {
                k: float(torch.linalg.vector_norm(v.double())) / (1 - b1)
                for k, v in prog.state.opt.mu.items()}
    out["change_norms"] = {
        k: float(torch.linalg.vector_norm(p.detach().double()
                                          - params0[k].double()))
        for k, p in prog.state.model.named_parameters()}
    sync(device)
    res = {"setup_s": time.perf_counter() - t0}
    log(f"setup_s {res['setup_s']!r}")
    if traced:
        got, plain_s, launches, timed = _traced(step, mix["trace_steps"],
                                                device, False, turn)
        res["traced"] = Traced("train", got, plain_s, mix["trace_steps"], B,
                               cell.data["image_size"], m, _itemsize(m),
                               launches, _flops(cell, pool, timed, True))
        res["attempted"] = mix["trace_steps"]
    else:
        n, window = _timed(step, seconds, device)
        res["attempted"] = n
        res["train_samples_s"] = n * B / window
        log(f"window: {n} steps of {B} in {window!r} s")
    del prog, tr, step
    res["memory_peak_bytes"] = _free(device)
    views = [_view(cell, pool[i], cell.data["weight_mode"])
             for i in range(mix["check_steps"])]
    t = time.perf_counter()
    ref = train_reference(cell, params0, views, device)
    log(f"reference: {mix['check_steps']} steps in "
        f"{time.perf_counter() - t!r} s; losses {out['losses']} against "
        f"{ref['losses']}")
    res["numbers"] = checks.train_numbers(out, ref)
    res["detail"] = checks.train_detail(out, ref)
    res["reference"] = ref
    return res


def train_reference(cell: spec.Cell, params0, views: List[dict],
                    device) -> dict:
    """The reference's steps from ``params0`` over the batches' views,
    with the yardstick of the first step's logits: the same forward with
    its operands rounded to bfloat16."""
    arch, conf = cell.arch, cell.config
    ref = arch.train_steps(conf, params0, views, device=device)
    ref["yard"] = arch.train_logits(conf, params0, views[0], device=device,
                                    quant=quant.bf16)
    return ref


class _Sample:
    """The pool batches whose window results are compared: ``k`` drawn
    from the seed, and the batch with the most points. The last result of
    each in the window is kept."""

    def __init__(self, seed: int, k: int, sizes: List[int]):
        chosen = random.Random(seed).sample(range(len(sizes)),
                                            min(k, len(sizes)))
        self.want = set(chosen) | {sizes.index(max(sizes))}
        self.kept: Dict[int, dict] = {}

    def offer(self, pool_index: int, result: dict) -> None:
        if pool_index in self.want:
            self.kept[pool_index] = result

    def missing(self) -> List[int]:
        return sorted(self.want - set(self.kept))

    def items(self) -> List[tuple]:
        return sorted(self.kept.items())


def run_ana(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, t0: float) -> dict:
    from uresnet_tpu_torch.engine import evaluator
    from uresnet_tpu_torch.engine.export import build_logits_fn

    torch.set_num_threads(HOST_THREADS)
    mix, m = cell.mix, cell.model
    B = cell.data["batch_size"]
    pool = _pool(cell, seed)
    for batch in pool:
        batch["row_valid"] = np.ones((B,), np.float32)
    leaves = weights.make(cell, seed, device, serve=True)
    cell.arch.calibrate(cell.config, leaves, _view(cell, pool[0], "ones"),
                        device=device)
    params, stats = weights.split(cell, leaves)
    prog = Program(cell, leaves, device)
    tr, cfg = prog.trainer, prog.cfg
    logits_fn = build_logits_fn(cfg, prog.state.model)
    sample = _Sample(seed, mix["check_batches"],
                     [int(b["npoints"].sum()) for b in pool])
    lat: List[float] = []
    turn = [0]

    def serve(keep: bool = True):
        i = turn[0] % len(pool)
        t = time.perf_counter()
        with record_function("bench.stage"):
            batch = tr.device_batch(pool[i])
        with record_function("bench.step"):
            out = evaluator._ana_step_sparse(cfg, logits_fn, batch)
        with record_function("bench.readback"):
            host = {k: v.cpu().numpy() for k, v in out.items()}
        if keep:
            lat.append(time.perf_counter() - t)
            sample.offer(i, host)
        turn[0] += 1

    for _ in range(mix["warmup_batches"]):
        serve(keep=False)
    sync(device)
    res = {"setup_s": time.perf_counter() - t0}
    log(f"setup_s {res['setup_s']!r}")
    if traced:
        got, plain_s, launches, timed = _traced(serve, mix["trace_steps"],
                                                device, True, turn)
        res["traced"] = Traced("ana", got, plain_s, mix["trace_steps"], B,
                               cell.data["image_size"], m, _itemsize(m),
                               launches, _flops(cell, pool, timed, False))
        res["attempted"] = mix["trace_steps"]
    else:
        n, window = _timed(serve, seconds, device)
        res["attempted"] = n
        res["serve_samples_s"] = n * B / window
        ms = sorted(x * 1e3 for x in lat)
        res["serve_batch_ms_p95"] = statistics.quantiles(ms, n=20)[18]
        log(f"window: {n} batches of {B} in {window!r} s; batch latency "
            f"over {len(ms)} batches: median {statistics.median(ms)!r} ms, "
            f"p95 {res['serve_batch_ms_p95']!r} ms, max {ms[-1]!r} ms")
    # a window too short to reach a sampled batch (on the CPU): it is
    # served now, so that every run compares the whole sample
    for i in sample.missing():
        turn[0] = i
        serve()
    kept = sample.items()
    del prog, tr, logits_fn, serve
    res["memory_peak_bytes"] = _free(device)
    t = time.perf_counter()
    views = [_view(cell, pool[i], "ones") for i, _ in kept]
    ref = [cell.arch.analyse(cell.config, params, stats, v, device=device)
           for v in views]
    log(f"reference: {len(kept)} batches (pool {[i for i, _ in kept]}) in "
        f"{time.perf_counter() - t!r} s")
    res["numbers"] = checks.ana_numbers([h for _, h in kept], ref, views)
    return res


def _itemsize(m: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[m["compute_dtype"]]


LOOPS = {"train": run_train, "ana": run_ana}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> dict:
    threads = torch.get_num_threads()
    try:
        return LOOPS[cell.mix["loop"]](cell, seed, seconds, traced, device, t0)
    finally:
        torch.set_num_threads(threads)

