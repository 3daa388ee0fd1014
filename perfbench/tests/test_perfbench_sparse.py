"""The sparse U-ResNet's cell (train_sparse_768; archs/sparse_uresnet.py,
configs/sparse_uresnet3d_768.json): its reference is the tier-1 tests'
own copy, its FLOPs are the brute-force pair count, a small copy of the
cell runs correct through loops.run, untraced and traced, and the two new
readers (rulebook_ms.train, sparse_conv_roofline.train) read nothing where
their span or kernels are not there."""

import filecmp
import importlib.util
import itertools
import os
import time

import pytest
import torch

import small
from harness import checks, events, loops, spec, trace, weights

SEED = 2 ** 31 + 29
TESTS = os.path.join(spec.ROOT, "tests", "sparse_uresnet_reference.py")
MINE = os.path.join(spec.ARCHS, "sparse_uresnet_reference.py")


def _cell():
    return small.cell("train_sparse_768", compute_dtype="float32")


def _pool(cell, batches=2):
    d = cell.data
    return events.make_pool(SEED, batches=batches,
                            batch_size=d["batch_size"] + 1,
                            shape=(d["image_size"],) * 3,
                            max_points=d["max_points"])


def test_the_cell_is_as_configured():
    c = spec.cell("train_sparse_768")
    assert c.chips == 1 and c.arch.__name__ == "perfbench_arch_sparse_uresnet"
    assert c.model["arch"] == "sparse_uresnet" and c.config["reduced"] == []
    assert (c.model["base_filters"], c.model["depth"], c.data["image_size"],
            c.data["batch_size"]) == (16, 5, 768, 16)
    assert c.mix == {"loop": "train", "pool_batches": 4, "check_steps": 3,
                     "trace_steps": 32}
    assert c.mix["trace_steps"] % c.mix["pool_batches"] == 0
    names = {m["name"] for m in c.per_layer}
    assert {"rulebook_ms.train", "sparse_conv_roofline.train", "mfu.train",
            "idle_share.train", "densify_ms.train", "forward_ms.train",
            "backward_ms.train", "loss_ms.train", "optim_ms.train"} <= names
    # it reckons the dense net's BN layers
    assert "bn_train_roofline.train" not in names


def test_the_two_reference_copies_are_one():
    """The benchmark's reference and the tier-1 tests' are the same file,
    and give the same logits."""
    assert filecmp.cmp(TESTS, MINE, shallow=False)
    spec_ = importlib.util.spec_from_file_location("tests_sparse_ref", TESTS)
    theirs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(theirs)
    cell = _cell()
    mine = cell.arch.reference
    params, _ = weights.split(cell, weights.make(cell, SEED, "cpu",
                                                 serve=False))
    batch = _pool(cell)[0]
    a = mine.train_logits(cell.config, params, batch, device="cpu")
    b = theirs.train_logits(cell.config, params, batch, device="cpu")
    assert a.shape == (batch["coords"].shape[:2] + (3,))
    assert torch.equal(a, b)


def _brute_pairs(batch, extent, levels):
    """Sites of every level and, by a search over all pairs, the
    submanifold pairs of each level."""
    coords, npts = batch["coords"], batch["npoints"]
    sites = [sorted({(b,) + tuple(int(v) >> lvl for v in coords[b, p])
                     for b in range(len(npts)) for p in range(npts[b])
                     if all(0 <= v < extent for v in coords[b, p])})
             for lvl in range(levels)]
    sc = []
    for s in sites:
        have = set(s)
        sc.append(sum((a[0],) + tuple(x + d for x, d in zip(a[1:], delta))
                      in have for a in s
                      for delta in itertools.product((-1, 0, 1), repeat=3)))
    return [len(s) for s in sites], sc


def test_batch_flops_is_the_pair_count():
    """2 x pairs x C_in x C_out for each conv's forward, weight gradient
    and (not the stem's) input gradient: the brute-force pairs of two
    small pool batches, and the counts pinned."""
    cell = _cell()
    m = cell.model
    C = [m["base_filters"] * (i + 1) for i in range(m["depth"] + 1)]
    got = []
    for batch in _pool(cell):
        n, sc = _brute_pairs(batch, cell.data["image_size"], len(C))
        macs = stem = sc[0] * C[0]
        for i, c in enumerate(C):
            macs += 4 * sc[i] * c * c
            if i < len(C) - 1:
                macs += 2 * n[i] * c * C[i + 1]          # Down and Up
                macs += 3 * sc[i] * c * c + 2 * n[i] * c * c  # 2C->C, 1x1
                macs += 2 * sc[i] * c * c                # the second block
        macs += n[0] * C[0] * 3
        fwd = cell.arch.batch_flops(cell.config, batch, train=False)
        step = cell.arch.batch_flops(cell.config, batch, train=True)
        assert (fwd, step) == (2 * macs, 2 * (3 * macs - stem))
        got.append((fwd, step))
    assert got == PINNED_FLOPS


PINNED_FLOPS = [(2000912, 5998088), (1947104, 5834696)]


def test_a_small_cell_runs_correct_untraced_and_traced():
    """The cell at extent 16, base 4, 3 levels, batch 1, f32: correct
    both ways; traced, every reader of the cell returns a number or (the
    roofline: no CUDA kernel on the CPU) nothing, and the window's FLOPs
    are the architecture's."""
    cell = _cell()
    for traced in (False, True):
        res = loops.run(cell, SEED, 0.2, traced, "cpu", time.perf_counter())
        assert checks.judge(res["numbers"], cell.limits)[0], res["numbers"]
    run = res["traced"]
    pool = loops._pool(cell, SEED)
    assert run.flops == sum(cell.arch.batch_flops(cell.config, pool[t % 4],
                                                  train=True)
                            for t in range(3 + 2, 3 + 4))
    read = {m["name"]: spec.metric_reader(m["name"])(run)
            for m in cell.per_layer}
    assert read.pop("sparse_conv_roofline.train") is None
    assert all(v is not None for v in read.values()), read


def _run(kernels=0, spans=("uresnet.train.rulebook",), steps=2, kind="train",
         model=None):
    """A hand-made traced window of ``steps`` steps: ``kernels`` sparse
    conv kernels of 10 us, and each phase span once a step."""
    phases = ("uresnet.train.densify", "uresnet.train.forward",
              "uresnet.train.loss", "uresnet.train.backward",
              "uresnet.train.optim") + tuple(spans)
    host, device = [], []
    for s in range(steps):
        for i, name in enumerate(phases):
            t0 = 10000 * s + 1000 * i
            host.append(trace.Op(name, len(host), t0, t0 + 900, [], False))
            host.append(trace.Op("cudaLaunchKernel", len(host), t0 + 10,
                                 t0 + 20, [], False))
            device.append((f"kernel {name}", t0 + 100, t0 + 200, 0))
    for k in range(kernels):
        device.append(("void (anonymous namespace)::sparse_gemm_tc_kernel"
                       "<64, __nv_bfloat16, 0>(...)", 100000 + 20 * k,
                       100010 + 20 * k, 0))
    t = trace.Trace(device=device, host=host, window=(0, 10 ** 7))
    m = dict(spec.cell("train_sparse_768").model) if model is None else model
    return loops.Traced(kind, t, 1.0, steps, 16, 768, m, 2, 0,
                        flops=int(1e9))


def test_the_new_readers_read_nothing_without_their_span_or_kernels():
    rulebook = spec.metric_reader("rulebook_ms.train")
    roofline = spec.metric_reader("sparse_conv_roofline.train")
    assert rulebook(_run()) == pytest.approx(0.1)  # 100 us a step
    assert rulebook(_run(spans=())) is None        # the dense step's trace
    assert rulebook(_run(kind="ana")) is None
    want = 2 * (3 * 61 - 1)                        # 2 steps of 182
    assert roofline(_run(kernels=want)) == pytest.approx(
        100 * 1e9 / 989e12 / (want * 10e-6))
    assert roofline(_run(kernels=want - 1)) is None
    assert roofline(_run(kernels=0)) is None
    dense = spec.cell("train_3d_192").model
    assert roofline(_run(kernels=want, model=dense)) is None
