"""The (data, spatial, model) mesh of a launch and its collectives (port
of uresnet_tpu/parallel/mesh.py).

The JAX package runs one process per host over a mesh of that host's
devices, and XLA compiles the collectives. The port runs one process per
device, in the ``torchrun`` model: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` come from the
environment, the device is ``cuda:LOCAL_RANK`` with NCCL, and the CPU with
gloo only when the caller asks for it. The world is laid out as the JAX
mesh's device grid, row-major over (data, spatial, model): the rank at
mesh index (d, s, m) is ``(d * spatial + s) * model + m``.

  * data    — each data index reads its own share of the global batch;
  * spatial — the ranks of a data index split H (2D) or D (3D) of its
              batch, with halo exchanges at every conv (parallel/halo.py);
  * model   — the ranks of a (data, spatial) index hold every conv's
              output channels in slices (parallel/tp.py).

The collectives are NCCL's (or gloo's) through ``torch.distributed``;
nothing here is a hand-written transport. Every rank creates every
process group, in one order (``dist.new_group`` requires it). A group that
spans the world is the world's group (a launch of one process still runs
its collectives); any other group of one rank is None: no collective runs
in it. Without an initialised process group the mesh is one process and
every group is None.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One rank's view of a group of the mesh: the group (None: this rank
    alone), its size and this rank's position in it."""

    group: Optional[dist.ProcessGroup]
    size: int = 1
    index: int = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, spatial, model) mesh.

    ``group`` spans the world (None: one process). ``batch`` is the
    data x spatial group of this rank's model index: the ranks that hold
    different parts of the global batch and the same channels, over which
    the BN statistics, the gradients, the loss and the confusion counts are
    reduced (the world under data parallelism alone). ``data_axis``,
    ``spatial_axis`` and ``model_axis`` are the groups along one axis
    through this rank."""

    rank: int
    world: int
    data: int
    spatial: int = 1
    model: int = 1
    index: Tuple[int, int, int] = (0, 0, 0)   # (d, s, m)
    group: Optional[dist.ProcessGroup] = None
    batch: Axis = Axis(None)
    data_axis: Axis = Axis(None)
    spatial_axis: Axis = Axis(None)
    model_axis: Axis = Axis(None)

    @property
    def leader(self) -> bool:
        """Rank 0 writes the logs, checkpoints and traces."""
        return self.rank == 0

    @property
    def batch_root(self) -> int:
        """The global rank of mesh index (0, 0, m): the first rank of this
        rank's batch group."""
        return self.index[2]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> torch.device:
    """Join the process group of a ``torchrun`` launch and return this
    process's device: ``cuda:LOCAL_RANK`` with NCCL for a CUDA ``device``,
    the CPU with gloo for ``cpu``. ``backend`` names another one explicitly
    (gloo between CUDA tensors, which runs several ranks on one card);
    nothing falls back from one backend to another. Raises RuntimeError
    when the torchrun environment is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"distributed training needs the torchrun environment; "
            f"{', '.join(missing)} not set (launch with `torchrun "
            f"--nproc-per-node N -m uresnet_tpu_torch.cli.train ... "
            f"--distributed`)")
    kind = torch.device(device).type
    if kind == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"no distributed backend for device {device!r}")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def start_local(argv: List[str], world: int, *, env=None, cwd=None,
                local_rank: Optional[Callable[[int], int]] = None) -> list:
    """Start ``argv`` as the ``world`` processes of one launch on this
    host, in the torchrun environment `init_distributed` reads (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` = ``local_rank(rank)``, default the rank,
    ``MASTER_ADDR`` 127.0.0.1, a free ``MASTER_PORT``) on top of ``env``
    (default: this process's); each one's output is piped. Returns the
    ``subprocess.Popen`` of each rank, for `join_local`."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ if env is None else env)
    local_rank = local_rank or (lambda r: r)
    return [subprocess.Popen(
        argv, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(base, RANK=str(r), WORLD_SIZE=str(world),
                            LOCAL_RANK=str(local_rank(r)),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
        for r in range(world)]


def join_local(procs: list, timeout: float = 600) -> List[Tuple[int, str]]:
    """Wait for the processes of `start_local`, kill what is left at
    ``timeout`` seconds (or on any error), and return each rank's (exit
    code, output)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def launch_local(argv: List[str], world: int, *, env=None, cwd=None,
                 local_rank: Optional[Callable[[int], int]] = None,
                 timeout: float = 600) -> List[Tuple[int, str]]:
    """Run ``argv`` as the ``world`` processes of one launch on this host
    (`start_local`) and wait for them (`join_local`): each rank's (exit
    code, output)."""
    return join_local(start_local(argv, world, env=env, cwd=cwd,
                                  local_rank=local_rank), timeout)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_data: int = 0, n_spatial: int = 1, n_model: int = 1) -> Mesh:
    """The (data, spatial, model) mesh over this launch's processes.
    ``n_data`` 0 means world / (spatial * model). The product must equal
    the world size (one process per device: a run never goes quietly on
    fewer), else ValueError, as the JAX mesh raises."""
    world = process_count()
    if n_data is None or n_data <= 0:
        n_data = world // (n_spatial * n_model)
        if n_data < 1:
            raise ValueError(
                f"mesh needs at least {n_spatial * n_model} devices for "
                f"spatial={n_spatial} x model={n_model}, have {world}")
    need = n_data * n_spatial * n_model
    if need != world:
        raise ValueError(
            f"mesh {n_data}x{n_spatial}x{n_model} needs {need} devices, "
            f"have {world} (one process per device: the mesh's product "
            f"must be the world size; parallel.data 0 takes the rest)")
    rank = process_index()
    grid = np.arange(world).reshape(n_data, n_spatial, n_model)
    index = tuple(int(i) for i in np.argwhere(grid == rank)[0])
    d, s, m = index
    axes = {}
    # every rank walks every partition in this one order
    for name, parts in (
            ("batch", [grid[:, :, j].ravel() for j in range(n_model)]),
            ("data", [grid[:, i, j] for i in range(n_spatial)
                      for j in range(n_model)]),
            ("spatial", [grid[i, :, j] for i in range(n_data)
                         for j in range(n_model)]),
            ("model", [grid[i, j, :] for i in range(n_data)
                       for j in range(n_spatial)])):
        for ranks in parts:
            ranks = [int(r) for r in ranks]
            if len(ranks) == world and dist.is_initialized():
                group = dist.group.WORLD  # a launch of one still reduces
            elif len(ranks) == 1:
                group = None
            else:
                group = dist.new_group(ranks)
            if rank in ranks:
                axes[name] = Axis(group, len(ranks), ranks.index(rank))
    return Mesh(rank=rank, world=world, data=n_data, spatial=n_spatial,
                model=n_model, index=index,
                group=dist.group.WORLD if dist.is_initialized() else None,
                batch=axes["batch"], data_axis=axes["data"],
                spatial_axis=axes["spatial"], model_axis=axes["model"])


# -- collectives -----------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose gradient is the SUM all-reduce of the output
    gradients: with every rank's loss a term of one global objective, each
    rank's input then gets the gradient of the sum of all the losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM over the group (a new tensor)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """MAX over the group, in place; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _buckets(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


@torch.no_grad()
def _flat_apply(tensors: List[torch.Tensor], fn) -> None:
    """Run ``fn`` on one flat copy of ``tensors`` per dtype and write the
    result back into them."""
    for ts in _buckets(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def broadcast(tensors: List[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, one broadcast per
    dtype."""
    _flat_apply(tensors, lambda f: dist.broadcast(f, src=src, group=group))


def all_reduce_mean(tensors: List[torch.Tensor], group) -> None:
    """Average ``tensors`` in place over the group, one SUM all-reduce per
    dtype (gloo has no AVG)."""
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)

    _flat_apply(tensors, mean)


def all_reduce_counts(counts: Dict[str, np.ndarray], group,
                      device) -> Dict[str, np.ndarray]:
    """Sum host count leaves (float64 numpy, any shapes) over the group in
    one float64 all-reduce on ``device``; a new dict."""
    keys = sorted(counts)
    arrs = [np.asarray(counts[k], np.float64) for k in keys]
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrs])
                            ).to(device)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat.cpu().numpy()
    out, i = {}, 0
    for k, a in zip(keys, arrs):
        out[k] = flat[i:i + a.size].reshape(a.shape)
        i += a.size
    return out
