"""The data-parallel process group and its collectives (port of
uresnet_tpu/parallel/mesh.py).

The JAX package runs one process per host over a mesh of that host's
devices, and XLA compiles the collectives. The port runs one process per
device, in the ``torchrun`` model: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` come from the
environment, the device is ``cuda:LOCAL_RANK`` with NCCL, and the CPU with
gloo only when the caller asks for it. The data axis is the world: every
process holds a replica of the train state and ``1/world`` of the global
batch. The collectives are NCCL's (or gloo's) all-reduce and broadcast
through ``torch.distributed``; nothing here is a hand-written transport.

Without an initialised process group the mesh is one process and no
collective runs: ``Mesh.group`` is None.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
_NOT_PORTED = ("is not ported yet (ROADMAP.md, modules to port: "
               "parallel/tp.py and parallel/halo.py)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, spatial, model) mesh. Only the
    data axis is ported: ``data`` equals the world size, and ``group`` is
    the process group its collectives run in (None: one process, no
    collectives)."""

    rank: int
    world: int
    data: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def leader(self) -> bool:
        """Rank 0 writes the logs, checkpoints and traces."""
        return self.rank == 0


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


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_data: int = 0, n_spatial: int = 1, n_model: int = 1) -> Mesh:
    """The mesh over this launch's processes. ``n_data`` 0 means all of
    them; any other ``n_data`` must equal the world size (one process per
    device: a run never goes quietly on fewer). Spatial and model
    parallelism raise NotImplementedError."""
    for axis, n in ((SPATIAL_AXIS, n_spatial), (MODEL_AXIS, n_model)):
        if n > 1:
            raise NotImplementedError(
                f"parallel.{axis} > 1: parallelism {_NOT_PORTED}")
    world = process_count()
    if n_data is None or n_data <= 0:
        n_data = world
    if n_data != world:
        raise ValueError(
            f"mesh {n_data}x{n_spatial}x{n_model} needs {n_data} devices, "
            f"have {world} (one process per device: parallel.data must be "
            f"the world size, or 0 for all)")
    return Mesh(rank=process_index(), world=world, data=n_data,
                group=dist.group.WORLD if dist.is_initialized() else None)


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
