"""Parallelism of the port (port of uresnet_tpu/parallel/).

One process per device on ``torch.distributed`` (NCCL between CUDA
devices, gloo on the CPU), laid out as the (data, spatial, model) mesh of
``mesh.py``: data parallelism, spatial partitioning of H or D with halo
exchanges (``halo.py``) and tensor parallelism over the conv channels
(``tp.py``).
"""
