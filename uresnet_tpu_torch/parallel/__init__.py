"""Parallelism of the port (port of uresnet_tpu/parallel/).

Data parallelism runs one process per device on ``torch.distributed``
(``mesh.py``): NCCL between CUDA devices, gloo on the CPU. Tensor
parallelism and the spatial halo exchange are not ported yet (ROADMAP.md).
"""
