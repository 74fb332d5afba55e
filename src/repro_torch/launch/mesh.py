"""Device meshes for the dry run: one HGX H100 node, and any slice of it.

The port's counterpart of the JAX package's ``launch/mesh.py``, whose
meshes are TPU pods of placeholder host devices.  Here a mesh is a
``DeviceMesh`` over PyTorch's fake process group: every collective is
recorded and none is sent, so one process stands for rank 0 of the node,
whose per-device view the roofline prices.  Functions, not module
constants: building a mesh starts the process's default group.

The mesh's tensors are fake CPU tensors whatever card they stand for: a
fake tensor holds no data on any device, and CPU ones work with every
build of PyTorch, a card or none (:mod:`repro_torch.launch.dryrun` says
how the card's kernels are priced).

The fake group is this process's default group.  It must never meet a
real NCCL or gloo group in one process, so a program that also runs real
collectives runs the dry run in a subprocess.
"""

from __future__ import annotations

from typing import Tuple

AXES: Tuple[str, str] = ("data", "model")
# one HGX H100 node: 8 cards on one NVSwitch, every pair at NVLink's rate
NODE_SHAPE: Tuple[int, int] = (2, 4)


def _fake_world(size: int) -> None:
    """Make the default group a fake one of ``size`` ranks, this process
    rank 0; replace an earlier fake group of another size, refuse a real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is running: the dry run's fake "
                "group must live in a process of its own"
            )
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_slice_mesh(rows: int, cols: int):
    """A ``(rows, cols)`` mesh over ``("data", "model")``; ``(1, 1)`` is one
    card."""
    from torch.distributed.device_mesh import init_device_mesh

    _fake_world(rows * cols)
    return init_device_mesh("cpu", (rows, cols), mesh_dim_names=AXES)


def make_production_mesh():
    """One HGX H100 node: 8 cards as ``(data, model) = (2, 4)``."""
    return make_slice_mesh(*NODE_SHAPE)
