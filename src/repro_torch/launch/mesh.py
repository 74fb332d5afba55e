"""Device meshes for the dry run: one HGX H100 node, two of them, and any
slice of one.

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

One mesh object serves each shape while its group lives.  DTensor caches
its sharding decisions by mesh value, and two meshes of one shape are equal
values with different process groups, so a second mesh of a shape would
have its tensors' collectives issued on the first one's groups, under
names the counter of the second does not know.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

AXES: Tuple[str, str] = ("data", "model")
# one HGX H100 node: 8 cards on one NVSwitch, every pair at NVLink's rate
NODE_SHAPE: Tuple[int, int] = (2, 4)
# the reference's multi-pod mesh adds a "pod" axis over pods; here it runs
# over HGX nodes, whose cards reach the other node's over InfiniBand
POD_AXES: Tuple[str, str, str] = ("pod",) + AXES
# two HGX H100 nodes: 16 cards as (pod, data, model) = (2, 2, 4)
POD_SHAPE: Tuple[int, int, int] = (2,) + NODE_SHAPE

# shape -> the mesh of that shape on the running fake group
_MESHES: Dict[Tuple[int, ...], object] = {}


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
        _MESHES.clear()
        # DTensor's cached sharding decisions hold meshes of the old group
        from torch.distributed.tensor import DTensor

        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_slice_mesh(*shape: int):
    """A ``(rows, cols)`` mesh over ``("data", "model")`` (``(1, 1)`` is one
    card), or a ``(pods, rows, cols)`` one over ``("pod", "data", "model")``."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh shape is (data, model) or (pod, data, model), not {shape}")
    _fake_world(math.prod(shape))
    if shape not in _MESHES:
        _MESHES[shape] = init_device_mesh(
            "cpu", shape, mesh_dim_names=AXES if len(shape) == 2 else POD_AXES)
    return _MESHES[shape]


def make_production_mesh(*, multi_pod: bool = False):
    """One HGX H100 node: 8 cards as ``(data, model) = (2, 4)``; with
    ``multi_pod`` two nodes, 16 cards as ``(pod, data, model) = (2, 2, 4)``."""
    return make_slice_mesh(*(POD_SHAPE if multi_pod else NODE_SHAPE))
