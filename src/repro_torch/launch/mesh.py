"""Production meshes, the process group under them, and the ambient-mesh
scope; port of ``repro.launch.mesh`` onto ``torch.distributed``.

Single pod:  (16, 16)      ("data", "model")          = 256 ranks
Multi-pod:   (2, 16, 16)   ("pod", "data", "model")   = 512 ranks

The ``pod`` axis carries only data parallelism (the gradient reduction
and optional ZeRO sharding), never per-layer tensor collectives.

A mesh is a ``DeviceMesh`` over the default process group, one rank a
device. ``init_world(device)`` makes that group where there is none: from
the launcher's environment under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), else a group of one
rank over an in-process store, so a plain ``python -m`` run is a 1-rank
mesh, never a meshless one. The backend follows the device: NCCL for the
card, gloo for the CPU; the meshes take their device type from the
group's backend. A mesh needs a world of its own size: where the world
cannot hold the mesh asked for, the functions below raise, as
``jax.make_mesh`` fails on too few devices (the reference's
``make_host_mesh`` clips ``model`` to the devices there are; the port
raises instead, so no flag is quietly dropped).

``mesh_scope(mesh)`` installs ``mesh`` as the ambient mesh that
``common/sharding.py:shard_hint`` and ``moe_apply_ep`` read.

``fake_world(n)`` makes the default group a ``"fake"`` group of ``n``
ranks (torch's ``FakeProcessGroup`` over a ``FakeStore``) with this
process as rank 0: its collectives return at once and move nothing, so
``make_production_mesh`` builds the (16, 16) and (2, 16, 16) meshes in
one process, over which the dry run traces rank 0's shards on the meta
device (``launch/dryrun.py``). The dry run owns its process's default
group, as the reference's owns jax's initialization: run it in a process
of its own.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.common.sharding import scope


def init_world(device: torch.device) -> bool:
    """Make the default process group for ``device`` if there is none;
    True if this call made it (its caller then destroys it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


@contextlib.contextmanager
def fake_world(size: int):
    """The default process group as a fake group of ``size`` ranks, this
    process rank 0, while the context is open; refuses a group that
    exists already."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists "
                           f"already ({dist.get_backend()}, "
                           f"{dist.get_world_size()} ranks); the dry run "
                           "needs a process of its own")
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def compat_make_mesh(shape: tuple, axes: tuple):
    """A named ``DeviceMesh`` of ``shape`` over the whole world."""
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs a world of "
                         f"{math.prod(shape)} ranks; this one has {world}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_scope(mesh):
    """``mesh`` as the ambient mesh while the context is open."""
    return scope(mesh)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes)


def make_host_mesh(model: int = 1):
    """(world / model, model) over ("data", "model")."""
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide a world "
                         f"of {n} ranks")
    return compat_make_mesh((n // model, model), ("data", "model"))


def mesh_chip_count(mesh) -> int:
    return math.prod(mesh.shape)
