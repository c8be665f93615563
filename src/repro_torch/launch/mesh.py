"""Production and local meshes on torch's ``DeviceMesh`` (port of
``repro/launch/mesh.py``).

Meshes are made by functions, not module-level constants, as in the
reference: importing this module touches no process group.  The reference
lowers against 512 placeholder TPU devices; here a mesh of 256 or 512
ranks is a ``DeviceMesh`` over the current default process group, which
the dry run (:mod:`repro_torch.launch.dryrun`) brings up in one process
over torch's ``"fake"`` backend (:func:`fake_world`): ranks that run no
collective, which is all an abstract step needs.  What runs on tensors is
the 1x1 mesh of :func:`make_local_mesh`, on the card unless the caller
asks for the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.config import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.core.device import resolve_device


def production_config(multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the (2,
    16, 16) ("pod", "data", "model") one, over the current default process
    group, whose world must have exactly that many ranks.  Raises
    RuntimeError, naming what is missing, when no such group is up."""
    mc = production_config(multi_pod)
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_production_mesh needs a process group of "
            f"{mc.num_devices} ranks and none is initialized; the dry run "
            f"brings one up in one process with fake_world({mc.num_devices})")
    world = dist.get_world_size()
    if world != mc.num_devices:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs "
            f"{mc.num_devices} ranks; the process group has {world}")
    return init_device_mesh("cpu", mc.shape, mesh_dim_names=mc.axes)


def make_local_mesh(device: Optional[Union[str, torch.device]] = None
                    ) -> DeviceMesh:
    """A 1x1 ("data", "model") mesh on ``device`` (None: the CUDA device,
    raising without one), over a one-rank process group that this call
    brings up in process (an in-memory store, no port) unless one is up.
    Raises RuntimeError if the group up has more than one rank."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"make_local_mesh needs a one-rank process "
                           f"group; the group up has "
                           f"{dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a
    :class:`~repro_torch.core.config.MeshConfig`, or such a dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if isinstance(mesh, MeshConfig):
        return dict(zip(mesh.axes, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_devices(mesh) -> int:
    """The number of devices (ranks) of ``mesh`` (as
    :func:`mesh_axis_sizes` takes it)."""
    n = 1
    for s in mesh_axis_sizes(mesh).values():
        n *= s
    return n


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` ranks in this one process
    over torch's ``"fake"`` backend (this process is rank 0; the others
    exist only as names, and a collective returns at once).  It is
    destroyed on exit.  Raises RuntimeError if a group is already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
