"""The production mesh and the H100's roofline constants.

The port of ``repro.launch.mesh``.  The reference lays its meshes over
TPU v5e chips; the port prices NVIDIA H100 80GB HBM3 cards at their
700 W power limit.  ``make_production_mesh`` builds a ``DeviceMesh`` of
(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
"model")``, over a ``fake`` process group of 256 or 512 ranks
(``fake_world``): this process is rank 0 of a world that exists only in
shapes, so the dry-run (``launch.dryrun``) can place fake DTensors on it
and see every collective DTensor would issue, with nothing allocated or
sent.  ``make_grid_mesh`` lists the devices the simulator's grid is
sharded over (``env/torchsim/driver.run_grid_engine(devices=...)``).
Nothing here runs at import.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

#: dense bf16 tensor-core peak of one H100 SXM5 (NVIDIA's data sheet,
#: without sparsity; NVIDIA H100 80GB HBM3 at its 700 W limit)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of one H100 SXM5 (data sheet), B/s
HBM_BW = 3.35e12
#: HBM per card (NVIDIA H100 80GB HBM3)
HBM_BYTES = 80e9
#: B/s per GPU across the mesh: one 400 Gb/s NDR InfiniBand port per GPU,
#: as in a DGX H100 (8 GPUs per NVLink domain, so a 16-wide axis spans two
#: domains and its collectives run at the network's rate; NVLink 4 inside
#: one domain gives 450 GB/s per direction)
LINK_BW = 50e9
#: the card the constants are for
CARD = "NVIDIA H100 80GB HBM3, 700 W"

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


class AbstractMesh(NamedTuple):
    """A mesh's axis sizes and names without devices or a process group
    (what the sharding rules read; the counterpart of JAX's
    ``AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of
    ``world_size`` ranks (collectives return at once, moving nothing);
    a no-op if a group of that size is already up."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the production mesh needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch build lacks") from e
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is up; the "
                               f"mesh needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over a fake process
    group (device type ``"cpu"``: its tensors are fake and run nowhere)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = MULTI if multi_pod else SINGLE
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_grid_mesh(devices="auto") -> list:
    """The devices the simulator's grid axis is sharded over, one
    contiguous slice of grid cells per device (the counterpart of the
    reference's 1-D ``"grid"`` mesh: the cells are independent, so a list
    of devices is the whole mesh).

    ``"auto"`` (or None) takes every visible CUDA device; an int n the
    first n of them, and raises a ``ValueError`` outside 1..count; a
    sequence of devices (``torch.device`` or strings, e.g. ``["cpu"] *
    8``) is taken as given.  There is no CPU fallback: ``"auto"`` with no
    CUDA device visible raises."""
    import torch
    from repro_torch.device import resolve
    if devices is None or isinstance(devices, str) and devices == "auto":
        n = torch.cuda.device_count()
        if n == 0:
            raise ValueError("devices='auto': no CUDA device is visible "
                             "(pass a list of devices to shard over "
                             "others)")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, int) and not isinstance(devices, bool):
        avail = torch.cuda.device_count()
        if not 1 <= devices <= avail:
            raise ValueError(f"devices={devices!r}: need 1..{avail} "
                             f"(visible CUDA devices: {avail})")
        return [torch.device("cuda", i) for i in range(devices)]
    devs = [resolve(d) for d in devices]
    if not devs:
        raise ValueError("devices: an empty sequence")
    return devs


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def num_chips(mesh) -> int:
    return math.prod(tuple(mesh.shape))
