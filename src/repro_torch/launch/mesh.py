"""Mesh construction: the port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and no process group. ``make_production_mesh`` and
``make_host_mesh`` build a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names over the current default process group
(a real one for the mesh trainer, a fake one for the dry run,
``repro_torch.launch.dryrun``), whose world size must equal the mesh's
size. The reference's ``fake_devices`` (an XLA flag for host devices) has
no PyTorch meaning: a fake process group takes its place for the dry run
and a :class:`~repro_torch.distributed.LocalConvMesh` for the conv mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                 device_type: Optional[str]):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """Single pod: 256 devices as (data=16, model=16). Multi-pod: 2 pods x
    256 devices as (pod=2, data=16, model=16); the pod axis is the outer
    data-parallel axis. ``device_type`` defaults to ``"cuda"`` where a card
    is visible, else ``"cpu"`` (the dry run passes ``"cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: Optional[str] = None):
    """A small (data, model) mesh over the default group's ranks (tests,
    the mesh trainer)."""
    return _device_mesh((data, model), ("data", "model"), device_type)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a JAX-like mesh
    (``axis_names`` and ``devices``)."""
    names: Sequence[str] = getattr(mesh, "mesh_dim_names", None) or \
        mesh.axis_names
    shape = (tuple(mesh.shape) if hasattr(mesh, "mesh_dim_names")
             else tuple(mesh.devices.shape))
    return dict(zip(names, shape))


def make_conv_mesh(blocking, group=None):
    """Snap a conv processor grid onto a conv mesh.

    ``blocking`` is a :class:`repro_torch.core.parallel_tiling.ParallelBlocking`
    (or a plain axis->procs dict). The mesh always carries the four axes the
    distributed conv shards over, ``("N", "cI", "hO", "wO")``, in that
    order, size 1 for unsplit axes, so its sizes equal
    ``dist_grid(blocking)``. With no ``group`` it is a
    :class:`~repro_torch.distributed.LocalConvMesh`, all P shards in this
    process, on the device of the tensors they are given; with a
    ``torch.distributed`` process group of P ranks it is a
    :class:`~repro_torch.distributed.GroupConvMesh`, one shard a rank
    (every rank must call it)."""
    from repro_torch.distributed import (GroupConvMesh, LocalConvMesh,
                                         dist_grid)

    sizes = dist_grid(blocking)
    if group is None:
        return LocalConvMesh(sizes)
    return GroupConvMesh(sizes, group=group)
