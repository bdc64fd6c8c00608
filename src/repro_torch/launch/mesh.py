"""Conv mesh construction: the port of ``repro.launch.mesh``'s
``make_conv_mesh``.

A function, not a module-level constant: importing this module touches no
device and no process group. The reference's ``make_production_mesh`` and
``make_host_mesh`` come with the dry run; its ``fake_devices`` (an XLA flag
for host devices) has no PyTorch meaning: a
:class:`~repro_torch.distributed.LocalConvMesh` takes its place.
"""

from __future__ import annotations


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
