"""``repro_torch.distributed`` — the paper's §4.2 parallel blocking,
executed. The port of ``repro.distributed``.

Takes a :class:`~repro_torch.core.parallel_tiling.ParallelBlocking` (the
integer processor grid the parallel LP chose), snaps it onto a conv mesh
(``repro_torch.launch.make_conv_mesh``), and runs conv2d shard by shard:
halo rows shifted from spatial neighbors, cI partials summed, and the
shard-local conv dispatched through the ``repro_torch.ops`` registry (op
``conv2d_dist``, backends ``torch``/``cuda``), so each bf16 shard runs
``conv2d_tc_kernel`` on the card.

    from repro_torch import distributed, ops
    from repro_torch.launch import make_conv_mesh

    pb = distributed.default_blocking(x.shape, w.shape, stride=(1, 1),
                                      P_devices=8)
    mesh = make_conv_mesh(pb)   # 8 shards, where x lies (one card)
    y = ops.conv2d_dist(x, w, blocking=pb, mesh=mesh, ctx=ctx)

The mesh is a :class:`LocalConvMesh` (all shards in one process, the
counterpart of the reference's fake host devices) or a
:class:`GroupConvMesh` (one shard a rank of a ``torch.distributed`` process
group). ``conv2d_dist_comm_words`` / ``allgather_comm_words`` report the
inter-device words per device from the identical geometry, and each mesh
counts what its collectives put on the wire (``mesh.wire``).
"""

from .collectives import (  # noqa: F401
    WIRE_KINDS,
    ConvMesh,
    GroupConvMesh,
    LocalConvMesh,
)
from .geometry import (  # noqa: F401
    DIST_AXES,
    DistConvGeometry,
    dist_grid,
)
from .halo import (  # noqa: F401
    allgather_comm_words,
    allgather_conv,
    conv2d_dist_comm_words,
    default_blocking,
    halo_conv,
)
