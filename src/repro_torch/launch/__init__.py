"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun``), the meshes (``make_production_mesh``,
``make_host_mesh``) and the conv mesh (``make_conv_mesh``)."""
from .mesh import (make_conv_mesh, make_host_mesh,  # noqa: F401
                   make_production_mesh)
