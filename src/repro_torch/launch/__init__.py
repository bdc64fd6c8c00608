"""Entry points of the port (``python -m repro_torch.launch.serve``) and
the conv mesh (``make_conv_mesh``)."""
from .mesh import make_conv_mesh  # noqa: F401
