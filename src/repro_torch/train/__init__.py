"""Training substrate of the port: AdamW (``optimizer``), the reference's
checkpoint format (``checkpoint``) and the training loop (``trainer``)."""

from . import checkpoint, optimizer, trainer  # noqa: F401
