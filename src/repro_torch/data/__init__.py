"""Token pipeline of the port (a numpy-only copy of ``repro.data``)."""

from .pipeline import DataConfig, FileSource, SyntheticSource, iterate, make_source  # noqa: F401
