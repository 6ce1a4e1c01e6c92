"""Training tier (this slice: the serving entry point only)."""

from .loop import predict

__all__ = ["predict"]
