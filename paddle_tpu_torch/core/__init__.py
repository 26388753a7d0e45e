"""Core runtime pieces of the PyTorch package (device resolution)."""

from .place import resolve_device

__all__ = ["resolve_device"]
