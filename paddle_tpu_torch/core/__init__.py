"""Core runtime pieces of the PyTorch package (device resolution, random
number streams)."""

from . import random
from .place import resolve_device

__all__ = ["random", "resolve_device"]
