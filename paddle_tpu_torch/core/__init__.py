"""Core runtime pieces of the PyTorch package (devices and places,
random number streams, LoD conversion)."""

from . import lod, random
from .dtype import convert_dtype, get_default_dtype, set_default_dtype
from .place import (CPUPlace, CUDAPlace, Place, accelerator_available,
                    device_count, get_device, is_compiled_with_cuda,
                    local_devices, resolve_device, set_device)

__all__ = ["random", "lod", "resolve_device", "Place", "CPUPlace",
           "CUDAPlace", "set_device", "get_device", "device_count",
           "local_devices", "is_compiled_with_cuda",
           "accelerator_available", "convert_dtype", "get_default_dtype",
           "set_default_dtype"]
