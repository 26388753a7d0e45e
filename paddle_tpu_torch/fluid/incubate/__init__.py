"""``fluid.incubate`` (ref: python/paddle/fluid/incubate/__init__.py):
fleet and data_generator, where 1.8-era user code imports them."""

from . import data_generator  # noqa: F401
from . import fleet  # noqa: F401
