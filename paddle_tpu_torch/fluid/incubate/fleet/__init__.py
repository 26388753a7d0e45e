"""``fluid.incubate.fleet`` (ref: incubate/fleet/): the 1.8 fleet import
tree, every road to the port's fleet singleton."""

from . import base  # noqa: F401
from . import collective  # noqa: F401
from . import parameter_server  # noqa: F401
