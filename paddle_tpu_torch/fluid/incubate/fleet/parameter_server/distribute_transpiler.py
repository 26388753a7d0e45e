"""``from paddle.fluid.incubate.fleet.parameter_server
.distribute_transpiler import fleet``: the 1.8 PS-mode entry (ref:
incubate/fleet/parameter_server/distribute_transpiler/__init__.py). The
PS runtime is ``distributed.ps``; the fleet singleton drives it through
``DistributedStrategy``."""

from ..... import distributed as _distributed
from .....distributed.fleet import (DistributedStrategy,  # noqa: F401
                                    fleet)

ps = _distributed.ps  # the sync/async/geo PS runtime
