"""``from paddle.fluid.incubate.fleet.collective import fleet``: the 1.8
collective-training entry (ref: incubate/fleet/collective/__init__.py),
the port's fleet singleton."""

from ....distributed.fleet import (DistributedStrategy,  # noqa: F401
                                   fleet)
