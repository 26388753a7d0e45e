"""``fluid.incubate.fleet.base.role_maker`` (ref: incubate/fleet/base/
role_maker.py): role makers read rank, size and endpoints from the
environment the launcher sets."""

from .....distributed.fleet.base import (  # noqa: F401
    PaddleCloudRoleMaker, UserDefinedRoleMaker)
