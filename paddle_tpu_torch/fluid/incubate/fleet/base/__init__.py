from . import role_maker  # noqa: F401
