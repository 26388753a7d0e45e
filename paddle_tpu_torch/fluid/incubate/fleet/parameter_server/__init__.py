from . import distribute_transpiler  # noqa: F401
