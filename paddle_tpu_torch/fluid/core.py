"""``fluid.core`` compatibility surface (ref: paddle/fluid/pybind/, the
reference's C++ binding module): the names user code touches."""

from ..core.place import CPUPlace, CUDAPlace  # noqa: F401
from ..static import Scope  # noqa: F401

CUDAPinnedPlace = CPUPlace  # pinned staging is core.arena's, not a place


def globals():  # noqa: A001  (reference spelling)
    """(ref: pybind global_var_getter) a mapping over the flag registry:
    ``core.globals()['FLAGS_check_nan_inf']``."""
    from ..flags import GLOBAL_FLAGS
    return _FlagsView(GLOBAL_FLAGS)


class _FlagsView:
    def __init__(self, registry) -> None:
        self._r = registry

    def _key(self, name: str) -> str:
        return name[6:] if name.startswith("FLAGS_") else name

    def __getitem__(self, name: str):
        return self._r.get(self._key(name))

    def __setitem__(self, name: str, value) -> None:
        self._r.set(self._key(name), value)

    def __contains__(self, name: str) -> bool:
        return self._key(name) in self._r.names()

    def keys(self):
        return self._r.names()
