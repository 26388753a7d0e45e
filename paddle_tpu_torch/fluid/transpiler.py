"""``fluid.transpiler`` redirects (ref: python/paddle/fluid/
transpiler/distribute_transpiler.py). The transpiler rewrote a built
Program into PS/collective variants; here the distributed steps are
``distributed.fleet`` / ``parallel`` and the PS stack is
``distributed.ps``."""

from __future__ import annotations


class DistributeTranspilerConfig:
    """Accepted for import parity; its knobs map to
    fleet.DistributedStrategy fields."""

    def __init__(self) -> None:
        self.slice_var_up = True
        self.split_method = None
        self.min_block_size = 8192


class DistributeTranspiler:
    def __init__(self, config=None) -> None:
        self.config = config or DistributeTranspilerConfig()

    def transpile(self, *a, **k):
        raise NotImplementedError(
            "program transpilation has no counterpart here: use "
            "fleet.DistributedStrategy + parallel.ShardedTrainStep for "
            "collective training, or distributed.ps for the parameter-"
            "server mode (sync/async/geo)")


class PSDispatcher:
    """(ref: transpiler/ps_dispatcher.py:18) dispatch(varlist) -> one
    endpoint per var; reset() rewinds the round-robin step."""

    def __init__(self, pserver_endpoints) -> None:
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self) -> None:
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError("use HashName or RoundRobin")

    @staticmethod
    def _var_name(v) -> str:
        if isinstance(v, str):
            return v
        name = getattr(v, "name", None)
        return name() if callable(name) else str(name)


class HashName(PSDispatcher):
    """(ref: ps_dispatcher.py:55) stable name-hash placement."""

    @staticmethod
    def _hash_block(name: str, total: int) -> int:
        import hashlib
        # stable across processes (builtin hash() is salted per run —
        # workers and servers must agree on placement)
        return int(hashlib.md5(name.encode()).hexdigest(), 16) % total

    def dispatch(self, varlist):
        return [self._eps[self._hash_block(self._var_name(v),
                                           len(self._eps))]
                for v in varlist]


class RoundRobin(PSDispatcher):
    """(ref: ps_dispatcher.py:93)."""

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eps[self._step])
            self._step = (self._step + 1) % len(self._eps)
        return out
