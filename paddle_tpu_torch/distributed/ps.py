"""Parameter-server training (sync, async and geo).

Counterpart of ``paddle_tpu.distributed.ps``, over the same native
service (``csrc/ps_service.cc``, through ``native.PsServer`` /
``native.PsClient``): the reference's DistributeTranspiler split of the
parameters into blocks spread over the pserver shards (``_split_blocks``),
the listen_and_serv optimize blocks as server-side optimizers, the
communicator modes (sync: the shards apply the mean of every trainer's
push, then bump a version each trainer waits for; async: each push
applies at once; geo: the trainers step locally and push parameter deltas
every ``geo_k`` steps to ``sum`` tables), and distributed_lookup_table
(:class:`SparseEmbeddingPS`: rows by id, sharded by id modulo the shard
count, pulled before the forward and their gradients pushed after it).
``HeartbeatMonitor`` flags a worker that stopped beating.

The trainer's forward and backward run in PyTorch on the model's device
(the card unless the model was built on the CPU): the pulled values are
copied into the model's parameters, the gradients come back to the host
to be pushed. A port addition: ``PSTrainStep(..., sparse_tables={name: (table,
arg)})`` serves the 2-D parameter ``name`` from a ``SparseEmbeddingPS``
as distributed_lookup_table does: only the rows of the ids in positional
input ``arg`` are pulled into the parameter before the forward, and only
their gradients are pushed after it. The model must read no other row (an
untied embedding; a tied decoder reads every row, and a gradient outside
the ids raises). The sparse table applies each push at once, so in sync
mode each trainer pushes its rows' gradient over the trainer count, after
the dense pull (by then every trainer has pulled the step's rows), then
waits on a one-entry dense sync table for every trainer's push (so the
next pull sees them all). The table's rows, not the model's, are the
parameter's first values.
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import random as _random
from ..native import PsClient, PsServer

__all__ = [
    "PsServer", "PSCluster", "DensePSAdapter", "SparseEmbeddingPS",
    "PSTrainStep", "run_server", "HeartbeatMonitor",
]


class PSCluster:
    """Connections to every pserver shard."""

    def __init__(self, endpoints: Sequence[str], timeout_ms: int = 30000):
        self.endpoints = list(endpoints)
        self.clients: List[PsClient] = []
        for ep in self.endpoints:
            host, port = ep.rsplit(":", 1)
            self.clients.append(PsClient(host, int(port), timeout_ms))

    def __len__(self) -> int:
        return len(self.clients)

    def close(self) -> None:
        for c in self.clients:
            c.close()


def _split_blocks(name: str, size: int, n_servers: int,
                  min_block: int = 8192) -> List[Tuple[int, str, int, int]]:
    """Split a flat param into ≤n_servers blocks: (server, key, start, stop).

    Mirrors the reference's even block split across pservers
    (distribute_transpiler.py:1678 _init_splited_vars); small params stay
    whole on one shard (chosen by name hash for balance).
    """
    if size <= min_block or n_servers == 1:
        # crc32, not builtin hash(): hash() is salted per process, so two
        # trainer processes would map the same param to different shards
        # (sync accumulation never completes; async trains disjoint copies).
        server = zlib.crc32(name.encode("utf-8")) % n_servers
        return [(server, f"{name}.block0", 0, size)]
    n_blocks = min(n_servers, (size + min_block - 1) // min_block)
    per = (size + n_blocks - 1) // n_blocks
    blocks = []
    for b in range(n_blocks):
        start, stop = b * per, min((b + 1) * per, size)
        if start >= stop:
            break
        blocks.append((b % n_servers, f"{name}.block{b}", start, stop))
    return blocks


class DensePSAdapter:
    """Dense-parameter bridge: local param dict <-> sharded PS tables."""

    def __init__(self, cluster: PSCluster, params: Dict[str, np.ndarray],
                 optimizer: str = "sgd", lr: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 sync_world: int = 0):
        self.cluster = cluster
        self.shapes = {k: np.asarray(v).shape for k, v in params.items()}
        self.blocks: Dict[str, List[Tuple[int, str, int, int]]] = {}
        for name, value in params.items():
            flat = np.ascontiguousarray(value, np.float32).reshape(-1)
            blocks = _split_blocks(name, flat.size, len(cluster))
            self.blocks[name] = blocks
            for server, key, start, stop in blocks:
                cluster.clients[server].dense_init(
                    key, flat[start:stop], stop - start, optimizer=optimizer,
                    lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                    sync_world=sync_world)

    def push(self, grads: Dict[str, np.ndarray]) -> int:
        version = 0
        for name, g in grads.items():
            flat = np.ascontiguousarray(g, np.float32).reshape(-1)
            for server, key, start, stop in self.blocks[name]:
                version = self.cluster.clients[server].dense_push(
                    key, flat[start:stop])
        return version

    def pull(self, min_version: int = 0,
             timeout_ms: int = 60000) -> Dict[str, np.ndarray]:
        out = {}
        for name, blocks in self.blocks.items():
            size = int(np.prod(self.shapes[name])) if self.shapes[name] \
                else 1
            flat = np.empty(size, np.float32)
            for server, key, start, stop in blocks:
                vals, _ = self.cluster.clients[server].dense_pull(
                    key, stop - start, min_version, timeout_ms)
                flat[start:stop] = vals
            out[name] = flat.reshape(self.shapes[name])
        return out


class SparseEmbeddingPS:
    """An embedding table whose rows live on the PS
    (distributed_lookup_table): ``pull(ids)`` the rows of the ids,
    ``push(ids, grads)`` their gradients (the server's optimizer applies
    them; duplicate ids merged first). Rows shard across servers by id
    modulo the shard count."""

    def __init__(self, cluster: PSCluster, name: str, dim: int,
                 optimizer: str = "sgd", lr: float = 0.01,
                 init_scale: float = 0.05):
        self.cluster = cluster
        self.name = name
        self.dim = dim
        for c in cluster.clients:
            c.sparse_init(name, dim, optimizer=optimizer, lr=lr,
                          init_scale=init_scale)

    def _shard(self, ids: np.ndarray) -> List[np.ndarray]:
        n = len(self.cluster)
        return [np.where(ids % n == s)[0] for s in range(n)]

    def pull(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        out = np.empty((ids.size, self.dim), np.float32)
        for s, idx in enumerate(self._shard(ids)):
            if idx.size:
                out[idx] = self.cluster.clients[s].sparse_pull(
                    self.name, ids[idx], self.dim)
        return out

    def push(self, ids: np.ndarray, grads: np.ndarray) -> None:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, np.float32).reshape(
            ids.size, self.dim)
        # Merge duplicate ids before pushing (reference merge_sparse_grad
        # semantics): the server applies its per-row optimizer once per
        # received row, so duplicates would take multiple adagrad/adam slot
        # steps for one batch.
        if ids.size:
            uniq, inv = np.unique(ids, return_inverse=True)
            if uniq.size != ids.size:
                summed = np.zeros((uniq.size, self.dim), np.float32)
                np.add.at(summed, inv, grads)
                ids, grads = uniq, summed
        for s, idx in enumerate(self._shard(ids)):
            if idx.size:
                self.cluster.clients[s].sparse_push(
                    self.name, ids[idx], grads[idx], self.dim)

    def size(self) -> int:
        return sum(c.sparse_size(self.name) for c in self.cluster.clients)


class PSTrainStep:
    """The trainer's step of PS training (see the module note).

    mode="sync":  push the gradients, pull the parameters of version
                  ``step`` (every trainer's push applied).
    mode="async": push the gradients (applied at once), pull the latest.
    mode="geo":   ``geo_k`` local steps of ``local_optimizer``, then push
                  the parameter deltas to ``sum`` tables and adopt the
                  merged values.

    ``step(*args, labels=(...))`` returns ``{"loss": float}``."""

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 cluster: PSCluster, mode: str = "sync", n_trainers: int = 1,
                 optimizer: str = "sgd", lr: float = 0.01, geo_k: int = 8,
                 local_optimizer=None, seed: int = 0,
                 sparse_tables: Optional[
                     Dict[str, Tuple["SparseEmbeddingPS", int]]] = None
                 ) -> None:
        if mode not in ("sync", "async", "geo"):
            raise ValueError(f"unknown PS mode {mode!r}")
        self.model = model
        self.loss_fn = loss_fn
        self.mode = mode
        self.geo_k = geo_k
        self.n_trainers = int(n_trainers)
        self.sparse_tables = dict(sparse_tables or {})
        if self.sparse_tables and mode == "geo":
            raise ValueError("PSTrainStep: sparse tables take pushed "
                             "gradients; geo mode pushes deltas")
        self._step_no = 0
        self._live = dict(model.named_parameters())
        self.device = next(iter(self._live.values())).device
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        params = {k: v.detach().float().cpu().numpy()
                  for k, v in self._live.items()
                  if k not in self.sparse_tables}
        if mode == "geo":
            if local_optimizer is None:
                raise ValueError("geo mode needs local_optimizer")
            self.local_opt = local_optimizer
            self._opt_state = local_optimizer.init(
                {k: self._live[k] for k in params})
            self.adapter = DensePSAdapter(cluster, params, optimizer="sum")
            self._base = {k: v.copy() for k, v in params.items()}
        else:
            sync_world = n_trainers if mode == "sync" else 0
            self.adapter = DensePSAdapter(
                cluster, params, optimizer=optimizer, lr=lr,
                sync_world=sync_world)
        self._params = params

    @torch.no_grad()
    def _load(self, values: Dict[str, np.ndarray]) -> None:
        for k, v in values.items():
            self._live[k].copy_(torch.from_numpy(v).to(self._live[k].dtype))

    def __call__(self, *args, labels=()) -> Dict[str, float]:
        labels = labels if isinstance(labels, (tuple, list)) else (labels,)
        args = tuple(torch.as_tensor(a).to(self.device) for a in args)
        labels = tuple(torch.as_tensor(y).to(self.device) for y in labels)
        self._load(self._params)
        rows = {}
        with torch.no_grad():
            for name, (table, arg) in self.sparse_tables.items():
                rows[name] = np.unique(args[arg].cpu().numpy())
                at = torch.from_numpy(rows[name]).to(self.device)
                self._live[name][at] = torch.from_numpy(
                    table.pull(rows[name])).to(self.device,
                                               self._live[name].dtype)
        with _random.rng_scope(default=self.generator,
                               dropout=self.generator):
            out = self.model(*args)
            loss = self.loss_fn(out, *labels)
        names = list(self._live)
        grads = torch.autograd.grad(loss, [self._live[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self._live[n]) if g is None else g
                 for n, g in zip(names, grads)}
        self._step_no += 1
        sparse = {}
        for name, (_, arg) in self.sparse_tables.items():
            g = grads.pop(name)
            at = torch.from_numpy(rows[name]).to(self.device)
            if bool(g.index_fill(0, at, 0.0).ne(0).any()):
                raise ValueError(
                    f"PSTrainStep: {name!r} is read outside the ids of "
                    f"input {arg} (a tied decoder?); a sparse table "
                    f"serves a lookup only")
            sparse[name] = g[at].float().cpu().numpy()
        if self.mode == "geo":
            self.local_opt.apply_gradients(
                {k: self._live[k] for k in self._params}, grads,
                self._opt_state)
            self._params = {k: self._live[k].detach().float().cpu().numpy()
                            for k in self._params}
            if self._step_no % self.geo_k == 0:
                deltas = {k: self._params[k] - self._base[k]
                          for k in self._params}
                self.adapter.push(deltas)
                merged = self.adapter.pull()
                self._params = merged
                self._base = {k: v.copy() for k, v in merged.items()}
        else:
            self.adapter.push({k: g.float().cpu().numpy()
                               for k, g in grads.items()})
            min_version = self._step_no if self.mode == "sync" else 0
            self._params = self.adapter.pull(min_version=min_version)
        self._push_sparse(rows, sparse)
        return {"loss": float(loss.detach())}

    def _push_sparse(self, rows, sparse) -> None:
        """The looked-up rows' gradients. In sync mode they go after the
        dense pull (every trainer has pulled this step's rows by then),
        each over the trainer count, and a one-entry sync table then waits
        for every trainer's push, so the next step's pull sees them
        all."""
        for name, g in sparse.items():
            if self.mode == "sync":
                g = g / self.n_trainers
            self.sparse_tables[name][0].push(rows[name], g)
        if sparse and self.mode == "sync":
            cli = self.adapter.cluster.clients[0]
            if self._step_no == 1:
                cli.dense_init("__sparse_barrier", np.zeros(1, np.float32),
                               1, optimizer="sum",
                               sync_world=self.n_trainers)
            cli.dense_push("__sparse_barrier", np.zeros(1, np.float32))
            cli.dense_pull("__sparse_barrier", 1, min_version=self._step_no)

    @property
    def params(self) -> Dict[str, np.ndarray]:
        """The dense parameters as the last pull (or local step) left
        them, name -> numpy array."""
        return self._params

    def sync_to_model(self) -> None:
        """Writes the dense parameters into the model (a sparse-table
        parameter holds the rows of its last lookup)."""
        self._load(self._params)


def run_server(port: int = 0, ready_callback: Optional[Callable] = None,
               stop_event: Optional[threading.Event] = None) -> PsServer:
    """Start a PS shard; blocks until stop_event (if given) else returns.

    The reference blocks inside ListenAndServOp::RunImpl; here the server
    runs on background threads, so blocking is optional.
    """
    server = PsServer(port)
    if ready_callback is not None:
        ready_callback(server)
    if stop_event is not None:
        try:
            while not stop_event.wait(0.2):
                pass
        finally:
            server.stop()
    return server


class HeartbeatMonitor:
    """Worker liveness over the PS (ref: heart_beat_monitor.cc — the
    pserver-side monitor flagging workers that stop calling in).

    Each worker runs ``start_beating(worker_id)`` (background thread,
    one beat per ``interval_s``); any process can ask
    ``dead_workers(workers, timeout_ms)``. Failure DETECTION half of
    the elastic story — restart orchestration is
    ``distributed.launch --elastic``.
    """

    def __init__(self, client, interval_s: float = 2.0) -> None:
        self.client = client
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start_beating(self, worker_id: str) -> None:
        if self._thread is not None:
            raise RuntimeError("already beating")
        self._stop.clear()  # allow stop() -> start_beating() restarts
        self.client.heartbeat(worker_id)  # immediate first beat

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.client.heartbeat(worker_id)
                except Exception:
                    return  # connection gone; the monitor sees silence

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def dead_workers(self, workers, timeout_ms: int):
        """Workers whose last beat is older than timeout_ms (or that
        never beat)."""
        dead = []
        for w in workers:
            ms = self.client.liveness_ms(w)
            if ms is None or ms > timeout_ms:
                dead.append(w)
        return dead

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
