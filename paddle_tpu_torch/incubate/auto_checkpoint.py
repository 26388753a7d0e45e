"""Auto-checkpoint: resumable epoch ranges.

Counterpart of ``paddle_tpu.incubate.auto_checkpoint`` (the reference's
fluid/incubate/checkpoint/auto_checkpoint.py:265 TrainEpochRange: wraps
the epoch loop, saves periodically, and on a restart fast-forwards past
the completed epochs). The directory comes from the constructor or
``PT_CHECKPOINT_DIR``. Saves go through ``io.AsyncCheckpointer`` (the
host copies enqueued on the stream, written by a thread), and any tree
the caller registers rides along: a ``static.TrainStep``'s
``state_dict()`` with ``set_state_dict`` as its setter restores the
whole training state in place, so a captured step keeps its graph.

A restarted job builds the same ``TrainEpochRange`` and resumes after the
last completed epoch; SIGTERM finishes the epoch in flight, forces a
checkpoint and re-raises (``preemption.guard``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, Optional

from .. import io as io_mod
from .. import preemption as _preempt
from ..observability import flight as _flight

__all__ = ["TrainEpochRange", "train_epoch_range"]


class TrainEpochRange:
    """Iterates epochs with automatic save and resume::

        r = TrainEpochRange(max_epoch=10, save_dir=ckdir, name="job1")
        r.register("train", step.state_dict, step.set_state_dict)
        for epoch in r:           # skips the epochs already completed
            ... train one epoch ...
    """

    def __init__(self, max_epoch: int, save_dir: Optional[str] = None,
                 name: str = "acp", save_interval: int = 1,
                 max_to_keep: int = 3) -> None:
        save_dir = save_dir or os.environ.get("PT_CHECKPOINT_DIR")
        if save_dir is None:
            raise ValueError(
                "TrainEpochRange needs save_dir (or PT_CHECKPOINT_DIR)")
        self.max_epoch = int(max_epoch)
        self.save_interval = max(1, int(save_interval))
        self.name = name
        self._ckpt = io_mod.AsyncCheckpointer(
            os.path.join(save_dir, name), max_to_keep=max_to_keep)
        self._getters: Dict[str, Callable[[], Any]] = {}
        self._setters: Dict[str, Callable[[Any], None]] = {}
        self._start_epoch = 0
        # restore_latest skips corrupt or uncommitted checkpoints for the
        # newest intact one: the start epoch is the one restored
        self._restored_state, at = self._ckpt.restore_latest()
        if self._restored_state is not None:
            self._start_epoch = int(at)
            _flight.record("checkpoint_restore", name=name, epoch=at)
        self.restored = self._restored_state is not None

    def register(self, key: str, getter: Callable[[], Any],
                 setter: Optional[Callable[[Any], None]] = None) -> None:
        """Attaches a state tree to the checkpoint under ``key``. If a
        restore happened at construction, ``setter`` gets its leaves now
        (a flat dict of leaf paths below ``key``)."""
        self._getters[key] = getter
        if setter is not None:
            self._setters[key] = setter
            if self._restored_state is not None:
                sub = {k.split("/", 1)[1]: v
                       for k, v in self._restored_state.items()
                       if k.startswith(key + "/")}
                if sub:
                    setter(sub)

    def _save(self, step: int) -> None:
        state = {k: g() for k, g in self._getters.items()}
        self._ckpt.save(state, step=step)
        _flight.record("checkpoint_save", name=self.name, epoch=step)

    def get(self) -> Iterator[int]:
        """The epoch iterator (ref: TrainEpochRange.get :265). SIGTERM
        finishes the epoch in flight, forces and flushes an off-interval
        checkpoint, and re-raises (``preemption.guard``)."""
        with _preempt.guard() as guard:
            for epoch in range(self._start_epoch, self.max_epoch):
                yield epoch
                saved = False
                if (epoch + 1) % self.save_interval == 0 or \
                        epoch + 1 == self.max_epoch:
                    self._save(epoch + 1)
                    saved = True
                if guard.preempted:
                    if not saved:
                        self._save(epoch + 1)
                    self._ckpt.wait()
                    _flight.record("preempt_checkpoint", force=True,
                                   name=self.name, epoch=epoch + 1)
                    guard.reraise()
            self._ckpt.wait()

    def __iter__(self) -> Iterator[int]:
        return self.get()

    @property
    def start_epoch(self) -> int:
        return self._start_epoch


def train_epoch_range(max_epoch: int, save_checkpoint_inter: int = 1,
                      save_dir: Optional[str] = None,
                      name: str = "acp") -> TrainEpochRange:
    """The reference helper's spelling (auto_checkpoint.py
    train_epoch_range)."""
    return TrainEpochRange(max_epoch, save_dir=save_dir, name=name,
                           save_interval=save_checkpoint_inter)
