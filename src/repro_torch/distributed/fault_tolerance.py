"""Fault tolerance: failure injection, restart with resume, elastic
rescale (port of ``repro.distributed.fault_tolerance``).

  * :class:`FailureInjector`: a deterministic failure schedule for tests
    and drills (stands in for preemptions and hardware faults);
  * :func:`run_with_restarts`: the crash-looping driver: run, and on a
    failure restore the latest checkpoint and the data cursor and go on.
    It gives the same loss curve as an uninterrupted run, loss for loss,
    on one device or on a mesh (a placed state resumes onto its shards);
  * :func:`reshard_state`: elastic rescale, a state placed onto another
    mesh's shards (save on mesh A, resume on mesh B).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Set

from repro_torch.distributed import sharding
from repro_torch.train.checkpoint import CheckpointManager

Params = Any


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises SimulatedFailure at the given global step numbers (once each)."""
    fail_at: Set[int]
    fired: Set[int] = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


def run_with_restarts(*, state: Params, train_step: Callable,
                      data_factory: Callable[[int], Iterable],
                      num_steps: int, manager: CheckpointManager,
                      checkpoint_every: int,
                      injector: Optional[FailureInjector] = None,
                      max_restarts: int = 10):
    """Crash-looping training driver.

    ``data_factory(cursor)`` must return a deterministic iterator
    positioned at ``cursor`` batches consumed: a checkpoint stores the
    state at a step, so the resumed run sees exactly the batches the lost
    run would have. A restore lands on the devices of ``state``'s leaves,
    or, for a state placed on a mesh, on its shards (every rank of the mesh
    runs it in step). Returns (final_state, losses, restarts)."""
    like = state
    losses = {}
    restarts = 0
    start_step = 0

    while True:
        try:
            data = iter(data_factory(start_step))
            cur = state
            for step in range(start_step, num_steps):
                if injector is not None:
                    injector.check(step)
                batch = next(data)
                cur, metrics = train_step(cur, batch)
                losses[step] = float(metrics["loss"])
                if (step + 1) % checkpoint_every == 0:
                    manager.save(step + 1, cur)
            return cur, [losses[i] for i in range(num_steps)], restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            resumed_step, resumed = manager.resume(like)
            if resumed is not None:
                start_step, state = resumed_step, resumed
            else:
                start_step = 0


def reshard_state(state: Params, shardings: Params) -> Params:
    """Elastic rescale: every leaf of ``state`` (whole, or placed on
    another mesh, gathered first) placed onto the matching
    ``NamedSharding`` of ``shardings``."""
    return sharding.place(state, shardings)
