"""Fault tolerance: restartable step loop, straggler deadline, fault
injection (torch twin of ``repro.distributed.fault``).

A failed or stuck *step* never loses more than the work since the last
checkpoint:

  * ``RestartableLoop`` wraps the train step. A ``StepFault`` or
    ``StragglerTimeout`` inside a step restores the newest complete
    checkpoint and replays from its step. The data pipeline is
    stateless-indexable (``batch_at(step)``) and the step deterministic,
    so the replay is bit-identical (on the card under
    ``torch.use_deterministic_algorithms``: its atomics otherwise sum in
    a run-dependent order).
  * ``DeadlineMonitor`` flags a step that ran past ``deadline_s`` (a hung
    collective, a dead host), surfaced as ``StragglerTimeout`` after the
    step.
  * ``FaultInjector`` fails chosen steps (or sleeps to fake a straggler),
    so the recovery path is testable on one host.

Pass ``registry=`` (a ``repro_torch.obs.MetricsRegistry``) to mirror the
``LoopReport`` counters into the reference's metrics: steps run, faults,
restarts, restores, checkpoints, and the wall time redone
(``fault_time_lost_seconds``: from the restored-from checkpoint to each
fault). A restored state lands on the devices of the state it replaces.

On a mesh (``mesh=``, a ``launch/steps.TrainMesh``) every rank runs the
loop on its slice of the state: a checkpoint is the whole tree, gathered
and written by rank 0 (``store.save_sharded``), and a restore reads it
and cuts each rank's slice. An injected fault or a straggler on one rank
is agreed by an all-reduce of a flag before the loop acts on it, so every
rank restores together (a fault raised inside a step's collectives on
one rank alone would stall the others until the collective timeout).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import store


class StepFault(RuntimeError):
    """A step failed (injected or real)."""


class StragglerTimeout(RuntimeError):
    """A step exceeded its deadline."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault plan: {step: 'fail' | 'hang'}."""

    plan: Dict[int, str] = dataclasses.field(default_factory=dict)
    fired: Dict[int, str] = dataclasses.field(default_factory=dict)
    hang_s: float = 0.5

    def check(self, step: int) -> None:
        action = self.plan.get(step)
        if action and step not in self.fired:
            self.fired[step] = action
            if action == "fail":
                raise StepFault(f"injected failure at step {step}")
            if action == "hang":
                time.sleep(self.hang_s)


class DeadlineMonitor:
    """Watchdog: mark step start/end; a step running past ``deadline_s``
    flags a straggler, surfaced as StragglerTimeout at the next poll."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._start: Optional[float] = None
        self._lock = threading.Lock()
        self.tripped = False

    def begin(self) -> None:
        with self._lock:
            self._start = time.monotonic()

    def end(self) -> None:
        with self._lock:
            if (self._start is not None
                    and time.monotonic() - self._start > self.deadline_s):
                self.tripped = True
            self._start = None

    def raise_if_tripped(self) -> None:
        if self.tripped:
            self.tripped = False
            raise StragglerTimeout(
                f"step exceeded {self.deadline_s}s deadline")


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    restores: int = 0
    faults_seen: int = 0


class RestartableLoop:
    """Checkpoint-restore step loop.

    ``step_fn(state, batch) -> (state, metrics)`` must be deterministic
    (it may update the state in place); ``make_batch(step)`` must be a
    pure function of the step index. The step's work must reach the
    device clock inside ``step_fn`` (read a value to the host) for the
    deadline to cover it."""

    def __init__(
        self,
        step_fn: Callable[[Any, Any], Any],
        make_batch: Callable[[int], Any],
        ckpt_dir: str,
        *,
        ckpt_every: int = 50,
        max_restarts: int = 10,
        deadline_s: float = 1e9,
        injector: Optional[FaultInjector] = None,
        async_ckpt: bool = False,
        registry: Optional[Any] = None,
        mesh: Optional[Any] = None,
    ):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.monitor = DeadlineMonitor(deadline_s)
        self.injector = injector
        self.mesh = mesh
        root = mesh is None or mesh.rank == 0
        self.writer = (store.AsyncWriter(ckpt_dir) if async_ckpt and root
                       else None)
        self.report = LoopReport()
        self._last_ckpt_t: Optional[float] = None
        if registry is not None:
            self._m_steps = registry.counter(
                "fault_steps_run_total", "train steps completed by the "
                "restartable loop", unit="steps")
            self._m_faults = registry.counter(
                "fault_faults_total", "step faults seen (injected or "
                "real, incl. straggler deadline trips)", unit="faults")
            self._m_restarts = registry.counter(
                "fault_restarts_total", "successful restore-and-replay "
                "restarts", unit="restarts")
            self._m_restores = registry.counter(
                "fault_restores_total", "checkpoint restores performed",
                unit="restores")
            self._m_ckpts = registry.counter(
                "fault_checkpoints_total", "checkpoints written (sync "
                "and async submits)", unit="checkpoints")
            self._g_time_lost = registry.gauge(
                "fault_time_lost_seconds", "cumulative wall time redone: "
                "step work between the restored-from checkpoint and each "
                "fault", unit="seconds")
        else:
            self._m_steps = self._m_faults = self._m_restarts = None
            self._m_restores = self._m_ckpts = self._g_time_lost = None

    def _save(self, state: Any, step: int) -> None:
        if self.mesh is not None:
            store.save_sharded(self.ckpt_dir, state, step, self.mesh,
                               self.writer)
        elif self.writer is not None:
            self.writer.submit(state, step)
        else:
            store.save(self.ckpt_dir, state, step)
        self._last_ckpt_t = time.monotonic()
        if self._m_ckpts is not None:
            self._m_ckpts.inc()

    def _restore_latest(self, like: Any):
        if self.mesh is not None:     # every rank reads the same newest
            if self.writer is not None:
                self.writer.flush()
            self.mesh.barrier()
        step = store.latest_step(self.ckpt_dir)
        if step is None:
            return None
        if self.mesh is not None:
            state = store.restore_sharded(self.ckpt_dir, step, like,
                                          self.mesh)
        else:
            state = store.place_like(
                store.restore(self.ckpt_dir, step, like), like)
        self.report.restores += 1
        if self._m_restores is not None:
            self._m_restores.inc()
        return step, state

    def _check_injector(self, step: int) -> None:
        """The injector's plan for ``step``; on a mesh a fault on any rank
        raises on every rank."""
        if self.mesh is None:
            self.injector.check(step)
            return
        err: Optional[StepFault] = None
        try:
            self.injector.check(step)
        except StepFault as e:
            err = e
        if self.mesh.any(err is not None):
            raise err or StepFault(f"a peer rank faulted at step {step}")

    def run(self, state: Any, start_step: int, n_steps: int):
        """Run ``n_steps`` with checkpoint/restart. Returns (state, metrics
        of the last step)."""
        step = start_step
        end = start_step + n_steps
        metrics = None
        restarts = 0
        # initial checkpoint so a step-0 failure is recoverable
        if store.latest_step(self.ckpt_dir) is None:
            self._save(state, step)
        while step < end:
            try:
                self.monitor.begin()
                if self.injector is not None:
                    self._check_injector(step)
                batch = self.make_batch(step)
                state, metrics = self.step_fn(state, batch)
                self.monitor.end()
                if self.mesh is not None and self.mesh.any(
                        self.monitor.tripped):
                    self.monitor.tripped = True
                self.monitor.raise_if_tripped()
                step += 1
                self.report.steps_run += 1
                if self._m_steps is not None:
                    self._m_steps.inc()
                if step % self.ckpt_every == 0:
                    self._save(state, step)
            except (StepFault, StragglerTimeout) as e:
                self.report.faults_seen += 1
                if self._m_faults is not None:
                    self._m_faults.inc()
                    if self._last_ckpt_t is not None:
                        self._g_time_lost.inc(
                            time.monotonic() - self._last_ckpt_t)
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                restored = self._restore_latest(state)
                if restored is None:
                    raise
                step, state = restored
                self.report.restarts += 1
                if self._m_restarts is not None:
                    self._m_restarts.inc()
        self._save(state, step)          # final checkpoint
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        return state, metrics
