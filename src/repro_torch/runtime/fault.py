"""Fault tolerance: checkpoint/restart driver, straggler monitoring,
elastic-mesh policy; the port of ``repro/runtime/fault.py`` (hardware
free: the same code, without the reference's mesh-API shim).

Design for 1000+ nodes (DESIGN.md §5):
  * the training step is pure and the data pipeline is a function of
    (seed, step), so recovery = restore latest checkpoint + fast-forward
    the step counter — no replay log needed;
  * node failure surfaces as an exception from the step (collective error /
    heartbeat timeout upstream); `run_with_restarts` restores and, when a
    `remesh` callback is provided, rebuilds the step for a smaller healthy
    mesh (elastic scaling) before resuming;
  * stragglers are detected from a step-latency EMA; the policy object only
    *decides* (log / skip-shard / remesh) — enforcement hooks live with the
    launcher, keeping this module hardware-free and unit-testable.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class FaultConfig:
    max_restarts: int = 3
    ckpt_interval: int = 50
    straggler_factor: float = 3.0     # step slower than factor x EMA
    straggler_patience: int = 2       # consecutive slow steps before action
    ema_alpha: float = 0.2


class StragglerMonitor:
    """Step-latency EMA; flags persistent stragglers."""

    def __init__(self, cfg: FaultConfig, clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.ema: Optional[float] = None
        self.slow_streak = 0
        self.events: list = []
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = self.clock()

    def end_step(self, step: int) -> bool:
        """Returns True when straggler mitigation should trigger."""
        dt = self.clock() - self._t0
        if self.ema is None:
            self.ema = dt
            return False
        is_slow = dt > self.cfg.straggler_factor * self.ema
        if is_slow:
            self.slow_streak += 1
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
            log.warning("straggler suspected at step %d: %.3fs vs EMA %.3fs",
                        step, dt, self.ema)
        else:
            self.slow_streak = 0
            self.ema = (1 - self.cfg.ema_alpha) * self.ema \
                + self.cfg.ema_alpha * dt
        return self.slow_streak >= self.cfg.straggler_patience


def run_with_restarts(*, make_step, init_state, data_for_step, n_steps: int,
                      manager, cfg: FaultConfig = FaultConfig(),
                      remesh: Optional[Callable] = None,
                      monitor: Optional[StragglerMonitor] = None,
                      meta: Optional[dict] = None):
    """Run `n_steps`, surviving step exceptions via checkpoint/restart.

    make_step()            -> step function (state, batch) -> (state, metrics)
    data_for_step(step)    -> batch (deterministic!)
    remesh()               -> called after a failure; may rebuild meshes and
                              return a fresh make_step (elastic scaling)
    Returns (state, history dict).
    """
    state = init_state
    step_fn = make_step()
    start = 0
    restored, man = manager.restore_latest(like=state)
    if restored is not None:
        state, start = restored, man["step"]
        log.info("resumed from checkpoint at step %d", start)

    history = {"restarts": 0, "completed": [], "straggler_events": []}
    step = start
    restarts = 0
    while step < n_steps:
        try:
            if monitor:
                monitor.start_step()
            state, metrics = step_fn(state, data_for_step(step))
            if monitor and monitor.end_step(step):
                history["straggler_events"].append(step)
            step += 1
            history["completed"].append(step)
            manager.maybe_save(step, state, dict(meta or {}, step=step))
        except Exception as e:   # noqa: BLE001 — any step fault
            restarts += 1
            history["restarts"] = restarts
            log.error("step %d failed (%s); restart %d/%d", step, e,
                      restarts, cfg.max_restarts)
            if restarts > cfg.max_restarts:
                raise
            restored, man = manager.restore_latest(like=state)
            if restored is not None:
                state, step = restored, man["step"]
            else:
                state, step = init_state, 0
            if remesh is not None:
                step_fn = remesh() or step_fn
    return state, history
