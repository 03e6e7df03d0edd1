"""Training loop with fault tolerance, counterpart of
``repro/train/trainer.py``:

  * checkpoint/restart: ``CheckpointManager`` (atomic, async, keep-N); the
    loop resumes from the latest committed step, and the data stream is a
    pure function of the step, so a preempted job replays nothing.
  * preemption: SIGTERM sets a flag; the loop then makes a final blocking
    save and returns.
  * straggler watchdog: an EWMA of the step time; a step slower than
    ``straggler_factor`` times the EWMA is logged (and can abort to
    restart).

A step's time runs to a host sync on its loss (``float``), the
counterpart of ``jax.block_until_ready``. There is no ``jax.jit`` and no
donation: the train step updates the state in place.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from ..checkpoint.manager import CheckpointManager
from ..optim import OptimizerConfig
from .step import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "repro_torch_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_abort: bool = False
    microbatches: int = 1


@dataclass
class StragglerWatchdog:
    factor: float = 3.0
    ewma: Optional[float] = None
    alpha: float = 0.1
    events: List[dict] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
        # the EWMA excludes straggler steps, so one hiccup does not mask
        # the next
        if not slow:
            self.ewma = dt if self.ewma is None else (
                (1 - self.alpha) * self.ewma + self.alpha * dt)
        return slow


class Trainer:
    def __init__(self, cfg: TrainerConfig, loss_fn: Callable,
                 init_fn: Callable, opt_cfg: OptimizerConfig, data):
        self.cfg = cfg
        self.data = data
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints)
        self.train_step = make_train_step(loss_fn, opt_cfg,
                                          microbatches=cfg.microbatches)
        self.init_fn = init_fn
        self.watchdog = StragglerWatchdog(factor=cfg.straggler_factor)
        self._preempted = False
        self.metrics_history: List[dict] = []

    def _install_preemption_hook(self):
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    def run(self, gen, start_state: Any = None) -> Any:
        """Train to ``total_steps`` from the latest checkpoint, else from
        ``start_state``, else from ``init_fn(gen)``; returns the state."""
        self._install_preemption_hook()
        start_step = self.ckpt.latest_step()
        if start_step is not None:
            # the target gives the structure and the devices; it is the
            # start state when given, else a fresh init
            target = (start_state if start_state is not None
                      else init_train_state(gen, self.init_fn))
            state = self.ckpt.restore(start_step, target)
            del target
            print(f"[trainer] resumed from step {start_step}")
        else:
            start_step = 0
            state = (start_state if start_state is not None
                     else init_train_state(gen, self.init_fn))

        step = start_step
        while step < self.cfg.total_steps:
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["total_loss"])  # host sync on the step
            dt = time.perf_counter() - t0
            if self.watchdog.observe(step, dt):
                print(f"[watchdog] straggler step {step}: {dt:.3f}s "
                      f"(ewma {self.watchdog.ewma:.3f}s)")
                if self.cfg.straggler_abort:
                    self.ckpt.save(step, state, blocking=True)
                    raise RuntimeError("straggler abort -> restart")
            step += 1
            if step % self.cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["step_time"] = dt
                self.metrics_history.append(m)
                print(f"[trainer] step {step}: loss={loss:.4f}"
                      f" lr={m.get('lr', 0):.2e} dt={dt:.3f}s")
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save_async(step, state)
            if self._preempted:
                print(f"[trainer] preempted at step {step}; checkpointing")
                self.ckpt.wait()
                self.ckpt.save(step, state, blocking=True)
                return state
        self.ckpt.wait()
        self.ckpt.save(step, state, blocking=True)
        return state
