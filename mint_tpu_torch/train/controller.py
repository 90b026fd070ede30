"""The training/eval controller (counterpart of
``mint_tpu/train/controller.py``, the Orbit equivalent):

- ``train(until_step)`` runs train steps in loops of ``steps_per_loop``
  until the ABSOLUTE step `until_step`, writing summaries every
  ``summary_interval`` steps and offering a checkpoint at every loop
  boundary (the manager saves when its interval has elapsed); with
  ``fuse_loop`` each loop's batches are stacked and run by
  ``Trainer.train_steps``, as the JAX controller runs each loop as one
  compiled ``lax.scan``;
- the latest checkpoint is restored at construction;
- ``evaluate()`` runs the evaluator once; ``evaluate_continuously`` restores
  and evaluates each new checkpoint until none appears for `timeout`
  seconds.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, Optional

from mint_tpu_torch.train.checkpoint import CheckpointManager
from mint_tpu_torch.train.metrics_io import MetricsWriter
from mint_tpu_torch.train.trainer import Trainer, TrainState
from mint_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger(__name__)


class Controller:
    def __init__(self,
                 trainer: Optional[Trainer] = None,
                 train_iter: Optional[Iterator] = None,
                 state: Optional[TrainState] = None,
                 evaluator=None,
                 steps_per_loop: int = 10,
                 checkpoint_manager: Optional[CheckpointManager] = None,
                 summary_dir: Optional[str] = None,
                 summary_interval: int = 10,
                 fuse_loop: bool = False,
                 train_sampler=None,
                 sample_seed: int = 0):
        """``fuse_loop``: run each ``steps_per_loop`` window through
        ``Trainer.train_steps`` on the window's batches, stacked (the JAX
        controller's option: one ``lax.scan`` dispatch a window there, one
        copy of the window to the device and a replay of the step's graph a
        step here).  ``train_iter`` then yields host (numpy) batches, as
        in JAX, so no other thread copies to the device while a step is
        captured; per-step mode also takes device batches.

        ``train_sampler``: a DeviceDataset; when given, batches are drawn
        on the device (``Trainer.train_steps_sampled``) and ``train_iter``
        is not read.  Draws are seeded from ``sample_seed`` and the
        ABSOLUTE step, so a resumed run draws the windows it would have
        drawn uninterrupted.

        `evaluator` is any object with ``evaluate(state) -> dict``."""
        self.trainer = trainer
        self.train_iter = train_iter
        self.train_sampler = train_sampler
        self.sample_seed = sample_seed
        self.state = state
        self.evaluator = evaluator
        self.steps_per_loop = steps_per_loop
        self.fuse_loop = fuse_loop
        self.checkpoint_manager = checkpoint_manager
        self.summary_interval = summary_interval
        self.metrics_writer = MetricsWriter(summary_dir)
        self._pending = None

        # Resume from the latest checkpoint if one exists.
        self._restored_step: Optional[int] = None
        if checkpoint_manager is not None and state is not None:
            if checkpoint_manager.latest_step() is not None:
                self.state = self._restore(state)
                self._restored_step = int(self.state.step)
                log.info("restored checkpoint at step %d",
                         int(self.state.step))

    def _restore(self, template: TrainState,
                 step: Optional[int] = None) -> TrainState:
        """Full restore for training; params-ONLY restore when the
        template has no optimizer state (the evaluator side)."""
        if template.opt_state is None:
            if step is None:
                step = self.checkpoint_manager.latest_step()
            params = self.checkpoint_manager.restore_params(
                template.params, step=step)
            # The controller saves at step == global_step, so the
            # directory's label is the state's step.
            return TrainState(step=step, params=params, opt_state=None)
        return self.checkpoint_manager.restore(template, step=step)

    @property
    def global_step(self) -> int:
        return int(self.state.step) if self.state is not None else 0

    def train(self, until_step: int) -> Dict[str, float]:
        """Train until ``global_step`` reaches `until_step` (ABSOLUTE): a
        resumed run continues from its checkpoint and stops at the same
        budget, and calling train again with the same target is a
        no-op."""
        if self.trainer is None:
            raise ValueError("Controller.train needs a trainer")
        if self.train_iter is None and self.train_sampler is None:
            raise ValueError("Controller.train needs a train_iter or a "
                             "train_sampler")
        timer = StepTimer()
        # A loop's metrics (the loss is a tensor on the device) are read
        # only once the next loop is queued: reading them blocks until
        # the device has caught up.
        try:
            metrics = self._train_loops(until_step, timer)
        except BaseException:
            # The previous loop completed; a failure in the next one (an
            # exhausted iterator, a device fault, KeyboardInterrupt) must
            # not lose its summary: a resumed run never rewrites a passed
            # interval.
            pending, self._pending = self._pending, None
            if pending is not None:
                try:
                    self._flush_loop_metrics(*pending, timer)
                except Exception:
                    log.exception("could not flush the last loop's metrics")
            # Let an in-flight save finish, so the resumed run restores
            # this interval; its own failure must not mask the original
            # exception.
            if self.checkpoint_manager is not None:
                try:
                    self.checkpoint_manager.join_async_save()
                except Exception:
                    log.exception("the in-flight checkpoint save failed")
            raise
        pending, self._pending = self._pending, None
        if pending is not None:
            metrics = self._flush_loop_metrics(*pending, timer)
        return metrics

    def _train_loops(self, until_step: int, timer) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        self._pending = None  # (step, loop, step_metrics)
        while self.global_step < until_step:
            loop = min(self.steps_per_loop, until_step - self.global_step)
            if self.train_sampler is not None:
                self.state, step_metrics = self.trainer.train_steps_sampled(
                    self.state, self.train_sampler, loop,
                    seed=self.sample_seed)
                for _ in range(loop):
                    timer.step()
            elif self.fuse_loop:
                stacked = self.trainer.stack_batches(
                    [next(self.train_iter) for _ in range(loop)])
                self.state, step_metrics = self.trainer.train_steps(
                    self.state, stacked)
                for _ in range(loop):
                    timer.step()
            else:
                for _ in range(loop):
                    batch = next(self.train_iter)
                    self.state, step_metrics = self.trainer.train_step(
                        self.state, batch)
                    timer.step()
            if self._pending is not None:
                metrics = self._flush_loop_metrics(*self._pending, timer)
                self._pending = None
            step = self.global_step
            self._pending = (step, loop, step_metrics)
            if self.checkpoint_manager is not None \
                    and self.checkpoint_manager.would_save(step):
                # A checkpoint must never outlive its summary (a kill after
                # the save but before the write would leave a resumed run
                # a gap at exactly the restore step), so on save loops the
                # summary is written first.
                metrics = self._flush_loop_metrics(*self._pending, timer)
                self._pending = None
                self.checkpoint_manager.save_async(step, self.state)
        return metrics

    def _flush_loop_metrics(self, step: int, loop: int, step_metrics,
                            timer) -> Dict[str, float]:
        """Read one loop's metrics (blocking) and write and log them."""
        metrics = {k: float(v) for k, v in step_metrics.items()}
        metrics.update(timer.metrics())
        if self.summary_interval and step % self.summary_interval < loop:
            self.metrics_writer.write(step, metrics)
        log.info("step %d: %s", step, metrics)
        return metrics

    def evaluate(self) -> Dict[str, float]:
        if self.evaluator is None:
            raise ValueError("Controller.evaluate needs an evaluator")
        return self.evaluator.evaluate(self.state)

    def evaluate_continuously(self, timeout: float = 70000,
                              poll_seconds: float = 10.0
                              ) -> Dict[str, float]:
        """Evaluate every new checkpoint until none appears for
        `timeout` s."""
        if self.evaluator is None or self.checkpoint_manager is None:
            raise ValueError("evaluate_continuously needs an evaluator and "
                             "a checkpoint manager")
        results: Dict[str, float] = {}
        for step in self.checkpoint_manager.checkpoints_iterator(
                timeout, poll_seconds):
            # The constructor restored the latest checkpoint, and the
            # iterator's first yield is that same step: do not read it
            # twice.  _restored_step (not state.step) is the marker: a
            # template whose step equals a new checkpoint's label was never
            # restored.
            if self._restored_step != step:
                self.state = self._restore(self.state, step=step)
                self._restored_step = step
            results = self.evaluator.evaluate(self.state)
            self.metrics_writer.write(step, results)
        return results

    def save_checkpoint(self, force: bool = True) -> None:
        if self.checkpoint_manager is not None:
            self.checkpoint_manager.save(self.global_step, self.state,
                                         force=force)
            self.checkpoint_manager.wait_until_finished()

    def close(self) -> None:
        self.metrics_writer.close()
        if self.checkpoint_manager is not None:
            self.checkpoint_manager.close()
