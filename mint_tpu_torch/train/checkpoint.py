"""Checkpoints of a TrainState (counterpart of
``mint_tpu/train/checkpoint.py``).

The card's machine has no orbax, so the port writes its own format: one
directory per step under the checkpoint directory, ``<dir>/<step>/``,
holding ``params.pt`` (the parameters) and ``opt_state.pt`` (the step and
the optimizer state), each a ``torch.save`` of CPU tensors.  A step is
written under a temporary name and renamed, so a directory named by a step
is always whole.  Reading the JAX package's orbax checkpoints is not done
here.

The manager keeps the JAX one's semantics: keep the last `max_to_keep`;
save when `save_interval_steps` have ELAPSED since the last save, not only
on exact multiples (the controller offers steps at loop boundaries, 1,
1 + loop, ..., which need never hit a multiple); ``would_save``;
``save_async`` with a background fetch and write, a grace period paid once
per drain and then a deferral, and a failure re-raised at the next join;
``restore``; ``restore_params``, which reads no optimizer state; and
``checkpoints_iterator``, whose timeout counts only time spent waiting.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, Mapping, Optional

import torch

from mint_tpu_torch.train.trainer import TrainState

PARAMS_FILE = "params.pt"
OPT_STATE_FILE = "opt_state.pt"


def _map_tensors(tree, fn):
    """`tree` (dicts of tensors and Python values) with `fn` applied to
    every tensor; other leaves pass through unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


def _like(loaded, template):
    """`loaded` moved onto the devices and dtypes of `template`, whose
    tensor names it must match."""
    if isinstance(template, torch.Tensor):
        if tuple(loaded.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(loaded.shape)} does "
                             f"not fit {tuple(template.shape)}")
        return loaded.to(device=template.device, dtype=template.dtype)
    if isinstance(template, Mapping):
        if set(loaded) != set(template):
            raise ValueError(
                f"checkpoint keys do not match: missing "
                f"{sorted(set(template) - set(loaded))}, extra "
                f"{sorted(set(loaded) - set(template))}")
        return {k: _like(loaded[k], v) for k, v in template.items()}
    return loaded


class CheckpointManager:
    """Saves and restores TrainStates under one directory."""

    def __init__(self, directory: str, save_interval_steps: int = 1000,
                 max_to_keep: int = 5, async_join_grace: float = 1.0):
        self.directory = os.path.abspath(directory)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        #: How long a non-forced :meth:`save_async` waits for a previous
        #: save's background drain before DEFERRING (returning False)
        #: instead of blocking.
        self.async_join_grace = async_join_grace
        os.makedirs(self.directory, exist_ok=True)
        self._save_thread: Optional[threading.Thread] = None
        self._save_exc: Optional[BaseException] = None
        self._inflight_step: Optional[int] = None
        # The drain we already paid `async_join_grace` for: later offers
        # against the same drain defer at once instead of paying it again
        # at every loop boundary.
        self._graced_thread: Optional[threading.Thread] = None
        # Steps on disk, as this process knows them; `would_save` reads
        # this and `_inflight_step`, never the directory, so it does not
        # block or race the save thread.
        self._known_steps = set(self.all_steps())

    # -- the directory ----------------------------------------------------

    def all_steps(self) -> list[int]:
        """Steps with a whole checkpoint on disk, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit())

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write(self, step: int, params: Dict[str, torch.Tensor],
               rest: Dict[str, Any]) -> None:
        """Write one step's files under a temporary name, rename it into
        place, then drop the oldest steps beyond `max_to_keep`."""
        tmp = f"{self._path(step)}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(params, os.path.join(tmp, PARAMS_FILE))
        torch.save(rest, os.path.join(tmp, OPT_STATE_FILE))
        final = self._path(step)
        if os.path.exists(final):  # a forced re-save of a step
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    @staticmethod
    def _to_host(state: TrainState):
        """(params, {step, opt_state}) with every tensor on the CPU."""
        cpu = lambda t: t.detach().cpu()  # noqa: E731
        return (_map_tensors(state.params, cpu),
                {"step": int(state.step),
                 "opt_state": _map_tensors(state.opt_state, cpu)})

    # -- saving -----------------------------------------------------------

    def join_async_save(self) -> None:
        """Block until an in-flight :meth:`save_async` has written its
        step, re-raising its failure."""
        t = self._save_thread
        if t is not None:
            t.join()
            self._save_thread = None
            self._graced_thread = None
            step, self._inflight_step = self._inflight_step, None
            if self._save_exc is not None:
                exc, self._save_exc = self._save_exc, None
                raise exc
            if step is not None:
                self._known_steps.add(step)

    def would_save(self, step: int, force: bool = False) -> bool:
        """Whether :meth:`save` would write a checkpoint at `step` — lets
        callers order work that must precede a save (the controller writes
        the step's summary first: a checkpoint must never outlive its
        summary).  Never blocks: an in-flight save's step counts as
        saved."""
        inflight = self._inflight_step
        if step == inflight or step in self._known_steps:
            return False  # already saved (e.g. force-save after interval)
        last = max(self._known_steps) if self._known_steps else None
        if inflight is not None:
            last = inflight if last is None else max(last, inflight)
        return force or last is None \
            or step - last >= self.save_interval_steps

    def save(self, step: int, state: TrainState, force: bool = False
             ) -> bool:
        """Write `state` as `step` now, if the interval allows (or
        `force`)."""
        self.join_async_save()
        self._known_steps.update(self.all_steps())
        if not self.would_save(step, force):
            return False
        self._write(step, *self._to_host(state))
        self._known_steps.add(step)
        return True

    def save_async(self, step: int, state: TrainState,
                   force: bool = False) -> bool:
        """Save without stalling the caller on the device->host fetch and
        the file write.

        Copies `state`'s tensors into fresh device buffers (queued on the
        caller's stream, so they hold the state as it is now, whatever the
        next in-place train step does) and runs the fetch, one tensor at a
        time, and the write on a background thread.

        At most one save is in flight.  A non-forced save offered while
        the previous one is still draining waits up to `async_join_grace`
        (paid once per drain: later offers against the same drain defer at
        once) and then returns False: DEFERRED, not blocked.  The
        controller offers at every loop boundary, so the save lands at the
        first offer after the drain.  Forced saves, restore, wait and close
        join outright and re-raise the joined save's failure.

        The save thread is not a daemon: a process that exits without
        :meth:`close` still finishes the write instead of dropping it.
        Cost: the copy doubles the state's device memory until the fetch
        is done.
        """
        if not self.would_save(step, force):
            return False
        t = self._save_thread
        if t is not None and t.is_alive() and not force:
            if t is not self._graced_thread:
                t.join(timeout=self.async_join_grace)
            if t.is_alive():
                self._graced_thread = t
                return False
        self.join_async_save()  # serialize saves; surface prior failures
        if not self.would_save(step, force):  # re-check after the join
            return False
        snapshot = TrainState(
            step=int(state.step),
            params=_map_tensors(state.params, lambda x: x.detach().clone()),
            opt_state=_map_tensors(state.opt_state,
                                   lambda x: x.detach().clone()))

        held = [snapshot]

        def run():
            try:
                # pop: the device copies are freed once fetched
                host = self._to_host(held.pop())
                self._write(step, *host)
            except BaseException as exc:  # re-raised at the next join
                self._save_exc = exc

        self._inflight_step = step
        self._save_thread = threading.Thread(
            target=run, name=f"ckpt-save-{step}", daemon=False)
        self._save_thread.start()
        return True

    # -- restoring --------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        self.join_async_save()
        steps = self.all_steps()
        self._known_steps.update(steps)
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step

    def restore(self, state_template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """The TrainState saved at `step` (default: the latest), on the
        devices and dtypes of `state_template`'s tensors."""
        self.join_async_save()
        path = self._path(self._resolve(step))
        params = torch.load(os.path.join(path, PARAMS_FILE),
                            map_location="cpu", weights_only=True)
        rest = torch.load(os.path.join(path, OPT_STATE_FILE),
                          map_location="cpu", weights_only=True)
        return TrainState(
            step=rest["step"],
            params=_like(params, state_template.params),
            opt_state=_like(rest["opt_state"], state_template.opt_state))

    def restore_params(self, params_template: Mapping[str, torch.Tensor],
                       step: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
        """Only the parameters saved at `step` (the evaluator's restore):
        the optimizer state, two thirds of a checkpoint's bytes, is not
        read."""
        path = self._path(self._resolve(step))
        params = torch.load(os.path.join(path, PARAMS_FILE),
                            map_location="cpu", weights_only=True)
        return _like(params, dict(params_template))

    def wait_until_finished(self) -> None:
        self.join_async_save()

    def close(self) -> None:
        self.join_async_save()

    def checkpoints_iterator(self, timeout: float,
                             poll_seconds: float = 10.0):
        """Yield new checkpoint steps as they appear (the evaluator's
        side).  Like ``tf.train.checkpoints_iterator``, the first yield is
        the CURRENT LATEST checkpoint (older ones are not replayed), then
        every newer step in order.  The timeout counts only time spent
        waiting: it is re-armed after the consumer returns control."""
        seen = set()
        first = True
        deadline = time.time() + timeout
        while time.time() < deadline:
            all_steps = self.all_steps()
            if first and all_steps:
                seen.update(all_steps[:-1])
                first = False
            steps = [s for s in all_steps if s not in seen]
            for s in steps:
                seen.add(s)
                yield s
                deadline = time.time() + timeout
            if not steps:
                time.sleep(poll_seconds)
