"""The port's checkpoint manager and controller (mint_tpu_torch/train),
the counterparts of the checkpoint and controller tests in
tests/test_trainer.py, on the tiny FACT config on the CPU."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import __graft_entry__
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.train import CheckpointManager, Controller, Trainer
from mint_tpu_torch.train import TrainState, schedules
from mint_tpu_torch.train.checkpoint import OPT_STATE_FILE


def _setup(lr=1e-3, **kw):
    model = init_params(FACT(__graft_entry__._tiny_fact_config()),
                        torch.Generator().manual_seed(0))
    trainer = Trainer(model, schedules.constant(lr), **kw)
    return model, trainer, trainer.init_state(model)


def make_batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return {"motion_input": rng.standard_normal((b, 8, 9)).astype(np.float32),
            "audio_input": rng.standard_normal((b, 16, 35)).astype(
                np.float32),
            "target": rng.standard_normal((b, 4, 9)).astype(np.float32)}


def forever(batch):
    while True:
        yield batch


def _steps_on_disk(path):
    return sorted(int(d) for d in os.listdir(path) if d.isdigit())


def _equal_states(a: TrainState, b: TrainState):
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for slot in ("mu", "nu"):
        for k in a.opt_state[slot]:
            assert torch.equal(a.opt_state[slot][k], b.opt_state[slot][k])
    assert a.opt_state["count"] == b.opt_state["count"]


def test_checkpoint_save_restore(tmp_path):
    _, trainer, state = _setup()
    batch = make_batch(1)
    for _ in range(3):
        state, _ = trainer.train_step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1,
                            max_to_keep=5)
    assert mgr.save(state.step, state)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 3

    _, _, template = _setup()
    restored = mgr.restore(template)
    _equal_states(restored, state)
    mgr.close()


def test_keeps_the_last_five(tmp_path):
    _, _, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    for step in range(1, 9):
        assert mgr.save(step, state._replace(step=step))
    assert _steps_on_disk(tmp_path / "ckpt") == [4, 5, 6, 7, 8]
    # Only whole steps are ever named by a number.
    assert all(d.isdigit() for d in os.listdir(tmp_path / "ckpt"))
    mgr.close()


def test_restore_rejects_another_model(tmp_path):
    _, _, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state._replace(step=1))
    other = dict(state.params)
    other.pop(next(iter(other)))
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(state._replace(params={**other, "bogus": torch.zeros(1)}))
    mgr.close()


def test_controller_trains_and_checkpoints(tmp_path):
    _, trainer, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=10,
                            max_to_keep=5)
    ctl = Controller(trainer=trainer, train_iter=forever(make_batch(2)),
                     state=state, steps_per_loop=5, checkpoint_manager=mgr,
                     summary_dir=str(tmp_path / "summaries"),
                     summary_interval=5)
    metrics = ctl.train(20)
    assert ctl.global_step == 20
    assert "loss" in metrics and "learning_rate" in metrics
    assert metrics["steps_per_sec"] > 0
    ctl.save_checkpoint()
    assert mgr.latest_step() == 20
    rows = [json.loads(line) for line in
            (tmp_path / "summaries" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [5, 10, 15, 20]
    # train() is absolute: the same target again is a no-op.
    assert ctl.train(20) == {}
    assert ctl.global_step == 20

    # Resume: a fresh controller restores from the checkpoint dir.
    _, _, fresh = _setup()
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=10)
    ctl2 = Controller(trainer=trainer, train_iter=forever(make_batch(2)),
                      state=fresh, checkpoint_manager=mgr2)
    assert ctl2.global_step == 20
    _equal_states(ctl2.state, ctl.state)
    ctl.close()
    ctl2.close()


def test_controller_flushes_pending_metrics_on_loop_exception(tmp_path):
    """A loop's metrics are read only once the next loop is queued; if that
    next loop raises, the completed loop's summary is still written before
    the exception propagates."""
    _, trainer, state = _setup()
    batch = make_batch(3)

    def batches(n):
        for _ in range(n):
            yield batch
        raise RuntimeError("simulated worker drop")

    ctl = Controller(trainer=trainer, train_iter=batches(5), state=state,
                     steps_per_loop=5,
                     summary_dir=str(tmp_path / "summaries"),
                     summary_interval=5)
    with pytest.raises(RuntimeError, match="simulated worker drop"):
        ctl.train(20)
    ctl.close()
    rows = [json.loads(line) for line in
            (tmp_path / "summaries" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [5]
    assert "loss" in rows[0]


def test_checkpoint_save_implies_summary_written(tmp_path):
    """A checkpoint at step N never exists without step N's summary row:
    the summary is written BEFORE the save starts, with no step in
    between."""
    _, trainer, state = _setup()
    events = []
    orig_step = trainer.train_step

    def spy_step(state, b):
        events.append("dispatch")
        return orig_step(state, b)

    trainer.train_step = spy_step
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=5,
                            max_to_keep=5)
    orig_save = mgr.save_async

    def spy_save(step, state, force=False):
        saved = orig_save(step, state, force=force)
        if saved:
            events.append(("saved", step))
        return saved

    mgr.save_async = spy_save
    ctl = Controller(trainer=trainer, train_iter=forever(make_batch(5)),
                     state=state, steps_per_loop=5, checkpoint_manager=mgr,
                     summary_dir=str(tmp_path / "summaries"),
                     summary_interval=5)
    orig_write = ctl.metrics_writer.write

    def spy_write(step, metrics):
        events.append(("write", step))
        return orig_write(step, metrics)

    ctl.metrics_writer.write = spy_write
    ctl.train(10)
    ctl.close()
    for saved_step in (5, 10):
        i_save = events.index(("saved", saved_step))
        i_write = events.index(("write", saved_step))
        assert i_write < i_save
        assert "dispatch" not in events[i_write:i_save]


def test_controller_loops_match_per_step():
    """The Controller's loops of 3, 3 and 1 steps give the parameters and
    metrics of a plain train_step loop over the same batches."""
    batches = [make_batch(10 + i) for i in range(7)]
    _, trainer_a, state_a = _setup()
    for b in batches:
        state_a, metrics_a = trainer_a.train_step(state_a, b)
    _, trainer_b, state_b = _setup()
    ctl = Controller(trainer=trainer_b, train_iter=iter(batches),
                     state=state_b, steps_per_loop=3)
    metrics_b = ctl.train(7)
    assert ctl.global_step == 7
    assert metrics_b["loss"] == float(metrics_a["loss"])
    for k in state_a.params:
        assert torch.equal(state_a.params[k], ctl.state.params[k]), k
    ctl.close()


def test_interval_checkpoints_fire_off_multiple_boundaries(tmp_path):
    """After the bring-up train(1), loop boundaries are 1, 11, 21, ...:
    never a multiple of the interval.  The manager saves whenever the
    interval has ELAPSED since the last save."""
    _, trainer, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=20,
                            max_to_keep=5)
    ctl = Controller(trainer=trainer, train_iter=forever(make_batch(4)),
                     state=state, steps_per_loop=10, checkpoint_manager=mgr,
                     summary_dir=str(tmp_path / "s"), summary_interval=10)
    ctl.train(1)
    ctl.train(45)  # boundaries at 11, 21, 31, 41, 45
    ctl.close()
    assert _steps_on_disk(tmp_path / "ckpt") == [1, 21, 41]


def test_save_async_survives_in_place_updates(tmp_path):
    """save_async copies the state before it returns: the next train steps
    update the same tensors in place, and the checkpoint must hold the
    state as it was at the save."""
    _, trainer, state = _setup()
    batch = make_batch(3)
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    want = {k: v.clone() for k, v in state.params.items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    assert mgr.save_async(state.step, state)
    for _ in range(3):
        state, _ = trainer.train_step(state, batch)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 2
    _, _, template = _setup()
    restored = mgr.restore(template, step=2)
    assert restored.step == 2 and restored.opt_state["count"] == 2
    for k, v in want.items():
        assert torch.equal(restored.params[k], v), k
    mgr.close()


def test_controller_save_does_not_stall_training(tmp_path):
    """The interval save runs on a background thread: train() returns
    before a slowed write finishes."""
    _, trainer, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=10,
                            async_join_grace=30.0)
    finished = {}
    orig_write = mgr._write

    def slow_write(*args, **kwargs):
        assert threading.current_thread().name.startswith("ckpt-save"), \
            "interval save ran on the training thread"
        time.sleep(2.0)
        orig_write(*args, **kwargs)
        finished["at"] = time.monotonic()

    mgr._write = slow_write
    ctl = Controller(trainer=trainer, train_iter=forever(make_batch(4)),
                     state=state, steps_per_loop=5, checkpoint_manager=mgr,
                     summary_dir=str(tmp_path / "s"), summary_interval=5)
    ctl.train(25)  # interval saves at 5, 15, 25
    returned_at = time.monotonic()
    ctl.save_checkpoint()  # joins the in-flight save of 25
    assert finished["at"] > returned_at, \
        "train() blocked until the interval save completed"
    assert _steps_on_disk(tmp_path / "ckpt") == [5, 15, 25]
    ctl.close()


def test_save_async_defers_while_drain_in_flight(tmp_path):
    """A non-forced save_async offered while the previous drain is in
    flight DEFERS after the grace period, paid once per drain; the step
    stays eligible and lands at the next offer after the drain."""
    _, _, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=10,
                            async_join_grace=0.5)
    release = threading.Event()
    orig_write = mgr._write

    def gated_write(*args, **kwargs):
        assert release.wait(timeout=30), "test never released the save"
        return orig_write(*args, **kwargs)

    mgr._write = gated_write
    assert mgr.save_async(10, state._replace(step=10))
    assert not mgr.save_async(20, state._replace(step=20)), \
        "save_async joined a slow in-flight drain instead of deferring"
    assert mgr.would_save(20), "deferred step lost its save eligibility"
    t0 = time.monotonic()
    assert not mgr.save_async(20, state._replace(step=20))
    assert time.monotonic() - t0 < mgr.async_join_grace / 2, \
        "a later offer against the same drain re-paid the join grace"
    release.set()
    mgr.wait_until_finished()
    assert mgr.save_async(20, state._replace(step=20))
    mgr.wait_until_finished()
    assert _steps_on_disk(tmp_path / "ckpt") == [10, 20]
    mgr.close()


def test_save_async_failure_surfaces_at_next_join(tmp_path):
    _, _, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)

    def boom(*args, **kwargs):
        raise RuntimeError("disk full")

    mgr._write = boom
    assert mgr.save_async(1, state._replace(step=1))
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait_until_finished()
    # The failure is consumed; the manager stays usable.
    assert mgr.latest_step() is None
    mgr.close()


def test_checkpoints_iterator_starts_at_latest(tmp_path):
    _, _, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    for step in (3, 7, 12):
        mgr.save(step, state._replace(step=step), force=True)
    it = mgr.checkpoints_iterator(timeout=30, poll_seconds=0.05)
    assert next(it) == 12  # the latest only, not 3
    mgr.save(15, state._replace(step=15), force=True)
    assert next(it) == 15
    it2 = mgr.checkpoints_iterator(timeout=0.3, poll_seconds=0.05)
    assert list(it2) == [15]
    mgr.close()


def test_checkpoints_iterator_timeout_excludes_consumer_time(tmp_path):
    _, _, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    mgr.save(1, state._replace(step=1), force=True)
    it = mgr.checkpoints_iterator(timeout=0.5, poll_seconds=0.05)
    assert next(it) == 1
    time.sleep(1.0)  # the consumer takes longer than the whole timeout
    mgr.save(2, state._replace(step=2), force=True)
    assert next(it) == 2
    mgr.close()


def test_restore_params_skips_optimizer_state(tmp_path):
    """The params-only restore reads no optimizer state: it works with the
    optimizer's file gone."""
    model, _, state = _setup()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    mgr.save(7, state._replace(step=7), force=True)
    os.remove(tmp_path / "ckpt" / "7" / OPT_STATE_FILE)
    restored = mgr.restore_params(dict(model.named_parameters()))
    assert sorted(restored) == sorted(state.params)
    for k, v in restored.items():
        assert torch.equal(v, state.params[k]), k
    mgr.close()


def test_continuous_eval_restores_each_checkpoint_once(tmp_path):
    """The controller restores the latest checkpoint at construction;
    evaluate_continuously's first yield is that step and is not read
    again; a checkpoint that appears when nothing was restored at boot
    (even at step 0, the template's own step) is restored."""
    model, _, full = _setup()
    params = dict(model.named_parameters())
    restores = []

    class Counting(CheckpointManager):
        def restore_params(self, template, step=None):
            restores.append(step if step is not None
                            else self.latest_step())
            return super().restore_params(template, step=step)

    class Evaluator:
        def __init__(self):
            self.steps = []

        def evaluate(self, state):
            self.steps.append(int(state.step))
            return {"n": float(len(self.steps))}

    mgr = Counting(str(tmp_path / "a"), max_to_keep=3)
    mgr.save(5, full._replace(step=5), force=True)
    ev = Evaluator()
    ctl = Controller(evaluator=ev, state=TrainState(
        step=0, params=params, opt_state=None), checkpoint_manager=mgr,
        summary_dir=str(tmp_path / "eval"))
    ctl.evaluate_continuously(timeout=0.3, poll_seconds=0.05)
    assert ev.steps == [5]
    assert restores == [5]
    assert ctl.evaluate() == {"n": 2.0}
    ctl.close()
    rows = (tmp_path / "eval" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(rows[0])["step"] == 5

    restores.clear()
    mgr2 = Counting(str(tmp_path / "b"), max_to_keep=3)
    ev2 = Evaluator()
    ctl2 = Controller(evaluator=ev2, state=TrainState(
        step=0, params=params, opt_state=None), checkpoint_manager=mgr2)
    mgr2.save(0, full._replace(step=0), force=True)
    ctl2.evaluate_continuously(timeout=0.3, poll_seconds=0.05)
    assert ev2.steps == [0]
    assert restores == [0]
    ctl2.close()


def test_train_without_input_raises():
    _, trainer, state = _setup()
    ctl = Controller(trainer=trainer, state=state)
    with pytest.raises(ValueError, match="train_iter"):
        ctl.train(1)
