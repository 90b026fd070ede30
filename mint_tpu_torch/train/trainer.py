"""The training step (counterpart of ``mint_tpu/train/trainer.py``).

Reference semantics, as in the JAX trainer:

- pop the ``target`` off the batch, forward, mean L2 loss;
- optional clip by global norm, optax's formula: the gradients are kept
  when the norm is under the limit and scaled by ``limit / norm`` otherwise,
  with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- Adam as optax's ``scale_by_adam``: bias-corrected moments, eps 1e-7 (the
  reference's Keras default, where optax's and torch's is 1e-8) outside
  the square root, the update scaled by ``-schedule(update count)``;
- gradient accumulation as ``optax.MultiSteps``: the gradients' running
  mean ``acc + (g - acc) / (n + 1)`` over ``accumulate_steps``
  micro-batches, then one clip-and-Adam update of that mean; the schedule
  counts optimizer updates, so the ``learning_rate`` metric is
  ``schedule(step // accumulate_steps)``;
- metrics total_loss / loss / reg_loss (always 0: FACT has no
  regularisation loss) / learning_rate.

The state's parameters and optimizer slots are a dict of tensors on the
model's device.  The forward runs the model on them with
``torch.func.functional_call``, so the model's own parameters are only a
template.  The update is in place, to keep one copy of the state on the
card: ``train_step`` consumes the state it is given, as the JAX step
donates it.  The optimizer's element-wise work runs as ``torch._foreach``
ops, a few launches for all parameters at once.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mint_tpu_torch.data.prefetch import to_device
from mint_tpu_torch.models.fact import l2_loss
from mint_tpu_torch.train.schedules import Schedule

LABEL_KEY = "target"
# Adam's decay rates, and eps 1e-7: tf.keras Adam's default, the
# reference's optimizer (optax's own default is 1e-8).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7


class TrainState(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Optional[Dict[str, Any]]


def _f32(x: float) -> float:
    return float(np.float32(x))


class Trainer:
    """Owns the optimizer's arithmetic and the train step of one model on
    its device (CPU or one card)."""

    def __init__(self,
                 model: nn.Module,
                 learning_rate: Schedule,
                 grad_clip_norm: float = 0.0,
                 accumulate_steps: int = 1):
        """`accumulate_steps` > 1 averages gradients over that many
        micro-batches before applying the optimizer; the schedule then
        counts optimizer updates (one per k micro-batches), so "drop at
        100k" in a config means 100k updates."""
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self.model = model
        self.schedule = learning_rate
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.accumulate_steps = int(accumulate_steps)
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            # f32 trains in true f32, as the reference does: no TF32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    # -- state ---------------------------------------------------------

    def init_state(self, params: Mapping[str, torch.Tensor] | nn.Module
                   ) -> TrainState:
        """A TrainState holding a COPY of `params` (a module's parameters or
        a name -> tensor mapping) on the trainer's device, zero Adam
        moments and, with accumulation, a zero gradient accumulator.  The
        caller's tensors are never aliased: the train step updates the
        state in place."""
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        params = {k: v.detach().to(self.device, copy=True)
                  for k, v in params.items()}

        def zeros():
            return {k: torch.zeros_like(v) for k, v in params.items()}

        opt_state: Dict[str, Any] = {"count": 0, "mu": zeros(),
                                     "nu": zeros()}
        if self.accumulate_steps > 1:
            opt_state.update(mini_step=0, acc=zeros())
        return TrainState(step=0, params=params, opt_state=opt_state)

    # -- one step ------------------------------------------------------

    def loss(self, params: Mapping[str, torch.Tensor],
             batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Mean loss of a batch of device tensors under `params` (the
        forward; differentiable where `params` require grad)."""
        inputs = dict(batch)
        target = inputs.pop(LABEL_KEY)
        output = functional_call(self.model, dict(params), (inputs,))
        return torch.mean(l2_loss(target, output))

    def loss_and_grads(self, params: Mapping[str, torch.Tensor],
                       batch: Mapping[str, Any]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean loss of `batch` under `params` and its gradient for each
        parameter."""
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss = self.loss(leaves, to_device(batch, self.device))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    @torch.no_grad()
    def apply_gradients(self, state: TrainState,
                        grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer step on `state`, in place: accumulate, and every
        ``accumulate_steps`` micro-batches clip and apply Adam."""
        opt = state.opt_state
        names = list(state.params)
        gs = [grads[k] for k in names]
        if self.accumulate_steps > 1:
            accs = [opt["acc"][k] for k in names]
            n = opt["mini_step"]
            delta = torch._foreach_sub(gs, accs)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(accs, delta)
            if n + 1 < self.accumulate_steps:
                opt["mini_step"] = n + 1
                return
            gs = [a.clone() for a in accs]
            torch._foreach_zero_(accs)
            opt["mini_step"] = 0
        if self.grad_clip_norm > 0.0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(gs)))
            coef = torch.where(norm < self.grad_clip_norm,
                               torch.ones_like(norm),
                               self.grad_clip_norm / norm)
            torch._foreach_mul_(gs, coef)
        lr = self.schedule(opt["count"])
        count = opt["count"] + 1
        bc1 = _f32(1 - np.float32(ADAM_B1) ** np.float32(count))
        bc2 = _f32(1 - np.float32(ADAM_B2) ** np.float32(count))
        mus = [opt["mu"][k] for k in names]
        nus = [opt["nu"][k] for k in names]
        torch._foreach_mul_(mus, ADAM_B1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - ADAM_B1))
        torch._foreach_mul_(nus, ADAM_B2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - ADAM_B2))
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        update = torch._foreach_div(mus, bc1)
        torch._foreach_div_(update, den)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_([state.params[k] for k in names], update)
        opt["count"] = count

    def train_step(self, state: TrainState, batch: Mapping[str, Any]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        """One step on `batch` (numpy arrays or tensors).  Consumes `state`
        (its tensors are updated in place) and returns the next one and
        the step's metrics; the loss stays a tensor on the device until
        the caller reads it."""
        loss, grads = self.loss_and_grads(state.params, batch)
        self.apply_gradients(state, grads)
        metrics = {
            "total_loss": loss,
            "loss": loss,
            "reg_loss": 0.0,
            "learning_rate": self.schedule(
                state.step // self.accumulate_steps),
        }
        return state._replace(step=state.step + 1), metrics

    # -- several steps ---------------------------------------------------

    def stack_batches(self, batches) -> Dict[str, Any]:
        """Stack `loop` batches into [loop, batch, ...] arrays (numeric
        features only): numpy arrays stay numpy, tensors stack where they
        lie."""
        first = batches[0]
        out = {}
        for key, value in first.items():
            if isinstance(value, torch.Tensor):
                out[key] = torch.stack([b[key] for b in batches])
            elif np.asarray(value).dtype.kind in "fiub":
                out[key] = np.stack([np.asarray(b[key]) for b in batches])
        return out

    def train_steps(self, state: TrainState, stacked: Mapping[str, Any]
                    ) -> Tuple[TrainState, Dict[str, Any]]:
        """``stacked[...].shape[0]`` train steps, one per slice, in a
        plain loop: numerically the same as looping ``train_step``, whose
        last metrics it returns.  (The JAX trainer compiles the loop into
        one ``lax.scan``; a CUDA graph of the step is the port's
        counterpart, not built yet.)"""
        loop = next(iter(stacked.values())).shape[0]
        metrics: Dict[str, Any] = {}
        for i in range(loop):
            state, metrics = self.train_step(
                state, {k: v[i] for k, v in stacked.items()})
        return state, metrics

    def train_steps_sampled(self, state: TrainState, dataset, loop: int,
                            seed: int = 0
                            ) -> Tuple[TrainState, Dict[str, Any]]:
        """`loop` train steps on batches drawn on the device from a
        :class:`~mint_tpu_torch.data.device_dataset.DeviceDataset`.  Each
        step's draw is seeded from (`seed`, absolute step), so a resumed
        run draws the windows the uninterrupted run would have drawn."""
        metrics: Dict[str, Any] = {}
        for _ in range(loop):
            state, metrics = self.train_step(
                state, dataset.sample(seed, state.step))
        return state, metrics
