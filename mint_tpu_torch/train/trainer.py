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

The step is one body over static tensors, the counterpart of the fused
``lax.scan`` that the JAX trainer compiles per ``steps_per_loop`` window:
forward, backward, clip and Adam read a static batch (each step's batch
is copied into it), the state's own tensors, and the step's scalars
(the learning rate negated, Adam's two bias corrections, the
accumulation divisor) as tensors on the device, which the host computes
in f32 (``schedule(count)``, as the JAX step does) and writes before
each step.  With
accumulation there are two bodies: the micro-step, and the micro-step
plus clip and Adam; the Python ``count`` and ``mini_step`` stay in the
optimizer state, as the checkpoint holds them.  On the CPU the body runs
as it is.  On the card it runs as a CUDA graph (``utils/graphs.py``):
eager at its first step, captured at its second, replayed after.  A
graph reads the tensors it was captured on, so a state whose tensors are
others (a fresh ``init_state``, a checkpoint restore, a caller's own
state) drops the graphs, which the next steps capture anew on its
tensors: a replay never reads another state's addresses, and no state is
overwritten but the one passed in.

Over a mesh of ranks (``parallel/mesh.py``; the JAX trainer's ``mesh``):
each rank's model holds its slice of the attention heads and MLP width
(``models/layers.py``), and its state the same slices of the parameters
and of Adam's moments.  Each rank takes the mean loss of its own batch
(``global batch / data`` rows); the loss and every gradient leaf are then
averaged over the data group in one all-reduce of one flat buffer, so the
step's loss is the global batch's and the gradients are the JAX
package's.  The global-norm clip sums the squares of the split leaves
over the model group and counts the replicated leaves once, as optax's
clip over the global arrays does.  Adam runs on each rank's slice.  On
the card the collectives are captured in the step's graph when the
device groups are NCCL's; with gloo's (the CPU's, or ranks sharing one
card) the step runs uncaptured.

Tracing (``utils/profiling.py``): the step's body stamps its phases on
the card, inside the graph: ``begin`` at its first launch, ``forward``
after the loss, ``backward`` after the gradients, ``exchange`` after the
mesh's all-reduce (over a mesh only) and ``update`` after the clip and
Adam (or a micro-step's accumulate).  :meth:`Trainer.phase_ms` reads the
last step's phases from the stamps with no profiler; a profiler's trace
reads every step's from the stamp kernels.  On the host,
``mint.train.step`` spans :meth:`Trainer.train_step`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mint_tpu_torch.data.prefetch import to_device
import torch.distributed as dist

from mint_tpu_torch.models.fact import l2_loss
from mint_tpu_torch.parallel import mesh as mesh_lib
from mint_tpu_torch.train.schedules import Schedule
from mint_tpu_torch.utils import graphs, profiling

LABEL_KEY = "target"
# Elements a gradient's segment of the flat all-reduce buffer is rounded
# up to: 512 bytes of f32, the caching allocator's alignment.
_SEGMENT = 128
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
    its device (CPU or one card), on one rank of a mesh where given."""

    def __init__(self,
                 model: nn.Module,
                 learning_rate: Schedule,
                 grad_clip_norm: float = 0.0,
                 accumulate_steps: int = 1,
                 mesh: Optional[mesh_lib.Mesh] = None):
        """`accumulate_steps` > 1 averages gradients over that many
        micro-batches before applying the optimizer; the schedule then
        counts optimizer updates (one per k micro-batches), so "drop at
        100k" in a config means 100k updates.

        `mesh`: this rank's place in a (data, model) mesh; `model` must be
        built with it (``builder.build(..., mesh=mesh)``) and the batches
        given to the steps are this rank's.  Every rank of the mesh must
        run the same steps: each step runs collectives."""
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self.model = model
        self.schedule = learning_rate
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.accumulate_steps = int(accumulate_steps)
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            # f32 matmuls run in full f32 (no TF32).  The JAX package sets
            # no matmul precision: its f32 matmuls run at the backend's
            # default, exact f32 on the CPU (where the tests hold the port
            # to it) but not exact f32 on a TPU.  TF32 here stays off until
            # a run on the card measures what it does to the loss.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.mesh = mesh
        self._graphed = graphs.enabled(self.device) and (
            mesh is None or mesh.backend == "nccl")
        self._norm_weights: Dict[Tuple[str, ...], torch.Tensor] = {}
        # The step's scalars: the learning rate negated, Adam's bias
        # corrections 1 and 2, the accumulation divisor.
        self._scalars = torch.zeros(4, device=self.device)
        self._batches: Dict[Any, Dict[str, torch.Tensor]] = {}
        self._steps: Dict[Any, Any] = {}  # (batch key, body) -> step
        self._bound: Tuple[int, ...] = ()  # the state the steps read
        # The phase stamps of the step last run (device ns, by
        # profiling.PHASES): made here, before any capture reads them.
        self._stamps = torch.zeros(len(profiling.PHASES), dtype=torch.int64,
                                   device=self.device)

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
        loss, grads = self._loss_and_grads(params,
                                           to_device(batch, self.device))
        return loss, dict(zip(params, grads))

    def _loss_and_grads(self, params, batch, stamped: bool = False):
        """The loss and gradients, averaged over the mesh's data group;
        `stamped` (the step's body) stamps the phases' ends."""
        def mark(phase):
            if stamped:
                profiling.stamp(self._stamps, phase)

        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss = self.loss(leaves, batch)
            mark("forward")
            grads = torch.autograd.grad(loss, list(leaves.values()))
        mark("backward")
        if self.mesh is None:
            return loss.detach(), list(grads)
        loss, grads = self._data_mean(loss.detach(), grads)
        mark("exchange")
        return loss, grads

    def _data_mean(self, loss, grads):
        """The loss and gradients averaged over the data group: one
        all-reduce of one flat f32 buffer (run at any data size, so a
        world of one runs the collective path too).  Each gradient's
        segment starts on a 512-byte boundary, as a tensor of its own
        does: the foreach kernels after it (the clip's norms) then take
        the same vectorised path and sum in the same order as over the
        gradients themselves, so a world of one is bit-equal to one
        device."""
        starts, at = [], 0
        for g in grads:
            starts.append(at)
            at += -(-g.numel() // _SEGMENT) * _SEGMENT
        flat = torch.zeros(at + 1, device=loss.device)
        views = [flat[s:s + g.numel()].view_as(g)
                 for s, g in zip(starts, grads)]
        torch._foreach_copy_(views, list(grads))
        flat[at:].copy_(loss.float().reshape(1))
        dist.all_reduce(flat, group=self.mesh.data_group)
        flat.div_(self.mesh.data)
        return flat[at], views

    def _global_norm(self, gs, names) -> torch.Tensor:
        """The global norm of the gradients `gs` (of parameters `names`):
        over a model axis, the squares of the split leaves summed over the
        model group and the replicated leaves, the same on every rank,
        counted once (each weighted 1 / model before the sum)."""
        norms = torch.stack(torch._foreach_norm(gs))
        if self.mesh is None or self.mesh.model == 1:
            return torch.linalg.vector_norm(norms)
        key = tuple(names)
        weights = self._norm_weights.get(key)
        if weights is None:
            weights = self._norm_weights[key] = torch.tensor(
                [1.0 if mesh_lib.shard_dim(k) is not None
                 else 1.0 / self.mesh.model for k in names],
                device=norms.device)
        total = (norms * norms * weights).sum()
        dist.all_reduce(total, group=self.mesh.model_group)
        return torch.sqrt(total)

    @torch.no_grad()
    def _update(self, gs, names, params, mus, nus, accs,
                body: str) -> None:
        """The optimizer's arithmetic on lists of tensors, in place, with
        the step's scalars read from the device: accumulate (``accs`` not
        empty), and unless this is a micro-step clip and apply Adam."""
        neg_lr, bc1, bc2, divisor = self._scalars.unbind()
        if accs:
            delta = torch._foreach_sub(gs, accs)
            torch._foreach_div_(delta, divisor)
            torch._foreach_add_(accs, delta)
            if body == "micro":
                return
            gs = [a.clone() for a in accs]
            torch._foreach_zero_(accs)
        if self.grad_clip_norm > 0.0:
            norm = self._global_norm(gs, names)
            coef = torch.where(norm < self.grad_clip_norm,
                               torch.ones_like(norm),
                               self.grad_clip_norm / norm)
            torch._foreach_mul_(gs, coef)
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
        torch._foreach_mul_(update, neg_lr)
        torch._foreach_add_(params, update)

    def _lists(self, state: TrainState):
        """The state's parameter names, parameters, moments and
        accumulator as lists in the parameters' order."""
        opt = state.opt_state
        names = list(state.params)
        accs = [opt["acc"][k] for k in names] if "acc" in opt else []
        return (names, [state.params[k] for k in names],
                [opt["mu"][k] for k in names],
                [opt["nu"][k] for k in names], accs)

    def _body_name(self, opt: Mapping[str, Any]) -> str:
        """"step", or with accumulation "micro" (gradients into the
        accumulator only) or "update" (then clip and Adam)."""
        if self.accumulate_steps == 1:
            return "step"
        last = opt["mini_step"] + 1 == self.accumulate_steps
        return "update" if last else "micro"

    def _write_scalars(self, opt: Mapping[str, Any]) -> None:
        """The step's scalars, computed on the host in f32 as the JAX step
        computes them, onto the device, behind the work already queued."""
        count = opt["count"] + 1
        values = torch.tensor([
            -self.schedule(opt["count"]),
            _f32(1 - np.float32(ADAM_B1) ** np.float32(count)),
            _f32(1 - np.float32(ADAM_B2) ** np.float32(count)),
            float(opt.get("mini_step", 0) + 1)], dtype=torch.float32)
        if self._scalars.is_cuda:
            values = values.pin_memory()
        self._scalars.copy_(values, non_blocking=True)

    def _advance(self, opt: Dict[str, Any]) -> None:
        """The optimizer state's Python counters past one micro-batch."""
        if self.accumulate_steps > 1:
            n = opt["mini_step"] + 1
            opt["mini_step"] = 0 if n == self.accumulate_steps else n
            if n < self.accumulate_steps:
                return
        opt["count"] += 1

    def apply_gradients(self, state: TrainState,
                        grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer step on `state`, in place and uncaptured:
        accumulate, and every ``accumulate_steps`` micro-batches clip and
        apply Adam.  The same arithmetic as a train step's."""
        opt = state.opt_state
        self._write_scalars(opt)
        self._update([grads[k] for k in state.params], *self._lists(state),
                     self._body_name(opt))
        self._advance(opt)

    def _bind(self, state: TrainState) -> None:
        """Make `state`'s tensors the ones the steps read: if they are not
        those of the steps so far, drop those steps and their graphs (the
        next steps capture on `state`'s tensors)."""
        bound = tuple(t.data_ptr() for group in self._lists(state)[1:]
                      for t in group)
        if bound != self._bound:
            self._bound = bound
            self._steps.clear()

    def _static_batch(self, batch: Mapping[str, Any]
                      ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        """The static batch for `batch`'s numeric features (made at the
        first batch of their shapes), with `batch` copied into it behind
        the work already queued."""
        values = to_device(batch, self.device)
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in values.items())
        static = self._batches.get(key)
        if static is None:
            static = self._batches[key] = {
                k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                for k, v in values.items()}
        for k, value in values.items():
            static[k].copy_(value)
        return key, static

    def _step(self, state: TrainState, batch_key, batch, body: str):
        """The step that runs `body` on the bound state and `batch`: a
        graph on the card, the body itself on the CPU."""
        step = self._steps.get((batch_key, body))
        if step is None:
            lists = self._lists(state)

            def run():
                profiling.stamp(self._stamps, "begin")
                loss, gs = self._loss_and_grads(state.params, batch,
                                                stamped=True)
                self._update(gs, *lists, body)
                profiling.stamp(self._stamps, "update")
                return loss

            step = run
            if self._graphed:
                cache = graphs.of(self.model)
                step = graphs.Step(run, cache, ("train", body) + batch_key,
                                   self.device,
                                   thread_local=self.mesh is not None)
            self._steps[batch_key, body] = step
        return step

    def train_step(self, state: TrainState, batch: Mapping[str, Any]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        """One step on `batch` (numpy arrays or tensors).  Consumes `state`
        (its tensors are updated in place) and returns the next one and
        the step's metrics; the loss stays a tensor on the device until
        the caller reads it."""
        opt = state.opt_state
        with profiling.annotate("mint.train.step"):
            self._bind(state)
            batch_key, static = self._static_batch(batch)
            self._write_scalars(opt)
            # A copy: after a capture the step returns its static loss,
            # which the next step overwrites.
            loss = self._step(state, batch_key, static,
                              self._body_name(opt))().clone()
            self._advance(opt)
        metrics = {
            "total_loss": loss,
            "loss": loss,
            "reg_loss": 0.0,
            "learning_rate": self.schedule(
                state.step // self.accumulate_steps),
        }
        return state._replace(step=state.step + 1), metrics

    def phase_ms(self) -> Optional[Dict[str, float]]:
        """The phases of the step last run, in ms, from the stamps its
        body wrote on the card (one copy to the host, which waits for
        that step): ``forward``, ``backward``, ``exchange`` (over a mesh
        only: the all-reduce of the loss and gradients) and ``update``
        (the clip and Adam, or a micro-step's accumulate).  None on the
        CPU, where nothing is stamped, and before a step."""
        if self._stamps.device.type != "cuda":
            return None
        return profiling.phase_ms(self._stamps.tolist(),
                                  exchange=self.mesh is not None)

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
        """``stacked[...].shape[0]`` train steps, one per slice: the same
        steps as looping ``train_step``, whose last metrics it returns.
        The stack goes to the device in one copy; on the card each step
        replays the step's graph, as the JAX trainer runs its window as
        one compiled ``lax.scan``."""
        loop = next(iter(stacked.values())).shape[0]
        stacked = to_device(stacked, self.device)
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
        run draws the windows the uninterrupted run would have drawn.  The
        draw runs outside the step's graph (it reseeds a generator on the
        host) and is copied into the static batch."""
        metrics: Dict[str, Any] = {}
        for _ in range(loop):
            state, metrics = self.train_step(
                state, dataset.sample(seed, state.step))
        return state, metrics
