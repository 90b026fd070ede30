"""Decode over device replicas: the port's counterpart of the JAX
package's decode sharded over a mesh's data axis (the evaluator's and the
server's ``mesh``: ``mint_tpu/eval/evaluator.py:195-199``, ``:254-268``;
``mint_tpu/serving/server.py:104-109``, ``:407-426``).

As in JAX, one process drives every device.  Each device holds a replica
of the model's parameters (the first is the model itself); a dispatch
splits its batch by rows into one equal share a replica (callers pad the
batch to a multiple of the replica count,
``decoder.padded_batch_size(n, data=...)``), decodes the shares, and
gathers the frames in row order.

Graphs: each replica is a model of its own, so it has its own decode
graphs and memory pool (``utils/graphs.py``).  A capture forbids other
threads' CUDA calls, so a replica whose graph for the dispatch is not yet
captured decodes alone, one after another; the replicas whose graph is
captured then decode concurrently, a thread each, their steps replays.
On the CPU every replica decodes concurrently.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models.fact import FACT
from mint_tpu_torch.utils import graphs


def _device(d: torch.device | str) -> torch.device:
    """`d` with its index: 'cuda' is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def devices_for(device: torch.device | str, n: int) -> List[torch.device]:
    """`n` devices of `device`'s kind for replicas: the first `n` cards
    for 'cuda' (0 = every card), or `n` replicas on the CPU (0 = one)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * max(1, n)
    n = n or torch.cuda.device_count()
    if n > torch.cuda.device_count():
        raise ValueError(f"{n} replicas asked for, but only "
                         f"{torch.cuda.device_count()} CUDA card(s) exist")
    return [torch.device("cuda", i) for i in range(n)]


class Replicas:
    """`model` and a copy of it on each further device of `devices`."""

    def __init__(self, model: FACT, devices: Sequence[torch.device | str]):
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("Replicas needs at least one device")
        if devices[0] != model.device:
            raise ValueError(f"the model is on {model.device}, the first "
                             f"replica's device is {devices[0]}")
        # A copy shares no graph with the model: its own pool and captures.
        cache = model.__dict__.pop("_graphs", None)
        try:
            self.models: List[FACT] = [model] + [
                copy.deepcopy(model).to(d) for d in devices[1:]]
        finally:
            if cache is not None:
                model._graphs = cache
        self.devices = devices

    def __len__(self) -> int:
        return len(self.models)

    def load_state_dict(self, params: Mapping[str, torch.Tensor]) -> None:
        """The same parameters into every replica (in place: the graphs
        keep reading them)."""
        for model in self.models:
            model.load_state_dict(params)

    def decode(self, inputs: Dict[str, np.ndarray], steps: int
               ) -> np.ndarray:
        """``decoder.infer_auto_regressive`` over the replicas: the rows of
        `inputs` (``motion_input`` and ``audio_input``, host arrays of
        ``len(self) * k`` rows) split in order, k a replica; the frames
        [rows, steps, motion_dim] as f32 on the host."""
        rows = len(inputs["motion_input"])
        n = len(self.models)
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} replicas (pad it with "
                             "decoder.padded_batch_size(n, data=...))")
        share = rows // n
        outs: List = [None] * n

        def run(i: int) -> None:
            part = {k: np.asarray(v)[i * share:(i + 1) * share]
                    for k, v in inputs.items()}
            # The kernels launch on the thread's current device.
            device = self.devices[i]
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                frames = decoder.infer_auto_regressive(self.models[i], part,
                                                       steps=steps)
                outs[i] = frames.float().cpu().numpy()

        warm = [i for i, m in enumerate(self.models)
                if decoder.captured(m, share, steps)]
        for i in range(n):  # captures, one replica at a time
            if i not in warm:
                run(i)
        if len(warm) == 1:
            run(warm[0])
        elif warm:
            errors: List[BaseException] = []

            def guarded(i: int) -> None:
                try:
                    run(i)
                except BaseException as exc:  # re-raised below
                    errors.append(exc)

            threads = [threading.Thread(target=guarded, args=(i,),
                                        name=f"replica-{i}") for i in warm]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        return np.concatenate(outs)

    def summary(self) -> str:
        """The replicas' decode graphs, one entry each."""
        return "; ".join(f"{d}: {graphs.of(m).summary()}"
                         for d, m in zip(self.devices, self.models))
