"""The (data, model) grid of ranks: the port's counterpart of
``mint_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a 2-D ``jax.sharding.Mesh`` and
lets XLA place the collectives its sharding annotations imply.  Here one
process drives one device (one rank of ``torch.distributed``), and the
model code calls the collectives itself.  The ranks form a grid of
``data x model``, rank ``d * model + m`` at data index d and model index
m (the JAX mesh's row-major ``devices.reshape(data, model)``):

- the ranks of one data index form a **model group**: they hold one
  replica of the model between them, each its own slice of the attention
  heads and of the MLP's hidden width (tensor parallelism), and read the
  same batch;
- the ranks of one model index form a **data group**: they hold the same
  slice, read different batches, and average their gradients.

Groups on the device use the world's backend: NCCL on CUDA, gloo on the
CPU.  A second set of gloo groups on the host carries checkpoint gathers
and barriers: gloo takes CUDA tensors only in ``broadcast`` and
``all_reduce``, so everything else crosses through host copies.

Partition rules (``mint_tpu/parallel/mesh.py:44-53``), as there by Flax
path: the fused QKV projection and fc1 are column-parallel (their output
dim split), ``to_out`` and fc2 row-parallel (their input dim split), fc1's
bias split with its columns; every other leaf is replicated.  One
difference: JAX cuts ``to_qkv``'s output, laid out (qkv, head, dim)
(``mint_tpu/models/layers.py:85-90``), into contiguous blocks and lets
GSPMD reshard behind it.  A rank here computes its own heads
(:func:`head_split`: a contiguous run, the first ``heads % model`` ranks
one head more, so 10 heads over 4 ranks are 3, 3, 2 and 2), so its slice
takes the same heads from q, k and v (rows of ``to_qkv`` and, in a model
whose LayerNorm affines are folded, of its bias) and their columns of
``to_out``.  Where the model ranks outnumber the heads, each head takes a
contiguous group of ranks (:func:`head_group`: ``head_split(model, heads,
h)`` of them, so 16 ranks over 10 heads are groups of 2, 2, 2, 2, 2, 2,
1, 1, 1, 1), and a rank of a group holds a contiguous run of its head's
columns of q, k and v and the same rows of ``to_out``'s input; the group
gathers the head before attention (:func:`gather_head`).  Either way a
rank's slice is one run of the (head, head dim) columns
(:func:`head_columns`).  The split of those leaves therefore needs each
attention's head count (:func:`attention_heads`); every other split is
even.
"""

from __future__ import annotations

import math
import re
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: A data rank's input seed is ``SEED_STRIDE * data_index`` (plus the
#: run's): its shuffle and its windows differ from the other data ranks',
#: and the ranks of one model group read the same batch.  The JAX CLI
#: seeds its hosts' shuffles this way (``mint_tpu/tools/train.py:80``).
SEED_STRIDE = 1000003

# Parameter partition rules, matched against the '/'-joined Flax path.
# Kernels are [in_dim, out_dim] there (Keras layout); nn.Linear's weight
# is [out, in], so its spec reads backwards.
_PARAM_RULES = (
    (re.compile(r"attn/to_qkv/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"attn/to_qkv/bias$"), (MODEL_AXIS,)),
    (re.compile(r"attn/to_out/kernel$"), (MODEL_AXIS, None)),
    (re.compile(r"mlp/fc1/kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"mlp/fc1/bias$"), (MODEL_AXIS,)),
    (re.compile(r"mlp/fc2/kernel$"), (MODEL_AXIS, None)),
)


def param_spec(path: str) -> tuple:
    """The partition spec of one parameter, by its Flax path, as a tuple
    of axis names (None: not split; ``()``: replicated)."""
    for rule, spec in _PARAM_RULES:
        if rule.search(path):
            return spec
    return ()


def _flax_path(key: str) -> str:
    """The Flax path of a state_dict key, as far as the rules read it (a
    Linear's ``weight`` is a Dense ``kernel``)."""
    path = key.replace(".", "/")
    return path[:-len("weight")] + "kernel" if path.endswith(
        "/weight") else path


def shard_dim(key: str) -> Optional[int]:
    """The dim of the state_dict tensor `key` that the model axis splits,
    or None where it is replicated."""
    spec = param_spec(_flax_path(key))
    if MODEL_AXIS not in spec:
        return None
    if len(spec) == 2:  # a Dense kernel: nn.Linear's weight is [out, in]
        spec = spec[::-1]
    return spec.index(MODEL_AXIS)


def head_split(heads: int, parts: int, index: int) -> Tuple[int, int]:
    """(first head, head count) of model rank `index` of `parts` in an
    attention of `heads` heads: a contiguous run, the first
    ``heads % parts`` ranks one head more than the rest."""
    if not 0 < parts <= heads:
        raise ValueError(f"{heads} attention heads do not fill {parts} "
                         "model ranks (a rank would hold no head)")
    base, extra = divmod(heads, parts)
    return index * base + min(index, extra), base + (index < extra)


def head_group(heads: int, parts: int, index: int) -> Tuple[int, int, int]:
    """(head, its first rank, its ranks) of model rank `index` of `parts`
    where the ranks outnumber the `heads`: head h takes a contiguous group
    of ``head_split(parts, heads, h)`` ranks."""
    for head in range(heads):
        first, size = head_split(parts, heads, head)
        if first <= index < first + size:
            return head, first, size
    raise ValueError(f"model rank {index} of {parts}")


def head_columns(heads: int, head_dim: int, parts: int,
                 index: int) -> Tuple[int, int]:
    """[start, stop) of model rank `index` of `parts` in the heads x
    head_dim columns of each of q, k and v (and of ``to_out``'s input): its
    run of whole heads (:func:`head_split`) where the ranks are no more
    than the heads, else its contiguous run of its head's columns, split
    over the head's group as :func:`head_split` splits heads."""
    if parts <= heads:
        start, count = head_split(heads, parts, index)
        return start * head_dim, (start + count) * head_dim
    head, first, size = head_group(heads, parts, index)
    start, count = head_split(head_dim, size, index - first)
    return head * head_dim + start, head * head_dim + start + count


def attention_heads(model: torch.nn.Module) -> Dict[str, int]:
    """Each attention's whole head count, by its state_dict prefix (the
    ``heads`` that :func:`shard_state_dict` splits by)."""
    return {name: m.total_heads for name, m in model.named_modules()
            if hasattr(m, "total_heads")}


def _head_leaf(key: str) -> Optional[str]:
    """'qkv' or 'out' where `key` is a leaf split by heads, else None."""
    if key.endswith(("attn.to_qkv.weight", "attn.to_qkv.bias")):
        return "qkv"
    if key.endswith("attn.to_out.weight"):
        return "out"
    return None


class Mesh:
    """A ``data x model`` grid over the ranks of ``torch.distributed``.

    Attributes: ``data``, ``model`` (the axis sizes), ``rank``,
    ``data_index``, ``model_index``, ``device`` (this rank's), ``backend``
    (of the device groups), ``model_group`` and ``data_group`` (this
    rank's device groups), ``host_group`` (gloo, every rank) and
    ``host_model_group`` (gloo, this rank's model group)."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 device: torch.device | str = "cpu",
                 backend: Optional[str] = None, model_group=None,
                 data_group=None, host_group=None, host_model_group=None):
        self._head_groups: Dict[int, object] = {}
        self.data, self.model = int(data), int(model)
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, self.model)
        self.device = torch.device(device)
        self.backend = backend
        self.model_group = model_group
        self.data_group = data_group
        self.host_group = host_group
        self.host_model_group = host_model_group

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def head_group(self, heads: int):
        """The device group of the model ranks that share this rank's head
        (:func:`head_group`) in an attention of `heads` heads, or None
        where the rank holds whole heads or the mesh has no groups.  The
        first call for a head count makes the groups of every data index
        and every head at once, so every rank must ask for the same head
        counts in the same order, as building one model does."""
        if heads not in self._head_groups:
            own = None
            if self.model_group is not None and self.model > heads:
                for d in range(self.data):
                    for h in range(heads):
                        first, size = head_split(self.model, heads, h)
                        if size == 1:
                            continue
                        group = dist.new_group(
                            [d * self.model + first + j for j in range(size)],
                            backend=self.backend)
                        if (d == self.data_index
                                and first <= self.model_index < first + size):
                            own = group
            self._head_groups[heads] = own
        return self._head_groups[heads]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank="
                f"{self.rank}, device={self.device}, backend={self.backend})")


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """A (data, model) mesh over the world of the initialised default
    process group, `device` this rank's device (default: the CPU under
    gloo, ``cuda:<current>`` otherwise).  ``data=None`` takes every rank
    the model axis leaves.  Every rank must call it, in the same order
    as its other group creations: it creates the groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group) on every rank")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    backend = dist.get_backend()
    if device is None:
        device = ("cpu" if backend == "gloo"
                  else f"cuda:{torch.cuda.current_device()}")
    rank = dist.get_rank()
    d_idx, m_idx = divmod(rank, model)

    def groups(backend_name):
        """(this rank's model group, its data group) of `backend_name`."""
        own_model = own_data = None
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)],
                               backend=backend_name)
            if d == d_idx:
                own_model = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)],
                               backend=backend_name)
            if m == m_idx:
                own_data = g
        return own_model, own_data

    model_group, data_group = groups(backend)
    if backend == "gloo":
        host_group, host_model_group = dist.group.WORLD, model_group
    else:
        host_group = dist.new_group(list(range(world)), backend="gloo")
        host_model_group = groups("gloo")[0]
    return Mesh(data, model, rank, device, backend, model_group, data_group,
                host_group, host_model_group)


def leave() -> None:
    """End this rank's part of a run that succeeded: wait until every
    rank has arrived here, then destroy the process group.  A gloo rank
    that exits at once can close its sockets while a peer still finishes
    the last collective they shared, which then fails with "Connection
    closed by peer"; so the ranks meet in the default group's key-value
    store first, and rank 0, which serves that store, leaves last.  NCCL
    destroys a communicator only once the CUDA graphs that captured its
    collectives are gone (else every rank hangs there), so those go
    first."""
    from mint_tpu_torch.utils import graphs

    graphs.release_collectives()
    store = dist.distributed_c10d._get_default_store()
    world = dist.get_world_size()

    def wait_for(key):
        while int(store.add(key, 0)) < world:
            time.sleep(0.01)

    store.add("mint_tpu_torch/arrived", 1)
    wait_for("mint_tpu_torch/arrived")
    store.add("mint_tpu_torch/left", 1)
    if dist.get_rank() == 0:
        wait_for("mint_tpu_torch/left")
    dist.destroy_process_group()


# -- the parameters' slices ---------------------------------------------------

def _split(t: torch.Tensor, key: str, n: int, i: int,
           heads: Optional[Mapping[str, int]]) -> torch.Tensor:
    """Slice i of n of the state_dict tensor `key`."""
    dim = shard_dim(key)
    kind = _head_leaf(key)
    if kind is not None:
        prefix = key.rsplit(".", 2)[0]
        if heads is None or prefix not in heads:
            raise ValueError(f"{key}: splitting it needs the head count of "
                             f"{prefix} (mesh.attention_heads(model))")
        h = heads[prefix]
        if kind == "out":  # [dim, heads x head dim]: the rank's columns
            start, stop = head_columns(h, t.shape[1] // h, n, i)
            return t[:, start:stop]
        # [3 x heads x head dim, ...]: the rank's rows of q, k and v each
        start, stop = head_columns(h, t.shape[0] // (3 * h), n, i)
        thirds = t.reshape(3, -1, *t.shape[1:])
        return thirds[:, start:stop].reshape(-1, *t.shape[1:])
    if t.shape[dim] % n:
        raise ValueError(f"{key}: dim {dim} of {tuple(t.shape)} does not "
                         f"split over {n} model ranks")
    return t.chunk(n, dim=dim)[i]


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh: Mesh,
                     heads: Optional[Mapping[str, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full state_dict (or of any dict keyed like
    one, such as an Adam moment): split leaves cut by ``mesh.model`` at
    ``mesh.model_index``, replicated ones copied.  `heads` (from
    :func:`attention_heads` of the model) gives each attention's head
    count, which the split of its ``to_qkv`` and ``to_out`` needs."""
    out = {}
    for key, t in full.items():
        if mesh.model > 1 and shard_dim(key) is not None:
            t = _split(t, key, mesh.model, mesh.model_index, heads)
        out[key] = t.clone()
    return out


def unshard_state_dict(shards: Sequence[Mapping[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """The full state_dict from the slices of model index 0, 1, ... (the
    inverse of :func:`shard_state_dict`); replicated leaves from slice 0.
    The slices of q, k and v (and ``to_out``'s) are runs of the heads'
    columns in rank order, as long as their rows say."""
    n = len(shards)
    out = {}
    for key, t in shards[0].items():
        dim = shard_dim(key)
        if n == 1 or dim is None:
            out[key] = t.clone()
        elif _head_leaf(key) == "qkv":
            parts = [s[key].reshape(3, -1, *t.shape[1:]) for s in shards]
            out[key] = torch.cat(parts, dim=1).reshape(-1, *t.shape[1:])
        else:
            out[key] = torch.cat([s[key] for s in shards], dim=dim)
    return out


def gather_state_dicts(trees: Sequence[Mapping[str, torch.Tensor]],
                       mesh: Mesh):
    """The full trees on rank 0 (None on every other rank) from each
    rank's slices of `trees` (state_dict-keyed dicts of tensors), gathered
    over the host: the ranks of data index 0 send their slices to rank 0
    through their gloo model group, one flat f32 buffer each.  Every rank
    must call it.  The slices' shapes may differ from rank to rank (a
    rank with one head more than another), so the ranks first share
    every leaf's shape and pad their buffers to the longest."""
    host = [{k: t.detach().cpu() for k, t in tree.items()} for tree in trees]
    if mesh.model == 1:
        return host if mesh.is_chief else None
    if mesh.data_index != 0:
        return None
    group = mesh.host_model_group
    shape = torch.tensor([d for tree in host for t in tree.values()
                          for d in t.shape], dtype=torch.int64)
    shapes = [torch.empty_like(shape) for _ in range(mesh.model)]
    dist.all_gather(shapes, shape, group=group)
    sizes = [_leaf_shapes(host, s) for s in shapes]
    longest = max(sum(math.prod(d) for d in size) for size in sizes)
    flat = torch.cat([t.float().reshape(-1) for tree in host
                      for t in tree.values()])
    flat = torch.cat([flat, flat.new_zeros(longest - flat.numel())])
    parts = ([torch.empty_like(flat) for _ in range(mesh.model)]
             if mesh.is_chief else None)
    dist.gather(flat, parts, dst=0, group=group)
    if not mesh.is_chief:
        return None
    out = []
    offsets = [0] * mesh.model
    leaf = 0
    for tree in host:
        shards = [{} for _ in parts]
        for j, (k, t) in enumerate(tree.items()):
            for i, part in enumerate(parts):
                size = sizes[i][leaf + j]
                n = math.prod(size)
                shards[i][k] = part[offsets[i]:offsets[i] + n].view(
                    size).to(t.dtype)
                offsets[i] += n
        leaf += len(tree)
        out.append(unshard_state_dict(shards))
    return out


def _leaf_shapes(host, dims: torch.Tensor) -> list:
    """Every leaf's shape in `dims` (one rank's shapes, flattened in the
    order of `host`'s leaves, whose ranks of dims they share)."""
    out, at = [], 0
    for tree in host:
        for t in tree.values():
            out.append(tuple(int(d) for d in dims[at:at + t.dim()]))
            at += t.dim()
    return out


# -- the collectives of a tensor-parallel layer -------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward all-reduces the gradient over the model
    group.  At a column-parallel layer's input: each rank's heads (or
    hidden slice) give only part of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over the model group; identity backward.  At a
    row-parallel layer's output: each rank holds a partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherHead(torch.autograd.Function):
    """One head's columns from the ranks that share it: forward puts this
    rank's run [start, start + n) into zeros `width` wide and sums them
    over the head's group, exactly (each column comes from one rank);
    backward sums the gradient over the group (every rank's kept columns
    of the output reach every column of q, k and v) and keeps this rank's
    run."""

    @staticmethod
    def forward(ctx, x, group, start, width):
        ctx.group, ctx.start, ctx.n = group, start, x.shape[-1]
        full = x.new_zeros(*x.shape[:-1], width)
        full[..., start:start + x.shape[-1]] = x
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[..., ctx.start:ctx.start + ctx.n], None, None, None


def gather_head(x: torch.Tensor, group, start: int,
                width: int) -> torch.Tensor:
    """x [..., n], this rank's columns [start, start + n) of a head
    `width` wide, gathered whole from the ranks of `group`."""
    return _GatherHead.apply(x, group, start, width)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)
