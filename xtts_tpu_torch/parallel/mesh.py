"""Device mesh, tensor-parallel rules and the collectives (port of
xtts_tpu/parallel/mesh.py).

JAX lays a (data x model) `jax.sharding.Mesh` over the chips and lets
GSPMD insert the collectives. Here a `Mesh` is the same grid over the
ranks of the default `torch.distributed` process group: rank r sits at
(r // n_model, r % n_model). Each rank holds its data index's rows of the
global batch and its model index's shard of every parameter that a rule
shards; the collectives are written out below, and every one of them goes
through `all_reduce` over the rank's data or model group (gloo, which the
CPU tests use, supports little else on CUDA tensors; NCCL is the backend
for several cards).

Axes:
  data   batch rows (the reference's only strategy, HF Accelerate DDP);
  model  tensor parallel for the GPT (GPT_PARAM_RULES): attention heads and
         MLP columns, as in JAX.

Data parallelism keeps the single-device result: each rank's loss is its
share of the global batch's loss (the shares sum to it), its gradients are
summed over the data group, and random draws are made for the whole
global batch on every rank from one generator, each rank taking its rows.
Tensor parallelism follows Megatron: a column-sharded product takes its
input through `copy_to_model` (identity forward, sum of the gradients
backward) and a row-sharded one sums its output with `reduce_from_model`
(sum forward, identity backward), so the replicated parameters get their
whole gradient on every model rank.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

import torch
import torch.distributed as dist
import torch.nn.functional as F

REPLICATED = None


@dataclass(eq=False)
class Mesh:
    """A (n_data x n_model) grid of the default group's ranks. data_group:
    the ranks of this rank's model index (one per data index); model_group:
    the ranks of this rank's data index. A group of one rank is None and
    its collectives return their input."""

    n_data: int
    n_model: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the default process group (one rank when
    none is initialised). Every rank calls it, with the same sizes: making
    the groups is itself collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"{n_data}x{n_model} != {world} ranks")
    data_group = model_group = None
    if world > 1:
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            g = dist.new_group(ranks) if n_data > 1 else None
            if rank in ranks:
                data_group = g
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            g = dist.new_group(ranks) if n_model > 1 else None
            if rank in ranks:
                model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


# ---------------------------------------------------------------------------
# collectives (all_reduce only)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, as a new tensor (t itself when the group
    is one rank)."""
    if group is None:
        return t
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_flat(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over `group`, in one all_reduce of their
    concatenation."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


class _SumBoth(torch.autograd.Function):
    """Sum over the group forward and backward: the gradient of a sum of
    per-rank terms that each read the reduced value."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def _grad_call(fn, x, group):
    if group is None:
        return x
    return fn.apply(x, group)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's f: identity forward, gradients summed over the model
    group backward (the input of a column-sharded product)."""
    return _grad_call(_SumBackward, x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's g: partial results summed over the model group forward,
    identity backward (the output of a row-sharded product)."""
    return _grad_call(_SumForward, x, mesh.model_group)


def data_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the data group, differentiable: each rank's loss share
    may read the sum, and its gradient sums the shares' gradients."""
    if mesh is None:
        return x
    return _grad_call(_SumBoth, x, mesh.data_group)


def data_total(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the data group, outside autograd (counts, the DVAE's
    EMA statistics)."""
    if mesh is None:
        return x
    return all_reduce(x.detach(), mesh.data_group)


def mean_share(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A rank's share of a mean over the global batch, from the mean over
    its rows (every rank holds as many rows)."""
    return x if mesh is None else x / mesh.n_data


# ---------------------------------------------------------------------------
# batch rows (the counterparts of data_sharding and replicated)


def data_rows(mesh: Optional[Mesh], n_rows: int) -> slice:
    """This rank's rows of a global batch of n_rows (contiguous blocks, as
    JAX's P('data') places them)."""
    if mesh is None:
        return slice(0, n_rows)
    if n_rows % mesh.n_data:
        raise ValueError(f"batch of {n_rows} rows over {mesh.n_data} data "
                         f"ranks")
    per = n_rows // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(batch: Mapping[str, torch.Tensor], mesh: Optional[Mesh],
                axis: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's rows of every tensor of the batch along `axis`."""
    if mesh is None:
        return dict(batch)
    return {k: v.narrow(axis, *_start_len(data_rows(mesh, v.shape[axis])))
            for k, v in batch.items()}


def _start_len(s: slice) -> Tuple[int, int]:
    return s.start, s.stop - s.start


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                differentiable: bool = False) -> torch.Tensor:
    """Every data rank's rows of x, in order: each rank's rows placed in a
    zero global buffer and the buffers summed. differentiable: the rank's
    rows get the summed gradient of every rank's use of the result."""
    if mesh is None or mesh.n_data == 1:
        return x
    b = x.shape[0]
    pad = (0, 0) * (x.dim() - 1) + (mesh.data_index * b,
                                    (mesh.n_data - 1 - mesh.data_index) * b)
    full = F.pad(x, pad)
    return data_sum(full, mesh) if differentiable else data_total(full, mesh)


# ---------------------------------------------------------------------------
# a serving replica's block of a wave (TextToSpeech.place_on_mesh)

_BLOCK: contextvars.ContextVar = contextvars.ContextVar("row_block",
                                                       default=None)


@contextlib.contextmanager
def row_block(index: int, count: int):
    """Inside it, the batch-level draws (block_draw: sampling.sample_token,
    gaussian.randn_rows with one generator) are made for `count` equal
    blocks of rows and keep block `index`. A replica that holds that block
    of a wave and starts from the wave's generator state thus draws the
    numbers the whole wave gives its rows, as JAX's one key for a sharded
    batch does. count 1 changes nothing."""
    token = _BLOCK.set((index, count) if count > 1 else None)
    try:
        yield
    finally:
        _BLOCK.reset(token)


def current_block() -> Optional[Tuple[int, int]]:
    """(index, count) of the row_block in force, or None."""
    return _BLOCK.get()


def block_draw(draw: Callable[[Tuple[int, ...]], torch.Tensor],
               shape) -> torch.Tensor:
    """draw(shape), whose leading axis is the rows, for the row_block in
    force: drawn for all its blocks, this block's rows kept."""
    blk = _BLOCK.get()
    if blk is None:
        return draw(tuple(shape))
    i, n = blk
    b = shape[0]
    return draw((n * b,) + tuple(shape[1:]))[i * b:(i + 1) * b]


# ---------------------------------------------------------------------------
# parameter partition rules
#
# (name regex, sharded dimension); first match wins, default replicated.
# Names are the port's (the reference's) state-dict names. HF GPT2 Conv1D
# weights are (in, out) like a flax kernel; nn.Linear's are (out, in).

GPT_PARAM_RULES: List[Tuple[str, int]] = [
    # attention qkv / mlp up: shard output features (c_attn by heads within
    # each of q, k and v: Conv1D.tp_groups)
    (r".*attn\.c_attn\.weight", 1),
    (r".*attn\.c_attn\.bias", 0),
    (r".*mlp\.c_fc\.weight", 1),
    (r".*mlp\.c_fc\.bias", 0),
    # attention out / mlp down: shard input features
    (r".*attn\.c_proj\.weight", 0),
    (r".*mlp\.c_proj\.weight", 0),
    # the mel embedding by vocabulary, the mel head by output column
    (r".*mel_embedding\.weight", 0),
    (r".*mel_head\.weight", 0),
    (r".*mel_head\.bias", 0),
]


def partition_spec_tree(names: Iterable[str], rules=GPT_PARAM_RULES
                        ) -> Dict[str, Optional[int]]:
    """Each parameter name -> its sharded dimension, or REPLICATED."""
    out = {}
    for n in names:
        out[n] = REPLICATED
        for pat, dim in rules:
            if re.fullmatch(pat, n):
                out[n] = dim
                break
    return out


def _split_view(t: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    shape = list(t.shape)
    return t.reshape(shape[:dim] + [groups, shape[dim] // groups]
                     + shape[dim + 1:])


def take_shard(full: torch.Tensor, dim: int, groups: int, n: int,
               i: int) -> torch.Tensor:
    """Shard i of n of `full` along `dim`; with groups > 1 the dimension is
    `groups` equal blocks (c_attn's q, k, v) and each is split alike."""
    v = _split_view(full, dim, groups)
    per = v.shape[dim + 1]
    if per % n:
        raise ValueError(f"dimension {dim} of {tuple(full.shape)} does not "
                         f"split {n} ways")
    s = per // n
    part = v.narrow(dim + 1, i * s, s)
    shape = list(full.shape)
    shape[dim] //= n
    return part.reshape(shape).contiguous()


def gather_shard(local: torch.Tensor, dim: int, groups: int,
                 mesh: Mesh) -> torch.Tensor:
    """The full tensor from every model rank's shard (no gradient)."""
    n, i = mesh.n_model, mesh.model_index
    shape = list(local.shape)
    shape[dim] *= n
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    v = _split_view(full, dim, groups)
    s = v.shape[dim + 1] // n
    v.narrow(dim + 1, i * s, s).copy_(_split_view(local, dim, groups))
    return all_reduce(full, mesh.model_group)


@dataclass(frozen=True)
class ShardSpec:
    """How a parameter is held: `dim` split n_model ways, in `groups`
    blocks (ShardSpec.dim None: replicated)."""

    dim: int
    groups: int = 1


def shard_params(model: torch.nn.Module, mesh: Mesh,
                 rules=GPT_PARAM_RULES) -> Dict[str, ShardSpec]:
    """Cut every parameter that a rule shards to this rank's model shard, in
    place, and switch its module to the tensor-parallel forward (the
    module's `tp` attribute). Returns the sharded parameters' specs."""
    if mesh.n_model == 1 or not rules:
        return {}
    specs = {}
    names = [n for n, _ in model.named_parameters()]
    for name, dim in partition_spec_tree(names, rules).items():
        if dim is REPLICATED:
            continue
        owner_name, leaf = name.rpartition(".")[::2]
        owner = model.get_submodule(owner_name)
        spec = ShardSpec(dim, getattr(owner, "tp_groups", 1))
        p = getattr(owner, leaf)
        with torch.no_grad():
            p.data = take_shard(p.data, dim, spec.groups, mesh.n_model,
                                mesh.model_index)
        if leaf == "weight":
            owner.tp = TensorParallel(mesh, dim)
        specs[name] = spec
    return specs


@dataclass(frozen=True)
class TensorParallel:
    """A module's place in the model axis: its weight is split along `dim`
    of its stored layout."""

    mesh: Mesh
    dim: int


def column_gather(y_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A column-sharded product's output (..., n / n_model) -> the full
    (..., n) on every model rank: zero-padded shards summed."""
    n, i = mesh.n_model, mesh.model_index
    w = y_local.shape[-1]
    return reduce_from_model(F.pad(y_local, (i * w, (n - 1 - i) * w)), mesh)


def vocab_lookup(idx: torch.Tensor, weight: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """Embedding rows from a vocabulary-sharded table: each model rank looks
    up the ids in its range, zero elsewhere, and the results are summed."""
    per = weight.shape[0]
    off = mesh.model_index * per
    local = idx - off
    inside = (local >= 0) & (local < per)
    e = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                    weight)
    return reduce_from_model(e * inside[..., None].to(e.dtype), mesh)
