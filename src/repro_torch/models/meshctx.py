"""Context-scoped activation layouts, and the collectives that keep them.

The port of ``repro.models.meshctx``. The models are mesh-free: without an
active mesh ``constrain`` returns its input itself and every helper here is
the identity, so the one-card paths run the code they ran before. Under
``activation_mesh(mesh)`` (a ``torch.distributed`` ``DeviceMesh``) the port
is SPMD, one process a rank, and these functions are where ranks meet:

- Activations carry this rank's rows of the batch (the train step splits
  the batch over the data axes before the forward). So a ``"batch"`` entry
  of a layout holds already, and the reference's residual-stream
  constraints (``constrain(x, "batch", None, None)`` in each block) have
  no counterpart here.
- A ``"model"`` entry cuts the tensor to this rank's block of that dim
  (when the axis divides it, as the reference's sanitised spec), through a
  differentiable take whose backward all-reduces the gradient over
  ``"model"``: the code before the cut runs replicated over the model
  ranks, so its gradient must be the same on each. ``whole`` is the
  inverse, an all-gather whose backward keeps this rank's block.
- ``local_heads`` lays q, k and v out by heads over ``"model"`` for the
  attention (``layers.attention``): q's heads are cut when the axis divides
  them; k and v are cut the same way when it divides theirs, else each rank
  takes the kv heads that its q heads read (GQA), so K6 (or the chunked
  scan) runs, unchanged, on this rank's heads.
- ``batch_sum`` and ``batch_mean`` reduce over the data axes (the loss's
  token count, the MoE load-balance means): a loss over the whole batch.
- ``gather_param`` and ``gathered`` turn a parameter held as a ``DTensor``
  shard (``train.sharding.shard_model_``) into the full tensor a layer
  reads, inside the block that reads it (under ``layers.remat``, so a
  rematerialised block gathers again in the backward). Its backward sums
  the gradient over the data axes (a reduce-scatter where the parameter is
  split over them: ZeRO-3) and keeps this rank's block over ``"model"``.
  Expert stacks (``expert_parallel``) keep their ``"model"`` split: each
  rank runs its own experts (``layers.moe``).

Serving under a mesh (the models' ``prefill`` and ``decode_step``, and
``train.serve_step.greedy_generate``) gathers parameters as training does,
each block's inside the block and the others around the whole step, and
runs on this rank's rows of the batch. Its KV cache is this rank's shard
(``train.sharding.local_cache``); over a cache split by sequence the
ranks' partial attentions meet in ``lse_merge``. ``gather_rows`` gives
every rank the whole batch's rows of an output.

A sharded parameter read anywhere else (no active mesh, or outside a
gathered block) raises: PyTorch refuses to mix
``DTensor`` and plain tensor arguments, so no op falls back to a silent
replicate. Every collective here is a plain ``torch.distributed`` call
on the mesh's process groups.

Axis aliases: "batch" → all data-carrying mesh axes (("pod","data") on the
multi-pod mesh), "model" → "model". Layouts are divisibility-sanitised.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["activation_mesh", "active_mesh", "batch_axes", "batch_mean",
           "batch_sum", "constrain", "full_value", "gather_param", "gathered",
           "gather_rows", "head_split", "local_heads", "lse_merge",
           "run_gathered", "whole"]

_ACTIVE = None


@contextlib.contextmanager
def activation_mesh(mesh):
    """Make ``mesh`` (or None) the active mesh inside the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh of the innermost ``activation_mesh``, or None."""
    return _ACTIVE


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def batch_axes(names: Iterable[str]) -> Tuple[str, ...]:
    """The axes among mesh axis ``names`` that carry the batch (the
    ``"batch"`` alias): ``"pod"`` and ``"data"``, in mesh order."""
    return tuple(a for a in names if a in ("pod", "data"))


def _data_axes(mesh) -> Tuple[str, ...]:
    return batch_axes(_names(mesh))


def _size(mesh, axis: str) -> int:
    return mesh.size(_names(mesh).index(axis))


def _resolve(axis, mesh):
    if axis == "batch":
        ax = _data_axes(mesh)
        return ax if ax else None
    if axis == "model":
        return "model" if "model" in _names(mesh) else None
    return axis


# ------------------------------------------------------------ collectives

# the single-tensor collectives under the names of the installed release
# (newer ones deprecate the older names)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``group`` (``n`` ranks), in rank
    order."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    _ALL_GATHER(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int
                        ) -> torch.Tensor:
    """Sum ``x`` over ``group`` and keep this rank's block along ``dim``."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    _REDUCE_SCATTER(out, xt, group=group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


class _Take(torch.autograd.Function):
    """Forward: the entries ``index`` of ``dim`` (this rank's block of a
    tensor replicated over ``axis``). Backward: the gradient scattered into
    the full shape and summed over ``axis``."""

    @staticmethod
    def forward(ctx, x, dim, index, group):
        ctx.dim, ctx.index, ctx.group = dim, index, group
        ctx.full = x.shape
        return x.index_select(dim, index).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.full)
        full.index_add_(ctx.dim, ctx.index, g.contiguous())
        return _all_reduce(full, ctx.group), None, None, None


class _Whole(torch.autograd.Function):
    """Forward: all-gather along ``dim`` over ``axis``. Backward: this
    rank's block of the gradient (what follows runs replicated)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.rank, ctx.len = dim, rank, x.shape[dim]
        return _gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.len, ctx.len).contiguous(),
                None, None, None, None)


def _take(x, dim: int, index: Sequence[int], axis: str, mesh):
    idx = torch.as_tensor(list(index), dtype=torch.long, device=x.device)
    return _Take.apply(x, dim, idx, mesh.get_group(axis))


def _block(x, dim: int, axis: str, mesh):
    n = _size(mesh, axis)
    step = x.shape[dim] // n
    lo = mesh.get_local_rank(axis) * step
    return _take(x, dim, range(lo, lo + step), axis, mesh)


def whole(x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
    """The full tensor of ``x``, this rank's block of ``dim`` over ``axis``
    of the active mesh (an all-gather; its backward keeps this rank's
    block). ``x`` itself without a mesh or when the axis has one rank."""
    mesh = _ACTIVE
    if mesh is None or axis not in _names(mesh) or _size(mesh, axis) == 1:
        return x
    return _Whole.apply(x, dim, mesh.get_group(axis), _size(mesh, axis),
                        mesh.get_local_rank(axis))


def constrain(x, *spec):
    """No-op without an active mesh. spec entries: "batch", "model", None.

    Under a mesh: a "batch" entry holds already (activations are this
    rank's rows); each other entry cuts its dim to this rank's block of
    its axes, where the axes divide it (else the dim stays whole, as the
    reference's sanitised layout replicates it). Returns ``x`` itself when
    nothing is cut."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    data = set(_data_axes(mesh))
    for dim, axis in enumerate(spec):
        entry = _resolve(axis, mesh)
        if entry is None:
            continue
        axes = tuple(a for a in (entry if isinstance(entry, tuple)
                                 else (entry,))
                     if a not in data and a in _names(mesh)
                     and _size(mesh, a) > 1)
        n = 1
        for a in axes:
            n *= _size(mesh, a)
        if not axes or x.shape[dim] % n:
            continue
        for a in axes:
            x = _block(x, dim, a, mesh)
    return x


def head_split(hq: int, hkv: int, n: int, rank: int
               ) -> Optional[Tuple[range, List[int]]]:
    """The heads model rank ``rank`` of ``n`` runs: (its q heads, the kv
    heads they read, in the order the local call takes them), or None when
    ``n`` does not divide ``hq`` (the heads stay whole). The kv heads are
    this rank's block where ``n`` divides ``hkv``; else the ones its q heads
    read (q head i reads kv head i // (hq / hkv)), each once when every one
    of them is read by the same run of q heads, else one a q head."""
    if n <= 1 or hq % n:
        return None
    hl, g = hq // n, hq // hkv
    lo = rank * hl
    if hkv % n == 0:
        kl = hkv // n
        return range(lo, lo + hl), list(range(rank * kl, (rank + 1) * kl))
    reads = [(lo + j) // g for j in range(hl)]
    kv = sorted(set(reads))
    if hl % len(kv) or reads != [h for h in kv for _ in range(hl // len(kv))]:
        kv = reads
    return range(lo, lo + hl), kv


def local_heads(q, k, v) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  Callable]:
    """q (B, S, Hq, hd), k and v (B, T, Hkv, hd) laid out by heads over
    ``"model"``; returns (q, k, v, join) where ``join`` brings an output of
    the returned q's heads back to all Hq heads. Without a mesh, or when
    the model axis does not divide Hq, the inputs themselves and the
    identity."""
    q_loc = constrain(q, "batch", None, "model", None)
    if q_loc is q:
        return q, k, v, lambda o: o
    mesh = _ACTIVE
    k_loc = constrain(k, "batch", None, "model", None)
    v_loc = constrain(v, "batch", None, "model", None)
    if k_loc is k:  # kv heads replicated: the ones this rank's q heads read
        _, kv = head_split(q.shape[2], k.shape[2], _size(mesh, "model"),
                           mesh.get_local_rank("model"))
        k_loc = _take(k, 2, kv, "model", mesh)
        v_loc = _take(v, 2, kv, "model", mesh)
    return q_loc, k_loc, v_loc, lambda o: whole(o, 2, "model")


def lse_merge(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor
              ) -> torch.Tensor:
    """Merge partial attentions over ``"model"`` of the active mesh: each
    rank's (out = Σ exp(x − m)·v, m, l = Σ exp(x − m)) over its keys
    (``layers.decode_attention_partial``). The largest m is all-reduced,
    then the rescaled out and l in one all-reduce; returns Σ out / Σ l,
    (..., hd) fp32. Without a mesh (or a model axis of one rank) the one
    partial normalised."""
    mesh = _ACTIVE
    if mesh is not None and "model" in _names(mesh) \
            and _size(mesh, "model") > 1:
        group = mesh.get_group("model")
        top = m.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        w = torch.exp(m - top)
        packed = torch.cat([out * w[..., None], (l * w)[..., None]], dim=-1)
        dist.all_reduce(packed, group=group)
        out, l = packed[..., :-1], packed[..., -1]
    return out / l[..., None]


def gather_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The whole batch of ``x`` (this rank's rows leading) from every data
    rank of the active mesh, in row order; ``x`` itself without a mesh or
    when it already holds all ``rows`` rows (a batch the data axes do not
    divide is replicated)."""
    mesh = _ACTIVE
    if mesh is None or x.shape[0] == rows:
        return x
    for a in reversed(_data_axes(mesh)):  # the inner axis first
        n = _size(mesh, a)
        if n > 1:
            x = _gather_dim(x, 0, mesh.get_group(a), n)
    return x


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over the data ranks. Backward: the gradient over
    the rank count, each rank's own (the loss term that reads the mean is
    computed alike on every data rank, and the parameter gradients are
    summed over them)."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _data_groups(mesh) -> Tuple[list, int]:
    groups, n = [], 1
    for a in _data_axes(mesh):
        if _size(mesh, a) > 1:
            groups.append(mesh.get_group(a))
            n *= _size(mesh, a)
    return groups, n


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks of the active mesh, outside the
    graph (a count, a metric); ``x`` itself without a mesh."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    groups, _ = _data_groups(mesh)
    if not groups:
        return x
    y = x.detach().clone()
    for g in groups:
        dist.all_reduce(y, group=g)
    return y


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks of the active mesh (each rank
    holds the same number of rows), differentiable; ``x`` itself without
    a mesh."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    groups, n = _data_groups(mesh)
    if not groups:
        return x
    return _BatchMean.apply(x, groups, n)


# --------------------------------------------------------- parameters


def _shard_dims(p) -> List[Tuple[int, str, Optional[int]]]:
    """(mesh dim, axis, tensor dim or None) of a ``DTensor``'s placements."""
    from torch.distributed.tensor import Shard

    names = _names(p.device_mesh)
    return [(m, names[m], pl.dim if isinstance(pl, Shard) else None)
            for m, pl in enumerate(p.placements)]


class _GatherParam(torch.autograd.Function):
    """Forward: all-gather a parameter shard over its split mesh dims (the
    inner mesh dim first), except the kept ones. Backward: over each mesh
    dim in order, a data axis sums the gradient (reduce-scatter to the
    shard where it splits the parameter, else all-reduce); the model axis
    keeps this rank's block where it splits it (the compute that used the
    full tensor ran replicated there)."""

    @staticmethod
    def forward(ctx, local, plan):
        ctx.plan = plan
        return _gather_local(local, plan)

    @staticmethod
    def backward(ctx, g):
        for m, axis, d, group, n, rank, gather, data in ctx.plan:
            if n == 1:
                continue
            if data:
                g = (_reduce_scatter_dim(g, d, group, n) if d is not None
                     else _all_reduce(g, group))
            elif d is not None and gather:
                step = g.shape[d] // n
                g = g.narrow(d, rank * step, step)
        return g.contiguous(), None


def _gather_local(local: torch.Tensor, plan) -> torch.Tensor:
    x = local
    for m, axis, d, group, n, rank, gather, data in reversed(plan):
        if d is not None and gather and n > 1:
            x = _gather_dim(x, d, group, n)
    return x


def _param_plan(p, keep: Iterable[str] = ()):
    mesh = p.device_mesh
    data = set(_data_axes(mesh))
    keep = set(keep)
    return tuple((m, axis, d, mesh.get_group(m), mesh.size(m),
                  mesh.get_local_rank(m), axis not in keep, axis in data)
                 for m, axis, d in _shard_dims(p))


def gather_param(p, keep: Iterable[str] = ()) -> torch.Tensor:
    """The value a layer reads of parameter ``p``: ``p`` itself unless it
    is a ``DTensor``; else its full tensor (differentiable), still split
    over the axes in ``keep``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    return _GatherParam.apply(p.to_local(), _param_plan(p, keep))


@torch.no_grad()
def full_value(p) -> torch.Tensor:
    """The full tensor of a ``DTensor`` (every rank gathers), or ``p``
    itself (a checkpoint's view of a leaf)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    return _gather_local(p.to_local(), _param_plan(p))


def _modules(objs) -> List[torch.nn.Module]:
    out = []
    for o in objs:
        if isinstance(o, torch.nn.Module):
            out.append(o)
        elif isinstance(o, (list, tuple)):
            out.extend(_modules(o))
    return out


@contextlib.contextmanager
def gathered(modules, *, skip: Tuple[type, ...] = ()):
    """Inside the block, every ``DTensor`` parameter of ``modules`` (modules,
    or lists and tuples of them) reads as ``gather_param`` of it, expert
    stacks keeping their ``"model"`` split (``expert_parallel``);
    submodules of a type in ``skip`` are left alone (the model's blocks,
    which ``layers.remat`` gathers one at a time). Nothing happens without
    an active mesh."""
    from torch.distributed.tensor import DTensor

    swapped = []
    try:
        if _ACTIVE is not None:
            seen = set()
            stack = list(_modules(modules))
            while stack:
                mod = stack.pop()
                if id(mod) in seen:
                    continue
                seen.add(id(mod))
                for name, p in list(mod._parameters.items()):
                    if isinstance(p, DTensor):
                        keep = ("model",) if getattr(
                            p, "expert_parallel", False) else ()
                        mod._parameters[name] = gather_param(p, keep)
                        swapped.append((mod, name, p))
                stack.extend(c for c in mod.children()
                             if not isinstance(c, skip))
        yield
    finally:
        for mod, name, p in reversed(swapped):
            mod._parameters[name] = p


def run_gathered(fn: Callable, modules, *args):
    """``fn(*args)`` with ``modules``' parameters gathered (``gathered``)."""
    with gathered(modules):
        return fn(*args)
