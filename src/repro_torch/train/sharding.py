"""Parameter, batch and cache placements on a ``DeviceMesh``.

The port of ``repro.train.sharding``. The rules are the reference's: a
regex over each leaf's tree path gives a spec, one entry a tensor dim (a
mesh axis, a tuple of axes, or None). The scheme is Megatron-style tensor
parallelism on ``"model"`` with optional FSDP on ``"data"``:

  embed (V, D)                → (model, None)   vocab-parallel embedding
  attn wq/wk/wv (D, H·hd)     → (fsdp?, model)  column-parallel
  attn wo (H·hd, D)           → (model, fsdp?)  row-parallel
  mlp wi/wg (D, F)            → (fsdp?, model)
  mlp wo (F, D)               → (model, fsdp?)
  moe wi/wg (E, D, F)         → (model, fsdp?, None)  expert-parallel
  moe wo (E, F, D)            → (model, None, fsdp?)
  ssm in/out projections      → column/row parallel like attention
  scalars/norms/biases        → replicated

The port's parameters are keyed by their own names (``named_parameters``);
``convert.reference_path`` gives each its tree path in the reference,
where the per-layer leaves are stacked on a leading layer (or group) axis.
A port spec is the reference's for that stacked leaf with the leading
``None`` dropped. ``sanitize_spec`` drops an axis from a dim it does not
divide (replication is always legal), as the reference does; a spec names
no ``"pod"``: parameters are replicated across pods.

``param_shardings`` turns the sanitised specs into ``DTensor`` placements
(``Shard(d)`` on each mesh dim that splits tensor dim d, else
``Replicate()``), and ``shard_model_`` replaces each parameter of a model
by the ``DTensor`` of this rank's shard (no collective: every rank slices
the same full value). Optimizer moments and gradient accumulators take
their parameter's placement, which with ``fsdp`` is ZeRO-3 over ``"data"``;
without it the moments still shard over ``"model"``.

A batch is split over the data axes (``("pod", "data")`` where a pod axis
exists): ``batch_sharding`` gives its placements and ``local_rows`` this
rank's rows (``serve_rows`` for serving, where a batch that the data axes
do not divide is replicated, as the reference's sanitised spec does).
``cache_specs`` ports the reference's KV/state-cache rule over the port's
cache trees, which are laid out as the reference's; ``local_cache`` builds
this rank's shard of a cache from it, each leaf a ``CacheShard`` in the
cache's ``"layout"``.

Specs are tuples; a mesh is a ``DeviceMesh`` or, for the spec functions,
anything with a ``shape`` mapping of axis sizes (a dict is taken too).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.models.meshctx import batch_axes

__all__ = ["NamedSharding", "axis_sizes", "batch_sharding", "cache_specs", "data_axis",
           "expert_parallel", "local", "local_rows", "param_shardings",
           "param_specs", "placed_like", "placements", "resident_bytes",
           "sanitize_spec", "serve_rows", "shard_like", "shard_model_",
           "CacheShard", "cache_leaf_spec", "layer_shards", "local_cache",
           "new_cache"]

# (regex over '/'-joined path, spec WITHOUT the stacked-layer leading axis)
_RULES = [
    (r"embed$", ("model", None)),
    (r"dec_pos$", (None, None)),
    (r"vision_proj/w$", (None, "model")),
    # attention
    (r"(attn|xattn)/w[qkv]/w$", ("_fsdp", "model")),
    (r"(attn|xattn)/w[qkv]/b$", ("model",)),
    (r"(attn|xattn)/wo/w$", ("model", "_fsdp")),
    # dense mlp
    (r"(mlp|dense)/w[ig]/w$", ("_fsdp", "model")),
    (r"(mlp|dense)/wo/w$", ("model", "_fsdp")),
    # moe experts: expert dim over model (EP), feature dims over fsdp
    (r"moe/router$", (None, None)),
    (r"moe/w[ig]$", ("model", "_fsdp", None)),
    (r"moe/wo$", ("model", None, "_fsdp")),
    # mamba2
    (r"in_proj/w$", ("_fsdp", "model")),
    (r"out_proj/w$", ("model", "_fsdp")),
    (r"conv_w$", (None, "model")),
    # griffin recurrent branch
    (r"(in_x|in_gate)/w$", ("_fsdp", "model")),
    (r"out/w$", ("model", "_fsdp")),
    (r"(gate_[ri]_[wb]|lam)$", ("model",)),
]

#: The leaves that ``layers.moe`` uses split over ``"model"``: each rank
#: runs its own experts, so their expert axis is never gathered.
_EXPERT_PARALLEL = re.compile(r"moe/w[igo]$")

Spec = Tuple[Any, ...]


class NamedSharding(NamedTuple):
    """Where a tensor lives: a ``DeviceMesh`` and one ``DTensor`` placement
    a mesh dim (the reference's ``NamedSharding(mesh, spec)``)."""
    mesh: Any
    placements: tuple


def _spec_for(path_s: str, ndim: int, fsdp: bool) -> Spec:
    for pat, spec in _RULES:
        if re.search(pat, path_s):
            axes = tuple(("data" if fsdp else None) if a == "_fsdp" else a
                         for a in spec)
            # stacked-layer leading dims: pad with None on the left
            pad = ndim - len(axes)
            if pad < 0:  # rule is wider than the actual array (e.g. no bias)
                axes = axes[-ndim:] if ndim else ()
            return (None,) * max(pad, 0) + axes
    return ()  # replicate (norms, scalars, small tables)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, of an object whose ``shape``
    is such a mapping (the reference's tests' fake mesh), or of a
    mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def _axis_size(sizes: Mapping[str, int], entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in names:
        n *= sizes.get(a, 1)
    return n


def sanitize_spec(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """Drop sharding on dims the mesh axes don't divide (replication is
    always legal). E.g. mamba2's vocab 50280 and minicpm's 122753 aren't
    16-divisible."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if i >= len(shape) or entry is None:
            out.append(entry)
            continue
        out.append(entry if shape[i] % _axis_size(sizes, entry) == 0
                   else None)
    return tuple(out)


def _reference_leaf(name: str, cfg) -> Tuple[str, bool]:
    from repro_torch.models.convert import reference_path
    return reference_path(name, cfg)


def param_spec(name: str, ndim: int, cfg, *, fsdp: bool = False) -> Spec:
    """The spec of the port's parameter ``name`` (``ndim`` dims): the
    reference's for its (stacked) tree leaf, the stacked axis dropped.

    Raises:
      ValueError: a rule that would shard the stacked layer axis.
    """
    path, stacked = _reference_leaf(name, cfg)
    spec = _spec_for(path, ndim + int(stacked), fsdp)
    if not stacked or not spec:
        return spec
    if spec[0] is not None:
        raise ValueError(f"{path}: the rule shards the stacked layer axis "
                         f"({spec}), which the port's per-layer {name} "
                         f"lacks")
    return spec[1:]


def param_specs(model, *, fsdp: bool = False) -> Dict[str, Spec]:
    """{parameter name: spec} of ``model`` (any family; a model on the meta
    device will do), unsanitised, as the reference's ``param_specs``."""
    cfg = model.cfg
    return {name: param_spec(name, p.dim(), cfg, fsdp=fsdp)
            for name, p in model.named_parameters()}


def expert_parallel(name: str, cfg) -> bool:
    """Whether ``name`` is an expert stack that ``layers.moe`` uses split
    over ``"model"`` (its expert axis is never gathered)."""
    return bool(_EXPERT_PARALLEL.search(_reference_leaf(name, cfg)[0]))


def placements(spec: Sequence, mesh) -> tuple:
    """The ``DTensor`` placements of a sanitised ``spec`` on ``mesh``: for
    each mesh dim, ``Shard(d)`` when it is among the axes of tensor dim
    d's entry, else ``Replicate()``.

    Raises:
      ValueError: a mesh dim named by two entries.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a not in names:
                continue
            m = names.index(a)
            if not isinstance(out[m], Replicate):
                raise ValueError(f"spec {tuple(spec)} names mesh axis {a!r} "
                                 f"twice")
            out[m] = Shard(d)
    return tuple(out)


def param_shardings(model, mesh, *, fsdp: bool = False
                    ) -> Dict[str, NamedSharding]:
    """{parameter name: ``NamedSharding``} of ``model`` on ``mesh``, from
    its sanitised specs."""
    specs = param_specs(model, fsdp=fsdp)
    return {name: NamedSharding(mesh, placements(
        sanitize_spec(specs[name], p.shape, mesh), mesh))
        for name, p in model.named_parameters()}


def _local_slice(full: torch.Tensor, plc: Sequence, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``plc``: the mesh dims in order,
    each splitting its tensor dim into equal chunks (the outer mesh dim
    first, as ``DTensor`` lays out two mesh dims on one tensor dim)."""
    from torch.distributed.tensor import Shard

    x = full
    for m, p in enumerate(plc):
        if isinstance(p, Shard):
            n = mesh.size(m)
            c = mesh.get_local_rank(m)
            step = x.shape[p.dim] // n
            x = x.narrow(p.dim, c * step, step)
    return x


def shard_like(full: torch.Tensor, plc: Sequence, mesh, *,
               dtype: Optional[torch.dtype] = None):
    """The ``DTensor`` of ``full`` placed by ``plc`` on ``mesh``: a contiguous
    copy of this rank's block (cast to ``dtype``; never a view of
    ``full``), wrapped without a collective (every rank holds the same
    ``full``)."""
    from torch.distributed.tensor import DTensor

    # a copy: a block of a contiguous tensor (a split of dim 0) is a view,
    # which would keep the whole full tensor alive beside the shard
    local = _local_slice(full, plc, mesh).to(
        dtype=dtype or full.dtype, memory_format=torch.contiguous_format,
        copy=True)
    return DTensor.from_local(local, mesh, tuple(plc), run_check=False,
                              shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


@torch.no_grad()
def shard_model_(model, mesh, *, fsdp: bool = False
                 ) -> Dict[str, NamedSharding]:
    """Replace every parameter of ``model`` by the ``DTensor`` of this rank's
    shard (its ``requires_grad`` and draw attributes kept), one parameter at
    a time, so the full value of only one is held beside the shards.
    Returns ``param_shardings``."""
    from torch import nn

    plc = param_shardings(model, mesh, fsdp=fsdp)
    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        new = nn.Parameter(shard_like(p.data, plc[name].placements, mesh),
                           requires_grad=p.requires_grad)
        for attr in ("he_fan", "init_std", "init_fill"):
            if hasattr(p, attr):
                setattr(new, attr, getattr(p, attr))
        new.expert_parallel = expert_parallel(name, model.cfg)
        owner._parameters[leaf] = new
        del p
    return plc


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (a view), or ``t`` itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, this rank's shard of a tensor placed as ``like``, as a
    ``DTensor`` of ``like``'s placements (no collective); ``t`` itself
    when ``like`` is not a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def data_axis(mesh) -> Tuple[str, ...]:
    """The mesh axes that carry the batch (``meshctx.batch_axes``):
    ``("pod", "data")`` on the multi-pod mesh, ``("data",)`` on the
    others."""
    return batch_axes(axis_sizes(mesh))


def _entry(axes: Tuple[str, ...]):
    """A spec entry of ``axes``: one axis by its name, as a
    ``PartitionSpec`` normalises it; None for no axis."""
    return (axes[0] if len(axes) == 1 else axes) if axes else None


def batch_sharding(mesh, ndim_or_shape) -> NamedSharding:
    """Where a batch-leading input lives: the batch over the data axes.
    Given a shape (preferred), the split is dropped where the data axes do
    not divide the batch, as the reference's sanitised spec."""
    ax = _entry(data_axis(mesh))
    if isinstance(ndim_or_shape, int):
        spec = (ax,) + (None,) * (ndim_or_shape - 1)
    else:
        shape = tuple(ndim_or_shape)
        spec = sanitize_spec((ax,) + (None,) * (len(shape) - 1), shape, mesh)
    return NamedSharding(mesh, placements(spec, mesh))


def local_rows(batch: Mapping[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each batch-leading tensor (its block of the data
    axes' split).

    Raises:
      ValueError: a batch the data axes do not divide (the port never
        replicates a batch over the data ranks: their gradients are
        summed).
    """
    sizes = axis_sizes(mesh)
    n = _axis_size(sizes, data_axis(mesh))
    out = {}
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{key!r}] has {x.shape[0]} rows, not a "
                             f"multiple of the {n} data ranks")
        out[key] = _local_slice(x, batch_sharding(mesh, x.dim()).placements,
                                mesh)
    return out


def serve_rows(batch: Mapping[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each batch-leading tensor for serving: its block
    of the data axes' split where they divide the rows, else every row
    (replicated over the data ranks, as ``batch_sharding``'s sanitised
    spec)."""
    return {key: _local_slice(x, batch_sharding(mesh, x.shape).placements,
                              mesh)
            for key, x in batch.items()}


def cache_leaf_spec(shape: Sequence[int], mesh, batch_size: int) -> Spec:
    """The sanitised spec of one cache leaf of global ``shape``
    (``cache_specs``' rule): the batch dim (the first of dims 0 and 1 of
    size ``batch_size``) over the data axes; a 5-D (L, B, T, H, hd) KV leaf
    also its heads over ``"model"`` where the axis divides them, else its
    sequence (flash-decode style)."""
    ax = _entry(data_axis(mesh))
    sizes = axis_sizes(mesh)
    entries = [None] * len(shape)
    for i, d in enumerate(shape[:2]):  # batch dim is dim 0 or 1
        if d == batch_size:
            entries[i] = ax
            break
    if len(shape) >= 5:  # (L, B, T, H, hd): heads over model, else seq
        if shape[3] % _axis_size(sizes, "model") == 0:
            entries[3] = "model"
        else:  # MHA archs (qwen 40H, minicpm 36H): flash-decode style
            entries[2] = "model"
    return sanitize_spec(tuple(entries), shape, mesh)


def cache_specs(cache, mesh, batch_size: int):
    """KV/state caches: shard the batch dim (identified by size — caches
    are (L, B, ...) for the layer-stacked families but (B, ...) for the
    hybrid's ring-buffer blocks) over data; for layer-stacked 5-D KV
    caches (L, B, T, H, hd) also shard heads over model when divisible,
    else the sequence (flash-decode style). batch=1 replicates.

    Returns the cache's structure (dicts, lists, tuples) with a sanitised
    spec in place of each tensor and None in place of anything else (the
    host int ``pos``)."""
    def spec(x):
        if not isinstance(x, torch.Tensor):
            return None
        return cache_leaf_spec(tuple(x.shape), mesh, batch_size)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return spec(node)

    return walk(cache)


class CacheShard(NamedTuple):
    """Where this rank's block of a cache leaf lies: the leaf's global
    ``shape`` and, on each dim, the global index range [lo, hi) it holds.
    ``layer()`` is the same for one layer's slice (dim 0 dropped)."""
    shape: tuple
    ranges: tuple

    def layer(self) -> "CacheShard":
        return CacheShard(self.shape[1:], self.ranges[1:])

    @property
    def split(self) -> bool:
        """Of a layer's shard ((B, T, ...), ``layer()``): whether a dim past
        the batch is split (the heads or the sequence)."""
        return any((lo, hi) != (0, n) for n, (lo, hi) in
                   zip(self.shape[1:], self.ranges[1:]))


def _block_ranges(shape: Sequence[int], plc: Sequence, mesh) -> tuple:
    """The [lo, hi) of this rank's block of each dim under ``plc``, the mesh
    dims in order (as ``_local_slice`` cuts them)."""
    from torch.distributed.tensor import Shard

    ranges = [[0, int(n)] for n in shape]
    for m, p in enumerate(plc):
        if isinstance(p, Shard):
            lo, hi = ranges[p.dim]
            step = (hi - lo) // mesh.size(m)
            lo += mesh.get_local_rank(m) * step
            ranges[p.dim] = [lo, lo + step]
    return tuple(tuple(r) for r in ranges)


def local_cache(cache, mesh, batch_size: int, device) -> Dict[str, Any]:
    """This rank's shard of ``cache`` (a model's cache on ``meta``, of the
    global batch ``batch_size``): each top-level tensor leaf becomes zeros
    of its block's shape under ``cache_specs``' placements on ``device``,
    and a nested list of leaves (the hybrid's blocks) each leaf the same;
    the other entries (``pos``) are kept. The cache gains ``"layout"``:
    {name: ``CacheShard``} of the top-level leaves."""
    def local(x):
        plc = placements(cache_leaf_spec(tuple(x.shape), mesh, batch_size),
                         mesh)
        ranges = _block_ranges(x.shape, plc, mesh)
        return (torch.zeros([hi - lo for lo, hi in ranges], dtype=x.dtype,
                            device=device),
                CacheShard(tuple(int(n) for n in x.shape), ranges))

    def walk(node):
        if isinstance(node, torch.Tensor):
            return local(node)[0]
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    out, layout = {}, {}
    for key, x in cache.items():
        if isinstance(x, torch.Tensor):
            out[key], layout[key] = local(x)
        else:
            out[key] = walk(x)
    out["layout"] = layout
    return out


def layer_shards(cache: Mapping[str, Any], names: Sequence[str]):
    """The layer-level ``CacheShard``s of a sharded cache's leaves
    ``names`` (a tuple in that order), or None for a whole cache (no
    ``"layout"``)."""
    layout = cache.get("layout")
    if not layout:
        return None
    return tuple(layout[n].layer() for n in names)


def new_cache(build, batch_size: int, device) -> Dict[str, Any]:
    """A model's cache of ``batch_size`` rows: ``build(device)`` (the
    model's tree of cache leaves) without an active mesh; under one, this
    rank's shard of ``build("meta")`` (``local_cache``), so only the shard
    is allocated."""
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.models.meshctx import active_mesh

    mesh = active_mesh()
    if mesh is None:
        return build(device)
    # the global cache on meta is a template of shapes and dtypes: no
    # dispatch mode (the dry run's tally) counts it as memory
    with _disable_current_modes():
        template = build("meta")
    return local_cache(template, mesh, batch_size, device)


def resident_bytes(tensors) -> int:
    """The bytes this rank holds for ``tensors`` (an iterable of tensors or
    ``DTensor``s): each one's local shard."""
    total = 0
    for t in tensors:
        loc = local(t)
        total += loc.numel() * loc.element_size()
    return total
