"""Loop-aware counting of one traced step, with no HLO.

The port's counterpart of ``repro.launch.hlo_cost``. The reference parses
the optimised HLO of a compiled step and counts each while loop's body
times its trip count; the port runs eagerly, so a step is counted as it
runs: ``OpCost`` is a ``TorchDispatchMode`` that sees every aten op and
every ``c10d`` collective the step dispatches, in order, as many times as
a Python loop runs it. It works on real tensors and on the ``meta`` device
(the dry run, ``launch.dryrun``), where nothing is allocated or launched.
Over the step it records:

* FLOPs by dtype: each op in ``torch.utils.flop_counter``'s registry (the
  products: ``mm``, ``bmm``, ``addmm``, convolutions, ...) counted as
  ``FlopCounterMode`` counts it, under the dtype of its first tensor
  input. Elementwise ops are not FLOPs there, and not here.
* HBM bytes, as eager PyTorch moves them: each op reads its tensor inputs
  and writes its tensor outputs once (``copy_``, ``fill_`` and ``zero_``
  do not read their destination); view and alias ops, and the factories
  that only allocate (``empty``), move nothing.
* Collective bytes by kind (``"all-reduce"``, ``"all-gather"``,
  ``"reduce-scatter"``, ``"all-to-all"``, ``"collective-permute"``), on
  the wire of one rank with the reference's ring factors
  (``roofline.RING_FACTORS``), with each call's group size and global
  ranks, from the ``c10d`` ops that ``models.meshctx`` and the sharded
  lanes issue.
* Live bytes and their peak: every storage an op makes is live from that
  op until its last reference dies (a weak reference to the storage),
  rounded up to 512 bytes, the CUDA caching allocator's block; the caller
  gives the bytes that were live before the step (``start_bytes``:
  weights, state, inputs).
* The hand-written kernels: a kernel wrapper given ``meta`` tensors
  (K6 ``flash_attention_kernel``, K4 ``masked_spgemm_gathered``) returns
  its output's shape and dtype and calls ``record_kernel`` with the work
  the card's kernel would do on those inputs (its FLOPs, by dtype, and the
  bytes it reads and writes). The aten ops the wrapper runs (its output's
  allocation) are counted as any other.

Collectives move no HBM bytes here, and the kernels' work is kept apart
from the aten ops' (``kernels``), so a count of the aten FLOPs can be
held to ``FlopCounterMode``'s.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost", "active_tally", "record_kernel", "tally_bytes"]

#: The CUDA caching allocator's smallest block: every allocation is
#: rounded up to a multiple of it.
ALLOC_BLOCK = 512

_STACK: List["OpCost"] = []

# c10d op name → (collective kind, index of its process-group argument,
# where its size is read: "in" the first tensor, "out" the output buffer)
_C10D = {
    "allreduce_": ("all-reduce", 1, "in"),
    "_allgather_base_": ("all-gather", 2, "out"),
    "allgather_": ("all-gather", 2, "out"),
    "allgather_into_tensor_coalesced_": ("all-gather", 2, "out"),
    "_reduce_scatter_base_": ("reduce-scatter", 2, "in"),
    "reduce_scatter_": ("reduce-scatter", 2, "in"),
    "alltoall_base_": ("all-to-all", 2, "in"),
    "alltoall_": ("all-to-all", 2, "in"),
    "broadcast_": ("collective-permute", 1, "in"),
}
# ops that write their first argument without reading it
_NO_READ_DEST = {"copy_", "fill_", "zero_"}
# factories that only allocate
_ALLOC_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def _rounded(nbytes: int) -> int:
    return -(-int(nbytes) // ALLOC_BLOCK) * ALLOC_BLOCK


def tally_bytes(tensors) -> int:
    """The bytes that ``tensors`` hold, each tensor once (a view counts its
    own elements), each rounded up to ``ALLOC_BLOCK`` as the tally counts
    its live bytes (``start_bytes`` of a step's arguments)."""
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += _rounded(_nbytes(t))
    return total


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def active_tally() -> Optional["OpCost"]:
    """The innermost active ``OpCost``, or None."""
    return _STACK[-1] if _STACK else None


def record_kernel(name: str, *, flops: float, dtype: torch.dtype,
                  bytes_read: int, bytes_written: int) -> None:
    """Record one launch of hand-written kernel ``name`` in the active
    tally (nothing without one): ``flops`` of ``dtype`` and the bytes it
    reads and writes."""
    tally = active_tally()
    if tally is not None:
        tally.kernels.append(dict(name=name, flops=float(flops),
                                  dtype=_dtype_name(dtype),
                                  bytes_read=int(bytes_read),
                                  bytes_written=int(bytes_written)))


class OpCost(TorchDispatchMode):
    """Counts one traced step (see the module docstring).

    Args:
      start_bytes: the bytes live before the step (its arguments), the
        floor of ``live_bytes`` and ``peak_bytes``.

    After the ``with`` block: ``flops`` ({dtype: FLOPs} of the aten ops),
    ``bytes_read`` / ``bytes_written`` (aten ops), ``collectives`` (one
    dict a call: kind, payload ``bytes``, ``wire`` bytes, group ``size``
    and ``ranks``), ``kernels`` (one dict a kernel launch), ``peak_bytes``,
    ``live_bytes`` (at the end) and ``ops`` (aten ops counted).
    """

    def __init__(self, start_bytes: int = 0):
        super().__init__()
        self.flops: Dict[str, float] = collections.defaultdict(float)
        self.bytes_read = 0
        self.bytes_written = 0
        self.collectives: List[dict] = []
        self.kernels: List[dict] = []
        self.ops = 0
        self.live_bytes = self.peak_bytes = int(start_bytes)
        self._tracked: Dict[int, weakref.ref] = {}

    # ------------------------------------------------------------- mode

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STACK.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor)
               and t.__name__ == "DTensor" for t in types):
            return NotImplemented  # DTensor unwraps; its local ops come here
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d":
            self._collective(name, args, out)
            return out
        inputs = list(_tensors(list(args) + list(kwargs.values())))
        outputs = list(_tensors(out))
        self._track(outputs, inputs)
        if func.is_view or name in ("detach", "alias", "lift_fresh") \
                or name in _ALLOC_ONLY:
            return out
        self.ops += 1
        read = inputs[1:] if name in _NO_READ_DEST else inputs
        self.bytes_read += sum(_nbytes(t) for t in read)
        self.bytes_written += sum(_nbytes(t) for t in outputs)
        self._flops(func, args, kwargs, out, inputs)
        return out

    # ---------------------------------------------------------- counting

    def _flops(self, func, args, kwargs, out, inputs) -> None:
        from torch.utils.flop_counter import flop_registry

        count = flop_registry.get(func.overloadpacket)
        if count is None or not inputs:
            return
        self.flops[_dtype_name(inputs[0].dtype)] += float(
            count(*args, **kwargs, out_val=out))

    def _track(self, outputs, inputs) -> None:
        """Make every new storage among ``outputs`` live until its last
        reference dies."""
        owned = {id(t.untyped_storage()) for t in inputs}
        for t in outputs:
            st = t.untyped_storage()
            key = id(st)
            if key in owned:
                continue
            ref = self._tracked.get(key)
            if ref is not None and ref() is st:
                continue
            nbytes = _rounded(st.nbytes())
            self._tracked[key] = weakref.ref(
                st, self._freed_callback(key, nbytes))
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed_callback(self, key: int, nbytes: int):
        this = weakref.ref(self)

        def freed(ref):
            tally = this()
            if tally is None:
                return
            tally.live_bytes -= nbytes
            if tally._tracked.get(key) is ref:
                del tally._tracked[key]
        return freed

    def _collective(self, name: str, args, out) -> None:
        from torch._C._distributed_c10d import ProcessGroup
        import torch.distributed as dist

        from repro_torch.launch.roofline import RING_FACTORS

        spec = _C10D.get(name)
        if spec is None:
            return  # a barrier or a point-to-point op: no payload priced
        kind, pg_at, size_of = spec
        group = ProcessGroup.unbox(args[pg_at])
        n = group.size()
        if size_of == "out":
            payload = sum(_nbytes(t) for t in _tensors(args[0]))
        else:
            first = args[0] if name != "_reduce_scatter_base_" else args[1]
            payload = sum(_nbytes(t) for t in _tensors(first))
        if n <= 1:
            return  # a one-rank group moves nothing
        wire = payload * RING_FACTORS[kind](n)
        self.collectives.append(dict(
            kind=kind, bytes=int(payload), wire=float(wire), size=int(n),
            ranks=tuple(dist.get_process_group_ranks(group))))

    # ----------------------------------------------------------- results

    def flops_total(self) -> float:
        """The aten ops' FLOPs, all dtypes."""
        return float(sum(self.flops.values()))

    def collective_bytes(self) -> Dict[str, float]:
        """{kind: wire bytes of one rank}, as the reference's
        ``collective_bytes``."""
        out: Dict[str, float] = collections.defaultdict(float)
        for c in self.collectives:
            out[c["kind"]] += c["wire"]
        return dict(out)

    def kernel_launches(self) -> Dict[str, int]:
        """{kernel name: launches recorded}."""
        return dict(collections.Counter(k["name"] for k in self.kernels))

