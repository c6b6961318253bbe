"""FLOP and byte counts of a function's run: the port's counterpart of
``src/repro/launch/hloanalysis.py``.

The reference lowers a step to HLO and reads XLA's cost analysis. XLA
counts a ``while`` body (a scanned layer stack) once, so the reference
weights each computation by its loops' trip counts. The port has no HLO
and no trip counts: it runs its layers in a Python loop, so each product is
seen once for each time it runs, and that loop is the weighting the
reference gets from trip counts.

``op_costs(fn, *args)`` runs ``fn`` once and returns the counterparts of
the keys the reference's ``compiled_costs`` returns:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total, which
  counts products, convolutions and attention: the sum of its formulas
  (``flop_counter.flop_registry``) over the ops, added here in the one
  dispatch mode that also counts the products and the bytes;
* ``dot_flops``: the products alone, 2 M N K each (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, and the matrix-vector and vector products), the
  counterpart of the reference's ``hlo_dot_flops``;
* ``bytes_accessed``: the bytes of every aten op's tensor operands and
  results, read by a ``TorchDispatchMode``; views and metadata ops
  (allocation, detach, reshape aliases) are skipped, and an in-place op's
  first operand counts as read and as written.

How these differ from XLA's: nothing is fused, so every intermediate is
written and read again and ``bytes_accessed`` is an upper bound on XLA's;
elementwise FLOPs are not counted (XLA counts about one an element).

On ``meta`` tensors nothing executes, and the counts are those of the ops
the function dispatches, which depend on shapes only. On a card cuDNN is
switched off while counting, so the composite batch norm dispatches
``native_batch_norm`` as it does on the CPU and on ``meta`` (with cuDNN it
would dispatch ``cudnn_batch_norm``, whose extra result changes the
bytes): the counts of one function are then the same on every device.
Collectives have no counterpart in one process.

``meta`` runs PyTorch's shape functions, many of them in Python (some
hundreds of microseconds an elementwise op). A counted run on ``meta``
therefore keeps each op's result layout (shape, strides, dtype) by its
inputs' layouts and arguments, and an op seen again with the same ones
gets a fresh ``meta`` tensor of that layout without running the shape
function again. It is still counted each time: only the shape arithmetic
is not redone. Views, in-place ops and ops whose results alias an input
always run.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# products: (op packet, the position of the left operand)
_PRODUCTS = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0, aten.vdot: 0,
             aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1}
# ops that move no element: allocation, aliasing and metadata
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.lift_fresh, aten.alias,
         aten._unsafe_view, aten._reshape_alias, aten.resize_, aten.set_,
         aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten.is_same_size, aten._has_compatible_shallow_copy_type}


def _tensor_bytes(values):
    """Bytes of the tensors among ``values`` and in their lists and tuples."""
    n = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
        elif isinstance(v, (list, tuple)):
            n += _tensor_bytes(v)
    return n


def _layout(x):
    """A hashable key of an op argument's layout, or a TypeError."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not a meta tensor")
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_layout(v) for v in x)
    hash(x)
    return x


def _fresh(func):
    """Whether ``func`` makes new tensors only: no view, no mutation, no
    result aliasing an input."""
    schema = func._schema
    return not (func.is_view or schema.is_mutable
                or any(r.alias_info is not None for r in schema.returns))


class _Counter(TorchDispatchMode):
    """Adds each op's FLOPs, product FLOPs and tensor bytes; keeps the
    result layouts of ``meta`` ops by their inputs' layouts."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_flops = 0
        self.bytes_accessed = 0
        self._layouts = {}

    def _run(self, func, args, kwargs):
        if func.is_view:
            return func(*args, **kwargs)
        try:
            key = (func, _layout(args), _layout(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        if key in self._layouts:
            made = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                    for shape, stride, dtype in self._layouts[key][1]]
            return made[0] if self._layouts[key][0] else tuple(made)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else out
        # only meta results: a factory op (no tensor operand) on a device
        # has a key too, and must not come back as meta
        if _fresh(func) and isinstance(outs, tuple) and all(
                isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
            self._layouts[key] = (single, [(tuple(t.shape), t.stride(), t.dtype)
                                           for t in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in _PRODUCTS:
            lhs = args[_PRODUCTS[packet]]
            self.dot_flops += 2 * out.numel() * lhs.shape[-1]
        if not func.is_view and packet not in _FREE:
            self.bytes_accessed += (_tensor_bytes(args) + _tensor_bytes(kwargs.values())
                                    + _tensor_bytes((out,)))
        return out


def count(fn, *args, **kwargs):
    """``(costs, fn(*args, **kwargs))``: ``op_costs``' dict and the result."""
    counter = _Counter()
    with torch.backends.cudnn.flags(enabled=False), counter:
        out = fn(*args, **kwargs)
    dots = float(counter.dot_flops)
    flops = float(counter.flops)
    return {"flops": flops if flops > 0.0 else dots, "dot_flops": dots,
            "bytes_accessed": float(counter.bytes_accessed)}, out


def op_costs(fn, *args, **kwargs):
    """``{flops, dot_flops, bytes_accessed}`` of one run of
    ``fn`` (on ``meta`` inputs nothing executes). ``flops`` falls back to
    the product count when the flop counter reports none, as the
    reference's ``compiled_costs`` does."""
    return count(fn, *args, **kwargs)[0]
