"""Counts of one eager step: FLOPs, bytes and peak live bytes, by op
family, with each of the port's kernels under its own name. The port's
counterpart of the JAX package's ``repro/roofline/hlo_accounting.py``,
which reads them off a compiled program's HLO text.

``Accounting`` is a ``TorchDispatchMode``: every aten op the step issues
passes through it (the autograd backward's too), on whichever device
the step runs. On the meta device (a dry-run) the counts cost no memory
at any width; on the card the same step gives the same counts, which is
how ``chip_smoke.py`` checks a dry-run's prediction.

- FLOPs: ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` and the convolutions,
  by ``torch.utils.flop_counter``'s formulas (2·M·N·K a product), as the
  reference counts ``dot`` and ``convolution``; other ops count none.
- Bytes: the inputs and outputs of every aten op that is not a view or
  a metadata op (``_FREE``), each read or written once: eager PyTorch's
  counterpart of "each top-level op reads its operands and writes its
  result once".
- Peak live bytes: storages from their first appearance to their last
  reference (a weak reference's callback), over the tensors the caller
  ``hold``s and every op's outputs.
- Kernels: a kernel wrapper's launch (or its meta stand-in) counts as one
  launch of its name with ``kernels/cost.py``'s FLOPs and bytes
  (``cost.launch``); the aten ops the wrapper issues to allocate its
  outputs count no bytes. A CPU call runs the plain version, whose ops
  count as any others.

Eager runs every loop iteration, so there are no trip counts to infer.
Where the data decides a shape (MoE's kept entries, a ``bincount``), a
meta tensor has no data: the meta run takes the largest shape, every
entry kept, as the reference's static shapes do (``_meta_fallback``).
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

aten = torch.ops.aten

_MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
           aten._convolution, aten.convolution_backward}
_COPY = {aten._to_copy, aten.copy_, aten.clone, aten.cat, aten.stack,
         aten.index, aten.index_put, aten.index_put_, aten.gather,
         aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_,
         aten.index_select, aten.embedding, aten.embedding_dense_backward,
         aten.slice_scatter, aten.select_scatter, aten.constant_pad_nd,
         aten.repeat, aten.lift_fresh_copy, aten.index_add,
         aten.index_add_, aten.index_copy, aten.index_copy_,
         aten.masked_scatter}
# Ops that move no data: views, allocations without a fill, and
# metadata.
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
         aten._unsafe_view, aten.set_, aten.resize_, aten.as_strided_,
         aten.t_, aten.transpose_, aten.squeeze_, aten.unsqueeze_,
         aten._local_scalar_dense, aten._reshape_alias, aten.is_same_size,
         aten.sym_size, aten.sym_stride, aten.sym_numel}


def family(func) -> str:
    """An aten op's family: matmul, copy, elementwise or other."""
    pkt = func.overloadpacket
    if pkt in _MATMUL:
        return "matmul"
    if pkt in _COPY:
        return "copy"
    if torch.Tag.pointwise in func.tags:
        return "elementwise"
    return "other"


def _tensors(tree, out=None):
    """The tensors in nested tuples, lists and dicts (an aten op's
    arguments and results), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _meta_fallback(func, args, kwargs):
    """The output of an op whose shape the data decides, on meta tensors
    (which have no data): the largest it could be. None for any other
    op."""
    pkt = func.overloadpacket
    if pkt is aten.bincount:
        x = args[0]
        minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
        weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
        if not minlength:
            raise NotImplementedError(
                "bincount of a meta tensor needs minlength: its length is "
                "the data's largest value")
        return torch.zeros(minlength, device=x.device, dtype=(
            torch.int64 if weights is None else weights.dtype))
    if func is aten.index.Tensor:
        x, indices = args[0], list(args[1])
        if not any(i is not None and i.dtype == torch.bool
                   for i in indices):
            return None
        # Every mask entry kept: each bool index becomes a full
        # arange over the dims it covers.
        full = []
        for i in indices:
            if i is None or i.dtype != torch.bool:
                full.append(i)
                continue
            full += [torch.empty(i.numel(), dtype=torch.int64,
                                 device=x.device)] * i.dim()
        return func(x, full)
    if pkt is aten._local_scalar_dense:
        raise NotImplementedError(
            "a host read of a meta tensor's value (.item(), bool(), "
            ".tolist()): a dry-run step must take such values from the "
            "host")
    return None


# Pointwise ops whose result is not of their inputs' dtype.
_TO_BOOL = {aten.eq, aten.ne, aten.lt, aten.le, aten.gt, aten.ge,
            aten.logical_and, aten.logical_or, aten.logical_xor,
            aten.logical_not, aten.isnan, aten.isinf, aten.isfinite,
            aten.signbit, aten.isneginf, aten.isposinf}


def _meta_pointwise(func, args, kwargs):
    """A pointwise op over contiguous floating meta tensors of one shape
    and one dtype (Python numbers beside them): its output without the
    meta kernel, which goes through PyTorch's Python reference
    implementations at about 20 times the cost. The output is what
    TensorIterator gives such inputs: contiguous, of their shape and
    dtype; an in-place op returns its first argument. None where any of
    that does not hold."""
    if func is aten.log_sigmoid_forward.default:
        # The card's kernel keeps no buffer: (output, an empty buffer).
        x = args[0]
        if x.device.type != "meta" or not x.is_contiguous():
            return None
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty(0, dtype=x.dtype, device=x.device))
    if func is aten.log_sigmoid_backward.default:
        func_args = args[:2]
    elif kwargs or torch.Tag.pointwise not in func.tags \
            or func.overloadpacket in _TO_BOOL:
        return None
    else:
        func_args = args
    first = None
    for a in func_args:
        if isinstance(a, torch.Tensor):
            if first is None:
                first = a
                if not (a.device.type == "meta" and a.dtype.is_floating_point
                        and a.is_contiguous()):
                    return None
            elif (a.shape != first.shape or a.dtype != first.dtype
                  or a.device != first.device or not a.is_contiguous()):
                return None
        elif not isinstance(a, (int, float)) or isinstance(a, bool):
            return None
    if first is None or len(func._schema.returns) != 1:
        return None
    if func._schema.name.endswith("_"):
        return args[0] if args[0] is first else None
    return torch.empty(first.shape, dtype=first.dtype, device=first.device)


class Accounting(TorchDispatchMode):
    """``with Accounting() as acc: step(...)`` -> ``acc.result()``.

    ``hold(tree)`` counts the storages of tensors that exist before the
    step (params, optimizer state, the batch, a cache) as live, so the
    peak includes them; hold them before the step runs.

    ``device``: where the step runs. On "cuda" or "meta", an op whose
    tensors all lie on the CPU is host bookkeeping (a checkpoint's RNG
    state, a host mask) and counts under the family "host", apart from
    the step's FLOPs and bytes; None (or "cpu") counts every op. ``log``:
    a list that gets (op, family, bytes) of every op counted, in order.
    """

    def __init__(self, device: Optional[str] = None,
                 log: Optional[list] = None):
        super().__init__()
        self.device = device
        self.log = log
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes: Dict[str, float] = defaultdict(float)
        self.ops: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, Dict] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, weakref.ref] = {}
        self._kernel_depth = 0

    # ------------------------------------------------------- storages

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n, self_ref=weakref.ref(self)):
            acc = self_ref()
            if acc is not None and acc._storages.pop(key, None) is not None:
                acc.live -= n

        self._storages[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, *trees) -> "Accounting":
        for t in _tensors(trees):
            self._track(t)
        return self

    # ------------------------------------------------------- kernels

    def kernel_enter(self) -> None:
        self._kernel_depth += 1

    def kernel_exit(self, name: str, c: Optional[Dict]) -> None:
        self._kernel_depth -= 1
        if c is None:
            return
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0, "bound_ms": 0.0})
        k["launches"] += 1
        k["flops"] += c["flops"]
        k["bytes"] += c["bytes"]
        k["bound_ms"] += c["bound_ms"]

    def __enter__(self):
        cost._SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost._SINKS.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------- aten ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = None
        if any(t.device.type == "meta" for t in ins):
            out = _meta_pointwise(func, args, kwargs)
            if out is None:
                out = _meta_fallback(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if self._kernel_depth or func.is_view or \
                func.overloadpacket in _FREE:
            return out
        fam = family(func)
        if self.device not in (None, "cpu") and all(
                t.device.type == "cpu" for t in ins + outs):
            fam = "host"
        self.ops[fam] += 1
        nbytes = sum(_nbytes(t) for t in ins + outs)
        self.bytes[fam] += nbytes
        if self.log is not None:
            self.log.append((str(func), fam, nbytes))
        if fam == "matmul" or (fam == "host"
                               and func.overloadpacket in _MATMUL):
            self.flops[fam] += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        return out

    # ------------------------------------------------------- result

    def result(self) -> Dict:
        """{"flops", "bytes", "peak_bytes", "by_family": {family:
        {"flops", "bytes", "ops"}}, "kernels": {name: {"launches",
        "flops", "bytes", "bound_ms"}}}; a kernel's family is
        "kernel:<name>". The totals leave out the "host" family."""
        fams = {f: {"flops": self.flops[f], "bytes": self.bytes[f],
                    "ops": self.ops[f]}
                for f in sorted(set(self.ops) | set(self.flops))}
        for name, k in sorted(self.kernels.items()):
            fams[f"kernel:{name}"] = {"flops": k["flops"],
                                      "bytes": k["bytes"],
                                      "ops": k["launches"]}
        step = [f for name, f in fams.items() if name != "host"]
        return {
            "flops": sum(f["flops"] for f in step),
            "bytes": sum(f["bytes"] for f in step),
            "peak_bytes": self.peak,
            "by_family": fams,
            "kernels": {n: dict(k) for n, k in sorted(self.kernels.items())},
        }
