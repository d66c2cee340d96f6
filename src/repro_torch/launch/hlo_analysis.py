"""Cost analysis of one eager step (``repro.launch.hlo_analysis``).

The JAX module walks a compiled program's HLO text, multiplies while
bodies by their trip counts and reports FLOPs, bytes and collective
bytes per device. Eager PyTorch compiles no program and has no HLO
text, so ``parse_hlo``, ``analyze_hlo_text`` and the HLO helpers have
no torch meaning and are not ported. The analog is ``CostCounter``, a
``TorchDispatchMode`` that counts every ATen operator a step dispatches
as one kernel, which is what eager execution launches:

  flops          — products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                   convolutions) 2·M·N·K, by ``torch.utils.flop_counter``'s
                   shape formulas; elementwise operators 1 an output
                   element (the JAX module's ``ELEMENTWISE`` set, by their
                   ATen names); reductions 1 an input element; fused
                   elementwise operators (GELU, SiLU, softmax) as many as
                   the XLA operators they stand for
  transcendental — the JAX module's transcendental operators, 1 an
                   output element
  bytes          — operands plus outputs of every operator that is not a
                   view: views, metadata operators and operators that
                   move zero bytes are free, as the JAX module's
                   ``NOOP_OPS`` are
  peak_bytes     — the most bytes of storage the step's operators held
                   live at once, each storage counted once and dropped
                   when it is freed; the arguments' storages are counted
                   apart (``argument_bytes``)

A hand-written kernel is one operator (``kernels._cost``): it is charged
once, at the kernel's own work, on every device, and the ops of its
plain version are never counted. ``collective_bytes`` stays 0 until the
model-axis slice, and ``unknown_trip_whiles`` is always 0, because eager
execution runs every loop trip. The same step counts the same on meta
tensors, on the CPU and on the card: what is dispatched does not depend
on the device. Use ``analyze_step(fn, *args)``.

A loop whose trips run the same operators on tensors of the same shapes
(a train step's microbatches) iterates over ``trips(n)``: under a
counter whose arguments are all meta tensors (the dry run's) it runs
the first trip only and scales what that trip counted by ``n``, as the
JAX module scales a while body by its trip count; meta tensors hold no
values, so nothing but the count comes of the other trips. Otherwise
(real tensors, or no counter) it is ``range(n)``.
"""
from __future__ import annotations

import contextvars
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _cost

# the JAX module's ELEMENTWISE set by ATen names: 1 FLOP an output element
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum", "exp",
    "expm1", "log", "log1p", "tanh", "rsqrt", "sqrt", "neg", "abs", "sign",
    "floor", "ceil", "round", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "clamp",
    "clamp_min", "clamp_max", "atan2", "cos", "sin", "sigmoid", "erf",
    "remainder", "fmod", "bitwise_left_shift", "bitwise_right_shift",
    "reciprocal", "masked_fill", "square",
}
# the JAX module's transcendental operators (exponential, tanh, log,
# logistic, erf, cosine, sine, power, rsqrt, sqrt)
TRANSCENDENTAL = {"exp", "tanh", "log", "sigmoid", "erf", "cos", "sin", "pow",
                  "rsqrt", "sqrt"}
# ATen operators that stand for several elementwise operators: (FLOPs,
# transcendentals) an output element, by the HLO operators of the JAX
# functions (tanh GELU: x³ by two multiplies, four more multiplies, two
# adds and the tanh, 9 as the JAX module counts it; SiLU: a logistic and
# a multiply, the logistic one operator as the JAX module's ELEMENTWISE
# set has it, though XLA's CPU backend expands it to 4); the backward
# operators by the elementwise operations of their formulas
FUSED_ELEMENTWISE = {
    "gelu": (9, 1), "silu": (2, 1), "gelu_backward": (14, 1),
    "silu_backward": (5, 1), "sigmoid_backward": (3, 0),
    "tanh_backward": (3, 0), "threshold_backward": (1, 0),
    "addcmul": (2, 0), "addcdiv": (2, 0), "lerp": (3, 0),
}
# reductions: 1 FLOP an input element
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
              "argmin", "any", "all", "cumsum", "cumprod", "logsumexp",
              "norm", "linalg_vector_norm", "var", "std", "var_mean"}
# softmax over its last axis: a max and a sum (reductions), the subtract,
# the exponential and the divide (log-softmax: the log in place of the
# divide); their backward: a reduction and two elementwise operators
SOFTMAX = {"_softmax": (2, 3, 1), "_log_softmax": (2, 3, 2),
           "_softmax_backward_data": (1, 2, 0),
           "_log_softmax_backward_data": (1, 2, 1)}
PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
            "convolution_backward"}
# operators that launch nothing: metadata, allocation without a fill
FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "empty",
        "empty_like", "empty_strided", "new_empty", "new_empty_strided",
        "_reshape_alias", "sym_size", "sym_stride", "sym_numel",
        "sym_storage_offset", "is_same_size", "_local_scalar_dense",
        "set_", "resize_", "record_stream"}


@dataclasses.dataclass
class CostReport:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    transcendental: float = 0.0
    unknown_trip_whiles: int = 0
    # the torch analog's own counts
    ops: int = 0                 # operators launched (kernels included)
    product_flops: float = 0.0   # the FLOPs of matrix products
    peak_bytes: float = 0.0      # peak live bytes beside the arguments
    argument_bytes: float = 0.0  # the arguments' storages

    def __add__(self, o):
        """Two steps one after the other: counts add, the peak is the
        larger one."""
        return CostReport(self.flops + o.flops, self.bytes + o.bytes,
                          self.collective_bytes + o.collective_bytes,
                          self.transcendental + o.transcendental,
                          self.unknown_trip_whiles + o.unknown_trip_whiles,
                          self.ops + o.ops,
                          self.product_flops + o.product_flops,
                          max(self.peak_bytes, o.peak_bytes),
                          max(self.argument_bytes, o.argument_bytes))

    def scale(self, k: float):
        return CostReport(self.flops * k, self.bytes * k,
                          self.collective_bytes * k,
                          self.transcendental * k,
                          self.unknown_trip_whiles, int(self.ops * k),
                          self.product_flops * k, self.peak_bytes,
                          self.argument_bytes)

    def to_dict(self):
        return dataclasses.asdict(self)


def _operands(args: Tuple, kwargs: Dict) -> list:
    """The tensors among an operator's arguments (one level of lists)."""
    out = []
    for x in (*args, *kwargs.values()):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _tensors(tree) -> list:
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return out


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _numel(tensors) -> float:
    return float(sum(t.numel() for t in tensors))


def op_cost(func, args: Tuple, kwargs: Dict, out: Any) -> Tuple[
        float, float, float, float]:
    """(flops, product flops, transcendentals, bytes) of one operator
    call; bytes 0 means the call is free."""
    name = func._overloadpacket.__name__
    kernel = _cost.cost_of(func)
    if kernel is not None:
        w = kernel(*args, **kwargs)
        return w.flops, w.products, w.transcendental, w.bytes
    if name in FREE or func.is_view:
        return 0.0, 0.0, 0.0, 0.0
    ins = _operands(args, kwargs)
    outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
    nbytes = _nbytes(ins) + _nbytes(outs)
    n_out = _numel(outs[:1])
    flops = products = trans = 0.0
    if name in PRODUCTS:
        products = float(flop_registry[func._overloadpacket](
            *args, **kwargs, out_val=out))
        flops = products
    elif name.rstrip("_") in ELEMENTWISE:
        flops = n_out
        trans = n_out if name.rstrip("_") in TRANSCENDENTAL else 0.0
    elif name in FUSED_ELEMENTWISE:
        f, t = FUSED_ELEMENTWISE[name]
        flops, trans = f * n_out, t * n_out
    elif name in SOFTMAX:
        reductions, elementwise, exps = SOFTMAX[name]
        flops = (reductions + elementwise) * n_out
        trans = exps * n_out
    elif name in REDUCTIONS:
        flops = _numel(ins[:1])
    return flops, products, trans, nbytes


# the innermost active counter, for ``trips``
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "cost_counter", default=None)


class CostCounter(TorchDispatchMode):
    """Counts every operator dispatched while it is active (see the
    module docstring); ``report()`` gives the totals. ``arguments``:
    tensors whose storages are counted apart from the peak; when there
    are some and all are meta, ``trips(n)`` runs one trip and scales
    it."""

    def __init__(self, arguments: Any = ()):
        super().__init__()
        args = _tensors(arguments)
        self.scale_trips = bool(args) and all(t.is_meta for t in args)
        self._tokens = []
        self.report_ = CostReport()
        # reentrant: a storage's finalizer may run in the thread that
        # holds the lock (a garbage collection during the count)
        self._lock = threading.RLock()
        self._live: Dict[int, float] = {}
        self._args = set()
        self.live_bytes = 0.0
        for t in args:
            s = t.untyped_storage()
            if s._cdata not in self._args:
                self._args.add(s._cdata)
                self.report_.argument_bytes += s.nbytes()

    def __enter__(self):
        self._tokens.append(_ACTIVE.set(self))
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _cost.cost_of(func) is None and func._can_decompose():
            # a composite operator (matmul, einsum, linear, ...) reaches
            # the mode whole where autograd is off (inference mode):
            # count the operators it runs, as under autograd
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        flops, products, trans, nbytes = op_cost(func, args, kwargs, out)
        with self._lock:
            r = self.report_
            if nbytes > 0:
                r.ops += 1
                r.flops += flops
                r.product_flops += products
                r.transcendental += trans
                r.bytes += nbytes
            for t in ([out] if isinstance(out, torch.Tensor)
                      else _tensors(out)):
                self._track(t.untyped_storage())
        return out

    def _track(self, storage) -> None:
        key = storage._cdata
        if key in self._args or key in self._live:
            return
        size = float(storage.nbytes())
        self._live[key] = size
        self.live_bytes += size
        self.report_.peak_bytes = max(self.report_.peak_bytes,
                                      self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0.0)

    def report(self) -> CostReport:
        return dataclasses.replace(self.report_)

    def _scale_since(self, before: CostReport, n: int) -> None:
        """Count what was counted since ``before`` ``n`` times."""
        with self._lock:
            r = self.report_
            r.flops += (n - 1) * (r.flops - before.flops)
            r.bytes += (n - 1) * (r.bytes - before.bytes)
            r.transcendental += (n - 1) * (r.transcendental
                                           - before.transcendental)
            r.product_flops += (n - 1) * (r.product_flops
                                          - before.product_flops)
            r.ops += (n - 1) * (r.ops - before.ops)


def trips(n: int) -> Iterator[int]:
    """``range(n)``, or, under a counter of meta arguments, the first
    trip only, counted ``n`` times (the module docstring)."""
    counter = _ACTIVE.get()
    if counter is None or not counter.scale_trips or n <= 1:
        yield from range(n)
        return
    before = counter.report()
    yield 0
    counter._scale_since(before, n)


def analyze_step(fn: Callable, *args, **kwargs) -> CostReport:
    """The report of one ``fn(*args, **kwargs)`` under a ``CostCounter``
    whose arguments are ``args`` and ``kwargs`` (its result dropped)."""
    with CostCounter((args, kwargs)) as counter:
        fn(*args, **kwargs)
    return counter.report()
