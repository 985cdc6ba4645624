"""Per-device cost of a recorded aten program — the counterpart of
``repro.core.hlo``, which walks XLA's optimized post-SPMD HLO.

Eager PyTorch has no HLO.  Its counterpart of "the per-device program" is
the sequence of aten ops, custom ops and functional collectives that one
rank dispatches on its local blocks.  :class:`OpRecorder`, a
``TorchDispatchMode``, records that sequence while a step runs, deduplicated
as (op, operand and result dtypes and shapes, written operands, collective
group and the mesh dimension it spans) → calls, and serializes it as JSON
(the saved HLO text's counterpart).  :class:`OpCostAnalyzer` then re-derives

  * FLOPs            — every op that ``torch.utils.flop_counter``'s registry
                       knows by its formula (``mm``, ``bmm``, ``addmm``,
                       convolutions, the hand kernels' custom ops through
                       ``kernels/flops.py``), computed from the live call at
                       record time; elementwise ops one per result element,
                       reductions one per input element;
  * HBM-proxy bytes  — each op that launches a kernel is one HBM round trip
                       of its operands and results (eager PyTorch fuses
                       nothing, so this is the reference's fusion boundary,
                       taken literally); views cost nothing;
  * collective bytes — payload (the operands' bytes) and per-device wire
                       bytes per collective kind, with the reference's ring
                       wire factors (g − 1)/g.

No trip counts are needed: eager execution dispatches every loop step, so
counting each dispatched op once multiplies through the loops.

On the card the model-layer kernels (attention, SSD, sLSTM, both ways)
are launched by their wrappers directly, not through their custom ops,
so no dispatch shows them; their launchers report each launch
(``kernels/_observe.py``) and the recorder enters it as a call of the
custom op it stands for, its operands and outputs the launch's.

Under DTensor the recorder returns ``NotImplemented`` whenever a DTensor
is among the operands' types (as ``CommDebugMode`` does): DTensor unwraps
first and the recorder sees each rank's local-block ops and the
``_c10d_functional`` collectives at their local shapes — the per-device
program, as the reference's partitioned HLO is.  DTensor's sharding
propagation runs each op once more on fake tensors of the global shapes;
those calls are not recorded (a ``FakeTensorMode`` is active, or an
operand is a ``FakeTensor``).  So nothing is recorded under a
``FakeTensorMode`` the caller enters either: record ``meta`` or real
tensors.

Departures from the reference's pricing rules, each forced by eager
execution or by the op set:

  * an op the flop registry knows is priced by its formula, where the
    reference reads a dot's contracting dimensions (the same number for
    ``mm``/``bmm``; for attention ``kernels/flops.py`` counts the full
    score rectangle);
  * copies, ``index`` and gathers cost 2 × their result's bytes, as the
    reference's ``copy``/``gather``; ``copy_`` costs its source read and
    its destination written (2 × the update where dtypes and shapes
    agree); ``index_put_``, scatters and ``index_add_`` 2 × the update's
    bytes at the target's element size;
  * an in-place op costs its operands (the target among them) and the
    target written; the ``_foreach_*`` ops' lists are flattened, so the
    optimizer's traffic counts;
  * a hand kernel's custom op costs its operands and results: scratch it
    allocates inside (the SSD's states) stays uncounted;
  * a fused aten op (``_softmax``, ``addcdiv`` under ``_foreach``) counts
    one FLOP an element where XLA would count its parts.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ---------------------------------------------------------------------------
# Op classes, by name without the overload ("aten.add",
# "repro_torch.flash_attention")
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "int16": 2, "uint16": 2, "int32": 4,
    "uint32": 4, "int64": 8, "uint64": 8, "float16": 2, "bfloat16": 2,
    "float32": 4, "float64": 8, "complex64": 8, "complex128": 16,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}

#: the reference's TRANSCENDENTAL set, by aten name (sigmoid is its
#: logistic; gelu, silu and softplus evaluate one each)
TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "rsqrt", "sqrt", "pow", "sin", "cos", "tan", "sigmoid", "atan",
    "atan2", "erf", "erfc", "erfinv", "cbrt", "gelu", "silu", "softplus",
    "log_sigmoid_forward", "_softmax", "_log_softmax", "logsumexp",
}
TRANSCENDENTAL = {f"aten.{n}" for n in TRANSCENDENTAL} | \
    {f"aten.{n}_" for n in TRANSCENDENTAL}
#: reductions: one FLOP per input element
REDUCTIONS = {f"aten.{n}" for n in (
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "var_mean",
    "std", "std_mean", "norm", "linalg_vector_norm", "logsumexp", "argmax",
    "argmin", "any", "all", "cumsum", "cumprod", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "nll_loss_forward", "nll_loss_backward")}
#: no kernel, no traffic: allocation, metadata, autograd plumbing
ZERO_COST = {
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten._unsafe_view", "aten.resize_",
    "aten.set_", "aten.record_stream", "aten.sym_size", "aten.sym_stride",
    "aten.sym_numel", "aten.sym_storage_offset", "aten.is_contiguous",
    "aten.is_same_size", "prim.device", "prim.layout",
    "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd",
    "profiler._record_function_enter_new", "profiler._record_function_exit",
}
#: copies and gathers: the result read (from its slice) and written
COPIES = {f"aten.{n}" for n in (
    "clone", "copy", "contiguous", "index", "_unsafe_index", "index_select",
    "gather", "embedding", "take", "repeat", "cat", "stack", "roll", "flip",
    "constant_pad_nd", "narrow_copy", "masked_select", "lift_fresh_copy")}
#: fresh tensors shaped like an operand: the result written, the operand
#: not read
FILLS = {f"aten.{n}" for n in (
    "zeros_like", "ones_like", "full_like", "rand_like", "randn_like",
    "randint_like")}
#: updates into a slice: the update read and written
UPDATES = {f"aten.{n}" for n in (
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_add", "index_add_", "index_copy", "index_copy_",
    "masked_scatter", "masked_scatter_", "slice_scatter", "select_scatter",
    "embedding_dense_backward")}
#: the functional collectives, by the reference's kinds
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

_WIRE_FACTOR = {
    "all-gather": lambda g: g - 1,          # × operand bytes
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
    "collective-broadcast": lambda g: 1.0,
    "ragged-all-to-all": lambda g: (g - 1) / g,
}


def _numel(spec) -> int:
    return math.prod(spec[1])


def _nbytes(specs: Iterable) -> float:
    return float(sum(_numel(s) * _DTYPE_BYTES.get(s[0], 4) for s in specs))


def _nelems(specs: Iterable) -> float:
    return float(sum(_numel(s) for s in specs))


def collective_kind(name: str) -> Optional[str]:
    """The reference's collective kind of op ``name`` (``ns.op``), or None."""
    ns, _, op = name.partition(".")
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    return COLLECTIVE_OPS.get(op)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def _spec(t: torch.Tensor) -> Tuple[str, Tuple[int, ...]]:
    return (str(t.dtype).rsplit(".", 1)[-1], tuple(int(d) for d in t.shape))


def _op_name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


class _OpInfo:
    """What the recorder needs of an op's schema, computed once per op."""

    __slots__ = ("name", "writes", "view", "pointwise", "reduction",
                 "flop_formula", "args")

    def __init__(self, func):
        from torch.utils.flop_counter import flop_registry

        schema = func._schema
        self.name = _op_name(func)
        self.args = schema.arguments
        self.writes = tuple(a.alias_info is not None and a.alias_info.is_write
                            for a in schema.arguments)
        self.view = bool(getattr(func, "is_view", False))
        tags = set(func.tags)
        self.pointwise = torch.Tag.pointwise in tags
        reduction = getattr(torch.Tag, "reduction", None)
        self.reduction = reduction is not None and reduction in tags
        self.flop_formula = flop_registry.get(func._overloadpacket)


def _group(args) -> Tuple[Optional[int], Optional[str]]:
    """The size of the process group a functional collective names (its
    last string argument) and the mesh dimension it spans (a
    ``DeviceMesh`` group's ``mesh_<name>`` description), each None where
    it cannot be resolved."""
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return None, None
    try:
        from torch.distributed.distributed_c10d import _resolve_process_group
        pg = _resolve_process_group(names[-1])
    except Exception:  # noqa: BLE001 — the analyzer takes num_devices
        return None, None
    desc = getattr(pg, "group_desc", "") or ""
    return int(pg.size()), (desc[len("mesh_"):] if desc.startswith("mesh_")
                            and desc != "mesh_default" else None)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class OpRecorder(TorchDispatchMode):
    """Records every op a region dispatches, per device (see the module
    docstring), and every launch of a model-layer kernel on the card,
    which no dispatch shows (``kernels/_observe.py``).  ``entries()``
    gives the deduplicated record, ``to_json()`` / ``save(path)``
    serialize it; ``calls`` counts the recorded calls."""

    def __init__(self):
        # the hand kernels' custom ops' FLOP formulas
        from repro_torch.kernels import flops  # noqa: F401
        super().__init__()
        self._info: Dict[Any, _OpInfo] = {}
        self._record: Dict[tuple, List[float]] = {}
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out   # DTensor's sharding propagation, global shapes
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _OpInfo(func)
        ins, written = [], []
        for i, a in enumerate(info.args):
            value = args[i] if i < len(args) else kwargs.get(a.name)
            for t in tree_leaves(value):
                if isinstance(t, torch.Tensor):
                    if _is_fake(t):
                        return out
                    if info.writes[i]:
                        written.append(len(ins))
                    ins.append(_spec(t))
        outs = [_spec(t) for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        flops = None
        if info.flop_formula is not None:
            flops = float(info.flop_formula(*args, **kwargs, out_val=out))
        group, axis = (_group(args) if collective_kind(info.name)
                       else (None, None))
        self._add((info.name, tuple(ins), tuple(outs), tuple(written), group,
                   axis, info.view, info.pointwise, info.reduction,
                   flops is not None), flops)
        return out

    def _launched(self, op: str, args: tuple, outputs) -> None:
        """A model-layer kernel's launch on the card, reported by its
        launcher (``kernels/_observe.py``): recorded as a call of its
        custom op, its operands the launcher's tensor arguments, priced by
        the op's FLOP formula."""
        from torch.utils.flop_counter import flop_registry

        ins = [_spec(t) for t in tree_leaves(args)
               if isinstance(t, torch.Tensor)]
        outs = [_spec(t) for t in tree_leaves(outputs)
                if isinstance(t, torch.Tensor)]
        formula = flop_registry.get(getattr(torch.ops.repro_torch, op))
        flops = (float(formula(*args, out_val=outputs))
                 if formula is not None else None)
        self._add((f"repro_torch.{op}", tuple(ins), tuple(outs), (), None,
                   None, False, False, False, flops is not None), flops)

    def _add(self, key: tuple, flops: Optional[float]) -> None:
        slot = self._record.get(key)
        if slot is None:
            slot = self._record[key] = [0, 0.0]
        slot[0] += 1
        slot[1] += flops or 0.0
        self.calls += 1

    def __enter__(self):
        from repro_torch.kernels import _observe
        _observe.observers.append(self._launched)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import _observe
        _observe.observers.remove(self._launched)
        return super().__exit__(*exc)

    def entries(self) -> List[Dict]:
        """The record: one entry per distinct (op, shapes, ...) with its
        call count and, for an op the flop registry knows, its FLOPs summed
        over those calls."""
        out = []
        for key, (count, flops) in self._record.items():
            (name, ins, outs, written, group, axis, view, pointwise,
             reduction, has_flops) = key
            e = {"op": name, "in": [list(s) for s in ins],
                 "out": [list(s) for s in outs], "count": count}
            if written:
                e["written"] = list(written)
            if group is not None:
                e["group"] = group
            if axis is not None:
                e["axis"] = axis
            if view:
                e["view"] = True
            if pointwise:
                e["pointwise"] = True
            if reduction:
                e["reduction"] = True
            if has_flops:
                e["flops"] = flops
            out.append(e)
        return out

    def to_json(self) -> str:
        return json.dumps({"format": "repro_torch.opcost/1",
                           "torch": torch.__version__, "calls": self.calls,
                           "ops": self.entries()})

    def save(self, path) -> int:
        """Writes the record to ``path``; returns the recorded calls."""
        with open(path, "w") as f:
            f.write(self.to_json())
        return self.calls


def parse_ops(text: str) -> List[Dict]:
    """The entries of a serialized record (:meth:`OpRecorder.to_json`)."""
    return json.loads(text)["ops"]


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


@dataclass
class Cost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    coll_payload: Dict[str, float] = field(default_factory=dict)
    coll_wire: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.transcendentals += other.transcendentals * mult
        self.bytes += other.bytes * mult
        for k in other.coll_payload:
            self.coll_payload[k] = self.coll_payload.get(k, 0.0) \
                + other.coll_payload[k] * mult
            self.coll_wire[k] = self.coll_wire.get(k, 0.0) \
                + other.coll_wire[k] * mult
            self.coll_count[k] = self.coll_count.get(k, 0.0) \
                + other.coll_count[k] * mult

    @property
    def collective_payload_bytes(self) -> float:
        return sum(self.coll_payload.values())

    @property
    def collective_wire_bytes(self) -> float:
        return sum(self.coll_wire.values())

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "bytes": self.bytes,
            "collective_payload_bytes": self.collective_payload_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collectives": {
                k: {"payload": self.coll_payload[k],
                    "wire": self.coll_wire[k],
                    "count": self.coll_count[k]}
                for k in sorted(self.coll_payload)
            },
        }


class OpCostAnalyzer:
    """Prices a record (:meth:`OpRecorder.entries`, or its JSON text) per
    device.  ``num_devices`` is the group size of a collective whose group
    the record could not resolve.  With ``track_breakdown`` the bytes and
    FLOPs are also summed per op name (``byte_breakdown``,
    ``flop_breakdown``), and the FLOPs priced by the flop registry's
    formulas per op name (``formula_flops``)."""

    def __init__(self, ops, *, num_devices: int = 1,
                 track_breakdown: bool = False):
        self.ops = parse_ops(ops) if isinstance(ops, str) else list(ops)
        self.num_devices = num_devices
        self.track_breakdown = track_breakdown
        self.byte_breakdown: Dict[str, float] = {}
        self.flop_breakdown: Dict[str, float] = {}
        self.formula_flops: Dict[str, float] = {}

    # -- per-op (one call) -------------------------------------------------
    def op_cost(self, e: Dict) -> Cost:
        c = Cost()
        name = e["op"]
        if name in ZERO_COST or e.get("view"):
            return c
        ins, outs = e["in"], e["out"]
        written = [ins[i] for i in e.get("written", ())]
        res = outs or written
        res_bytes = _nbytes(res)

        kind = collective_kind(name)
        if kind is not None:
            read = [s for i, s in enumerate(ins)
                    if i not in e.get("written", ())]
            payload = _nbytes(read) or res_bytes
            g = e.get("group") or self.num_devices
            c.coll_payload[kind] = payload
            c.coll_wire[kind] = payload * _WIRE_FACTOR[kind](max(g, 1))
            c.coll_count[kind] = 1
            # collectives also read/write HBM
            c.bytes += payload + res_bytes
            return c

        # ---- bytes ---------------------------------------------------------
        if name in COPIES:
            c.bytes += 2.0 * res_bytes
        elif name in FILLS:
            c.bytes += res_bytes
        elif name in UPDATES:
            itemsize = _DTYPE_BYTES.get(ins[0][0], 4) if ins else 4
            upd = _numel(ins[-1]) * itemsize if ins else res_bytes
            c.bytes += 2.0 * upd
        elif name == "aten.copy_":
            c.bytes += _nbytes(ins[1:2]) + _nbytes(ins[:1])
        else:
            c.bytes += _nbytes(ins) + res_bytes

        # ---- arithmetic ----------------------------------------------------
        if "flops" in e:
            c.flops += e["flops"] / e["count"]
        elif name in REDUCTIONS or e.get("reduction"):
            c.flops += _nelems(ins[:1])
        elif name in ("aten._to_copy", "aten.copy_"):
            if ins and res and ins[-1][0] != res[0][0]:   # convert
                c.flops += _nelems(res)
        elif name in COPIES or name in UPDATES:
            pass
        elif e.get("pointwise") or name.startswith("aten._foreach_"):
            c.flops += _nelems(res)
        if name in TRANSCENDENTAL:
            c.transcendentals += _nelems(res)
        return c

    # -- the whole record --------------------------------------------------
    def entry_cost(self) -> Cost:
        total = Cost()
        for e in self.ops:
            c = self.op_cost(e)
            total.add(c, e["count"])
            if self.track_breakdown:
                label = e["op"]
                n = e["count"]
                self.byte_breakdown[label] = \
                    self.byte_breakdown.get(label, 0.0) + c.bytes * n
                self.flop_breakdown[label] = \
                    self.flop_breakdown.get(label, 0.0) + c.flops * n
                if "flops" in e:
                    self.formula_flops[label] = \
                        self.formula_flops.get(label, 0.0) + c.flops * n
        return total


def analyze_ops_text(text: str, *, num_devices: int = 1) -> Dict:
    return OpCostAnalyzer(text, num_devices=num_devices).entry_cost().as_dict()


def analyze_ops_file(path: str, *, num_devices: int = 1) -> Dict:
    with open(path) as f:
        return analyze_ops_text(f.read(), num_devices=num_devices)


#: the ops that run a product of two matrices (or batches of them)
PRODUCTS = {"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm"}


def product_flops(entries: List[Dict], width: int) -> float:
    """The FLOPs of the record's products with an operand dimension of
    ``width``: the products of one weight, at its local width on a rank
    (how a layout check finds work the mesh should have split)."""
    return sum(e.get("flops") or 0.0 for e in entries
               if e["op"] in PRODUCTS
               and any(width in shape for _, shape in e["in"]))
