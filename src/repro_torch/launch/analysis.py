"""Roofline terms of a step traced on the meta device, with the H100's
constants (``repro.launch.analysis``).

compute term    = FLOPs_per_device / PEAK_FLOPS
memory term     = bytes_per_device / HBM_BW
collective term = wire_bytes_per_device / ICI_BW

**What replaces XLA's cost analysis.**  The reference lowers each step
for its mesh and reads ``compiled.cost_analysis()`` (FLOPs and bytes of
the per-device module), collective bytes from the HLO text and the peak
from ``memory_analysis()``.  The port has no compiler to ask.
``trace(fn, *args)`` runs the port's own step on meta tensors (shapes
and dtypes, no data, no device) under three counters:

  - ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of every
    matmul, batched matmul and convolution (its formulas; elementwise
    ops count none);
  - the kernels' tally (``kernels/meta.py``): on meta tensors the ops
    that launch K3, N1, K4 or K5 on the card return empty outputs and
    add the work of the kernels' bound formulas.  On the card those
    kernels are ctypes calls that FlopCounterMode cannot see, so FLOPs
    are counted on meta, never on the card;
  - ``_Traffic``, a ``TorchDispatchMode``: every aten op on meta
    tensors that is not a view or an allocation reads each tensor
    argument once and writes
    each output once (an in-place op writes its argument back), and
    the storages the step allocates are held from their op to their
    last reference; their largest total at any moment is the trace's
    peak live bytes.

These are global counts: the whole batch as one device would run it.
Per device, FLOPs and bytes are the global counts over ``num_devices``.

**Collectives: a first-order model of the specs** (``collective_bytes``;
per device, as result bytes, the reference's accounting; m, d, p the
model, data and pod axis sizes; a leaf's "model factor" is m where its
spec names "model", else 1):

  - all-gather: every "data"-sharded weight, gathered over "data" to
    its model shard (its elements over the model factor) in the dtype
    it is gathered in.  A train step with ``pregather`` gathers each
    once in the compute dtype, except MoE expert stacks, which keep
    their FSDP spec (the reference's ``pregather_params``); without
    it, each is gathered in its own dtype once a forward pass, and the
    backward's recompute under remat is a second pass.  A serving step
    gathers each once.  FedKT's label step holds one member per data
    index, TP-sharded and never gathered; it all-gathers the members'
    (M, B, S) int32 predictions for the vote.
  - reduce-scatter (train): the gradient of every "data"-sharded
    weight, in its own dtype, to its shard.
  - all-reduce, gradients (train): over "pod" for those shards, and
    over pod x data for every weight not sharded over "data".
  - all-reduce, activations (m > 1): each model-sharded row-parallel
    weight (wo, w_down, w_out, cm_w_down; a shared expert's w_down
    joins its routed experts' reduce) sums its output over "model":
    (rows a device holds) x (positions) x d_model in the compute dtype,
    once a forward pass and once a backward pass (train: forward,
    backward, and the recompute under remat).  An encoder layer's
    positions are the encoder's 1500.
  - all-to-all and collective-permute: none in this layout.

**Peak memory**: the exact resident shard bytes from the specs
(parameters, and the optimizer state of a train step or the cache of a
decode step) plus the trace's peak live bytes over the number of parts
the batch is split into (its data-parallel size where the batch
divides it, as ``batch_sharding`` splits it).

These numbers differ from GSPMD's by design: no compiler fuses,
rematerialises, reorders or inserts collectives here.  Elementwise
FLOPs are not counted; bytes count every unfused op's operands, which
a compiler's fusion would keep on chip; the collectives are what the
specs imply, not what a partitioner chose.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet; PERF.md
§6): bf16 989e12 FLOP/s dense, HBM3 3.35e12 B/s, 80 GB a device.
``ICI_BW`` keeps the reference's name for the one collective bandwidth
a device: 50e9 B/s, one NDR InfiniBand port (400 Gb/s) a GPU, since
both 16-wide axes span more than one 8-GPU NVLink node.
"""
from __future__ import annotations

import weakref
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves

from repro_torch.kernels import meta
from repro_torch.models.layers import dtype_of
from repro_torch.sharding.specs import (ROW, _map_with_path, spec_axes,
                                        spec_for_param)
from repro_torch.tree_util import flatten_tree

PEAK_FLOPS = 989e12          # bf16 dense / H100 SXM
HBM_BW = 3.35e12             # bytes/s / H100 SXM (HBM3)
HBM_BYTES = 80e9             # bytes / H100
ICI_BW = 50e9                # bytes/s / device (NDR InfiniBand)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------
_aten = torch.ops.aten
_ALLOCATE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided}


def _returns_alias(func, write):
    """Whether an output of ``func`` aliases an input: as a view
    (``write`` False) or written in place (True)."""
    return any(r.alias_info is not None and r.alias_info.is_write == write
               for r in func._schema.returns)


def _tensors(tree):
    return [t for t in _pt_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Traffic(TorchDispatchMode):
    """Bytes every aten op moves, and the storages the traced code
    allocates that are alive at once (``live``, ``peak``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held = set()

    def _release(self, key, n):
        self._held.discard(key)
        self.live -= n

    def _hold(self, t):
        s = t.untyped_storage()
        key = id(s)
        if key in self._held:
            return
        self._held.add(key)
        n = s.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._release, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.is_meta for t in ins + outs):
            return out          # host work: the device moves nothing
        view = _returns_alias(func, write=False)
        if not view and func.overloadpacket not in _ALLOCATE:
            self.bytes += _nbytes(ins) + _nbytes(outs)
        if not view and not _returns_alias(func, write=True):
            for t in outs:
                self._hold(t)
        return out


@dataclass
class Trace:
    """What one traced step costs, for all devices together: FLOPs,
    bytes moved, the peak of what it allocates alive at once, and the
    kernels' share ({name: {"calls", "flops", "bytes"}})."""
    flops: int
    bytes: int
    peak_live_bytes: int
    kernels: Dict[str, Dict[str, int]] = field(default_factory=dict)


def trace(fn, *args, **kwargs):
    """(fn's result, its Trace): ``fn`` run on meta tensors under the
    counters."""
    from torch.utils.flop_counter import FlopCounterMode
    work = meta.Work()
    traffic = _Traffic()
    counter = FlopCounterMode(display=False)
    # the flop counter innermost: it decomposes composite ops (matmul,
    # to, ...), which reach the modes whole where autograd is off
    # (inference mode), so the traffic counter sees the primitive ops
    with meta.counting(work), traffic, counter:
        out = fn(*args, **kwargs)
    return out, Trace(flops=int(counter.get_total_flops()) + work.flops,
                      bytes=traffic.bytes + work.bytes,
                      peak_live_bytes=traffic.peak,
                      kernels=work.by_kernel)


# ---------------------------------------------------------------------------
# A traced step on a mesh
# ---------------------------------------------------------------------------
@dataclass
class Lowered:
    """One traced step on a mesh: what ``analyze`` prices in place of an
    XLA executable.  ``kind`` is "train", "prefill", "decode" or
    "label" (FedKT's vote step over ``members`` models); ``param_shapes``
    one model's tree; ``batch`` the global rows and ``seq`` the
    positions a row runs through the decoder (frontend embeds
    included; 1 for a decode step); ``resident_bytes`` what
    one device holds between steps (parameters, optimizer state,
    cache), from the specs; ``batch_parts`` how many parts the batch is
    split into."""
    trace: Trace
    kind: str
    cfg: Any
    mesh: Any
    param_shapes: Any
    batch: int
    seq: int
    resident_bytes: int
    batch_parts: int
    remat: bool = False
    pregather: bool = True
    members: int = 1


def collective_bytes(step: Lowered) -> Dict[str, int]:
    """Per-collective-kind result bytes a device sees in one step, by
    the module docstring's first-order model of the specs."""
    cfg, shape = step.cfg, step.mesh.shape
    m, d, p = (shape.get(a, 1) for a in ("model", "data", "pod"))
    e_c = dtype_of(cfg.dtype).itemsize
    out = {k: 0 for k in _COLLECTIVES}
    train = step.kind == "train"
    row_outputs = {"enc": 0, "dec": 0}

    def leaf(path, t):
        spec = spec_for_param(path, tuple(t.shape), step.mesh)
        axes = spec_axes(spec)
        mfac = m if "model" in axes else 1
        n, e = t.numel(), t.element_size()
        # a shared expert's output sums with the routed experts' before
        # the one reduce of its block
        if path[-1] in ROW and "model" in axes and "shared" not in path:
            row_outputs["enc" if path[0] == "enc" else "dec"] += 1
        if step.kind == "label":
            return
        sharded = "data" in axes and d > 1
        if sharded:
            if train and step.pregather:
                gathers, nbytes = (0 if t.ndim >= 3 else 1), n * e_c
            elif train:
                gathers, nbytes = (2 if step.remat else 1), n * e
            else:
                gathers, nbytes = 1, n * e
            out["all-gather"] += gathers * nbytes // mfac
        if not train:
            return
        if sharded:
            out["reduce-scatter"] += n * e // (d * mfac)
            if p > 1:
                out["all-reduce"] += n * e // (d * mfac)
        elif p * d > 1:
            out["all-reduce"] += n * e // mfac

    _map_with_path(leaf, step.param_shapes)
    if m > 1:
        passes = (3 if step.remat else 2) if train else 1
        rows = step.batch // step.batch_parts
        if step.kind == "label":
            rows *= step.members // d      # members a data index runs
        enc_pos = cfg.encoder_seq_len if step.kind != "decode" else 0
        out["all-reduce"] += passes * rows * cfg.d_model * e_c * (
            row_outputs["dec"] * step.seq + row_outputs["enc"] * enc_pos)
    if step.kind == "label":
        out["all-gather"] += step.members * step.batch * step.seq * 4
    return out


def wire_bytes(coll: Dict[str, int]) -> int:
    """First-order per-device wire traffic."""
    return (2 * coll["all-reduce"] + coll["all-gather"]
            + coll["reduce-scatter"] + coll["all-to-all"]
            + coll["collective-permute"])


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective: Dict[str, int]
    wire_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_total: float
    useful_ratio: float
    peak_memory_bytes: Optional[float] = None
    num_devices: int = 1
    notes: str = ""

    def to_dict(self):
        return asdict(self)


def _dominant(t_c, t_m, t_x):
    return max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
               key=lambda kv: kv[1])[0]


def analyze(arch, shape, mesh_name, compiled: Lowered, num_devices,
            model_flops_total, notes="") -> Roofline:
    """The roofline of a traced step (``compiled``, a ``Lowered``) on
    ``num_devices`` devices."""
    tr = compiled.trace
    flops = tr.flops / num_devices
    byts = tr.bytes / num_devices
    coll = collective_bytes(compiled)
    wb = wire_bytes(coll)
    t_c, t_m, t_x = flops / PEAK_FLOPS, byts / HBM_BW, wb / ICI_BW
    peak_mem = float(compiled.resident_bytes
                     + tr.peak_live_bytes // compiled.batch_parts)
    useful = model_flops_total / max(flops * num_devices, 1.0)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_device=flops, bytes_per_device=byts, collective=coll,
        wire_bytes_per_device=wb, t_compute=t_c, t_memory=t_m,
        t_collective=t_x, dominant=_dominant(t_c, t_m, t_x),
        model_flops_total=model_flops_total, useful_ratio=useful,
        peak_memory_bytes=peak_mem, num_devices=num_devices, notes=notes)


def extrapolate(full: Roofline, p1: Roofline, p2: Roofline,
                eff_periods: float) -> Roofline:
    """Affine depth extrapolation: X_true = X(1) + (P-1) * (X(2) - X(1)).

    The port's counters are exactly affine in depth (a trace counts
    every layer it runs); the full-depth trace contributes the peak
    memory, as the reference's full compile does."""
    def ext(a, b):
        # costs are monotone in depth: clamp a negative delta, as the
        # reference does
        return a + (eff_periods - 1.0) * max(0.0, b - a)

    flops = ext(p1.flops_per_device, p2.flops_per_device)
    byts = ext(p1.bytes_per_device, p2.bytes_per_device)
    coll = {k: int(max(0.0, ext(p1.collective[k], p2.collective[k])))
            for k in p1.collective}
    wb = wire_bytes(coll)
    t_c, t_m, t_x = flops / PEAK_FLOPS, byts / HBM_BW, wb / ICI_BW
    return Roofline(
        arch=full.arch, shape=full.shape, mesh=full.mesh,
        flops_per_device=flops, bytes_per_device=byts, collective=coll,
        wire_bytes_per_device=wb, t_compute=t_c, t_memory=t_m,
        t_collective=t_x, dominant=_dominant(t_c, t_m, t_x),
        model_flops_total=full.model_flops_total,
        useful_ratio=full.model_flops_total / max(flops * full.num_devices,
                                                  1.0),
        peak_memory_bytes=full.peak_memory_bytes,
        num_devices=full.num_devices,
        notes=full.notes)


def count_params(shape_tree, exclude_embed=True) -> int:
    """Elements of every leaf, without those under an "embed" key."""
    total = 0
    for path, leaf in flatten_tree(shape_tree).items():
        if exclude_embed and "embed" in path.split("/"):
            continue
        n = 1
        for dim in leaf.shape:
            n *= dim
        total += n
    return total


def model_flops(cfg, shape_kind: str, num_tokens: int,
                param_count: int) -> float:
    """6*N*D for training, 2*N*D for inference forward (per step);
    N = active params (MoE: top_k/num_experts of expert params +
    the rest)."""
    n_active = param_count
    if cfg.moe is not None:
        m = cfg.moe
        frac = (m.top_k + m.num_shared_experts) / (
            m.num_experts + m.num_shared_experts)
        e_params = (cfg.num_layers * m.num_experts * cfg.d_ff
                    * cfg.d_model * (3 if cfg.mlp in ("swiglu", "geglu")
                                     else 2))
        n_active = param_count - e_params + e_params * frac
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_active * num_tokens
