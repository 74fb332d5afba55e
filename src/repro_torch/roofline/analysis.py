"""Roofline terms of one step, counted per device from a fake run.

The port's counterpart of the JAX package's ``roofline/analysis.py``,
which parses the partitioned HLO of a compiled step.  Here the step runs
once under :class:`StepCounter`, a ``FakeTensorMode`` that counts what each
device would do; nothing is allocated and nothing is launched:

  compute_term    = FLOPs            / H100 bf16 peak
  memory_term     = bytes            / H100 HBM rate
  collective_term = collective bytes / the rate of the link they cross

all per device, from ``repro_torch.roofline.hw``.  The collective term
prices each mesh axis's bytes at its own link: NVLink within a node,
InfiniBand for a group over the "pod" axis, which spans nodes (the
reference prices every byte at one ICI rate; one node's term is its
bytes over NVLink, as before).  DTensor runs each
operator on the local shards of rank 0, and those local operators (and the
functional collectives that its redistributions issue) are what the
counter sees, so every count is per device.  The conventions follow the
reference's HLO walk:

* FLOPs: matmul-class operators only (``mm``, ``bmm``, ``addmm``, ...), by
  ``torch.utils.flop_counter``'s formulas, ``2·|out|·K`` for a product;
  element-wise work is not counted.
* bytes: the output bytes of every operator, plus the operand bytes of the
  matmuls.  Views, dtype casts (``_to_copy``, a ``copy_`` across dtypes:
  the reference's ``convert``) and allocations are skipped; an
  ``index_put_`` counts its written rows twice (read and write) rather
  than the buffer it updates.
* collectives: the output bytes of each functional collective (and of
  DTensor's own all-to-all), by kind and by the mesh axis of its group.
* kernels: with ``kernels=True`` (the card's step) a kernel wrapper
  launches nothing and books its kernel's FLOPs and bytes here
  (:meth:`StepCounter.book`); otherwise its plain version's operators are
  counted like any others (the reference's jnp path).
* peak memory: the local bytes of the step's arguments plus the peak of
  the storages that its operators create and that are still alive.
"""

from __future__ import annotations

import dataclasses
import json
import weakref
from typing import Dict, Iterable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import hw

aten = torch.ops.aten

# the functional collectives DTensor issues -> the reference's kinds
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# operators that move no data of their own: allocations, casts, aliases
_NO_BYTES = {
    aten._to_copy, aten.detach, aten.alias, aten.lift_fresh, aten.empty,
    aten.empty_strided, aten.empty_like, aten.new_empty, aten.new_empty_strided,
    aten._unsafe_view, aten._local_scalar_dense,
}


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (rank 0's); any other tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """Local bytes of the distinct storages in a tree of tensors."""
    seen: Dict[int, int] = {}
    for t in _tensors(tree):
        st = local(t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(FakeTensorMode):
    """A fake tensor mode that counts each device's FLOPs, bytes,
    collective bytes and peak memory (module docstring).  ``groups`` maps
    a process group's name to its mesh axis; ``kernels`` prices the kernel
    wrappers by their kernels' work rather than by their plain versions.
    Counting starts at :meth:`start`, after the arguments are made."""

    def __init__(self, groups: Optional[Dict[str, str]] = None, kernels: bool = False):
        super().__init__(allow_non_fake_inputs=True)
        self.groups = dict(groups or {})
        self.kernels_booked = kernels
        self._depth = 0
        self._busy = False
        self.start(())
        self.stop()

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        # DTensor's sharding propagation re-enters the active fake mode to
        # infer global shapes; only the outermost level is the step's work
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        return super().__exit__(*exc)

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (not self._counting or self._depth != 1 or self._busy
                or any(t is not torch.Tensor and not issubclass(t, FakeTensor) for t in types)):
            return super().dispatch(func, types, args, kwargs)
        self._busy = True  # a decomposition's operators are this one's
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._busy = False
        self._count(func, args, kwargs, out)
        return out

    # -- counting ----------------------------------------------------------------
    def start(self, args) -> None:
        """Zero every count and take ``args`` (a tree of the step's tensor
        arguments) as resident."""
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0 for k in KINDS}
        self.collectives_by_axis: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.arg_bytes = tree_bytes(args)
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self.peak_live = 0
        self._gen = getattr(self, "_gen", 0) + 1
        self._counting = True

    def stop(self) -> None:
        self._counting = False

    @property
    def peak_bytes(self) -> int:
        return self.arg_bytes + self.peak_live

    def book(self, kernel: str, flops: float, nbytes: float) -> None:
        """A kernel wrapper's work on this device, in place of a launch."""
        if not self._counting:
            return
        k = self.kernels.setdefault(kernel, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        outs = list(_tensors(out))
        if func.namespace in ("_c10d_functional", "_c10d_functional_autograd", "_dtensor"):
            kind = COLLECTIVES.get(packet.__name__)
            if kind is not None:
                n = sum(_nbytes(t) for t in outs)
                axis = self.groups.get(args[-1], str(args[-1]))
                self.collectives[kind] += n
                key = f"{kind}/{axis}"
                self.collectives_by_axis[key] = self.collectives_by_axis.get(key, 0) + n
            return
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.bytes += sum(_nbytes(t) for t in _tensors(args))
        if packet in (aten.index_put_, aten.index_put):
            self.bytes += 2 * _nbytes(args[2])  # the rows written, read and written
        elif not (func.is_view or packet in _NO_BYTES
                  or (packet is aten.copy_ and args[0].dtype != args[1].dtype)):
            self.bytes += sum(_nbytes(t) for t in outs)
        self._track(args, outs)

    def _track(self, args, outs) -> None:
        """Add the storages that ``outs`` newly hold to the live set; each
        leaves it when its storage is freed."""
        inputs = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._live_bytes += n
            self.peak_live = max(self.peak_live, self._live_bytes)
            weakref.finalize(st, self._free, key, self._gen)

    def _free(self, key: int, gen: int) -> None:
        if gen == self._gen and key in self._live:
            self._live_bytes -= self._live.pop(key)


def booking_counter(t: torch.Tensor) -> Optional[StepCounter]:
    """The StepCounter that owns fake tensor ``t`` and prices the card's
    kernels, if any."""
    mode = getattr(t, "fake_mode", None)
    return mode if isinstance(mode, StepCounter) and mode.kernels_booked else None


def link_bw(axis: str) -> float:
    """The rate of the link a collective over mesh axis ``axis`` crosses:
    InfiniBand for a group that spans nodes (the "pod" axis, alone or
    flattened with others, as "pod_data"), NVLink within a node."""
    return hw.IB_BW if "pod" in axis.split("_") else hw.NVLINK_BW


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: Dict[str, int]
    model_flops: float  # 6·N·D (dense) / 6·N_active·D (MoE) for the step
    # "kind/axis" -> bytes (StepCounter.collectives_by_axis), which the
    # collective term prices link by link
    collective_bytes_by_axis: Dict[str, int]
    peak_memory_per_device: Optional[float] = None
    output_bytes_per_device: Optional[float] = None

    # -- the three terms (seconds) ------------------------------------------------
    @property
    def compute_s(self) -> float:
        return self.flops_per_device / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        """Each axis's bytes over its link's rate (:func:`link_bw`), summed
        by link first, so one node's term is its bytes over NVLink."""
        by_link: Dict[float, int] = {}
        for key, n in self.collective_bytes_by_axis.items():
            bw = link_bw(key.split("/", 1)[1])
            by_link[bw] = by_link.get(bw, 0) + n
        return sum(n / bw for bw, n in by_link.items())

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs: catches remat and redundancy."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops": self.model_flops,
            "peak_memory_per_device": self.peak_memory_per_device,
            "output_bytes_per_device": self.output_bytes_per_device,
            "collective_bytes_by_axis": self.collective_bytes_by_axis,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_step_flops(cfg, shape) -> float:
    """MODEL_FLOPS for one step: 6·N·D for training, 2·N·D for inference
    (prefill), 2·N_active·B for one decode token — N_active for MoE."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one decode token


def load_report(path: str) -> RooflineReport:
    with open(path) as f:
        d = json.load(f)
    return RooflineReport(
        arch=d["arch"], shape=d["shape"], mesh=d["mesh"], chips=d["chips"],
        flops_per_device=d["flops_per_device"],
        bytes_per_device=d["bytes_per_device"],
        collective_bytes_per_device=d["collective_bytes_per_device"],
        model_flops=d["model_flops"],
        collective_bytes_by_axis=d["collective_bytes_by_axis"],
        peak_memory_per_device=d.get("peak_memory_per_device"),
        output_bytes_per_device=d.get("output_bytes_per_device"),
    )
