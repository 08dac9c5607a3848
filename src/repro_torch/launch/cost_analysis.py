"""Per-device cost of a program of the port, for the roofline: the
counterpart of ``repro/launch/hlo_analysis.py`` by what it reports, not by
how it gets it.

``repro`` parses the optimized, SPMD-partitioned HLO of a compiled cell
(loop bodies times their trip counts). The port has no HLO: it runs one
rank's program eagerly on ``meta`` tensors (nothing is allocated, nothing
computes) over a dry mesh (``launch.mesh.make_mesh(..., dry=True)``: a fake
process group of the mesh's ranks) and counts what the program dispatches:

  * ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode``, 2 M N K
    per matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``; an einsum
    dispatches as them) and per attention product, forward and backward,
    remat's recomputation included as it runs;
  * ``hbm_bytes``: operand plus result bytes of every dispatched op but the
    views (which move nothing). Eager PyTorch fuses nothing, so this is the
    counterpart of ``repro``'s ``hbm_bytes_raw`` (every instruction's
    operands and result), not of its fused estimate ``hbm_bytes`` (anchor
    ops only); both keys hold it here;
  * ``collective_bytes``, ``collectives`` and ``collective_counts``: each
    collective the program issues over the fake process group
    (``launch/sharding.py``'s and ``launch/mesh.py``'s), by kind, its
    operand's bytes (an all-gather's the rank's block, a reduce-scatter's
    the whole input), as ``repro`` counts them.

What differs from ``repro``'s numbers: XLA fuses elementwise chains and
GSPMD places its collectives by its own choice (an all-gather where the
port reduces, a collective on the backward's partial sums where the port
all-reduces an input's gradient), while the port's collectives are those
``launch/sharding.py`` writes out; an XLA scan body counted once per trip
is here the eager loop itself; the port's in-place cache writes count the
slice they write, its plain clones count as copies.

``roofline_terms`` is ``repro``'s three-term roofline over per-device
quantities, with the NVIDIA H100 SXM's published figures in place of the
TPU v5e's.
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# c10d op name fragment -> (repro's collective kind, the argument holding the operand)
_COLLECTIVES = (("allreduce", "all-reduce", 0), ("_allgather_base", "all-gather", 1),
                ("allgather", "all-gather", 1), ("_reduce_scatter_base", "reduce-scatter", 1),
                ("reduce_scatter", "reduce-scatter", 1), ("alltoall", "all-to-all", 1),
                ("broadcast", "broadcast", 0), ("send", "collective-permute", 0))


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Bytes(TorchDispatchMode):
    """Operand plus result bytes of every dispatched op but views; the
    collectives' operand bytes and counts by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.coll = collections.Counter()
        self.coll_counts = collections.Counter()
        self.allocated = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            name = func._opname
            for frag, kind, arg in _COLLECTIVES:
                if frag in name:
                    self.coll[kind] += _bytes(args[arg])
                    self.coll_counts[kind] += 1
                    break
        elif not func.is_view:
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
            self.ops += 1
        self.allocated += sum(t.numel() * t.element_size() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor) and t.device.type != "meta")
        return out


def analyze(fn, *args, **kwargs) -> tuple[object, dict]:
    """(``fn(*args, **kwargs)``, its per-device counts under ``repro``'s
    ``analyze_hlo`` keys; ``n_ops`` the ops counted in place of its
    ``n_computations``, ``allocated_bytes`` those of the ops' results that
    are not meta tensors: 0 for a program run on meta tensors over a dry
    mesh, which allocates nothing)."""
    counter = _Bytes()
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args, **kwargs)
    return out, {
        "dot_flops": int(flops.get_total_flops()),
        "hbm_bytes": int(counter.bytes),
        "hbm_bytes_raw": int(counter.bytes),
        "collective_bytes": int(sum(counter.coll.values())),
        "collectives": {k: int(v) for k, v in counter.coll.items()},
        "collective_counts": {k: int(v) for k, v in counter.coll_counts.items()},
        "n_ops": counter.ops,
        "allocated_bytes": int(counter.allocated),
    }


# ---------------------------------------------------------------------------
# roofline terms (NVIDIA H100 SXM5 80 GB, published figures)
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12  # dense bf16 on the tensor cores, per GPU
HBM_BW = 3.35e12  # HBM3 bytes/s per GPU
NVLINK_BW = 450e9  # NVLink 4 bytes/s per direction per GPU (900 GB/s both ways)


def roofline_terms(*, hlo_flops: float, hlo_bytes: float, coll_bytes_per_device: float,
                   n_chips: int) -> dict:
    """``repro``'s three-term roofline over per-device quantities (a
    rank's program is the per-device program, so ``n_chips`` enters through
    its shapes, not as a division): compute, memory and collective seconds,
    which dominates, and its time."""
    terms = {"compute_s": hlo_flops / PEAK_FLOPS_BF16, "memory_s": hlo_bytes / HBM_BW,
             "collective_s": coll_bytes_per_device / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    return terms
