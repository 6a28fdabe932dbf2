"""Roofline terms per (arch × shape × mesh) from dry-run artifacts (port
of ``repro.analysis.roofline``, divided by the H100's rates).

    compute_term    = per_card_FLOPs / bf16 peak FLOP/s
    memory_term     = per_card_bytes / HBM bandwidth
    collective_term = per_card_collective_bytes / NVLink bandwidth

The costs come from ``repro_torch.analysis.op_costs``'s walk of one
card's program — on a production mesh, one device's share of it
(``launch/dryrun.py --mesh``) — so they are already per card, over
``chips`` cards; ``collective_breakdown`` keeps the collective bytes by
the reference's type names. The collective term divides by NVLink's
450 GB/s: where a mesh axis spans more than one 8-card node it is a
lower bound. ``raw_*`` fields are kept for the reference's artifact
shape; the port has no compiled module whose own cost analysis would
fill them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.performance_model import (
    H100_HBM_BW,
    H100_NVLINK_BW,
    H100_PEAK_FLOPS_BF16,
)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_chip: float
    useful_ratio: float
    collective_breakdown: Dict[str, float]
    raw_flops: Optional[float] = None
    raw_bytes: Optional[float] = None
    peak_memory_bytes: Optional[float] = None

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound set by *useful* model compute: how close
        the cell is to the 'perfect implementation' roofline where only
        MODEL_FLOPS at peak throughput remains."""
        ideal = self.model_flops / self.chips / H100_PEAK_FLOPS_BF16
        return ideal / max(self.bound_time_s, 1e-30)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["bound_time_s"] = self.bound_time_s
        d["roofline_fraction"] = self.roofline_fraction
        return d


def build_report(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    parsed_flops: float,
    parsed_traffic_bytes: float,
    parsed_collective_bytes: Dict[str, float],
    model_flops: float,
    raw_flops: Optional[float] = None,
    raw_bytes: Optional[float] = None,
    peak_memory_bytes: Optional[float] = None,
    analytic_traffic_bytes: Optional[float] = None,
) -> RooflineReport:
    compute_s = parsed_flops / H100_PEAK_FLOPS_BF16
    # Memory term: the analytic per-card HBM traffic model when provided
    # (the walk's eager traffic is unfused: each op reads its operands
    # and writes its output; see memory_model.py).
    traffic = (analytic_traffic_bytes if analytic_traffic_bytes is not None
               else parsed_traffic_bytes)
    memory_s = traffic / H100_HBM_BW
    coll_bytes = sum(parsed_collective_bytes.values())
    collective_s = coll_bytes / H100_NVLINK_BW
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    hlo_global = parsed_flops * chips
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        hlo_flops_per_chip=parsed_flops,
        useful_ratio=model_flops / max(hlo_global, 1e-30),
        collective_breakdown=dict(parsed_collective_bytes),
        raw_flops=raw_flops,
        raw_bytes=raw_bytes,
        peak_memory_bytes=peak_memory_bytes,
    )
