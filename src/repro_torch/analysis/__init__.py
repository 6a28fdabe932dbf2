"""Analysis: op-cost walks, analytic FLOPs and traffic, kernel bounds,
roofline assembly (port of ``repro.analysis``)."""

from repro_torch.analysis.flops import model_flops, param_counts  # noqa: F401
from repro_torch.analysis.kernel_traffic import (  # noqa: F401
    PrefillTraffic, bound_ms, fused_prefill_traffic,
)
from repro_torch.analysis.memory_model import hbm_traffic_bytes  # noqa: F401
from repro_torch.analysis.op_costs import Costs, compute_costs  # noqa: F401
from repro_torch.analysis.roofline import (  # noqa: F401
    RooflineReport, build_report,
)
