"""Energon performance model (§IV-D) + its H100 re-derivation (port of
``repro.core.performance_model``).

The paper models two pipelines:

* head-level:  t_load = 4.5·d·n / B   cycles  (K/V DRAM→SRAM per head)
* query-level: t_comp = 2·β·n·l / m   cycles  (AU MAC array, m results/2cyc)
               t_filt = 2·(1+γ)·n·l / p cycles (FU IPU, parallelism p)

balance condition m/p = β/(1+γ); double-buffering worth it iff
t_load ≳ t_comp. The paper's equations are copied verbatim; the
reference's TPU re-derivation becomes the same three-way analysis for
one NVIDIA H100 SXM (80 GB HBM3), the roofline classification used by
``repro_torch.analysis.roofline``. The constants are the data sheet's
dense peaks at the 700 W limit; a card set to a lower power limit runs
below them under load.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# --- NVIDIA H100 SXM 80GB (HBM3) data-sheet constants, one card ---
H100_PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
H100_PEAK_OPS_INT8 = 1979e12       # OP/s, dense int8 tensor cores
H100_HBM_BW = 3.35e12              # bytes/s, HBM3
H100_NVLINK_BW = 450e9             # bytes/s, NVLink 4: 18 links, one direction


@dataclasses.dataclass(frozen=True)
class EnergonHW:
    """The paper's accelerator parameters (Table III)."""

    dram_bytes_per_cycle: float     # B in the paper (bytes/cycle @ 1GHz)
    mac_parallelism: int            # m — AU MAC units
    ipu_parallelism: int            # p — FU PEs (each outputs 1/2cyc)
    frequency_hz: float = 1e9


ENERGON_EDGE = EnergonHW(dram_bytes_per_cycle=25.6, mac_parallelism=64,
                         ipu_parallelism=512)
ENERGON_SERVER = EnergonHW(dram_bytes_per_cycle=256.0, mac_parallelism=512,
                           ipu_parallelism=4096)


def load_cycles(d: int, n: int, hw: EnergonHW) -> float:
    """t_load = 4.5·d·n/B (§IV-D): 4 B of K+V for AU, 0.5 B of K for FU."""
    return 4.5 * d * n / hw.dram_bytes_per_cycle


def attention_cycles(beta: float, n: int, l: int, hw: EnergonHW) -> float:
    """t_comp = 2·β·n·l/m — AU emits m MACs every 2 cycles."""
    return 2.0 * beta * n * l / hw.mac_parallelism


def filter_cycles(gamma: float, n: int, l: int, hw: EnergonHW) -> float:
    """t_filt = 2·(1+γ)·n·l/p — round-0 over n keys + round-1 over γ·n."""
    return 2.0 * (1.0 + gamma) * n * l / hw.ipu_parallelism


def load_to_compute_ratio(
    d: int, n: int, l: int, beta: float, hw: EnergonHW
) -> float:
    """§IV-D headline ratio  t_load/t_comp = 2.25·d·m/(B·β·l)."""
    return load_cycles(d, n, hw) / attention_cycles(beta, n, l, hw)


def should_double_buffer(
    d: int, n: int, l: int, beta: float, hw: EnergonHW,
    threshold: float = 0.5,
) -> bool:
    """Enable K/V double-buffering when loading is non-negligible.

    The paper enables double buffers for Task-A (short/medium sequences,
    ratio ≈ 1.44) and clock-gates them for long-sequence tasks
    (ratio ≈ 0.017–0.35)."""
    return load_to_compute_ratio(d, n, l, beta, hw) >= threshold


def balanced_fu_parallelism(
    m: int, beta: float, gamma: float
) -> float:
    """FU parallelism p that balances the FU/AU pipeline: p = m·(1+γ)/β."""
    return m * (1.0 + gamma) / beta


def head_latency_cycles(
    d: int, n: int, l: int, beta: float, gamma: float, hw: EnergonHW,
    double_buffer: bool = True,
) -> Dict[str, float]:
    """End-to-end cycles for one attention head on the Energon ASIC."""
    t_l = load_cycles(d, n, hw)
    t_c = attention_cycles(beta, n, l, hw)
    t_f = filter_cycles(gamma, n, l, hw)
    stage = max(t_c, t_f)
    total = max(t_l, stage) if double_buffer else t_l + stage
    return {
        "t_load": t_l,
        "t_attention": t_c,
        "t_filter": t_f,
        "bottleneck": ("load" if t_l > stage else
                       ("filter" if t_f > t_c else "attention")),
        "total": total,
    }


# ----------------------------------------------------------------------
# H100 re-derivation: same three-way decomposition, roofline units.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionWorkload:
    """One attention instance (single head-group already folded in)."""

    batch: int
    heads: int
    q_len: int          # l in the paper (1 for decode)
    kv_len: int         # n
    head_dim: int       # d
    pruning_ratio: float = 4.0   # ρ ⇒ β = 1/ρ
    round0_survivor: float = 0.5  # γ
    filter_bits: int = 8         # int8 planes on the tensor cores
    attn_bytes: int = 2          # bf16


def mpmrf_attention_flops(w: AttentionWorkload) -> Dict[str, float]:
    """FLOPs of MP-MRF attention vs dense, per forward pass.

    filter   — integer QKᵀ at low precision over all keys (result reuse
               makes R rounds cost one full-width pass).
    attend   — exact QKᵀ + PV over the β-fraction survivors.
    dense    — the unpruned 2·n·l·d (scores) + 2·n·l·d (PV) baseline.
    """
    bh = w.batch * w.heads
    beta = 1.0 / w.pruning_ratio
    filter_ops = 2.0 * bh * w.q_len * w.kv_len * w.head_dim
    attend_ops = 4.0 * bh * w.q_len * (beta * w.kv_len) * w.head_dim
    dense_ops = 4.0 * bh * w.q_len * w.kv_len * w.head_dim
    return {"filter": filter_ops, "attend": attend_ops, "dense": dense_ops}


def mpmrf_attention_bytes(w: AttentionWorkload) -> Dict[str, float]:
    """HBM bytes: filter reads int8 K planes; AU fetches survivors only
    (On-Demand Fetching). Dense baseline reads full K/V at attn_bytes."""
    bh = w.batch * w.heads
    beta = 1.0 / w.pruning_ratio
    filter_bytes = bh * w.kv_len * w.head_dim * (w.filter_bits / 8.0)
    odf_bytes = 2.0 * bh * (beta * w.kv_len) * w.head_dim * w.attn_bytes
    dense_bytes = 2.0 * bh * w.kv_len * w.head_dim * w.attn_bytes
    q_bytes = bh * w.q_len * w.head_dim * w.attn_bytes
    out_bytes = bh * w.q_len * w.head_dim * w.attn_bytes
    return {
        "filter": filter_bytes,
        "attend": odf_bytes + q_bytes + out_bytes,
        "dense": dense_bytes + q_bytes + out_bytes,
    }


def gpu_attention_times(w: AttentionWorkload) -> Dict[str, float]:
    """Roofline times (seconds, one card) for MP-MRF vs dense attention:
    the filter's integer products at the int8 peak, the attention's at
    the bf16 peak, each term the larger of its compute and HBM times."""
    f = mpmrf_attention_flops(w)
    b = mpmrf_attention_bytes(w)
    t_filter = max(f["filter"] / H100_PEAK_OPS_INT8,
                   b["filter"] / H100_HBM_BW)
    t_attend = max(f["attend"] / H100_PEAK_FLOPS_BF16,
                   b["attend"] / H100_HBM_BW)
    t_dense = max(f["dense"] / H100_PEAK_FLOPS_BF16,
                  b["dense"] / H100_HBM_BW)
    return {
        "t_filter": t_filter,
        "t_attend": t_attend,
        "t_mpmrf": t_filter + t_attend,
        "t_dense": t_dense,
        "speedup": t_dense / max(t_filter + t_attend, 1e-30),
        "compute_bound": (f["attend"] / H100_PEAK_FLOPS_BF16)
        > (b["attend"] / H100_HBM_BW),
    }
