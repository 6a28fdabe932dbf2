"""Sparsity telemetry aggregation (port of
``repro.observability.sparsity``).

The model's decode/prefill dispatch paths, when built with
``telemetry=True``, return one small int32 stats array per dispatch —
shape ``[num_layers, batch, 4]`` with per-(layer, slot) block counts::

    [:, :, 0]  selected   key blocks the survivor gather actually reads
    [:, :, 1]  live       valid (in-length, in-window) candidate blocks
    [:, :, 2]  pinned     selected via the keep-first/diagonal safeguard
    [:, :, 3]  filled     selected as budget fill (not Eq. 3 survivors)

The counts are summed on device from the selection masks the MP-MRF
tier select already computes (`repro_torch.core.filtering.selection_stats`),
so telemetry adds one tiny transfer that rides the engine's existing
host syncs — no extra dispatches.

Layers that do no block selection (dense prefix layers below
``min_prune_layer``, row-granular or dense fallbacks, recurrent
families) report all-zero rows; idle prefill slots self-mask (their
sentinel positions make every candidate invalid). Decode stats for
idle slots are *not* self-masking — a parked slot still has one live
cache row — so `record_decode` takes the engine's live-slot list and
drops everything else.

ρ_eff = selected / live is the runtime-effective keep ratio (Energon
§III Eq. 3 survivors + safeguards + budget fill, after the length/
window mask): the paper's headline sparsity, measured on the real
serving traffic rather than assumed from the configured ρ.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

#: Column order of the per-dispatch stats arrays.
STAT_FIELDS = ("selected", "live", "pinned", "filled")


class SparsityAggregator:
    """Accumulates per-dispatch selection stats into run totals,
    per-layer totals, and derived ratios."""

    def __init__(self):
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self._decode = np.zeros(4, np.int64)
        self._prefill = np.zeros(4, np.int64)
        self._decode_layers: Optional[np.ndarray] = None  # [L, 4]
        self._prefill_layers: Optional[np.ndarray] = None

    @staticmethod
    def _fold(stats: np.ndarray,
              slots: Optional[Sequence[int]]) -> np.ndarray:
        stats = np.asarray(stats, np.int64)
        if stats.ndim != 3 or stats.shape[-1] != 4:
            raise ValueError(f"stats shape {stats.shape}, want [L,B,4]")
        if slots is not None:
            stats = stats[:, list(slots), :]
        return stats.sum(axis=1)  # [L, 4]

    def record_decode(self, stats: np.ndarray,
                      slots: Optional[Sequence[int]] = None) -> None:
        """Fold one decode dispatch's ``[L, B, 4]`` stats, restricted
        to the live ``slots`` (idle decode slots would otherwise count
        their parked single-row caches into ρ_eff)."""
        if slots is not None and len(slots) == 0:
            return
        per_layer = self._fold(stats, slots)
        self.decode_dispatches += 1
        self._decode += per_layer.sum(axis=0)
        if self._decode_layers is None:
            self._decode_layers = per_layer
        else:
            self._decode_layers += per_layer

    def record_prefill(self, stats: np.ndarray) -> None:
        """Fold one prefill dispatch's ``[L, B, 4]`` stats (idle slots
        self-mask to zero, so no slot list is needed)."""
        per_layer = self._fold(stats, None)
        self.prefill_dispatches += 1
        self._prefill += per_layer.sum(axis=0)
        if self._prefill_layers is None:
            self._prefill_layers = per_layer
        else:
            self._prefill_layers += per_layer

    # --- derived ratios ------------------------------------------------

    @staticmethod
    def _ratio(num: int, den: int) -> Optional[float]:
        return (num / den) if den else None

    @property
    def rho_eff_decode(self) -> Optional[float]:
        """Effective decode keep ratio: selected / live candidate
        blocks over every recorded dispatch (None before any)."""
        return self._ratio(int(self._decode[0]), int(self._decode[1]))

    @property
    def rho_eff_prefill(self) -> Optional[float]:
        return self._ratio(int(self._prefill[0]), int(self._prefill[1]))

    @property
    def pinned_fraction_decode(self) -> Optional[float]:
        """Share of selected decode blocks kept by the first-block /
        diagonal safeguard rather than Eq. 3 scores."""
        return self._ratio(int(self._decode[2]), int(self._decode[0]))

    @property
    def fill_fraction_decode(self) -> Optional[float]:
        """Share of selected decode blocks that are budget fill (valid
        blocks promoted only because the static budget had room)."""
        return self._ratio(int(self._decode[3]), int(self._decode[0]))

    def _layer_ratios(self, layers: Optional[np.ndarray]) \
            -> Optional[List[Optional[float]]]:
        if layers is None:
            return None
        return [self._ratio(int(r[0]), int(r[1])) for r in layers]

    def snapshot(self) -> Dict[str, object]:
        def tot(v: np.ndarray) -> Dict[str, int]:
            return {k: int(v[i]) for i, k in enumerate(STAT_FIELDS)}

        return {
            "decode": {
                "dispatches": self.decode_dispatches,
                "blocks": tot(self._decode),
                "rho_eff": self.rho_eff_decode,
                "pinned_fraction": self.pinned_fraction_decode,
                "fill_fraction": self.fill_fraction_decode,
                "rho_eff_per_layer":
                    self._layer_ratios(self._decode_layers),
            },
            "prefill": {
                "dispatches": self.prefill_dispatches,
                "blocks": tot(self._prefill),
                "rho_eff": self.rho_eff_prefill,
                "rho_eff_per_layer":
                    self._layer_ratios(self._prefill_layers),
            },
        }
