"""The rule that decides ``correct``: every number compared against its
limit. A cell's limits (``perfbench/limits/<cell>.json``) hold each
number's limit by name; ``tokens_checked`` has to reach its limit, every
other number has to stay at or under its own. The same rule judges the
program and, where a control is read beside it, the control."""

from __future__ import annotations

from typing import Dict, Tuple

#: numbers that must reach their limit; every other stays under its own
AT_LEAST = ("tokens_checked",)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[Dict[str, Dict], bool]:
    """Each number beside its limit (``{"value", "max"}`` or ``{"value",
    "min"}``), in the limits' order, and whether all hold. A number that
    is NaN holds no limit."""
    checks = {}
    for name, limit in limits.items():
        side = "min" if name in AT_LEAST else "max"
        checks[name] = {"value": numbers[name], side: limit}
    correct = all(c["value"] <= c["max"] if "max" in c
                  else c["value"] >= c["min"] for c in checks.values())
    return checks, correct
