"""The yardstick of the kernels: published peaks, and the least work an exact
count of a graph has to do.

The bound of a count is the input graph read once from device memory: the
forward-oriented CSR, one 4-byte id for each undirected edge and one
4-byte offset for each of the n + 1 rows, at the card's published HBM
rate. It is computed from the graph the harness handed to the program and
never from the program's own layouts, so it is the same work whatever
implements the count, and any exact implementation must read at least
this. Compare counts are left out: a packed bitmap compares many ids in
one operation, so counting them would not give a lower bound.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["PEAKS", "count_bound_bytes", "count_bound_seconds", "peak_for"]

#: Published peaks (NVIDIA's data sheet, SXM part, dense), by the name
#: ``torch.cuda.get_device_name()`` gives. They hold at the card's full
#: power limit (700 W); a card set lower runs slower under load.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,
        "power_w": 700.0,
    },
}


def peak_for(device_name: str) -> Dict[str, float]:
    """The peaks of the named card.

    Raises:
      KeyError: no published peak is recorded for it.
    """
    try:
        return PEAKS[device_name]
    except KeyError:
        raise KeyError(f"no published peaks for {device_name!r}; have "
                       f"{sorted(PEAKS)}") from None


def count_bound_bytes(n: int, m_undirected: int) -> int:
    """Bytes an exact count must read: 4 per undirected edge (each edge
    once, as the forward CSR holds it) and 4 per row offset (n + 1)."""
    return 4 * int(m_undirected) + 4 * (int(n) + 1)


def count_bound_seconds(n: int, m_undirected: int,
                        hbm_bytes_per_s: float) -> float:
    """The least time a count of the graph can take on a card of that
    memory rate."""
    return count_bound_bytes(n, m_undirected) / float(hbm_bytes_per_s)
