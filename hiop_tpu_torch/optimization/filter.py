"""Wächter–Biegler filter (parity: hiopFilter,
HiOp src/Optimization/hiopFilter.hpp:59-86).

A list of (theta, phi) pairs; a trial point is unacceptable if it is
dominated by any entry. Host-side (the filter is O(iterations) small and
data-dependent; keeping it out of jit mirrors where the reference keeps it)."""

from __future__ import annotations

from typing import List, Tuple


class Filter:
    def __init__(self) -> None:
        self._entries: List[Tuple[float, float]] = []

    def reinitialize(self, theta_max: float) -> None:
        """Reset to the single entry (theta_max, -inf) (hiopFilter::reinitialize)."""
        self._entries = [(float(theta_max), float("-inf"))]

    def add(self, theta: float, phi: float) -> None:
        self._entries.append((float(theta), float(phi)))

    def contains(self, theta: float, phi: float) -> bool:
        """True if (theta, phi) is dominated by (not acceptable to) the filter."""
        for th, ph in self._entries:
            if theta >= th and phi >= ph:
                return True
        return False

    def __len__(self) -> int:
        return len(self._entries)
