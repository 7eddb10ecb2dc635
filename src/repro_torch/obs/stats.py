"""Streaming quantile estimation, P² (Jain & Chlamtac, 1985); port of
repro/obs/stats.py.

One :class:`P2Quantile` tracks a single quantile in O(1) memory with five
markers; :class:`StreamingQuantiles` bundles the p50 / p95 / p99 set (plus
count, min, max, mean) behind the engines' latency and the training CLI's
step-time reports.

Pure host-side Python over floats: callers time with the host clock and
feed µs, so the estimators never see a tensor.  The marker arithmetic is
the reference's operation for operation, so the same stream of values gives
the same numbers exactly.  Exact through the first five observations (a
linear-interpolated percentile of the sorted buffer), then the P²
parabolic-marker approximation.
"""
from __future__ import annotations

import math


class P2Quantile:
    """Streaming estimate of one quantile ``q`` in (0, 1), O(1) memory."""

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1); got {q}")
        self.q = q
        self.count = 0
        self._heights: list[float] = []  # marker heights (the first 5: the buffer)
        # Marker positions (1-based, as in the paper), desired positions and
        # their per-observation increments.
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self._dwant = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        h = self._heights
        if self.count <= 5:
            h.append(x)
            h.sort()
            return

        # The cell k (0..3) holding x, the extremes extended in place.
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (h[k] <= x < h[k + 1]):
                k += 1

        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]

        # The three interior markers moved toward their desired positions.
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or (
                    d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1.0):
                d = math.copysign(1.0, d)
                cand = self._parabolic(i, d)
                if not (h[i - 1] < cand < h[i + 1]):
                    cand = self._linear(i, d)
                h[i] = cand
                self._pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float:
        """The current estimate (exact while count <= 5; nan when empty)."""
        if self.count == 0:
            return math.nan
        h = self._heights
        if self.count <= 5:
            rank = self.q * (len(h) - 1)
            lo = int(rank)
            hi = min(lo + 1, len(h) - 1)
            return h[lo] + (rank - lo) * (h[hi] - h[lo])
        return h[2]


class StreamingQuantiles:
    """The p50 / p95 / p99 bundle plus count, min, max and mean, in O(1)."""

    DEFAULT_QS = (0.5, 0.95, 0.99)

    def __init__(self, qs: tuple[float, ...] = DEFAULT_QS) -> None:
        self._est = {q: P2Quantile(q) for q in qs}
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self._sum += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        for est in self._est.values():
            est.add(x)

    def quantile(self, q: float) -> float:
        return self._est[q].value()

    def to_json(self) -> dict:
        """``{count, mean, min, max, p50, p95, p99}``; ``{"count": 0}`` when
        empty, so no report carries a NaN."""
        if self.count == 0:
            return {"count": 0}
        out = {"count": self.count, "mean": self._sum / self.count, "min": self._min,
               "max": self._max}
        for q, est in sorted(self._est.items()):
            out[f"p{round(q * 100)}"] = est.value()
        return out
