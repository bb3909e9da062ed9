"""Process-wide metrics: counters, gauges and histograms with labels.

The port's copy of ``accl_tpu/tracing.py``'s ``MetricsRegistry``,
trimmed to direct writes, collectors and :meth:`MetricsRegistry.snapshot`.
Event traces and profiling are not ported yet.
"""

from __future__ import annotations

import threading
import weakref


class MetricsRegistry:
    """Counters, gauges and histograms with Prometheus-style labels, plus
    weakly-held *collectors* polled at snapshot time.

    Rare events write directly (:meth:`inc`, :meth:`set_gauge`,
    :meth:`observe`); high-rate sources keep their own cheap counters and
    register a collector that turns them into labeled rows only when a
    snapshot is taken. A collector holds its owner weakly and vanishes
    with it."""

    _HIST_BUCKETS = tuple(4.0 ** k for k in range(0, 10))  # 1..4^9, +Inf

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, list] = {}  # key -> [count, sum, [bucket n]]
        self._collectors: list[tuple[weakref.ref, object]] = []

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    # -- direct writes -------------------------------------------------------
    def inc(self, name: str, value: float = 1, **labels):
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels):
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value: float, **labels):
        """Histogram sample (fixed power-of-4 buckets in the observed
        unit)."""
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0, 0.0,
                                        [0] * (len(self._HIST_BUCKETS) + 1)]
            h[0] += 1
            h[1] += value
            for i, edge in enumerate(self._HIST_BUCKETS):
                if value <= edge:
                    h[2][i] += 1
                    break
            else:
                h[2][-1] += 1

    # -- collectors ----------------------------------------------------------
    def register_collector(self, owner, fn):
        """``fn(owner) -> iterable of (kind, name, labels_dict, value)``
        with kind "counter" | "gauge" | "histogram" (histogram value:
        ``[count, sum, bucket-count list]``). ``owner`` is held weakly."""
        with self._lock:
            self._collectors = [(r, f) for r, f in self._collectors
                                if r() is not None]
            self._collectors.append((weakref.ref(owner), fn))

    def _collect(self) -> list[tuple[str, str, dict, float]]:
        with self._lock:
            refs = list(self._collectors)
        rows = []
        for ref, fn in refs:
            owner = ref()
            if owner is None:
                continue
            try:
                rows.extend(fn(owner))
            except Exception:  # noqa: BLE001 — a dying world's collector
                # must not take the whole snapshot down with it
                continue
        return rows

    # -- reporting -----------------------------------------------------------
    @staticmethod
    def _label_str(labels: tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in labels)

    def snapshot(self) -> dict:
        """``{"counters": {name: {"k=v,...": value}}, "gauges": {...},
        "histograms": {name: {labels: {count, sum, buckets}}}}``: direct
        writes merged with every live collector's rows."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: [h[0], h[1], list(h[2])]
                     for k, h in self._hists.items()}
        for kind, name, labels, value in self._collect():
            key = self._key(name, labels)
            if kind == "counter":
                counters[key] = counters.get(key, 0) + value
            elif kind == "histogram":
                h = hists.get(key)
                if h is None:
                    hists[key] = [value[0], value[1], list(value[2])]
                else:
                    h[0] += value[0]
                    h[1] += value[1]
                    h[2] = [a + b for a, b in zip(h[2], value[2])]
            else:
                gauges[key] = value
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, v in counters.items():
            out["counters"].setdefault(key[0], {})[
                self._label_str(key[1])] = v
        for key, v in gauges.items():
            out["gauges"].setdefault(key[0], {})[
                self._label_str(key[1])] = v
        for key, (n, s, buckets) in hists.items():
            edges = [*(str(e) for e in self._HIST_BUCKETS), "+Inf"]
            out["histograms"].setdefault(key[0], {})[
                self._label_str(key[1])] = {
                    "count": n, "sum": s,
                    "buckets": dict(zip(edges, buckets))}
        return out


# one health surface across every world living in this process
METRICS = MetricsRegistry()
