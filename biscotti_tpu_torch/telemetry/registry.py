"""Metrics registry: counters, gauges, histograms with label support — a
copy of `biscotti_tpu/telemetry/registry.py` (stdlib only), so the port's
simulator feeds the same families and renders the same Prometheus text
page as the reference's without importing it.

The one metrics API behind which the runtime's ad-hoc accounting lives
(PeerAgent's event counters, the fault plane's injection tallies, the
PhaseClock totals — SURVEY §5.1's "parse the logs afterwards" signal made
inspectable while the cluster is live). Design constraints, in order:

  * **stdlib only.** The registry is imported by the config layer's
    neighbourhood and by the disabled-telemetry no-op path; it must pull
    in neither jax nor numpy (asserted by the telemetry smoke test).
  * **cheap on the hot path.** One dict lookup + one float add per
    counter tick; histograms do one bisect over a fixed bucket table.
    A `threading.Lock` guards mutation because trainer steps run off the
    event loop (`asyncio.to_thread`) — uncontended acquisition is ~100 ns,
    noise against the RPC round-trips being measured.
  * **bounded cardinality.** Labels are caller-supplied (`peer`,
    `msg_type`, `phase`, `event`); a hostile or buggy label source must
    not grow series without bound, so each family caps its label-set
    count and collapses the excess into one `overflow="true"` series
    (the spill is counted, never silent).

Naming convention (docs/OBSERVABILITY.md): `biscotti_<noun>_<unit>` for
gauges/histograms (`_seconds`, `_bytes`), `biscotti_<noun>_total` for
counters — the Prometheus convention, so `render()` output plugs into any
standard scraper unchanged.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

# Fixed log-scale latency buckets (seconds), 100 µs … 100 s in 1-2.5-5
# decades: spans a share-row RPC on loopback through a WAN block deadline.
# One shared table for every histogram keeps per-peer snapshots mergeable
# bucket-by-bucket (tools/obs.py sums counts across peers before taking
# quantiles), so per-family overrides exist but default to this.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)

_OVERFLOW_KEY: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    """Canonical hashable form: sorted (name, str(value)) pairs."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    """Prometheus label-value escaping (text exposition format)."""
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


class _Family:
    """One named metric family; series keyed by canonical label tuples."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self.registry = registry
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _slot(self, labels: Dict[str, object], default):
        """Get-or-create the series for `labels`, enforcing the family's
        cardinality cap: past the cap every new label-set lands in the
        shared overflow series (counted in registry.overflow_series)."""
        key = _label_key(labels)
        series = self._series
        if key not in series and len(series) >= self.registry.max_label_sets:
            if key != _OVERFLOW_KEY:
                self.registry.overflow_series += 1
            key = _OVERFLOW_KEY
        if key not in series:
            series[key] = default()
        return key

    def series_count(self) -> int:
        return len(self._series)


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self.registry._lock:
            key = self._slot(labels, float)
            self._series[key] += amount

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self.registry._lock:
            key = self._slot(labels, float)
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self.registry._lock:
            key = self._slot(labels, float)
            self._series[key] += amount

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)  # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(registry, name, help)
        b = tuple(buckets) if buckets is not None else registry.buckets
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram buckets must strictly increase: {b}")
        self.buckets = b

    def observe(self, value: float, **labels) -> None:
        with self.registry._lock:
            key = self._slot(labels, lambda: _HistSeries(len(self.buckets)))
            s: _HistSeries = self._series[key]
            s.counts[bisect_left(self.buckets, value)] += 1
            s.sum += value
            s.count += 1


def quantile_from_buckets(bounds: Iterable[float], counts: Iterable[int],
                          q: float) -> float:
    """Histogram quantile estimate: the upper bound of the bucket where the
    cumulative count crosses q·total (the standard Prometheus estimate,
    conservative by up to one log-scale bucket). `counts` are per-bucket
    (non-cumulative) with the trailing +Inf bucket; bounds exclude +Inf.
    Returns the largest finite bound for observations past it."""
    bounds = list(bounds)
    counts = list(counts)
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


class MetricsRegistry:
    """Named metric families with get-or-create accessors.

    `counter/gauge/histogram` are idempotent per name (the same family
    object comes back), so call sites never coordinate registration;
    re-declaring a name as a different kind is a programming error and
    raises.
    """

    def __init__(self, max_label_sets: int = 64,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self.max_label_sets = max(1, int(max_label_sets))
        self.buckets = tuple(buckets)
        # observations routed to an overflow series by the cardinality
        # cap (counted per update, so a chatty runaway label is visible)
        self.overflow_series = 0

    # ------------------------------------------------------------ families

    def _family(self, cls, name: str, help: str, **kw) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = self._families[name] = cls(self, name, help, **kw)
        if not isinstance(fam, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{fam.kind}, not {cls.kind}")
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    # ------------------------------------------------------------ readout

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable dump — the structured half of the `Metrics`
        RPC reply (the Prometheus text is `render()`). Histogram series
        carry per-bucket counts plus the family's bounds so per-peer
        snapshots merge bucket-wise (tools/obs.py)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for name, fam in self._families.items():
                entry: dict = {"type": fam.kind, "help": fam.help,
                               "series": []}
                if isinstance(fam, Histogram):
                    entry["bounds"] = list(fam.buckets)
                for key, val in fam._series.items():
                    row: dict = {"labels": dict(key)}
                    if isinstance(val, _HistSeries):
                        row.update(buckets=list(val.counts),
                                   sum=val.sum, count=val.count)
                    else:
                        row["value"] = val
                    entry["series"].append(row)
                out[name] = entry
        return out

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key, val in sorted(fam._series.items()):
                    base = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
                    if isinstance(val, _HistSeries):
                        cum = 0
                        bounds = [repr(float(b)) for b in fam.buckets]
                        for le, c in zip(bounds + ["+Inf"], val.counts):
                            cum += c
                            lbl = (f'{base},le="{le}"' if base
                                   else f'le="{le}"')
                            lines.append(f"{name}_bucket{{{lbl}}} {cum}")
                        suffix = f"{{{base}}}" if base else ""
                        lines.append(f"{name}_sum{suffix} {val.sum}")
                        lines.append(f"{name}_count{suffix} {val.count}")
                    else:
                        suffix = f"{{{base}}}" if base else ""
                        lines.append(f"{name}{suffix} {val}")
        return "\n".join(lines) + "\n"
