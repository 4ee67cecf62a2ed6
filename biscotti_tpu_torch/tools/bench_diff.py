# The port's own copy of biscotti_tpu/tools/bench_diff.py; it imports nothing of biscotti_tpu.
"""Compare two bench artifacts key-wise: the bench trajectory as a
checkable artifact instead of eyeballed JSON.

    python -m biscotti_tpu_torch.tools.bench_diff BENCH_r05.json BENCH_r06.json
    python -m biscotti_tpu_torch.tools.bench_diff old.json new.json \
        --threshold 0.15 --regress '(_s|_seconds|_bytes.*)$'

Both inputs are JSON (BENCH_*.json, OVERLAY_*.json, or any nested dict
artifact — bench.py wraps its table under a `tail` string in its run
snapshots, which is unwrapped when it parses as JSON). Numeric leaves
are flattened to dotted keys and compared:

  * the delta table lists every key present in both (old, new, Δ, Δ%),
    plus keys added/removed between the artifacts;
  * `--regress REGEX` names the lower-is-better keys (default: seconds
    and bytes families); any matched key whose NEW value exceeds
    OLD × (1 + threshold) is a regression, listed and reflected in the
    exit code (1) — so a bench landing in CI fails loudly instead of
    drifting quietly.

stdlib only.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict

# lower-is-better keys. The negative lookbehind carves the
# higher-is-better throughput family (`*_points_per_s`, the device
# MSM) out of the `_s` suffix match — an MSM getting FASTER must not
# read as a latency regression. `failed` / `accepted_poisoned_n` are the
# attack-matrix survival bits (eval/eval_attack_matrix.py): a survived
# cell flipping to failed (0 → 1) or a defense letting MORE poisoned
# sources through must fail a bench diff loudly. The ENSEMBLE defense
# row's guard cell (hug_ensemble) is covered by the same two
# suffixes — bench.py emits its failed/accepted_poisoned_n under
# attack_matrix.hug_ensemble, no new pattern needed. The soak-SLO
# family (tools/soak.py SOAK_*.json, docs/SOAK.md) adds three
# lower-is-better keys the suffix rules don't already cover:
# `rss_drift_bytes_per_h` (leak rate — p99 latency and bytes/round ride
# the existing `_s` / `bytes_per_round` suffixes), `shed_rate` and
# `stall_rate` (admission sheds / round stalls per round — an endurance
# run shedding or stalling MORE at equal load is a robustness
# regression even when latency still clears its gate). Thresholds are
# the shared --threshold (+10% default): soak gates carry generous
# absolute limits, so the diff's job is catching relative creep between
# two soaks of the same scenario. The elastic-fleet pair
# (`migration_downtime_s` / `migration_bytes`, bench.py's `migration`
# entry, docs/PLACEMENT.md) already rides the `_s` / `_bytes` suffixes
# — named explicitly so the contract survives a future suffix-rule
# refactor: a change that makes moves slower or tickets fatter regresses.
DEFAULT_REGRESS = (r"(?<!points_per)(_s|_seconds|_secs|round_total|"
                   r"bytes_per_round|_bytes|crypto_s|final_error|"
                   r"failed|accepted_poisoned_n|rss_drift_bytes_per_h|"
                   r"shed_rate|stall_rate|migration_downtime_s|"
                   r"migration_bytes)$")


def load_artifact(path: str) -> Dict:
    """Load a bench JSON; run snapshots wrap the real table as a JSON
    string under `tail` — unwrap when it parses."""
    with open(path) as f:
        obj = json.load(f)
    tail = obj.get("tail") if isinstance(obj, dict) else None
    if isinstance(tail, str):
        try:
            inner = json.loads(tail)
            if isinstance(inner, dict):
                return inner
        except ValueError:
            pass
    return obj


def flatten(obj, prefix: str = "") -> Dict[str, float]:
    """Numeric leaves as dotted keys — lists by index (bools excluded:
    a flipped flag is a semantic change, not a delta)."""
    out: Dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix[:-1]] = float(obj)
    return out


def diff(old: Dict[str, float], new: Dict[str, float],
         threshold: float = 0.10,
         regress_pattern: str = DEFAULT_REGRESS) -> Dict:
    """The comparison: rows for shared keys, added/removed lists, and
    the regression verdicts for lower-is-better keys."""
    rx = re.compile(regress_pattern) if regress_pattern else None
    rows = []
    regressions = []
    for key in sorted(old.keys() & new.keys()):
        o, n = old[key], new[key]
        delta = n - o
        pct = (delta / abs(o)) if o else (0.0 if delta == 0 else
                                          float("inf"))
        row = {"key": key, "old": o, "new": n, "delta": delta,
               "pct": pct}
        if rx is not None and rx.search(key) and o > 0 \
                and n > o * (1.0 + threshold):
            row["regression"] = True
            regressions.append(row)
        rows.append(row)
    return {
        "rows": rows,
        "added": sorted(new.keys() - old.keys()),
        "removed": sorted(old.keys() - new.keys()),
        "regressions": regressions,
        "threshold": threshold,
    }


def format_diff(d: Dict, only_changed: bool = True,
                min_pct: float = 0.0) -> str:
    lines = [f"{'key':<58} {'old':>12} {'new':>12} {'Δ%':>8}"]
    for row in d["rows"]:
        if only_changed and row["delta"] == 0:
            continue
        if abs(row["pct"]) * 100 < min_pct and not row.get("regression"):
            continue
        mark = "  << REGRESSION" if row.get("regression") else ""
        pct = (f"{row['pct'] * 100:+.1f}%" if row["pct"] != float("inf")
               else "+inf")
        lines.append(f"{row['key']:<58} {row['old']:>12.6g} "
                     f"{row['new']:>12.6g} {pct:>8}{mark}")
    if d["added"]:
        lines.append(f"added ({len(d['added'])}): "
                     + ", ".join(d["added"][:12])
                     + (" …" if len(d["added"]) > 12 else ""))
    if d["removed"]:
        lines.append(f"removed ({len(d['removed'])}): "
                     + ", ".join(d["removed"][:12])
                     + (" …" if len(d["removed"]) > 12 else ""))
    if d["regressions"]:
        lines.append(f"\n{len(d['regressions'])} regression(s) past "
                     f"+{d['threshold'] * 100:.0f}%:")
        for row in d["regressions"]:
            lines.append(f"  {row['key']}: {row['old']:.6g} -> "
                         f"{row['new']:.6g} ({row['pct'] * 100:+.1f}%)")
    else:
        lines.append("\nno regressions past the threshold")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="key-wise delta between two bench JSON artifacts "
                    "with a regression-threshold exit code")
    ap.add_argument("old", help="baseline artifact (e.g. BENCH_r05.json)")
    ap.add_argument("new", help="candidate artifact")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="relative increase on a lower-is-better key "
                         "that counts as a regression (0.10 = +10%%)")
    ap.add_argument("--regress", default=DEFAULT_REGRESS,
                    help="regex naming the lower-is-better keys checked "
                         "against the threshold ('' disables)")
    ap.add_argument("--all", action="store_true",
                    help="print unchanged keys too")
    ap.add_argument("--min-pct", type=float, default=0.0,
                    help="hide rows whose |Δ%%| is below this (except "
                         "regressions)")
    ap.add_argument("--json", default="",
                    help="also write the structured diff here")
    ns = ap.parse_args(argv)

    old = flatten(load_artifact(ns.old))
    new = flatten(load_artifact(ns.new))
    d = diff(old, new, threshold=ns.threshold, regress_pattern=ns.regress)
    print(format_diff(d, only_changed=not ns.all, min_pct=ns.min_pct))
    if ns.json:
        with open(ns.json, "w") as f:
            json.dump(d, f, indent=1)
    return 1 if d["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
