# The port's own copy of eval/parse_logs.py; it imports nothing of biscotti_tpu.
"""Log parser — extracts `iteration,error,timestamp` CSV rows from peer
output, the exact artifact shape the reference's eval tooling consumes
(ref: usenix-eval/generateResults.py:23-52, eval/eval_performance/
parseLogs.py:27-55 parse node-0 stderr for "Train Error" lines).

Accepts either a peer process's stdout (the `=== LOGS ===` section printed
by `python -m biscotti_tpu_torch.runtime.peer`) or a JSONL event trace
(`--events`), and prints/writes CSV plus a summary line with s/iteration —
directly comparable to BASELINE.md numbers.

    python -m biscotti_tpu_torch.eval.parse_logs PEER_STDOUT [--csv F]
    python -m biscotti_tpu_torch.eval.parse_logs events_0.jsonl --events"""

from __future__ import annotations

import argparse
import json
import sys


def rows_from_stdout(text: str):
    lines = text.splitlines()
    try:
        start = lines.index("=== LOGS ===") + 1
    except ValueError:
        start = 0
    out = []
    for line in lines[start:]:
        parts = line.strip().split(",")
        if len(parts) == 3:
            try:
                out.append((int(parts[0]), float(parts[1]), float(parts[2])))
            except ValueError:
                continue
    return out


def rows_from_events(text: str):
    out = []
    for line in text.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if rec.get("event") == "round_end":
            out.append((rec["iter"] - 1, float(rec["error"]), float(rec["ts"])))
    return out


def summarize(rows):
    if len(rows) < 2:
        return {"iters": len(rows), "s_per_iter": float("nan"),
                "final_error": rows[-1][1] if rows else float("nan")}
    dt = (rows[-1][2] - rows[0][2]) / (len(rows) - 1)
    return {"iters": len(rows), "s_per_iter": round(dt, 4),
            "final_error": rows[-1][1],
            "best_error": min(r[1] for r in rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="peer stdout file or events JSONL (- for stdin)")
    ap.add_argument("--events", action="store_true",
                    help="input is a JSONL event trace")
    ap.add_argument("--csv", default="", help="write CSV rows here")
    args = ap.parse_args(argv)
    text = (sys.stdin.read() if args.input == "-"
            else open(args.input).read())
    rows = rows_from_events(text) if args.events else rows_from_stdout(text)
    csv = "\n".join(f"{i},{e:.6f},{t:.6f}" for i, e, t in rows)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(csv + "\n")
    else:
        print(csv)
    print(json.dumps(summarize(rows)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
