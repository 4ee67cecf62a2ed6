#!/bin/bash
# Round-5 poison sweep set 2: FOOLSGOLD columns everywhere, full-protocol
# (noising on, DP-masking documented) and defense-geometry (noising off)
# variants, seeded. --no-gate on the e=1.0 runs: the measured DP-masking
# (noise norm ~14x update norm at d=7,850) makes 30% separation
# indeterminate for every geometry defense there — that finding is the
# point of keeping the rows, not a CI failure.
# The port's queue: the same runs through the biscotti_tpu_torch.eval
# drivers (on the GPU; each raises without one), their logs and artifacts
# under biscotti_tpu_torch/eval/results/.
#   bash biscotti_tpu_torch/eval/run_r5_poison2.sh
cd "$(dirname "$0")/../.." || exit 1
OUT=biscotti_tpu_torch/eval/results
mkdir -p "$OUT"
LOG=$OUT/r5_poison2.log
: > "$LOG"

run() {
  echo "=== $(date -u +%H:%M:%S) $*" >> "$LOG"
  timeout 3600 "$@" >> "$LOG" 2>&1
  echo "--- exit=$? $(date -u +%H:%M:%S)" >> "$LOG"
}

# canonical IID mnist (full protocol, reference parity + FOOLSGOLD column)
run python -m biscotti_tpu_torch.eval.eval_poison --nodes 100 --rounds 100 --seeds 3 \
    --defenses KRUM,FOOLSGOLD,NONE --no-gate --out "$OUT"
# IID mnist defense-geometry sweep (noising off)
run python -m biscotti_tpu_torch.eval.eval_poison --nodes 100 --rounds 100 --seeds 3 \
    --noising 0 --defenses KRUM,FOOLSGOLD,NONE \
    --gate-defense FOOLSGOLD --tag poison_nonoise --out "$OUT"
# dir0.3 full protocol with FOOLSGOLD column (replaces queue-1 artifact)
run python -m biscotti_tpu_torch.eval.eval_poison --dataset mnist@dir0.3 --nodes 100 \
    --rounds 100 --seeds 3 \
    --defenses KRUM,MULTIKRUM,TRIMMED_MEAN,FOOLSGOLD,NONE \
    --gate-defense FOOLSGOLD --no-gate --tag poison_mnist_dir0.3_100 \
    --out "$OUT"
# REAL digits @100 with FOOLSGOLD column (shard reuse beyond capacity
# disclosed -> report-only)
run python -m biscotti_tpu_torch.eval.eval_poison --dataset digits --nodes 100 --rounds 100 \
    --seeds 3 --defenses KRUM,FOOLSGOLD,NONE --no-gate \
    --tag poison_digits_100 --out "$OUT"
# REAL digits @10 disjoint shards with FOOLSGOLD (small n -> report-only)
run python -m biscotti_tpu_torch.eval.eval_poison --dataset digits --nodes 10 --rounds 100 \
    --seeds 3 --defenses KRUM,FOOLSGOLD,NONE --no-gate \
    --tag poison_digits --out "$OUT"

echo "POISON2 DONE $(date -u +%H:%M:%S)" >> "$LOG"
