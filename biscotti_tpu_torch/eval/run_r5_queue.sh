#!/bin/bash
# Round-5 evidence queue (VERDICT r4 directives #1/#4/#5/#7/#8):
# sustained >=30-iteration keyed secure-agg runs for every CNN family and
# the N=200/300 rows, then the seeded poison sweeps (vanilla + robust
# aggregators), then the privacy-utility regen with the mechanism column.
# Sequential on purpose: one host core (see BASELINE.md normalization note).
# The port's queue: the same runs through the biscotti_tpu_torch.eval
# drivers (on the GPU; each raises without one), their logs and artifacts
# under biscotti_tpu_torch/eval/results/.
#   bash biscotti_tpu_torch/eval/run_r5_queue.sh
cd "$(dirname "$0")/../.." || exit 1
OUT=biscotti_tpu_torch/eval/results
mkdir -p "$OUT"
LOG=$OUT/r5_queue.log
: > "$LOG"

run() {
  echo "=== $(date -u +%H:%M:%S) $*" >> "$LOG"
  timeout 3600 "$@" >> "$LOG" 2>&1
  echo "--- exit=$? $(date -u +%H:%M:%S)" >> "$LOG"
}

S="python -m biscotti_tpu_torch.eval.scale_test --out $OUT --key-dir auto --secure-agg 1 --verification 1 --iterations 30"

# 1. sustained CNN families @100 (r4 configs, 5x the duration)
run $S --nodes 100 --dataset mnist --model mnist_cnn --noising 0 \
    --base-port 28000 --tag biscotti_mnist_cnn_100_secagg
run $S --nodes 100 --dataset lfw --model lfw_cnn --noising 0 \
    --base-port 28500 --tag biscotti_lfw_cnn_100_secagg
run $S --nodes 100 --dataset cifar --model cifar_cnn --noising 0 \
    --base-port 29000 --tag biscotti_cifar_lenet_100_secagg
# 2. sustained N=200 / N=300 (mnist softmax, noising on, r4 configs)
run $S --nodes 200 --dataset mnist --noising 1 \
    --base-port 29500 --tag biscotti_mnist_200_secagg
run $S --nodes 300 --dataset mnist --noising 1 --pool-conns 16 \
    --base-port 30000 --tag biscotti_mnist_300_secagg

# 3. seeded poison sweeps (N=100, 3 seeds, mean+-std + attack_success_rate)
run python -m biscotti_tpu_torch.eval.eval_poison --nodes 100 --rounds 100 --seeds 3 \
    --out "$OUT"
run python -m biscotti_tpu_torch.eval.eval_poison --dataset mnist@dir0.3 --nodes 100 \
    --rounds 100 --seeds 3 \
    --defenses KRUM,MULTIKRUM,TRIMMED_MEAN,NONE \
    --gate-defense TRIMMED_MEAN --tag poison_mnist_dir0.3_100 \
    --out "$OUT"
run python -m biscotti_tpu_torch.eval.eval_poison --dataset digits --nodes 100 --rounds 100 \
    --seeds 3 --tag poison_digits_100 --out "$OUT"

# 4. privacy-utility regen (gaussian + mcmc13 mechanism rows, accept rate)
run python -m biscotti_tpu_torch.eval.eval_privacy_utility --nodes 100 --rounds 100 \
    --out "$OUT"

echo "QUEUE DONE $(date -u +%H:%M:%S)" >> "$LOG"
