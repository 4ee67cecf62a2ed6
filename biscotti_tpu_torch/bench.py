"""The port's crypto-inclusive bench: the reference bench's `bench_config`
(bench.py:193-395) over its eight BASELINE configs (bench.py:842-879), on
the GPU.

    python -m biscotti_tpu_torch.bench [--configs NAME,NAME] [--rounds N]
                                       [--device cpu] [--density 100,400]

For each config:
  * device round — the port's `Simulator`, 2 warm rounds, then 10 timed
    rounds (4 for the rows that name a model, as bench.py:887), ending in
    `torch.cuda.synchronize()`; `device_round_s` is the mean timed round;
  * worker crypto — ONE peer's quantize → Pedersen-VSS chunk commitments →
    blinding rows → int64 Shamir shares (`worker_crypto_s`, host);
  * miner crypto — the busiest miner's intake of num_samples // 2 workers
    through `VssIntakeBatch`: `add` + one `fold` (`miner_fold_s`, overlapped
    with the intake network window in deployment), the mint-time settle
    (`miner_crypto_s`) and the pre-pipeline one-shot `vss_verify_multi`
    lump (`miner_crypto_oneshot_s`), on the native host plane;
  * recovery — `recover_update` of three workers' aggregated shares
    (`recovery_s`), which must round-trip exactly
    (`share_pipeline_roundtrip_ok`);
  * with C·k ≤ DEVICE_SETTLE_MAX_D (2048, the reference's default), the
    same settle with the device crypto plane armed on the bench's device
    (`miner_crypto_device_s`) and its `msm` rate at the grid width
    (`msm_points_per_s`), one timed call each.
The host crypto runs on the native EC plane (`native_ec_plane` in the
JSON); on the GPU the bench raises where that library did not load, since
the python-int fallback is ~30x slower.
`round_total_s` is the serial sum device + worker + one-shot + recovery;
`round_total_pipelined_s` is max(device, worker, fold) + settle + recovery,
the reference's depth-1 one-peer-per-host composition. Host times are the
host clock; every device entry point ends in a host copy of its result.
The byte columns (bench.py:396-417) are the cluster's protocol bytes for
one round, from the port's own block, codec, frame and wire packers with
the row's final weights (float64, off the card) as the representative
vector and the last round's accepted count: `wire_bytes_per_round` under
raw64, `wire_bytes_per_round_f32_zlib` under f32+zlib, their ratio
`wire_compression_x`, and the bytes that cross hosts on a 2-host fleet,
flat (`cross_host_bytes_per_round`) and through the aggregation overlay
(`cross_host_bytes_per_round_overlay`), with their ratio
`overlay_cross_host_saving_x`.

With `--density`, the reference's peer-density entry (bench.py:452-517)
runs too (`bench_peer_density`): one process of the port's hive CLI a
size, live mnist hives on the bench's device, under `peer_density`.

Standard output is one JSON line: the device, the card's `name,
power.limit` as nvidia-smi prints it (null on the CPU), whether the native
EC plane ran the host crypto, one row a config
and, when mnist_100_dp_eps1 ran, the reference's headline (its pipelined
crypto-inclusive s/iter). Left out: the MFU column (bench.py:225-232 counts
dense-layer FLOPs only and undercounts the convolutions by its own
comment).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from biscotti_tpu_torch.config import BiscottiConfig, Defense
from biscotti_tpu_torch.crypto import _native
from biscotti_tpu_torch.crypto import commitments as cm
from biscotti_tpu_torch.crypto import kernels
from biscotti_tpu_torch.device import resolve_device, synchronize
from biscotti_tpu_torch.ledger.block import Block, BlockData, Update
from biscotti_tpu_torch.ops import secretshare as ss
from biscotti_tpu_torch.parallel.sim import Simulator
from biscotti_tpu_torch.runtime import codecs as wcodecs
from biscotti_tpu_torch.runtime import messages as msgs
from biscotti_tpu_torch.runtime import wire as rwire

WARM_ROUNDS = 2
# the reference's default device-settle cap (C·k points): the eager device
# settle is launch-bound, seconds a call whatever its width, so the bench
# pays it on the one row under the cap (creditcard_10) and chip_smoke's
# `secagg` phase times it at the mnist width
DEVICE_SETTLE_MAX_D = 2048
HEADLINE = "mnist_100_dp_eps1"
HEADLINE_METRIC = ("crypto-inclusive s/iter, 100-peer MNIST softmax + Krum "
                   "+ DP eps=1.0 + secure-agg, pipelined round engine "
                   "(ref fleet: 38.2 s/iter)")

# bench.py:842-879, in order
BASE = dict(batch_size=10, epsilon=1.0, sample_percent=0.70,
            num_verifiers=3, num_miners=3, num_noisers=2, seed=0)
CONFIGS: List[Tuple[str, dict]] = [
    ("creditcard_10", dict(dataset="creditcard", num_nodes=10, secure_agg=True,
                           noising=True, verification=True)),
    ("mnist_100_clean", dict(dataset="mnist", num_nodes=100, secure_agg=True,
                             noising=False, verification=True)),
    ("mnist_100_poison30_krum", dict(dataset="mnist", num_nodes=100,
                                     secure_agg=True, noising=True,
                                     verification=True, poison_fraction=0.30)),
    ("mnist_100_dp_eps1", dict(dataset="mnist", num_nodes=100, secure_agg=True,
                               noising=True, verification=True)),
    ("cifar_lenet_100_krum_secagg", dict(dataset="cifar", model_name="cifar_cnn",
                                         num_nodes=100, secure_agg=True,
                                         noising=False, verification=True)),
    ("mnist_cnn_100_krum_secagg", dict(dataset="mnist", model_name="mnist_cnn",
                                       num_nodes=100, secure_agg=True,
                                       noising=False, verification=True)),
    ("lfw_cnn_100_krum_secagg", dict(dataset="lfw", model_name="lfw_cnn",
                                     num_nodes=100, secure_agg=True,
                                     noising=False, verification=True)),
    ("svm_mnist_100_krum_secagg", dict(dataset="mnist", model_name="svm",
                                       num_nodes=100, secure_agg=True,
                                       noising=False, verification=True)),
]


def config(name: str) -> BiscottiConfig:
    """The named BASELINE config, built from the reference's keywords."""
    return BiscottiConfig(defense=Defense.KRUM, **dict(CONFIGS)[name], **BASE)


def timed_rounds(cfg: BiscottiConfig) -> int:
    return 4 if cfg.model_name else 10


def _timeit(fn: Callable, warm: int = 1, iters: int = 3) -> float:
    """Mean host-clock seconds of `iters` calls after `warm` untimed ones."""
    for _ in range(warm):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _round_frame_bytes(cfg: BiscottiConfig, w64: np.ndarray, accepted: int,
                       codec: str = wcodecs.RAW) -> Tuple[int, int, int]:
    """(verify, submit, block) frame sizes of one round, from encoding the
    frames themselves with `w64` as the representative delta and model
    (bench.py:73-133)."""
    wc = wcodecs.get(codec)
    kw = dict(codec=None if wc.name == wcodecs.RAW else wc.name)
    d = len(w64)
    delta, _ = wc.transform(np.asarray(w64, np.float64),
                            topk_k=max(1, int(round(cfg.wire_topk * d))))
    gw = wc.transform_dense(np.asarray(w64, np.float64))
    it = 1
    # worker -> verifier: the redacted update, its noised copy in float32
    redacted = Update(source_id=1, iteration=it,
                      delta=np.zeros(0, np.float64), commitment=b"\0" * 32,
                      noised_delta=np.asarray(delta, np.float32))
    verify = len(msgs.encode("VerifyUpdateKRUM", *rwire.pack_update(redacted),
                             **kw))
    if cfg.secure_agg:
        c = ss.num_chunks(d, cfg.poly_size)
        submit = len(msgs.encode("RegisterSecret", {
            "iteration": it, "source_id": 1, "miner_index": 0,
            "commitment": "00" * 32,
        }, {
            "share_rows": np.ones((cfg.shares_per_miner, c), np.int64),
            "blind_rows": np.ones((cfg.shares_per_miner, c, 32), np.uint8),
            "comms": np.ones((c, cfg.poly_size, 64), np.uint8),
        }, **kw))
        blk_updates = [Update(source_id=1, iteration=it,
                              delta=np.zeros(0, np.float64),
                              commitment=b"\0" * 32, accepted=True)]
    else:
        u = Update(source_id=1, iteration=it, delta=delta,
                   commitment=b"\0" * 32)
        submit = len(msgs.encode("RegisterUpdate", *rwire.pack_update(u), **kw))
        blk_updates = [Update(source_id=1, iteration=it, delta=delta,
                              commitment=b"\0" * 32, accepted=True)]
    blk = Block(data=BlockData(iteration=it, global_w=gw,
                               deltas=blk_updates * max(1, accepted)),
                prev_hash=b"\0" * 32,
                stake_map={i: 10 for i in range(cfg.num_nodes)}).seal()
    block = len(msgs.encode("RegisterBlock", *rwire.pack_block(blk), **kw))
    return verify, submit, block


def wire_round_bytes(cfg: BiscottiConfig, w64: np.ndarray, accepted: int,
                     codec: str = wcodecs.RAW) -> int:
    """The cluster's protocol bytes for one round (bench.py:136-154):
    num_samples × (num_verifiers × verify + num_miners × submit)
    + (num_nodes − 1) × block."""
    verify, submit, block = _round_frame_bytes(cfg, w64, accepted, codec)
    n_s = cfg.num_samples
    return int(n_s * (cfg.num_verifiers * verify + cfg.num_miners * submit)
               + (cfg.num_nodes - 1) * block)


def cross_host_round_bytes(cfg: BiscottiConfig, w64: np.ndarray, accepted: int,
                           codec: str = wcodecs.RAW, hosts: int = 2,
                           overlay: bool = False) -> int:
    """The bytes of one round that cross hosts on a `hosts`-host fleet with
    peers split evenly (bench.py:157-190): (hosts − 1)/hosts of a uniform
    fan-out; with the aggregation overlay, verify traffic unchanged,
    secure-agg shares one aggregate per (subtree, miner), plain updates one
    copy per remote miner-holding host, the block once per remote
    subtree."""
    verify, submit, block = _round_frame_bytes(cfg, w64, accepted, codec)
    n, n_s = cfg.num_nodes, cfg.num_samples
    m, v = cfg.num_miners, cfg.num_verifiers
    h = max(1, int(hosts))
    remote_frac = (h - 1) / h
    if not overlay:
        return int(remote_frac * (n_s * (v * verify + m * submit)
                                  + (n - 1) * block))
    cross = remote_frac * n_s * v * verify
    if cfg.secure_agg:
        cross += remote_frac * h * m * submit
    else:
        cross += n_s * min(m, h - 1) * submit
    cross += (h - 1) * block
    return int(cross)


def byte_columns(cfg: BiscottiConfig, w64: np.ndarray, accepted: int) -> dict:
    """The six byte columns of a row, computed as bench.py:396-417 does."""
    wire_raw = wire_round_bytes(cfg, w64, accepted, codec="raw64")
    wire_f32z = wire_round_bytes(cfg, w64, accepted, codec="f32+zlib")
    xh_flat = cross_host_round_bytes(cfg, w64, accepted, hosts=2,
                                     overlay=False)
    xh_overlay = cross_host_round_bytes(cfg, w64, accepted, hosts=2,
                                        overlay=True)
    return {"wire_bytes_per_round": wire_raw,
            "wire_bytes_per_round_f32_zlib": wire_f32z,
            "wire_compression_x": round(wire_raw / max(1, wire_f32z), 2),
            "cross_host_bytes_per_round": xh_flat,
            "cross_host_bytes_per_round_overlay": xh_overlay,
            "overlay_cross_host_saving_x": round(xh_flat / max(1, xh_overlay), 2)}


def crypto_times(cfg: BiscottiConfig, w: np.ndarray, device_s: float,
                 dev: torch.device) -> dict:
    """The host crypto half of one config's row (bench.py:246-381), with
    `w` the representative d-vector and `device_s` the device round."""
    d, k = len(w), cfg.poly_size
    total_shares, per_miner = cfg.total_shares, cfg.shares_per_miner
    q = ss.quantize(w, cfg.precision)
    # CNN-sized models: one timed repetition (each pass is seconds long)
    reps = 1 if d > 20_000 else 2
    c_chunks = ss.num_chunks(d, k)
    chunks = ss.to_chunks(q, k)
    xs_all = [i - ss.SHARE_OFFSET for i in range(total_shares)]
    made = {}

    def worker():
        comms, blinds = cm.vss_commit_chunks(chunks, b"bench-seed" * 3, b"ctx")
        made.update(comms=comms, br=cm.vss_blind_rows(blinds, xs_all),
                    sh=ss.make_shares(q, k, total_shares))

    worker_s = _timeit(worker, warm=1, iters=reps)
    comms, br, sh = made["comms"], made["br"], made["sh"]
    sl = slice(0, per_miner)
    intake = max(1, cfg.num_samples // 2)

    def fold_intake():
        acc = cm.VssIntakeBatch(per_miner, c_chunks, k)
        for sid in range(intake):
            acc.add(sid, comms, sh[sl], br[sl])
        acc.fold()
        return acc

    t0 = time.perf_counter()
    accs = [fold_intake() for _ in range(reps)]
    fold_s = (time.perf_counter() - t0) / reps
    if not accs[0].verify(xs_all[sl]):  # + warm
        raise RuntimeError("intake settle failed")
    miner_s = _timeit(lambda: accs[0].verify(xs_all[sl]), warm=0, iters=reps)
    instances = [(comms, xs_all[sl], sh[sl], br[sl])] * intake
    oneshot_s = _timeit(lambda: cm.vss_verify_multi(instances), warm=0,
                        iters=reps)

    agg = ss.aggregate_shares(sh[None].repeat(3, axis=0))
    xs_arr = ss.share_xs(total_shares)

    def recover():
        return ss.recover_update(agg, xs_arr, d, k, cfg.precision)

    recover_s = _timeit(recover, warm=1, iters=reps)
    row = {"worker_crypto_s": worker_s, "miner_intake": intake,
           "miner_crypto_s": miner_s, "miner_fold_s": fold_s,
           "miner_crypto_oneshot_s": oneshot_s, "recovery_s": recover_s,
           "share_pipeline_roundtrip_ok": bool(np.allclose(
               recover(), 3 * q / 10.0 ** cfg.precision, atol=1e-9))}

    # the same settle with the device crypto plane armed on this device;
    # the checked settle is the warm call, and the `msm` after it reuses
    # the settle's compiled lane bucket
    if c_chunks * k <= DEVICE_SETTLE_MAX_D:
        kernels.set_enabled(True, device=dev)
        try:
            acc_dev = fold_intake()
            if not acc_dev.verify(xs_all[sl]):
                raise RuntimeError("device settle failed")
            row["miner_crypto_device_s"] = _timeit(
                lambda: acc_dev.verify(xs_all[sl]), warm=0, iters=1)
            n_pts = c_chunks * k
            # RLC-shaped odd ~128-bit scalars (the ladder's cost is
            # scalar-width independent)
            gammas = [((i + 3) * 0x9E3779B97F4A7C15F39CC0605CEDC835) | 1
                      for i in range(n_pts)]
            msm_t = _timeit(lambda: kernels.msm(gammas, acc_dev._acc_dev,
                                                device=dev),
                            warm=0, iters=1)
            row["msm_points_per_s"] = n_pts / msm_t
        finally:
            kernels.set_enabled(False)
    row["round_total_s"] = device_s + worker_s + oneshot_s + recover_s
    # one peer per host, depth-1 overlap: the device round, the worker's
    # crypto and the miner's folds run at once; settle and recovery follow
    row["round_total_pipelined_s"] = (max(device_s, worker_s, fold_s)
                                      + miner_s + recover_s)
    return row


def bench_config(cfg: BiscottiConfig, rounds: int,
                 device: Optional[Union[str, torch.device]] = None) -> dict:
    """One config's row: the device round (2 warm rounds, then `rounds`
    timed), then the host crypto half on the final weights."""
    sim = Simulator(cfg, device=device)
    w, stake = sim.init_state()
    for it in range(WARM_ROUNDS):
        w, stake, mask, err = sim.round_step(w, stake, it)
    synchronize(sim.device)
    t0 = time.perf_counter()
    for it in range(WARM_ROUNDS, WARM_ROUNDS + rounds):
        w, stake, mask, err = sim.round_step(w, stake, it)
    synchronize(sim.device)
    device_s = (time.perf_counter() - t0) / rounds
    row = {"dataset": cfg.dataset, "model": sim.model.name,
           "nodes": cfg.num_nodes, "params": sim.num_params,
           "defense": cfg.defense.value, "secure_agg": cfg.secure_agg,
           "noising": cfg.noising, "poison": cfg.poison_fraction,
           "timed_rounds": rounds, "device_round_s": device_s,
           "accepted_per_round": int(mask.sum()), "final_error": float(err)}
    w64 = w.double().cpu().numpy()
    row.update(crypto_times(cfg, w64, device_s, sim.device))
    row.update(byte_columns(cfg, w64, row["accepted_per_round"]))
    return row


def card_line() -> str:
    """The card's `name, power.limit` as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


DENSITY_SIZES = (100, 400, 1000)


def density_row(summary: Optional[dict], rc: int = 0,
                stderr: str = "") -> dict:
    """One size's row from the hive launcher's summary (the reference's
    columns, bench.py:502-510), or its error row when the process died
    before printing one."""
    if summary is None:
        return {"error": f"no summary (rc={rc})", "stderr_tail": stderr[-800:]}
    return {
        "peers": summary["peers"],
        "blocks": summary["blocks"],
        "chains_equal": summary["chains_equal_local"],
        "s_per_iter": summary["s_per_iter"],
        "rss_peak_mb": round(summary["rss_peak_bytes"] / 2**20, 1),
        "rss_per_peer_mb": round(summary["rss_per_peer_bytes"] / 2**20, 2),
        "loop_lag_s": summary["loop_lag_s"],
        "sgd_batches": summary.get("sgd_batches"),
        # the port's own columns: where the peak came from (ROADMAP C5) and
        # the hive monitor's largest RSS sample a peer
        "rss_peak_source": summary.get("rss_peak_source"),
        "rss_sampled_max_per_peer_mb": round(
            summary.get("rss_sampled_max_bytes", 0) / 2**20
            / max(1, summary["peers"]), 2),
    }


def bench_peer_density(sizes=DENSITY_SIZES, iterations: int = 2,
                       budget_s: float = 900.0, platform: str = "cuda") -> dict:
    """The reference's scale-frontier entry (bench.py:452-517): live
    hive-hosted clusters at N in `sizes`, each one process of the port's
    hive CLI (`python -m biscotti_tpu_torch.runtime.hive`, mnist, plain
    mode, Krum verification, seed 3) on `platform`, so its RSS peak is its
    own. Reports s/iter, peak RSS per co-hosted peer, loop lag and the
    chain-equality verdict a size; a failed or timed-out size, or one the
    budget no longer covers, gives an error row, never a sunk bench."""
    from biscotti_tpu_torch.tools.pod_launch import REPO, hive_summary

    out = {}
    deadline = time.time() + budget_s
    for n in sizes:
        name = f"n{n}"
        budget = deadline - time.time()
        if budget < 30.0:
            out[name] = {"error": "density budget exhausted"}
            continue
        cmd = [sys.executable, "-m", "biscotti_tpu_torch.runtime.hive",
               "-t", str(n), "-d", "mnist", "--iterations", str(iterations),
               "-sa", "0", "-np", "0", "-vp", "1", "--seed", "3",
               "--platform", platform]
        try:
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=budget)
            out[name] = density_row(hive_summary(proc.stdout),
                                    proc.returncode, proc.stderr)
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def run(names: Optional[List[str]] = None, rounds: int = 0,
        device: Optional[Union[str, torch.device]] = None) -> dict:
    """The bench over `names` (every config when not given); `rounds`
    overrides the timed-round count."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not _native.available():
        raise RuntimeError("the native EC plane did not load: "
                           f"{_native.load_error()}")
    rows: Dict[str, dict] = {}
    for name in names or [n for n, _ in CONFIGS]:
        cfg = config(name)
        rows[name] = bench_config(cfg, rounds or timed_rounds(cfg), dev)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "nvidia_smi": card_line() if dev.type == "cuda" else None,
           "native_ec_plane": _native.available(),
           "warm_rounds": WARM_ROUNDS, "rows": rows}
    if HEADLINE in rows:
        out["headline"] = {
            "metric": HEADLINE_METRIC, "unit": "s/iter",
            "value": rows[HEADLINE]["round_total_pipelined_s"],
            "serial_s_per_iter": rows[HEADLINE]["round_total_s"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's crypto-inclusive bench")
    ap.add_argument("--configs", default="",
                    help="comma-separated config names (all eight when empty): "
                         + ", ".join(n for n, _ in CONFIGS))
    ap.add_argument("--rounds", type=int, default=0,
                    help="timed rounds a config (10, or 4 for model rows)")
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    ap.add_argument("--density", default="",
                    help="comma-separated hive sizes for the peer-density "
                         "entry (e.g. 100,400,1000; none when empty); its "
                         "rows land under peer_density")
    ns = ap.parse_args(argv)
    names = [n for n in ns.configs.split(",") if n]
    unknown = set(names) - set(dict(CONFIGS))
    if unknown:
        ap.error(f"unknown configs: {sorted(unknown)}")
    out = run(names, ns.rounds, ns.device)
    sizes = [int(x) for x in ns.density.split(",") if x]
    if sizes:
        out["peer_density"] = bench_peer_density(
            sizes, platform=str(resolve_device(ns.device).type))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
