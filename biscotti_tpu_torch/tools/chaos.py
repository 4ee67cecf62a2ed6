# The port's own copy of biscotti_tpu/tools/chaos.py; it imports nothing of biscotti_tpu.
# It drops the reference's jax switches and adds `--device`, the peers' torch device.
"""Chaos harness CLI: run a live loopback cluster under a seeded FaultPlan
and report whether the protocol held.

The reproducible replacement for the reference's shell chaos
(failAndRestartLocal.sh / blockNode.sh): every injected fault is a pure
function of --fault-seed, so a failing run's exact fault schedule can be
replayed by re-running with the same flags (docs/FAULT_PLANE.md).

    python -m biscotti_tpu_torch.tools.chaos --nodes 4 --rounds 3 \
        --fault-seed 11 --fault-drop 0.10 --fault-delay 0.25 --fault-delay-s 0.05

Flood scenario (docs/ADMISSION.md): one seeded flooding peer replays every
outbound frame N extra times while every peer enforces the admission plan —
the report then carries the cluster's shed tallies and inflight/parked
peaks, so the flood acceptance run is replayable from the CLI:

    python -m biscotti_tpu_torch.tools.chaos --nodes 4 --rounds 3 \
        --flood 50 --flood-node 1 --admission 1

Straggler scenario (docs/STRAGGLERS.md): a seeded fraction of the fleet
runs heterogeneous speed profiles (compute pads + per-RPC service delay)
while every peer's deadlines adapt; slow composes with flood and churn in
one seeded replayable run:

    python -m biscotti_tpu_torch.tools.chaos --nodes 4 --rounds 4 \
        --fault-seed 1 --slow 0.25 --slow-preset tee --adaptive-deadlines 1

Migration scenario (docs/PLACEMENT.md): seeded-drawn peers are live-
migrated mid-run — serialized to a placement ticket, hard-killed, and
relaunched from the ticket with chain, stake, breaker ledger, and
admission buckets intact — composing with churn/flood/slow/upgrade in
one replayable run:

    python -m biscotti_tpu_torch.tools.chaos --nodes 4 --rounds 6 \
        --migrate 2 --migrate-period 2 --churn 0.2

Exit code 0 iff all peers finished with an equal settled chain prefix and
at least one real (non-empty) block survived. The JSON report carries the
per-peer fault tallies, retry/breaker counters, health snapshots, and
(when admission/flood is armed) the shed accounting — the same readouts
the pytest chaos suite asserts on (`pytest -m chaos` runs the checked-in
matrix; `pytest -m flood` the flood scenarios).
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import Dict, Tuple


def chain_oracle(results) -> Tuple[bool, int, int]:
    """The settled-prefix chain-equality oracle, shared by this CLI and
    the pytest chaos suite (tests/test_faults.py) so there is ONE
    definition of "the protocol held". Each peer's last block may still
    be in flight when it exits, so equality is judged over the common
    settled prefix. Returns (prefix_equal, settled_height, real_blocks)
    where real_blocks counts settled non-empty blocks — a run whose every
    surviving block is empty carries no training signal and must fail."""
    dumps = [r["chain_dump"].splitlines() for r in results]
    common = min(len(d) for d in dumps) - 1
    prefix_equal = all(d[:common] == dumps[0][:common] for d in dumps)
    real_blocks = sum("ndeltas=0" not in ln for ln in dumps[0][1:common])
    return prefix_equal, common, real_blocks


def tally_faults(results) -> Dict[str, int]:
    """Sum the per-peer injected-fault tallies across a cluster run —
    read from each result's TELEMETRY snapshot (the one public readout
    the Metrics RPC also serves); the legacy flat `faults` key is the
    fallback for pre-telemetry result dicts."""
    fired: Dict[str, int] = {}
    for r in results:
        faults = r.get("telemetry", {}).get("faults") or r.get("faults", {})
        for k, v in faults.items():
            fired[k] = fired.get(k, 0) + v
    return fired


from biscotti_tpu_torch.config import Defense as _Defense
from biscotti_tpu_torch.runtime import adversary as _adversary
from biscotti_tpu_torch.tools import obs as obs_mod
from biscotti_tpu_torch.tools import verdicts as _verdicts


def cluster_table(results) -> Dict:
    """Merged cluster view over the per-peer telemetry snapshots — one
    definition shared with `python -m biscotti_tpu_torch.tools.obs` (which
    scrapes the same snapshots live over the Metrics RPC)."""
    from biscotti_tpu_torch.tools import obs

    return obs.merge_snapshots([r["telemetry"] for r in results
                                if "telemetry" in r])


def _device_crypto_report(ns, results) -> Dict:
    """Which crypto path the cluster actually ran: `path` is "device"
    only when the plane was armed, available, and at least one kernel
    actually executed; armed-but-degraded runs say so explicitly."""
    snaps = [r.get("telemetry", {}).get("device_crypto") for r in results]
    snaps = [s for s in snaps if s]
    if not ns.device_crypto or not snaps:
        return {"enabled": bool(ns.device_crypto), "path": "cpu"}
    active = any(s.get("active") for s in snaps)
    seconds: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for s in snaps:
        # kernel tallies are process-wide accumulators; peers co-hosted
        # in one process report the same totals — take the max, not sum
        for k, v in (s.get("seconds") or {}).items():
            seconds[k] = max(seconds.get(k, 0.0), float(v))
        for k, v in (s.get("calls") or {}).items():
            calls[k] = max(calls.get(k, 0), int(v))
    ran = any(v > 0 for v in calls.values())
    return {
        "enabled": True,
        "available": active,
        "path": "device" if (active and ran) else "cpu (degraded)",
        "kernel_seconds": {k: round(v, 4) for k, v in seconds.items()},
        "kernel_calls": calls,
    }


def main(argv=None) -> int:
    from biscotti_tpu_torch.config import BiscottiConfig, Timeouts

    ap = argparse.ArgumentParser(description="seeded chaos cluster run")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--base-port", type=int, default=13900)
    ap.add_argument("--dataset", default="creditcard")
    ap.add_argument("--device", default=None,
                    help="torch device of every peer (default: the "
                         "GPU, which must exist; 'cpu' to run on the "
                         "CPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="protocol seed for every peer (keys, sampling, "
                         "committee draws) — one seed replays a whole "
                         "attack-matrix cell (eval/eval_attack_matrix)")
    ap.add_argument("--verifiers", type=int, default=1,
                    help="verifier committee size (attack-matrix cells "
                         "use 3: majority approval keeps one colluding "
                         "verifier from rubber-stamping its fellow "
                         "poisoners)")
    ap.add_argument("--secure-agg", type=int, default=0)
    ap.add_argument("--verification", type=int, default=0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-drop", type=float, default=0.0)
    ap.add_argument("--fault-delay", type=float, default=0.0)
    ap.add_argument("--fault-delay-s", type=float, default=0.05)
    ap.add_argument("--fault-dup", type=float, default=0.0)
    ap.add_argument("--fault-reset", type=float, default=0.0)
    ap.add_argument("--rpc-retries", type=int, default=2)
    ap.add_argument("--breaker-threshold", type=int, default=3)
    ap.add_argument("--breaker-cooldown-s", type=float, default=2.0)
    ap.add_argument("--codec", default="raw64",
                    help="wire codec for the whole cluster (e.g. "
                         "f32+zlib) so chaos schedules also exercise "
                         "compressed/chunked frames")
    ap.add_argument("--flood", type=int, default=0,
                    help="arm ONE peer (--flood-node) as a seeded "
                         "flooder: every frame it sends is replayed this "
                         "many extra times (e.g. 50 = 51x the honest "
                         "frame rate)")
    ap.add_argument("--flood-node", type=str, default="1",
                    help="an id: that peer floods blind (every frame, "
                         "every destination — the legacy static storm). "
                         "The sentinel `miner` aims the flood instead: "
                         "the flooding peer (--flood-from) replays only "
                         "frames bound for the PER-ROUND elected miner, "
                         "resolved via the campaign plane's observation "
                         "hook (docs/ADVERSARY.md) — miners are stake-"
                         "elected per round, and the flood now follows "
                         "the election")
    ap.add_argument("--flood-from", type=int, default=1,
                    help="which peer floods when --flood-node is a role "
                         "sentinel (default 1; node 0 is the oracle "
                         "anchor and refused)")
    ap.add_argument("--campaign", type=str, default="",
                    choices=[""] + list(_adversary.CAMPAIGNS),
                    help="arm an adaptive-adversary campaign "
                         "(docs/ADVERSARY.md) on the drawn attacker "
                         "peers: roleflood = flood the per-round "
                         "elected miner/noisers, sybil = churn-riding "
                         "identity recycling (runs under the "
                         "ChurnRunner so fresh incarnations relaunch), "
                         "hug = threshold-hugging adaptive poisoner")
    ap.add_argument("--campaign-attackers", type=float, default=0.0,
                    help="membership fraction drawn as attackers (top "
                         "ids — the poisoned-id formula, so matching "
                         "--poison makes the colluding and poisoned "
                         "sets identical)")
    ap.add_argument("--campaign-node", type=int, default=-1,
                    help="pin this id into the attacker set (-1: none)")
    ap.add_argument("--campaign-flood", type=int, default=20,
                    help="targeted replay factor for the roleflood "
                         "campaign")
    ap.add_argument("--campaign-recycle-period", type=int, default=4,
                    help="sybil: rounds between identity recycles "
                         "(--rounds must exceed it for any recycle to "
                         "land)")
    ap.add_argument("--campaign-recycle-down", type=int, default=1,
                    help="sybil: rounds a recycled attacker stays down")
    ap.add_argument("--campaign-seed", type=int, default=-1,
                    help="campaign decision seed (-1: the cluster seed)")
    ap.add_argument("--poison", type=float, default=0.0,
                    help="poison_fraction: top ids train on label-"
                         "flipped shards (the reference attack); "
                         "composes with --campaign for the "
                         "flood-while-poisoning scenarios")
    ap.add_argument("--defense", type=str, default="NONE",
                    choices=[d.value for d in _Defense],
                    help="poisoning defense for the cluster; any "
                         "non-NONE choice arms verification")
    ap.add_argument("--admission", type=int, default=-1,
                    help="1 arms the overload-governance plane on every "
                         "peer; 0 disables; default: armed iff --flood")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="membership fraction killed+restarted per churn "
                         "window (0.2 = 20%% per 10 rounds); "
                         "window-0 victims become late joiners. The "
                         "oracle switches to the SURVIVING-prefix "
                         "comparison (docs/MEMBERSHIP.md)")
    ap.add_argument("--churn-seed", type=int, default=-1,
                    help="seed for the churn schedule (default: "
                         "--fault-seed) — same seed replays the "
                         "identical join/leave timeline")
    ap.add_argument("--churn-period", type=int, default=10,
                    help="rounds per churn window")
    ap.add_argument("--churn-down", type=int, default=3,
                    help="rounds a churned peer stays down")
    ap.add_argument("--snapshot-bootstrap", type=int, default=0,
                    help="1: churned/late peers catch up from a chain "
                         "snapshot (GetSnapshot) instead of replaying "
                         "genesis")
    ap.add_argument("--slow", type=float, default=0.0,
                    help="fraction of peers assigned a seeded slow speed "
                         "profile (the straggler fault kind, "
                         "docs/STRAGGLERS.md); composes with --flood and "
                         "--churn in one replayable run")
    ap.add_argument("--slow-node", type=int, default=-1,
                    help="pin this node slow regardless of the fraction "
                         "draw (-1: none)")
    ap.add_argument("--slow-factor", type=float, default=4.0,
                    help="compute-slowdown multiple for drawn slow peers "
                         "(ignored when --slow-preset is set)")
    ap.add_argument("--slow-service-s", type=float, default=0.0,
                    help="extra per-RPC service delay for slow peers")
    ap.add_argument("--slow-preset", default="",
                    choices=["", "tee", "bimodal", "longtail"],
                    help="named speed-profile preset: tee = the "
                         "arXiv:2501.11771-calibrated confidential-"
                         "compute overhead, bimodal = 2x/8x split, "
                         "longtail = heavy-tail severities")
    ap.add_argument("--adaptive-deadlines", type=int, default=0,
                    help="1 arms the straggler-tolerance plane on every "
                         "peer: adaptive per-phase round deadlines + "
                         "partial-quorum graceful degradation")
    ap.add_argument("--overlay", type=int, default=0,
                    help="1 arms the hierarchical aggregation overlay on "
                         "every peer — including the flooding peer, so "
                         "overlay+flood+churn+slow compose in one seeded "
                         "replayable run (docs/OVERLAY.md)")
    ap.add_argument("--overlay-group", type=int, default=0,
                    help="peers per overlay subtree (default: nodes//2, "
                         "so a chaos cluster always has >= 2 subtrees)")
    ap.add_argument("--device-crypto", type=int, default=0,
                    help="1 arms the accelerator-resident crypto plane "
                         "on every peer, so the seeded chaos/poison "
                         "matrix replays with batched miner crypto on "
                         "device; the report records which crypto path "
                         "actually ran (docs/CRYPTO_KERNELS.md)")
    ap.add_argument("--protocol-version", type=int, default=-1,
                    help="pin EVERY peer's advertised feature set to "
                         "this historical protocol row (old-build "
                         "emulation, runtime/protocol.py; -1 = current "
                         "— docs/PROTOCOL.md)")
    ap.add_argument("--migrate", type=int, default=0,
                    help="live-migrate this many seeded-drawn non-anchor "
                         "peers mid-run (runtime/placement.py ticket "
                         "path: chain + stake + breaker ledger + "
                         "admission buckets survive the move — unlike "
                         "--churn restarts); the surviving-prefix "
                         "oracle judges the whole timeline "
                         "(docs/PLACEMENT.md)")
    ap.add_argument("--migrate-period", type=int, default=2,
                    help="anchor rounds between migrations")
    ap.add_argument("--migrate-seed", type=int, default=-1,
                    help="seed for the victim draw (default: "
                         "--fault-seed) — same seed replays the "
                         "identical move schedule")
    ap.add_argument("--rolling-upgrade", type=int, default=-1,
                    help="start every non-anchor peer pinned to this "
                         "protocol version row, then restart them "
                         "wave-by-wave onto the current build mid-run "
                         "(the mixed-version rolling-upgrade drill, "
                         "docs/PROTOCOL.md); the settled-prefix oracle "
                         "must hold across the whole timeline")
    ap.add_argument("--upgrade-period", type=int, default=3,
                    help="rounds between rolling-upgrade waves")
    ap.add_argument("--upgrade-wave", type=int, default=2,
                    help="peers restarted per rolling-upgrade wave")
    ns = ap.parse_args(argv)
    # --flood-node: a static id, or the `miner` sentinel (per-round
    # elected-miner targeting via the campaign plane's observation hook)
    flood_at_miner = ns.flood_node == "miner"
    if flood_at_miner:
        flood_node = -1  # no blanket flood plan; the campaign targets
        if not (0 < ns.flood_from < ns.nodes):
            ap.error(f"--flood-from {ns.flood_from} outside "
                     f"1..{ns.nodes - 1} (node 0 is the oracle anchor)")
        if ns.campaign and ns.campaign != "roleflood":
            ap.error("--flood-node miner IS the roleflood campaign — "
                     "it cannot combine with a different --campaign")
    else:
        try:
            flood_node = int(ns.flood_node)
        except ValueError:
            ap.error(f"--flood-node must be an id or `miner`, got "
                     f"{ns.flood_node!r}")
        if ns.flood and not (0 <= flood_node < ns.nodes):
            ap.error(f"--flood-node {flood_node} outside "
                     f"0..{ns.nodes - 1}")
    if ns.slow_node >= ns.nodes:
        # a typo'd id would silently run a homogeneous cluster labeled
        # as a straggler scenario (slow_profile returns NO_SLOW outside
        # the id space) — refuse loudly like --flood-node
        ap.error(f"--slow-node {ns.slow_node} outside 0..{ns.nodes - 1}")
    if ns.campaign and not (ns.campaign_node == -1
                            or 0 < ns.campaign_node < ns.nodes):
        # same failure mode as --slow-node: attacker_ids silently drops
        # out-of-range pins, so a typo'd id would run an honest cluster
        # labeled as an attack scenario (node 0 is the oracle anchor)
        ap.error(f"--campaign-node {ns.campaign_node} outside "
                 f"1..{ns.nodes - 1}")
    if flood_at_miner and ns.campaign_node != -1:
        # the sentinel pins the flooder via --flood-from; silently
        # overriding an explicit --campaign-node would arm a DIFFERENT
        # attacker than the one the user named
        ap.error("--flood-node miner pins its flooder via --flood-from;"
                 " it cannot combine with --campaign-node")
    if ns.campaign and not _adversary.CampaignPlan(
            campaign=ns.campaign, attackers=ns.campaign_attackers,
            attacker_node=ns.campaign_node).attacker_ids(ns.nodes):
        # an armed campaign whose draw is EMPTY would run an honest (or
        # merely static) cluster labeled as the attack scenario — the
        # exact mislabeling the campaign plane forbids (a
        # static-poisoner rerun labeled adaptive is not acceptable)
        ap.error(f"--campaign {ns.campaign} drew no attackers: raise "
                 f"--campaign-attackers (fraction of {ns.nodes} top "
                 "ids) or pin --campaign-node")

    # campaign plane (docs/ADVERSARY.md): an explicit --campaign, or the
    # --flood-node miner sentinel (role-aware targeted flood pinned on
    # --flood-from). One plan on EVERY peer's config — the plane arms
    # itself only on the drawn attacker ids, so honest peers stay on the
    # seed path by construction.
    if flood_at_miner:
        camp_plan = _adversary.CampaignPlan(
            campaign="roleflood", seed=ns.campaign_seed,
            attackers=ns.campaign_attackers,
            attacker_node=ns.flood_from,
            flood=ns.flood or ns.campaign_flood)
    else:
        camp_plan = _adversary.CampaignPlan(
            campaign=ns.campaign, seed=ns.campaign_seed,
            attackers=ns.campaign_attackers,
            attacker_node=ns.campaign_node,
            flood=ns.campaign_flood,
            recycle_period=ns.campaign_recycle_period,
            recycle_down=ns.campaign_recycle_down)
    if camp_plan.campaign == "sybil" and not camp_plan.recycle_schedule(
            ns.nodes, ns.rounds, protocol_seed=ns.seed):
        # an armed sybil campaign with no recycle inside the run is the
        # same mislabeling as an empty attacker draw: a static cluster
        # reported as an identity-recycling attack
        ap.error(f"--campaign sybil schedules no recycles in --rounds "
                 f"{ns.rounds}: raise --rounds above "
                 f"--campaign-recycle-period ({ns.campaign_recycle_period})"
                 " or shrink the period")

    # rolling-upgrade drill (docs/PROTOCOL.md): the pre-upgrade fleet
    # (every non-anchor peer) speaks the pinned historical row; waves of
    # --upgrade-wave peers are hard-restarted onto the current build
    # every --upgrade-period anchor rounds — the same ChurnRunner the
    # churn plane uses, so upgrade restarts compose with churn/flood/slow
    # in one seeded replayable run
    from biscotti_tpu_torch.runtime import protocol as _protocol
    upgrade_events: list = []
    upgrade_round: Dict[int, int] = {}
    upgrade_waves: list = []
    if ns.rolling_upgrade >= 0 and ns.protocol_version >= 0:
        ap.error("--rolling-upgrade already pins the pre-upgrade fleet; "
                 "it cannot combine with --protocol-version")
    if ns.protocol_version > _protocol.CURRENT_VERSION:
        ap.error(f"--protocol-version {ns.protocol_version} outside "
                 f"0..{_protocol.CURRENT_VERSION}")
    if ns.rolling_upgrade >= 0:
        if not 0 <= ns.rolling_upgrade < _protocol.CURRENT_VERSION:
            # upgrading FROM the current version is a no-op drill — the
            # same mislabeling the empty-campaign guard refuses
            ap.error(f"--rolling-upgrade {ns.rolling_upgrade} must be a "
                     f"historical row in "
                     f"0..{_protocol.CURRENT_VERSION - 1}")
        wave = max(1, ns.upgrade_wave)
        targets = [i for i in range(ns.nodes) if i != 0]
        for w in range(0, len(targets), wave):
            at = ns.upgrade_period * (w // wave + 1)
            upgrade_waves.append([at, targets[w:w + wave]])
            for node in targets[w:w + wave]:
                upgrade_round[node] = at
        last = upgrade_waves[-1][0]
        if last >= ns.rounds:
            ap.error(f"rolling upgrade's last wave lands at round {last} "
                     f"but the run stops at --rounds {ns.rounds}: raise "
                     f"--rounds or widen --upgrade-wave")

    # seeded live-migration schedule (docs/PLACEMENT.md §replay): pure
    # in --migrate-seed — one victim per --migrate-period anchor rounds,
    # drawn from the non-anchor ids, so a failing move replays from the
    # flags exactly like a fault plan
    import random as _random

    mseed = ns.fault_seed if ns.migrate_seed < 0 else ns.migrate_seed
    migrate_planned: list = []
    if ns.migrate > 0:
        if ns.nodes < 2:
            ap.error("--migrate needs >= 2 nodes (node 0 is the anchor)")
        mperiod = max(1, ns.migrate_period)
        last_at = mperiod * ns.migrate
        if last_at >= ns.rounds:
            ap.error(f"the last migration lands at round {last_at} but "
                     f"the run stops at --rounds {ns.rounds}: raise "
                     f"--rounds or shrink --migrate-period")
        rng = _random.Random((mseed * 9973 + 17) & 0x7FFFFFFF)
        for j in range(ns.migrate):
            migrate_planned.append([mperiod * (j + 1),
                                    rng.randrange(1, ns.nodes)])

    from biscotti_tpu_torch.runtime import faults as _faults
    from biscotti_tpu_torch.runtime.admission import AdmissionPlan
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.runtime.peer import PeerAgent

    for node, at in sorted(upgrade_round.items()):
        upgrade_events.append(_faults.ChurnEvent(round=at, node=node,
                                                 kind=_faults.RESTART))
    migrate_events = [_faults.ChurnEvent(round=at, node=node,
                                         kind=_faults.MIGRATE)
                      for at, node in migrate_planned]

    churn_seed = ns.fault_seed if ns.churn_seed < 0 else ns.churn_seed
    # one plan: the frame-fault schedule keys off --fault-seed, the
    # membership timeline off --churn-seed (FaultPlan.churn_seed), and
    # the slow-profile table off --fault-seed too — so slow + flood +
    # churn compose in ONE seeded replayable run
    slow_kw = dict(slow=ns.slow, slow_factor=ns.slow_factor,
                   slow_service_s=ns.slow_service_s,
                   slow_preset=ns.slow_preset, slow_node=ns.slow_node)
    plan = FaultPlan(seed=ns.fault_seed, drop=ns.fault_drop,
                     delay=ns.fault_delay, delay_s=ns.fault_delay_s,
                     duplicate=ns.fault_dup, reset=ns.fault_reset,
                     churn=ns.churn, churn_period=ns.churn_period,
                     churn_down=ns.churn_down, churn_seed=ns.churn_seed,
                     **slow_kw)
    # the flooder rides the SAME seeded plan plus the replay factor, so
    # a mixed run (drop + flood + churn + slow) stays replayable from one
    # seed — dropping the churn/slow fields here would silently strip a
    # flooding victim's self-kill schedule or speed profile
    flood_plan = FaultPlan(seed=ns.fault_seed, drop=ns.fault_drop,
                           delay=ns.fault_delay, delay_s=ns.fault_delay_s,
                           duplicate=ns.fault_dup, reset=ns.fault_reset,
                           flood=ns.flood,
                           churn=ns.churn, churn_period=ns.churn_period,
                           churn_down=ns.churn_down,
                           churn_seed=ns.churn_seed, **slow_kw)
    # default: the admission plane arms whenever ANY flood runs — the
    # static storm (--flood) or a roleflood campaign (incl. the
    # --flood-node miner sentinel, which floods at --campaign-flood
    # without --flood being set); an unshedded flood scenario must be
    # an explicit --admission 0 choice, never a silent default
    flooding_somehow = bool(ns.flood) or (
        camp_plan.enabled and camp_plan.campaign == "roleflood"
        and camp_plan.flood > 0)
    admit = flooding_somehow if ns.admission < 0 else bool(ns.admission)
    # harness-scaled budgets: a 4-node fast-timeout loopback cluster's
    # honest rate is well under 1 frame/s/peer/class, so these rates are
    # still ~10x headroom for honest traffic — while a 50x flood burst
    # overruns the bucket and sheds. (The production defaults are sized
    # for N=100 gossip fan-in and would let a 50x replay of THIS tiny
    # cluster's traffic ride the burst unshed.)
    admission = AdmissionPlan(enabled=admit, update_rate=8.0,
                              bulk_rate=6.0, control_rate=16.0)
    fast = Timeouts(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0,
                    rpc_s=4.0)
    if ns.device_crypto:
        # the harness-fast deadlines above exist to keep chaos snappy,
        # not to time out honest crypto: off real accelerator hardware
        # the limb kernels run under XLA *CPU* emulation at whole
        # seconds per settle, which would turn every round empty. Widen
        # to the byzantine-suite constants so the device path races
        # steady-state kernels, not the harness clock.
        fast = Timeouts(update_s=25.0, block_s=75.0, krum_s=15.0,
                        share_s=25.0, rpc_s=20.0)

    overlay_group = 0
    if ns.overlay:
        overlay_group = ns.overlay_group or max(2, ns.nodes // 2)

    defense = _Defense(ns.defense)
    verification = bool(ns.verification) or defense != _Defense.NONE

    def cfg(i):
        flooding = ns.flood > 0 and not flood_at_miner and i == flood_node
        # protocol pin for THIS incarnation: under --rolling-upgrade a
        # non-anchor peer speaks the old row until its upgrade wave has
        # fired (restarts are applied at anchor height >= the wave round,
        # so any relaunch from that point on comes up on the new build —
        # exactly how a supervisor rolling a new binary behaves)
        pin = ns.protocol_version
        if ns.rolling_upgrade >= 0 and i != 0:
            height = made[0].iteration if 0 in made else 0
            pin = (ns.rolling_upgrade
                   if height < upgrade_round.get(i, 0) else -1)
        return BiscottiConfig(
            node_id=i, num_nodes=ns.nodes, dataset=ns.dataset,
            base_port=ns.base_port, num_verifiers=ns.verifiers,
            num_miners=1,
            num_noisers=1, secure_agg=bool(ns.secure_agg), noising=False,
            verification=verification, defense=defense,
            poison_fraction=ns.poison,
            max_iterations=ns.rounds, convergence_error=0.0,
            sample_percent=1.0, batch_size=8, timeouts=fast,
            seed=ns.seed,
            rpc_retries=ns.rpc_retries,
            breaker_threshold=ns.breaker_threshold,
            breaker_cooldown_s=ns.breaker_cooldown_s,
            fault_plan=flood_plan if flooding else plan,
            admission_plan=admission,
            campaign_plan=camp_plan,
            snapshot_bootstrap=bool(ns.snapshot_bootstrap),
            adaptive_deadlines=bool(ns.adaptive_deadlines),
            # carried on EVERY peer's config — the `plan` peers and the
            # flood_plan flooder alike — so an overlay chaos run stays
            # one-seed replayable across all composed planes
            overlay=bool(ns.overlay), overlay_group=overlay_group,
            device_crypto=bool(ns.device_crypto),
            protocol_version=pin,
            wire_codec=ns.codec)

    # the sybil campaign's identity recycling rides the same runner the
    # churn plane uses — kills self-fire in the victims' round loops,
    # the runner relaunches fresh incarnations
    recycle_events = camp_plan.recycle_schedule(ns.nodes, ns.rounds,
                                                protocol_seed=ns.seed)
    made = {}

    def make_agent(i):
        a = PeerAgent(cfg(i), device=ns.device)
        made[i] = a  # latest incarnation; node 0 is never churned
        return a

    if ns.churn > 0 or recycle_events or upgrade_events or migrate_events:
        from biscotti_tpu_torch.runtime.membership import (ChurnRunner,
                                                     surviving_prefix_oracle)

        schedule = sorted(
            plan.churn_schedule(ns.nodes, ns.rounds) + recycle_events
            + upgrade_events + migrate_events,
            key=lambda e: (e.round, e.node, e.kind))

        def migrate_agent(i, ticket):
            # the migrated incarnation rehydrates from the ticket the
            # runner captured before the kill (runtime/placement.py)
            a = PeerAgent(cfg(i), ticket=ticket, device=ns.device)
            made[i] = a
            return a

        async def go():
            runner = ChurnRunner(make_agent, ns.nodes, schedule,
                                 migrate_factory=migrate_agent)
            res = await runner.run()
            return res, runner.events_applied, runner.migrations

        results, applied, moves_applied = asyncio.run(go())
        prefix_equal, common, real_blocks = surviving_prefix_oracle(results)
    else:
        async def go():
            agents = [make_agent(i) for i in range(ns.nodes)]
            return await asyncio.gather(*(a.run() for a in agents))

        results = asyncio.run(go())
        applied = None
        moves_applied = []
        prefix_equal, common, real_blocks = chain_oracle(results)
    faults_fired = tally_faults(results)
    # every robustness readout below comes off the telemetry snapshots —
    # the same schema the Metrics RPC serves a live scrape, so a chaos
    # report and `tools.obs` against a running cluster agree by
    # construction
    cluster = cluster_table(results)
    report = {
        "nodes": ns.nodes, "rounds": ns.rounds, "seed": ns.seed,
        "wire_codec": ns.codec,
        "fault_plan": {"seed": plan.seed, "drop": plan.drop,
                       "delay": plan.delay, "delay_s": plan.delay_s,
                       "duplicate": plan.duplicate, "reset": plan.reset},
        "flood": {"factor": (ns.flood or camp_plan.flood)
                            if flood_at_miner else ns.flood,
                  "node": "miner" if flood_at_miner else flood_node,
                  **({"from": ns.flood_from} if flood_at_miner else {})}
                 if (ns.flood or flood_at_miner) else None,
        "poison": ns.poison or None,
        "defense": defense.value,
        # defense outcomes off the settled anchor ledger — the ONE
        # verdict parser (tools/verdicts.py), same columns as the
        # attack-matrix artifact, so a chaos replay of a matrix cell is
        # comparable row-for-row
        "defense_verdict": (_verdicts.cluster_defense_verdict(
            results, ns.nodes, ns.poison,
            anchor_blocks=made[0].chain.blocks)
            if (ns.poison > 0 or camp_plan.enabled) else None),
        # adversary-campaign readout (docs/ADVERSARY.md): the armed plan
        # plus the cluster's merged action/target tallies and, for the
        # sybil campaign, the recycle events the runner actually applied
        # — built from the same telemetry the test suite asserts on
        "campaign": ({
            "name": camp_plan.campaign,
            "seed": camp_plan.seed,
            "attackers": sorted(camp_plan.attacker_ids(ns.nodes)),
            "flood": camp_plan.flood,
            "recycles_scheduled": [
                [e.round, e.node, e.kind] for e in recycle_events],
            **cluster["campaign"],
        } if camp_plan.enabled else None),
        # adaptive-defense readout (docs/DEFENSES.md): merged verdict
        # streams (per-verifier accept/reject walk + magnitudes + under
        # ENSEMBLE the scorer votes) and the ledger rollup — the
        # replayable counter-evidence to the campaign's schedule above.
        # None when no verifier recorded a verdict (verification off).
        "trust": (lambda t: t if t.get("verifiers") else None)(
            obs_mod.merge_trust(
                [r["telemetry"] for r in results if "telemetry" in r],
                streams=True)),
        "churn": {"fraction": ns.churn, "seed": churn_seed,
                  "period": ns.churn_period, "down": ns.churn_down,
                  "events_applied": applied}
                 if ns.churn else None,
        # rolling-upgrade timeline (docs/PROTOCOL.md): the planned waves,
        # the restarts the runner actually applied, and each surviving
        # peer's FINAL advertised protocol version off its telemetry —
        # a completed drill reads all-current with the settled-prefix
        # oracle intact across the mixed-version span
        "rolling_upgrade": ({
            "from_version": ns.rolling_upgrade,
            "to_version": _protocol.CURRENT_VERSION,
            "period": ns.upgrade_period,
            "wave": max(1, ns.upgrade_wave),
            "waves": upgrade_waves,
            "applied": [[r, n] for (r, n, k) in (applied or [])
                        if k == _faults.RESTART
                        and upgrade_round.get(n) == r],
            "final_versions": {
                str(s["node"]): s.get("protocol", {}).get("version")
                for s in (r["telemetry"] for r in results
                          if "telemetry" in r)},
        } if ns.rolling_upgrade >= 0 else None),
        "protocol_pin": (ns.protocol_version
                         if ns.protocol_version >= 0 else None),
        # live-migration timeline (docs/PLACEMENT.md): the seeded plan,
        # the moves the runner actually applied (with per-move downtime
        # and ticket bytes — the two bench/bench_diff regression keys),
        # and how many incarnations confirmed a ticket restore
        "migrations": ({
            "count": ns.migrate, "period": max(1, ns.migrate_period),
            "seed": mseed,
            "planned": migrate_planned,
            "applied": moves_applied,
            "restored": cluster["counters"].get("migration_restored", 0),
        } if ns.migrate > 0 else None),
        "slow": {"fraction": ns.slow, "node": ns.slow_node,
                 "factor": ns.slow_factor, "preset": ns.slow_preset,
                 "profiles": {
                     str(n): {"compute_factor": p.compute_factor,
                              "service_s": p.service_s}
                     for n, p in plan.slow_table(ns.nodes).items()}}
                if (ns.slow > 0 or ns.slow_node >= 0) else None,
        "adaptive_deadlines": bool(ns.adaptive_deadlines),
        "admission_enabled": admit,
        # which crypto path the run ACTUALLY took (docs/CRYPTO_KERNELS.md):
        # armed-but-unavailable degrades to cpu, and the per-kernel
        # seconds prove the device plane ran rather than just being
        # requested — read off the peers' telemetry snapshots
        "device_crypto": _device_crypto_report(ns, results),
        # aggregation-overlay readout (docs/OVERLAY.md): the armed knobs
        # plus the cluster's aggregated/direct/fallback tallies
        # (obs.merge_overlay — one definition with a live scrape)
        "overlay": {"enabled": bool(ns.overlay),
                    "group": overlay_group,
                    **cluster["overlay"]} if ns.overlay
                   else cluster["overlay"],
        # straggler readout (docs/STRAGGLERS.md): cluster excluded/stall
        # tallies + slowest-peer table (obs.merge_stragglers — one
        # definition with a live scrape) and each peer's bounded
        # deadline-decision history, so a straggler run's adaptive
        # behavior is auditable from the report alone
        "stragglers": {
            **cluster["stragglers"],
            "deadline_history": {
                str(s["node"]): (s.get("stragglers", {})
                                 .get("deadlines", {}).get("history", []))
                for s in (r["telemetry"] for r in results
                          if "telemetry" in r)
                if s.get("stragglers", {}).get("deadlines", {})
                .get("history")},
        },
        "settled_prefix_equal": prefix_equal,
        "settled_height": common,
        "real_blocks": real_blocks,
        "faults_injected": faults_fired,
        "rpc_retries": cluster["counters"].get("rpc_retry", 0),
        "breaker_opens": cluster["counters"].get("breaker_open", 0),
        # shed tallies + inflight/parked peaks (merged in obs.py — one
        # definition for this report and a live scrape)
        "sheds": cluster["admission"],
        "cluster": cluster,
        "per_node": [{"node": s["node"], "iterations": s["iter"],
                      "faults": s["faults"], "health": s["health"],
                      "admission": s.get("admission", {})}
                     for s in (r["telemetry"] for r in results)],
    }
    print(json.dumps(report, indent=2))
    return 0 if prefix_equal and real_blocks >= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
