# The port's own copy of biscotti_tpu/tools/verdicts.py; it imports nothing of biscotti_tpu.
"""Shared defense-verdict / outcome extraction helpers.

ONE definition of "what did the defense decide, and what did it cost the
attackers" for every entry point that reports it: the sim-based poisoning
sweep (eval/eval_poison.py), the live attack matrix
(eval/eval_attack_matrix.py), the chaos CLI, and the test suites
(tests/test_membership.py's defense-verdict parity, tests/test_adversary)
— so no second hand-rolled verdict parser can drift from the first.

  * `poisoned_ids` — the reference's poisoned-membership formula
    (DistSys/main.go:836-845: the top `poison_fraction` of node ids load
    bad shards). `parallel/sim._poisoned_ids` and
    `adversary.CampaignPlan.attacker_ids` both delegate/mirror this, so
    "the poisoned set" and "the colluding set" can never disagree on the
    formula.
  * `chain_defense_verdict` — the settled ledger read: which poisoned
    sources ever entered an accepted block record, which were rejected
    (accepted=False records — the stake-debited evidence), and where the
    poisoned population's stake ended up relative to genesis (net debits
    / earnings). Works on any block list: a live agent's chain, a
    replayed dump, a snapshot-bootstrapped suffix.
  * `agg_mean_std` / `separates` — the mean±std aggregation and the
    std-margin separation test the poisoning gate and the matrix's
    adaptive-vs-static comparison both use.

stdlib-only (block objects are duck-typed: anything with `.data.deltas`
records carrying `.source_id`/`.accepted` and a `.stake_map`).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence, Set, Tuple


def poisoned_ids(num_nodes: int, poison_fraction: float) -> Set[int]:
    """Top `poison_fraction` of node ids load bad shards
    (ref: DistSys/main.go:836-845) — THE membership formula, shared by
    the sim, the live runtime, and the campaign plane's attacker draw."""
    if poison_fraction <= 0:
        return set()
    poisoning_index = math.ceil(num_nodes * (1.0 - poison_fraction))
    return {i for i in range(num_nodes) if i > poisoning_index}


def agg_mean_std(vals: Sequence[float],
                 digits: int = 4) -> Tuple[float, float]:
    """mean±std over seeds/cells, rounded for artifact JSON."""
    m = statistics.fmean(vals)
    s = statistics.stdev(vals) if len(vals) > 1 else 0.0
    return round(m, digits), round(s, digits)


def separates(better: float, better_std: float, worse: float,
              worse_std: float, n_samples: int = 1) -> Tuple[bool, float]:
    """Does `worse - better` clear the summed-std margin? (the
    eval_poison gate's criterion, reused for matrix comparisons).
    Returns (separates, required_margin); with a single sample the
    margin is 0 — any strict improvement counts."""
    margin = (better_std + worse_std) if n_samples > 1 else 0.0
    return (worse - better) > margin, round(margin, 4)


def chain_defense_verdict(blocks: Iterable, poisoned: Set[int],
                          default_stake: int = 10) -> Dict:
    """The settled defense verdict from a chain's block records.

    accepted_poisoned — poisoned sources that EVER rode a block with
        accepted=True (the defense let the poison through);
    rejected — per-source counts of accepted=False records (the
        stake-debited rejection evidence minted by miners);
    poisoned_stake / debited / enriched — where the poisoned
        population's stake landed vs the genesis default: a debited
        poisoner paid for rejections, an enriched one EARNED stake
        while attacking (the TRIMMED_MEAN caveat in config.Defense,
        measurable here).
    """
    accepted_poisoned: Set[int] = set()
    rejected: Dict[int, int] = {}
    stake_map: Dict[int, int] = {}
    for b in blocks:
        for u in b.data.deltas:
            if u.accepted:
                if u.source_id in poisoned:
                    accepted_poisoned.add(u.source_id)
            else:
                rejected[u.source_id] = rejected.get(u.source_id, 0) + 1
        stake_map = dict(b.stake_map)
    poisoned_stake = {p: stake_map.get(p, default_stake)
                      for p in sorted(poisoned)}
    return {
        "poisoned": sorted(poisoned),
        "accepted_poisoned": sorted(accepted_poisoned),
        "n_accepted_poisoned": len(accepted_poisoned),
        "rejected": {str(s): n for s, n in sorted(rejected.items())},
        "rejected_poisoned": {str(s): n for s, n in sorted(
            rejected.items()) if s in poisoned},
        "poisoned_stake": {str(p): v for p, v in poisoned_stake.items()},
        "debited": sorted(p for p, v in poisoned_stake.items()
                          if v < default_stake),
        "enriched": sorted(p for p, v in poisoned_stake.items()
                           if v > default_stake),
    }


def cluster_defense_verdict(results: List[Dict], num_nodes: int,
                            poison_fraction: float,
                            default_stake: int = 10,
                            anchor_blocks: Iterable = None) -> Dict:
    """chain_defense_verdict over a live cluster run, plus the
    cross-peer robustness tallies the attack matrix reports beside it
    (sheds, breaker opens, campaign actions) — read off the same
    telemetry snapshots the Metrics RPC serves, through the obs
    mergers (one summation each — docs/OBSERVABILITY.md)."""
    # lazy import: obs is a tools sibling (stdlib-only too) — the ONE
    # definition of snapshot merging, shared with the live scraper and
    # the chaos cluster table
    from biscotti_tpu_torch.tools import obs

    poisoned = poisoned_ids(num_nodes, poison_fraction)
    out = (chain_defense_verdict(anchor_blocks, poisoned, default_stake)
           if anchor_blocks is not None else
           {"poisoned": sorted(poisoned)})
    snaps = [r.get("telemetry", {}) for r in results]
    out["sheds"] = obs.merge_admission(snaps)["shed_total"]
    out["breaker_opens"] = sum(
        t.get("counters", {}).get("breaker_open", 0) for t in snaps)
    out["campaign_actions"] = obs.merge_campaign(snaps)["actions"]
    return out
