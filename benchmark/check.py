"""The comparison that decides `correct`.

The reference (reference/) rebuilds, from the seed alone, what the timed
path's rounds should have produced, in float64, and holds the program's
rounds to it:

  * the run's first three rounds, from the weights the benchmark drew,
    which set-up drives through the window's own call before the window;
  * the window's last round, from the program's own state before it (the
    only way to reach round k without replaying k rounds: the weights it
    starts from are the program's, its draws, rows and decisions the
    reference's own).

Numbers; a cell's workload file names those it compares, each with its
limit, and a run reports those:

  first_update_gap   round 0's update w1 − w0, leaf by leaf: the gap
                     between the program's norm and the reference's, over
                     the larger of the reference's norm of that leaf and
                     of the median leaf; the worst leaf
  first_update_median_gap  the same of the median leaf
  change_gap         the same gap of w3 − w0, after three rounds, of the
                     median leaf
  window_update_gap  the same, median leaf, of the window's last round's
                     update
  mask_gap           where the program's accept mask differs from the
                     reference's in a judged first round (the cell's
                     `judged_first_masks`) or the window's last round:
                     the largest distance of such an update from its
                     threshold, as a share of the scale its statistic
                     rounds on (reference/defense.py; 1 where the counts
                     differ or the rule has no threshold); 0 where the
                     masks agree
  stake_gap          stake entries that differ from the reference's
  wrong_rows_gap     test rows counted wrong by one side and not the other

The reference follows the program's accept mask once it has judged it,
so an update on the other side of a near-tie does not carry into the
aggregate's comparison. Round 0 starts from weights of the usual scale;
its update, the sum of some 358 contributors' steps, is a hundred times
their norm, and from round 1 on the net computes on blown-up weights
where float32 and float64 part at relu and max-pool kinks. So the later
updates are held by their median leaf, and a cell's workload file names
the first rounds whose masks are judged (`judged_first_masks`); the
masks of the others are followed without being judged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.cells import Cell
from benchmark.reference import shards
from benchmark.reference.draws import round_draws
from benchmark.reference.nets import FP64, Precision, leaf_slices
from benchmark.reference.round import RoundOut, model, round_from_draws

FIRST_ROUNDS = 3


@dataclass
class Step:
    """What one of the program's rounds returned: (w', stake', mask, err)."""
    w: torch.Tensor
    stake: torch.Tensor
    mask: torch.Tensor
    err: torch.Tensor

    def to(self, device) -> "Step":
        return Step(*(t.detach().to(device) for t in
                      (self.w, self.stake, self.mask, self.err)))


@dataclass
class Observed:
    """The program's rounds that the comparison reads: rounds 0..2 from w0,
    and the window's last round `it` from its state `before`."""
    w0: torch.Tensor
    stake0: torch.Tensor
    first: List[Step]
    it: int
    before: Step
    last: Step


class Rows:
    """Contributors' rows, rebuilt by the reference's copy of the shards."""

    def __init__(self, cell: Cell, peers):
        s = cell.settings
        self.table = shards.peer_rows(s["dataset"], s["num_nodes"],
                                      s["poison_fraction"], peers)

    def gather(self, cidx: torch.Tensor, bidx: torch.Tensor, device):
        cidx, bidx = cidx.cpu().numpy(), bidx.cpu().numpy()
        x = np.stack([self.table[c][0][b] for c, b in zip(cidx, bidx)])
        y = np.stack([self.table[c][1][b] for c, b in zip(cidx, bidx)])
        return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def leaf_norms(v: torch.Tensor, slices) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(v[sl])) for _, sl in slices])


def _moving(rn: np.ndarray) -> np.ndarray:
    """Leaves the reference moves by at least a thousandth of its largest
    leaf: once the summed updates have blown the weights up, whole layers
    stop firing and their leaves stop, so the median over every leaf
    would be 0."""
    return rn >= 1e-3 * rn.max()


def norm_gap(pn: np.ndarray, rn: np.ndarray) -> float:
    """Worst leaf of |‖prog_l‖ − ‖ref_l‖| / max(‖ref_l‖, median ‖ref‖),
    the median over the moving leaves; a leaf the reference leaves still
    is held to the largest leaf's norm. 0 where neither side moved, 1
    where only the program did."""
    if not rn.any():
        return 0.0 if not pn.any() else 1.0
    mv = _moving(rn)
    med = float(np.median(rn[mv]))
    gaps = np.where(mv, np.abs(pn - rn) / np.maximum(rn, med),
                    np.abs(pn - rn) / rn.max())
    return float(gaps.max())


def median_gap(pn: np.ndarray, rn: np.ndarray) -> float:
    """The median over the moving leaves of norm_gap's per-leaf gap."""
    if not rn.any():
        return 0.0 if not pn.any() else 1.0
    mv = _moving(rn)
    med = float(np.median(rn[mv]))
    return float(np.median(np.abs(pn - rn)[mv] / np.maximum(rn[mv], med)))


def mask_gap(prog: torch.Tensor, ref: RoundOut) -> float:
    prog = prog.to(ref.mask.device)
    diff = prog != ref.mask
    if not bool(diff.any()):
        return 0.0
    if int(prog.sum()) != int(ref.mask.sum()):
        return 1.0
    return min(1.0, float(ref.margin[diff].max()))


class Judge:
    """Replays a cell's checked rounds in `prec` on `device`."""

    def __init__(self, cell: Cell, seed: int, device, prec: Precision = FP64,
                 rows: Optional[Rows] = None):
        self.cell, self.seed, self.device, self.prec = cell, seed, device, prec
        c, s = cell.config, cell.settings
        self.m = model(cell.model, c["reference_block"])
        self.slices = leaf_slices(self.m.leaves)
        self.rows = rows
        # per compared update the leaves' norms, per round the mask, stake
        # and test-row gaps (calibrate.py records them)
        self.detail = {}
        xt, yt = shards.test_split(s["dataset"], shards.class_means(s["dataset"]))
        self.x_test = torch.from_numpy(xt).to(device)
        self.y_test = torch.from_numpy(yt).to(device)
        self.test_rows = xt.shape[0]

    def draws(self, it: int):
        c, s = self.cell.config, self.cell.settings
        return round_draws(self.device, self.seed, it, s["num_nodes"],
                           self.cell.num_samples, c["train_rows_per_peer"],
                           s["batch_size"], self.m.d, s["noising"])

    def ensure_rows(self, its) -> None:
        if self.rows is None:
            peers = set()
            for it in its:
                peers.update(self.draws(it)[0].cpu().tolist())
            self.rows = Rows(self.cell, peers)

    def round(self, it: int, w, stake, follow=None) -> RoundOut:
        cidx, bidx, normals = self.draws(it)
        x, y = self.rows.gather(cidx, bidx, self.device)
        return round_from_draws(self.m, self.prec, self.cell.settings,
                                w.to(self.device, self.prec.dtype),
                                stake.to(self.device), cidx, x, y, normals,
                                self.x_test, self.y_test, follow)

    def gap(self, label: str, prog: torch.Tensor, ref: torch.Tensor,
            rule=norm_gap) -> float:
        pn, rn = leaf_norms(prog, self.slices), leaf_norms(ref, self.slices)
        self.detail[label] = {"program": pn.tolist(), "reference": rn.tolist()}
        return rule(pn, rn)

    def numbers(self, obs: Observed) -> Dict[str, float]:
        self.ensure_rows(list(range(FIRST_ROUNDS)) + [obs.it])
        w0 = obs.w0.to(self.device, torch.float64)
        w, stake = w0, obs.stake0.to(self.device)
        gaps = {"mask_gap": 0.0, "stake_gap": 0, "wrong_rows_gap": 0}

        def hold(label: str, step: Step, ref: RoundOut, judged: bool) -> None:
            masked = mask_gap(step.mask, ref)
            stake = int((step.stake.to(ref.stake.device) != ref.stake).sum())
            wrong = abs(int(round(float(step.err) * self.test_rows)) - ref.wrong)
            self.detail[f"round {label}"] = {"mask_gap": masked, "judged": judged,
                                             "stake_gap": stake, "wrong_rows": wrong}
            if judged:
                gaps["mask_gap"] = max(gaps["mask_gap"], masked)
            gaps["stake_gap"] = max(gaps["stake_gap"], stake)
            gaps["wrong_rows_gap"] = max(gaps["wrong_rows_gap"], wrong)

        for it, step in enumerate(obs.first):
            ref = self.round(it, w, stake, follow=step.mask)
            hold(str(it), step, ref, judged=it in self.cell.judged_first_masks)
            w, stake = ref.w.double(), ref.stake
            if it == 0:
                w1 = w
        prog = [s.w.to(self.device, torch.float64) for s in obs.first]
        out = {"first_update_gap": self.gap("first_update", prog[0] - w0,
                                            w1 - w0),
               "first_update_median_gap": median_gap(
                   *(np.array(self.detail["first_update"][k])
                     for k in ("program", "reference"))),
               "change_gap": self.gap("change", prog[-1] - w0, w - w0,
                                      median_gap)}
        before = obs.before.w.to(self.device, torch.float64)
        ref = self.round(obs.it, before, obs.before.stake, follow=obs.last.mask)
        hold(str(obs.it), obs.last, ref, judged=True)
        out["window_update_gap"] = self.gap(
            "window_update", obs.last.w.to(self.device, torch.float64) - before,
            ref.w.double() - before, median_gap)
        out.update(gaps)
        return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell compares at or under its limit."""
    return all(numbers[k] <= limit for k, limit in limits.items())
