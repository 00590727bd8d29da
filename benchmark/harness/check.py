"""The numbers that decide ``correct``, each against its limit.

Training (the program's first three steps against the reference's, from the
same seeded weights and the same three batches):
- ``loss_rel_k``: the relative gap of step k's loss (k = 1, 2, 3);
- ``grad_gap``: of the first gradient as the optimizer gets it (clipped; the
  program's read from Adam's first moment after one step), the worst leaf's
  gap between the two norms, over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``change_gap``: the same for each leaf's change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by round-off alone).

Streaming (every answer of the path's first pass, replayed by the reference
from zero state):
- ``tsdf_mae``: the worst fragment's mean |tsdf − tsdf_ref| over its volume
  (the answer's tsdf, 1 where it is not occupied);
- ``occ_mae``: the worst fragment's mean |occupancy − reference| (sigmoid);
- ``hidden_rel``: the worst level's mean |h − h_ref| over mean |h_ref| of the
  global hidden volumes after the pass.

The reference follows the program's decisions (which voxels and blocks each
level computes on, from the level before's occupancy), so that a voxel whose
occupancy logit rounding tips across the threshold does not turn a gap of
rounding into one of a whole voxel; ``mask_mismatch`` checks those
decisions on their own, exactly: the voxels where a level's mask (or, in a
stream, the answer's occupied set) is not what the program's own outputs of
the level before give by the configuration's rule.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from ..reference import neuralrecon as ref

CHANGE_FLOOR = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> List[float]:
    """Per leaf, the gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return [abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def train_numbers(c: dict, prog: dict, ref_side: dict, rows: int) -> Dict[str, float]:
    """``prog``/``ref_side``: ``losses`` (a float a step), ``grad_norms`` and
    ``change_norms`` (name -> norm); ``prog["decisions"]``: each step's
    per-level occupancy logits and masks; ``rows``: the batch size.  ``c``:
    the reference's resolved configuration."""
    out = {f"loss_rel_{k + 1}": abs(a - b) / max(abs(b), 1e-30)
           for k, (a, b) in enumerate(zip(prog["losses"], ref_side["losses"]))}
    g = ref_side["grad_norms"]
    med = statistics.median(g.values())
    moving = {n for n, v in g.items() if v >= CHANGE_FLOOR * med}
    grad = leaf_gaps(prog["grad_norms"], g)
    change = leaf_gaps(prog["change_norms"], ref_side["change_norms"], moving)
    return dict(out, grad_gap=max(grad), grad_gap_median=statistics.median(grad),
                change_gap=max(change), change_gap_median=statistics.median(change),
                mask_mismatch=float(sum(ref.mask_mismatch(c, d["occ"], d["mask"], rows)
                                        for d in prog["decisions"])))


def stream_numbers(c: dict, answers: List[dict], decisions: List[dict], hidden,
                   ref_side: dict) -> Dict[str, float]:
    """The program's first-pass answers, decisions and hidden volumes (host
    copies, channels last) against the reference's replay."""
    dev = ref_side["hidden"][0].device
    tsdf = tsdf_rel = occ = 0.0
    mismatch = 0
    for a, d, r in zip(answers, decisions, ref_side["answers"]):
        t, o = a["tsdf"].to(dev), a["occ"].to(dev)
        gap = (t - r["tsdf"]).abs()
        tsdf = max(tsdf, float(gap.mean()))
        tsdf_rel = max(tsdf_rel, float(gap.sum() / (r["tsdf"] - 1.0).abs().sum().clamp(min=1e-30)))
        occ = max(occ, float((o - r["occ"]).abs().mean()))
        mismatch += ref.mask_mismatch(c, d["occ"], d["mask"], 1)
        occupied = ref.occupancy(c, d["occ"], d["mask"])[-1].to(dev)
        mismatch += int(((t != 1.0) != occupied).sum())
    hid = max(float((a.to(dev).permute(0, 4, 1, 2, 3) - b).abs().mean()
                    / b.abs().mean().clamp(min=1e-30))
              for a, b in zip(hidden, ref_side["hidden"]))
    return dict(tsdf_mae=tsdf, tsdf_rel=tsdf_rel, occ_mae=occ, hidden_rel=hid,
                mask_mismatch=float(mismatch))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit under it (a NaN fails); the others are
    reported, not compared."""
    return all(numbers[k] <= limits[k] for k in limits)


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack(torch._foreach_norm([tensors[n].double() for n in names]))
    return dict(zip(names, vals.tolist()))
