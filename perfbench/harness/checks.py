"""The numbers that decide ``correct``: the program's outputs against the
plain reference's (the architecture's, archs/<arch>.py), each held to its
limit (limits/<workload>.json).

A leaf's gap is the gap between the program's norm and the reference's,
over the larger of the reference leaf's norm and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out (a gradient that is round-off alone).
Training (the first steps of the window's own call and feed):
  logit_err   the first step's logits as the step's loss takes them,
              against the reference's, in units of the seed's own bf16
              rounding: the largest, over the batch's rows, of the mean
              norm over the row's pixels of the program's minus the
              reference's logits (centred over the classes), over that of
              the yardstick's minus the reference's, the yardstick being
              the reference's forward with its operands rounded to
              bfloat16 (loops.train_reference). Infinite where the shapes
              differ. The yardstick takes out how far a seed's logits move
              under rounding at all, which differs 3-4x from seed to seed;
  grad_gap    the median leaf's gap of the first step's gradient as Adam
              got it (clipped; worked out from its first moment);
  change_gap  the worst leaf's gap of the parameters' change over the
              steps.
  Each step's loss gap and the logits' plain relative error are readings
  of the detail and decide nothing: neither separates the lower-precision
  control from sound runs over a dozen seeds, nor does the norm of the
  first gradient's difference. PERF.md section 2 gives the readings, and
  the look that compares the median leaf and not the worst.
Analysis (a seeded sample of the window's batches, with the largest):
  logit_gap       the largest, over the sampled events, of the relative
                  error of the logits as the scores at the event's points
                  give them (log-scores centred over the classes): the
                  mean norm of the program's minus the reference's, over
                  the mean norm of the reference's. Free of the logits'
                  scale, which differs from seed to seed;
  exact_mismatch  what must agree exactly: crop origins, pixels counted,
                  charged pixels, the pixels of each label (the confusion
                  counts summed over the predictions), and the charged
                  pixels counted right against the program's own scores
                  at the points, judged by the reference's labels.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

THRESHOLD = 1e-3  # of the median leaf's reference gradient norm


def _counted(ref_grads: Dict[str, float]) -> List[str]:
    floor = THRESHOLD * statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= floor]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> List[float]:
    """Per leaf: |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]


def logit_error(prog: torch.Tensor, ref: torch.Tensor,
                yard=None) -> float:
    """The largest over the rows of the relative error of logits (B, ...,
    K) centred over the classes: the mean norm over the row's pixels of
    the program's minus the reference's, over the mean norm of the
    reference's or, given ``yard``, of the yardstick's minus the
    reference's. Infinite where the shapes differ."""
    if prog.shape != ref.shape:
        return math.inf

    def centred(t):
        t = t.double()
        return t - t.mean(-1, keepdim=True)

    worst = 0.0
    for row in range(ref.shape[0]):
        p, r = centred(prog[row]), centred(ref[row])
        den = r if yard is None else centred(yard[row]) - r
        worst = max(worst, float(torch.linalg.vector_norm(p - r, dim=-1).mean()
                                 / torch.linalg.vector_norm(den, dim=-1).mean()))
    return worst


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    leaves = _counted(ref["grad_norms"])
    return {
        "logit_err": logit_error(prog["logits"], ref["logits"],
                                 yard=ref["yard"]),
        "grad_gap": statistics.median(leaf_gaps(
            prog["grad_norms"], ref["grad_norms"], leaves)),
        "change_gap": max(leaf_gaps(prog["change_norms"],
                                    ref["change_norms"], leaves)),
    }


def ana_numbers(prog: List[dict], ref: List[dict],
                views: List[dict]) -> Dict[str, float]:
    """``views``: the reference's view of each batch, of which this reads
    ``valid``, ``point_label`` and ``origin``."""
    gap, exact = 0.0, 0
    for p, r, d in zip(prog, ref, views):
        ps = np.asarray(p["pscores"], np.float64)
        rs = np.asarray(r["pscores"], np.float64)
        for row in range(len(ps)):
            valid = d["valid"][row]
            if valid.any():
                lp, lr = _logits(ps[row][valid]), _logits(rs[row][valid])
                gap = max(gap, float(np.linalg.norm(lp - lr, axis=-1).mean()
                                     / np.linalg.norm(lr, axis=-1).mean()))
        # what the densify decides alone, and the right calls among the
        # charged pixels as the program's own scores at the points make
        # them (each charged pixel is one point)
        right = float(((ps.argmax(-1) == d["point_label"])
                       & d["valid"]).sum())
        conf = np.asarray(p["conf"], np.float64).sum(0)
        exact += int(np.sum(conf.sum(0) != r["conf"].sum(0)))
        exact += int(float(np.sum(p["correct_nonzero"])) != right)
        exact += int(np.sum(np.asarray(p["origin"]) != d["origin"]))
        exact += int(float(p["n_pixels"]) != r["n_pixels"])
        exact += int(np.sum(np.asarray(p["n_nonzero"], np.float64)
                            != r["n_nonzero"]))
    return {"logit_gap": gap, "exact_mismatch": float(exact)}


def _logits(scores: np.ndarray) -> np.ndarray:
    """The logits that softmax scores come from, up to each point's
    constant: log-scores centred over the classes."""
    lg = np.log(np.maximum(scores, 1e-30))
    return lg - lg.mean(-1, keepdims=True)


def train_detail(prog: dict, ref: dict) -> dict:
    """What the readings look at: the logits' plain relative error, each
    step's loss gap, and the leaves whose gradient and change gaps are the
    largest, beside the median leaf's."""
    leaves = _counted(ref["grad_norms"])
    out = {"logit_rel_err": logit_error(prog["logits"], ref["logits"]),
           "loss_gaps": [abs(p - r) / abs(r) for p, r in
                         zip(prog["losses"], ref["losses"])]}
    for key in ("grad_norms", "change_norms"):
        med = statistics.median(ref[key][k] for k in leaves)
        gaps = sorted(((abs(prog[key][k] - ref[key][k])
                        / max(ref[key][k], med), k) for k in leaves),
                      reverse=True)
        out[key] = {"median_gap": statistics.median(g for g, _ in gaps),
                    "worst": [[k, g, prog[key][k], ref[key][k]]
                              for g, k in gaps[:6]]}
    out["left_out"] = sorted(set(ref["grad_norms"]) - set(leaves))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number finite and within
    its limit; a number without a limit is not correct."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
