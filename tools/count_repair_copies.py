#!/usr/bin/env python3
"""Counts, in the repair ladder of ``pipeline.plan_batch`` through "mega"
on the card, the dirty lanes whose first occurrence in a repair round did
not converge clean while one of its cyclic copies did. A round gathers
its R lanes as the dirty lanes in index order, the rest of the width
cyclic copies of them, and writes back each lane's first occurrence only;
under "mega" a copy in another 128-lane exit block keeps iterating while
its block runs, so it can end otherwise.

Set-up: chip_smoke.py's ``replan_setup`` at B=1024, float32, the RoadSpec,
unperturbed and with bench.py's first start perturbation
(``default_rng(1)``, +-0.2 m on y). Each round's solve and re-check are
read by wrapping ``pipeline.solve_batch`` and
``pipeline._recheck_solution``; a round's number of dirty lanes is the
period of its gathered goals. Prints one JSON line.

Run from the repository root:
  python3 tools/count_repair_copies.py [--backend mega]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def period(goals):
    """The number of distinct lanes a round gathered: the first position
    whose goals repeat position 0's (the cyclic copies), else R."""
    for p in range(1, goals.shape[0]):
        if torch.equal(goals[p], goals[0]):
            return p
    return goals.shape[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="mega")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("count_repair_copies: no CUDA device")
    sys.path.insert(0, HERE)
    from chip_smoke import B, NEAR, replan, replan_setup, smi_line

    import cilqr_tpu_torch as P
    from cilqr_tpu_torch import pipeline

    cfg = P.PlannerConfig()
    setup = replan_setup(P, range(B))
    seen = []
    real_solve, real_recheck = pipeline.solve_batch, pipeline._recheck_solution

    def solve_batch(goals, *a, **k):
        res = real_solve(goals, *a, **k)
        seen.append([goals, res, None])
        return res

    def recheck(scns, xs, *a, **k):
        hits = real_recheck(scns, xs, *a, **k)
        if seen and seen[-1][1].xs is xs:
            seen[-1][2] = hits
        return hits

    pipeline.solve_batch, pipeline._recheck_solution = solve_batch, recheck
    rng = np.random.default_rng(1)
    runs = {}
    for name, dy in (("unperturbed", None),
                     ("perturbed", torch.as_tensor(
                         rng.uniform(-0.2, 0.2, B), dtype=torch.float32,
                         device=setup[1].device))):
        seen.clear()
        out = replan(P, cfg, setup, args.backend, dy)
        rounds = []
        for goals, res, hits in seen[1:]:        # seen[0]: the main solve
            n = period(goals)
            ok = ((res.status >= 1) & (res.status <= 3)
                  & ~hits[:, :NEAR].any(-1)).cpu()
            R = ok.shape[0]
            first_failed_copy_ok = sum(
                1 for q in range(n)
                if not ok[q] and any(bool(ok[p]) for p in range(q + n, R, n)))
            copies_disagree = sum(
                1 for q in range(n)
                if any(bool(ok[p]) != bool(ok[q]) for p in range(q + n, R, n)))
            rounds.append({"R": R, "dirty": n,
                           "first_clean": int(ok[:n].sum()),
                           "first_failed_but_a_copy_clean":
                               first_failed_copy_ok,
                           "copies_disagreeing_with_first": copies_disagree})
        runs[name] = {
            "dirty": int(out.pre_hits[:, :NEAR].any(-1).sum()),
            "repaired": int(out.repaired.sum()),
            "still_dirty": int(out.still_dirty.sum()), "rounds": rounds}
    pipeline.solve_batch, pipeline._recheck_solution = real_solve, real_recheck
    print(json.dumps({"backend": args.backend, "B": B, "card": smi_line(),
                      **runs}), flush=True)


if __name__ == "__main__":
    main()
