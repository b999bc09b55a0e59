"""Validate the host structural screen + device CG against a direct
f64 oracle.

The reference's ONLY rejection is NaN after a real sfepy SuperLU solve
(/root/reference/datagen/fea_analysis.py:455-461 — solve, check
np.isnan, resample). This framework instead (a) rejects structurally
singular conditions host-side for microseconds
(StaticProblem.structurally_singular) and (b) flags device CG failures.
If the screen rejects conditions the reference's LU would have solved,
the generated data distribution silently diverges from the reference's.

This study samples conditions with the PRODUCTION samplers and scores
every one against the oracle the reference effectively uses — a scipy
SuperLU f64 direct solve on the Dirichlet-reduced system (sfepy's
ls.scipy_direct is the same SuperLU):

  screen-rejected + oracle finite      -> FALSE REJECT (the bad case)
  screen-rejected + oracle NaN/singular -> true reject (saved a solve)
  screen-accepted + oracle NaN          -> screen miss (reference would
                                           resample; our CG flags it)
  screen-accepted + oracle finite       -> run the production batched
        CG kernel (PlateSolver + solve_plate_group, f32, production
        tolerances) and compare: CG failure rate on oracle-solvable
        conditions + displacement agreement vs the oracle.

Oracle finiteness is the reference's exact bar (NaN check only). A
finite-but-astronomical solve (the composite app fixture's 1e10 ranges)
passes the reference's check, so `finite` is the parity metric;
`bounded` (max |u| <= 1e6) is reported alongside for context.

Usage:
  python benchmarks/screen_oracle.py --n 500 --mesh_size 1e-2 \
      --out docs/screen_oracle.json
  python benchmarks/screen_oracle.py --n 32 --quick   # bench.py inline

Runs on the CPU backend (forced) so it never competes with a production
job for the card; the CG kernel math is backend-agnostic.
"""

import argparse
import json
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def force_cpu():
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass  # backend already up; caller accepts whatever it is


def oracle_solve(problem):
    """The reference's solver, distilled: f64 SuperLU on the
    Dirichlet-reduced system; 'solved' iff no NaN (fea_analysis.py:
    455-461). Round 5 promoted the implementation into the framework
    as the production fallback lane for terminal CG failures
    (fea_tpu/fem/direct.py); this stays as the study's entry point."""
    from fea_tpu.fem.direct import direct_solve_u1

    return direct_solve_u1(problem)


def run_study(n_conditions, mesh_size, seed, conditions_per_plate=4,
              with_cg=True, verbose=True):
    import numpy as np

    from fea_tpu.datagen.batched import PlateSolver, solve_plate_group
    from fea_tpu.datagen.conditions import ConditionSampler
    from fea_tpu.datagen.pipeline import DATAGEN_ACCEPT_TOL
    from fea_tpu.fem.problem import StaticProblem
    from fea_tpu.geometry import GeometrySampler
    from fea_tpu.mesh import triangulate_polygon

    gs = GeometrySampler(random_seed=seed)
    cs = ConditionSampler(random_seed=seed + 1)

    stats = {
        "n_conditions": 0,
        "screen_rejects": 0,
        "false_rejects": 0,          # screen-rejected, oracle finite
        "false_rejects_bounded": 0,  # ... and |u| <= 1e6
        "true_rejects": 0,           # screen-rejected, oracle NaN
        "screen_accept_oracle_nan": 0,
        "cg_attempted": 0,
        "cg_failures": 0,
        "cg_failures_oracle_finite": 0,
    }
    mae_rel = []
    t0 = time.time()
    while stats["n_conditions"] < n_conditions:
        try:
            poly = gs.generate()
            mesh = triangulate_polygon(poly, mesh_size=mesh_size)
            conds = cs.sample(mesh, conditions_per_plate)
        except Exception:
            continue  # sampler retries are part of the reference loop too
        problems = [
            StaticProblem.from_condition(
                mesh,
                material_regions=c["material_regions"],
                point_constraints=c["point_constraints"],
                edge_constraints=c["edge_constraints"],
                point_forces=c["point_forces"],
                edge_forces=c["edge_forces"],
                num_steps=2,
            )
            for c in conds
        ]
        accepted = []
        for prob in problems:
            if stats["n_conditions"] >= n_conditions:
                break
            stats["n_conditions"] += 1
            rejected = prob.structurally_singular()
            u_ref, finite, bounded = oracle_solve(prob)
            if rejected:
                stats["screen_rejects"] += 1
                if finite:
                    stats["false_rejects"] += 1
                    if bounded:
                        stats["false_rejects_bounded"] += 1
                else:
                    stats["true_rejects"] += 1
            else:
                if not finite:
                    stats["screen_accept_oracle_nan"] += 1
                accepted.append((prob, u_ref, finite))

        if with_cg and accepted:
            # production batched kernel on the accepted conditions of
            # this plate — one payload, exactly the datagen dispatch
            solver = PlateSolver(mesh, 2, band_hb=-1,
                                 include_cell_fields=False)
            built = [
                solver.build_problem(c)
                for c, prob in zip(conds, problems)
                if any(prob is a[0] for a in accepted)
            ]
            results = solve_plate_group(
                [(solver, built)], max_iters=6000,
                tol=None, pad_group_to=1,
            )[0]
            for (prob, u_ref, finite), res in zip(accepted, results):
                stats["cg_attempted"] += 1
                if not bool(res.success):
                    stats["cg_failures"] += 1
                    if finite:
                        stats["cg_failures_oracle_finite"] += 1
                elif finite and u_ref is not None:
                    u_cg = np.asarray(res.displacements[-1])[: len(u_ref)]
                    scale = max(float(np.abs(u_ref).max()), 1e-300)
                    mae_rel.append(
                        float(np.abs(u_cg - u_ref).mean() / scale)
                    )
        if verbose and stats["n_conditions"] % 50 < conditions_per_plate:
            print(
                f"{stats['n_conditions']}/{n_conditions} "
                f"({time.time() - t0:.0f}s): "
                f"rejects={stats['screen_rejects']} "
                f"false={stats['false_rejects']}",
                file=sys.stderr,
            )

    out = dict(stats)
    out["mesh_size"] = mesh_size
    out["seed"] = seed
    out["accept_tol"] = DATAGEN_ACCEPT_TOL
    out["screen_reject_rate"] = round(
        stats["screen_rejects"] / max(stats["n_conditions"], 1), 4
    )
    out["screen_false_reject_rate"] = round(
        stats["false_rejects"] / max(stats["n_conditions"], 1), 4
    )
    out["screen_false_reject_rate_bounded"] = round(
        stats["false_rejects_bounded"] / max(stats["n_conditions"], 1), 4
    )
    out["cg_failure_rate_on_solvable"] = round(
        stats["cg_failures_oracle_finite"] / max(stats["cg_attempted"], 1),
        4,
    )
    if mae_rel:
        out["cg_vs_oracle_rel_mae_median"] = float(
            round(np.median(mae_rel), 8)
        )
        out["cg_vs_oracle_rel_mae_p95"] = float(
            round(np.percentile(mae_rel, 95), 8)
        )
    out["wall_s"] = round(time.time() - t0, 1)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=500,
                    help="conditions to sample (production draws, incl. "
                         "the ones the screen rejects)")
    ap.add_argument("--mesh_size", type=float, default=1e-2,
                    help="production datagen mesh size")
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--no_cg", action="store_true",
                    help="skip the production-CG leg (screen vs oracle "
                         "only)")
    ap.add_argument("--quick", action="store_true",
                    help="bench.py inline mode: small n, no CG, compact "
                         "JSON on stdout")
    ap.add_argument("--out", type=str, default=None,
                    help="write the JSON here as well")
    args = ap.parse_args()

    force_cpu()
    if args.quick:
        args.no_cg = True
    out = run_study(
        args.n, args.mesh_size, args.seed,
        with_cg=not args.no_cg, verbose=not args.quick,
    )
    js = json.dumps(out, indent=None if args.quick else 2)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=2) + "\n")


if __name__ == "__main__":
    main()
