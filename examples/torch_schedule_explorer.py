"""Schedule explorer: sweep the design space of Section 4 from the CLI.

Reproduces any point of Figs 5-12 on demand, e.g.:

  PYTHONPATH=src python examples/torch_schedule_explorer.py \
      --collective rs --n 128 --m-mb 16 --delta-us 150

and the generalized scenario space beyond the paper (any n, radix r):

  PYTHONPATH=src python examples/torch_schedule_explorer.py \
      --collective a2a --n 96 --radix 3 --m-mb 4

prints the BRIDGE plan (schedule + R), the planner's ranked alternatives
table, every baseline, and the speedups.  Planning goes through the unified
`repro_torch.planner` API; pass --save-plan to write the lossless PlanResult JSON.

Whole-workload traces (back-to-back collectives with fabric-state carryover,
see repro_torch/workloads/):

  PYTHONPATH=src python examples/torch_schedule_explorer.py \
      --trace mixed --n 48 --delta-us 1000

plans the trace jointly (carryover) and prints the per-collective schedules,
boundary reuse, and the amortization win over cold-fabric re-planning.

Fault injection (add --faults to a --trace run):

  PYTHONPATH=src python examples/torch_schedule_explorer.py \
      --trace mixed --n 48 --delta-us 1000 --faults spec.json

loads a `repro_torch.core.faults.FaultTimeline` JSON spec, replays the planned
trace under it, and prints the degraded state (committed prefix, surviving
world, chunk fate) plus the resume-from-snapshot vs restart-from-scratch
comparison.  A spec whose fault times all fall at/after the clean run's
completion is rejected up front (ValueError): such a timeline never takes
effect and loading it is a mistake, not a degraded run.

This is the twin of examples/schedule_explorer.py on the PyTorch port
(`repro_torch.core`, `repro_torch.planner`): the same options, the same
printed lines, and `--device` (default: the card).  With `--fabric ocs-sim`
every candidate is played by the card's certified fabric playback (the CUDA
kernel B6, `batch_run(backend="torch")`); `--device cpu` plays them with
the NumPy engine, whose bits B6 gives.
"""
import argparse

from repro_torch._device import resolve_device
from repro_torch.core import PAPER_DEFAULT, baselines, collective_time
from repro_torch.planner import PlanRequest, Planner

MB = 1024.0 ** 2


def explore_trace(args, cm):
    from repro_torch.workloads import (decode_ag_trace, mixed_trace, moe_a2a_trace,
                                 plan_trace, train_step_trace)

    trace = {
        "moe": lambda: moe_a2a_trace(args.n, layers=3),
        "train": lambda: train_step_trace(args.n, steps=2, buckets=2),
        "decode": lambda: decode_ag_trace(args.n, decode_steps=6, jitter=0.25),
        "mixed": lambda: mixed_trace(args.n),
    }[args.trace]()
    plans = {mode: plan_trace(trace, cm, mode=mode)
             for mode in ("static", "cold", "carryover")}
    carry = plans["carryover"]
    print(f"trace {trace.name!r}: {len(trace)} events -> "
          f"{len(carry.phases)} phases at n={args.n}, "
          f"delta={args.delta_us} us\n")
    print("  carryover plan (joint DP, boundary delta only on changed circuits):")
    for i, p in enumerate(carry.phases):
        boundary = ""
        if i:
            c = carry.boundary_changed[i - 1]
            boundary = ("  boundary: free (fabric reused)" if c == 0
                        else f"  boundary: {c} circuits swap "
                             f"({carry.boundary_cost[i - 1] * 1e3:.3f} ms)")
        print(f"    [{i:2d}] {p.tag:<24s} {p.strategy:<18s} "
              f"{p.time * 1e3:9.3f} ms{boundary}")
    print(f"\n  free boundaries: {carry.free_boundaries}/"
          f"{len(carry.boundary_cost)}")
    t_carry = carry.total_time
    for mode in ("carryover", "cold", "static"):
        t = plans[mode].total_time
        print(f"  {mode:<10s} {t * 1e3:10.3f} ms   carryover win "
              f"{t / t_carry:6.2f}x")
    if args.save_plan:
        with open(args.save_plan, "w") as f:
            f.write(carry.to_json(indent=1))
        print(f"\nwrote trace plan to {args.save_plan}")
    if args.faults:
        explore_faults(args, cm, trace, carry)


def explore_faults(args, cm, trace, carry):
    from repro_torch.core import FabricSim, FaultTimeline
    from repro_torch.workloads import run_with_recovery

    with open(args.faults) as f:
        faults = FaultTimeline.from_json(f.read())
    clean = FabricSim(mode="sparse", chunks_per_msg=8).run_trace(
        carry.fabric_phases(), cm)
    # reject specs that never take effect before running anything
    faults.check_horizon(clean.completion)
    rr = run_with_recovery(trace, cm, faults=faults)
    ds = rr.degraded
    print(f"\n  fault: {ds.fault.kind} at node {ds.fault.node}, "
          f"t={ds.fault.time * 1e3:.3f} ms (clean completion "
          f"{clean.completion * 1e3:.3f} ms)")
    print(f"    committed: {ds.completed_phases} phases / "
          f"{len(rr.committed_events)} events; surviving world "
          f"n={ds.n} -> n'={ds.new_n}")
    print(f"    chunks: {ds.committed_chunks} committed, "
          f"{ds.lost_chunks} lost, {ds.requeued_chunks} re-queued "
          f"(policy={ds.policy})")
    print(f"    re-plan: {len(rr.recovery_plan.phases)} phases at n'="
          f"{ds.new_n}, bit-identical to clean reduced run: "
          f"{rr.bit_identical}")
    print(f"    resume from snapshot {rr.recovery_total * 1e3:10.3f} ms")
    print(f"    restart from scratch {rr.restart_total * 1e3:10.3f} ms   "
          f"recovery ratio {rr.recovery_ratio:.3f}x")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--collective", default="a2a",
                    choices=["a2a", "rs", "ag", "ar"])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--m-mb", type=float, default=4.0)
    ap.add_argument("--delta-us", type=float, default=10.0)
    ap.add_argument("--alpha-h-us", type=float, default=1.0)
    ap.add_argument("--ports", type=int, default=None,
                    help="OCS ports (< 2n engages the Section 3.7 model)")
    ap.add_argument("--radix", type=int, default=2,
                    help="Bruck radix r (mixed-radix generalization; 2 = paper)")
    ap.add_argument("--fabric", default="ocs",
                    choices=["ocs", "static", "ocs-overlap", "ocs-sim"],
                    help="'ocs-overlap' = sparse reconfiguration with "
                         "hidden-delta credit (see core/fabricsim.py); "
                         "'ocs-sim' = every candidate event-scored by the "
                         "vectorized batch fabric engine (core/batchsim.py)")
    ap.add_argument("--overlap", type=float, default=0.0,
                    help="fraction of delta hidden behind communication "
                         "(requires --fabric ocs-overlap or ocs-sim)")
    ap.add_argument("--max-r", type=int, default=None,
                    help="cap on reconfigurations R")
    ap.add_argument("--top", type=int, default=5,
                    help="alternatives table rows to print")
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="write the PlanResult JSON (lossless, cacheable)")
    ap.add_argument("--trace", default=None,
                    choices=["moe", "train", "decode", "mixed"],
                    help="plan a whole workload trace (carryover vs cold vs "
                         "static) instead of a single collective")
    ap.add_argument("--faults", default=None, metavar="SPEC.json",
                    help="FaultTimeline JSON to inject into the --trace run "
                         "(fault times must fall inside the clean run's "
                         "horizon)")
    ap.add_argument("--device", default=None,
                    help="where ocs-sim plays its candidates: default the card (B6), "
                         "'cpu' the NumPy engine")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    # B6 on the card, NumPy on the host: one engine, chosen by the device
    args.sim_backend = "torch" if args.device.type == "cuda" else "numpy"
    if args.faults and not args.trace:
        ap.error("--faults requires --trace (faults strike a running trace)")

    n, m = args.n, args.m_mb * MB
    cm = PAPER_DEFAULT.replace(delta=args.delta_us * 1e-6,
                               alpha_h=args.alpha_h_us * 1e-6)
    if args.trace:
        explore_trace(args, cm)
        return

    hidden_fabrics = ("ocs-overlap", "ocs-sim")
    res = Planner(sim_backend=args.sim_backend).plan(PlanRequest(
        kind=args.collective, n=n, m_bytes=m, cost_model=cm, r=args.radix,
        fabric=args.fabric, overlap=args.overlap,
        paper_faithful=(args.fabric not in hidden_fabrics),
        max_R=args.max_r, ports=args.ports))
    t_bridge = res.predicted_time
    if args.collective == "ar":
        print(f"BRIDGE plan: {res.strategy}")
        print(f"  rs x={res.rs_schedule.x}  ag x={res.ag_schedule.x}")
    else:
        print(f"BRIDGE plan: {res.strategy}  x={res.schedule.x}")
        if args.fabric not in hidden_fabrics:
            t_bridge = collective_time(res.schedule, m, cm, ports=args.ports).total
    print(f"  completion time {t_bridge * 1e3:.3f} ms"
          + ("  (batched event simulation)" if args.fabric == "ocs-sim" else ""))

    print(f"\n  ranked alternatives (top {args.top} of {len(res.alternatives)}):")
    for alt in res.alternatives[:args.top]:
        r_str = f"R={alt.R}" if alt.R is not None else "-"
        print(f"    {alt.strategy:<22s} {alt.impl:<6s} {r_str:<6s}"
              f" {alt.predicted_time * 1e3:10.3f} ms")
    print()

    # under ocs-overlap / ocs-sim, score reconfiguring baselines with the
    # same fabric semantics so the printed speedups compare like with like
    hidden = args.fabric in hidden_fabrics
    kind = args.collective
    if kind == "ar":
        if args.fabric == "ocs-sim":
            from repro_torch.core import batch_completion_times, static_schedule
            ts = batch_completion_times(
                [static_schedule("rs", n, args.radix),
                 static_schedule("ag", n, args.radix)], m, cm,
                overlap=args.overlap, chunks_per_msg=8,
                backend=args.sim_backend, device=args.device)
            t_static = float(ts[0] + ts[1])
        else:
            t_static = (baselines.s_bruck("rs", n, m, cm, r=args.radix).total
                        + baselines.s_bruck("ag", n, m, cm, r=args.radix).total)
        rows = [("S-BRUCK (static)", t_static)]
    else:
        if args.fabric == "ocs-sim":
            from repro_torch.core import (batch_completion_times,
                                    every_step_schedule, static_schedule)
            ts = batch_completion_times(
                [static_schedule(kind, n, args.radix),
                 every_step_schedule(kind, n, args.radix)], m, cm,
                overlap=args.overlap, chunks_per_msg=8,
                backend=args.sim_backend, device=args.device)
            t_sbruck, t_gbruck = float(ts[0]), float(ts[1])
        elif hidden:
            from repro_torch.core import collective_time_overlap, every_step_schedule
            t_sbruck = baselines.s_bruck(kind, n, m, cm, r=args.radix).total
            t_gbruck = collective_time_overlap(
                every_step_schedule(kind, n, args.radix), m, cm,
                args.overlap).total
        else:
            t_sbruck = baselines.s_bruck(kind, n, m, cm, r=args.radix).total
            t_gbruck = baselines.g_bruck(kind, n, m, cm, r=args.radix).total
        rows = [("S-BRUCK (static)", t_sbruck),
                ("G-BRUCK (every step)", t_gbruck)]
    if kind in ("rs", "ag", "ar"):
        rows.append(("RING", baselines.ring(kind, n, m, cm).total))
    if kind in ("rs", "ag") and not hidden:
        # R-HD's schedule is internal to the baseline; it cannot be re-scored
        # with the overlap credit, so skip it on the ocs-overlap fabric
        t_rhd, R = baselines.r_hd_optimal(kind, n, m, cm, r=args.radix)
        rows.append((f"R-HD (R*={R})", t_rhd.total))
    for name, t in rows:
        print(f"  {name:<22s} {t * 1e3:10.3f} ms   bridge speedup "
              f"{t / t_bridge:6.2f}x")

    if args.save_plan:
        with open(args.save_plan, "w") as f:
            f.write(res.to_json(indent=1))
        print(f"\nwrote plan to {args.save_plan}")


if __name__ == "__main__":
    main()
