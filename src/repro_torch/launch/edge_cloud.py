"""Edge-cloud deployment launcher: run the paper's three deployments either
as the calibrated discrete-event simulation (the default: ``CostModel``
constants measured on the card by ``launch.calibrate``) or, with
``--real``, as real LSTM compute scheduled on the TopicBus by
``BusExecutor``, with each stage's wall measured on the card and rescaled
to its site's hardware class (paper Table 3, Sec. 6.2).

    PYTHONPATH=src python -m repro_torch.launch.edge_cloud \\
        --deployment all --windows 25 [--fast] [--quantized] [--static]
    PYTHONPATH=src python -m repro_torch.launch.edge_cloud --real \\
        --deployment all --fast [--quantized] [--period S] [--windows N] \\
        [--scenario none|gradual|abrupt|seasonal] [--static]
    PYTHONPATH=src python -m repro_torch.launch.edge_cloud --real \\
        --streams 8 --windows 4 --fast --gated --deployment integrated
    PYTHONPATH=src python -m repro_torch.launch.edge_cloud --real \\
        --streams 8 --windows 4 --fast --qps 20 --slots 4 --elastic \\
        --deployment integrated [--quantized]
    PYTHONPATH=src python -m repro_torch.launch.edge_cloud \\
        --chaos forged_sync [--chaos-seed 0]

The calibrated mode prints the calibration and each deployment's Table-3
breakdown and capacity failures.  ``--real`` prints each deployment's
Table-3 breakdown, its mean end-to-end window latency and model-topic
bytes, and the paper's claims as measured, PASS or FAIL.  With ``--streams
N > 1`` it runs a fleet of N correlated turbines through
``FleetBusExecutor`` (``--gated``: drift-gated retraining; ``--quantized``:
per-stream int8 sync; ``--qps``/``--slots``: the request plane, user
queries answered by serving ticks on ``--slots`` batch slots; ``--elastic
[reactive|proactive]``: the placement plane) and prints the request plane's
and the placement plane's lines.  ``--chaos <scenario>`` runs one chaos
scenario of ``core.scenarios`` (the fleet under a seeded fault plane,
``--chaos-seed``, with the health plane attached) and prints its
degradation envelope and health verdicts.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

# the inference rows of Table 3, summed by the totals claim
ROWS = ("speed_inference", "batch_inference", "hybrid_inference")
# the order the paper measures: integrated < cloud-centric < edge-centric
E2E_ORDER = ["edge-cloud-integrated", "cloud-centric", "edge-centric"]


def _print_table(table, e2e=None) -> None:
    for m, row in table.items():
        line = (f"  {m:<18} comp={row['computation']:>8.3f}s "
                f"comm={row['communication']:>8.3f}s ")
        if row.get("queue", 0.0) > 0:
            line += f"queue={row['queue']:>7.3f}s "
        line += f"total={row['total']:>8.3f}s"
        print(line)
    if e2e is not None:
        print(f"  {'end-to-end window':<18} {e2e:>42.3f}s")


def build_real_pipeline(n_windows: int, fast: bool = True, mode="dynamic",
                        records_per_window: int = 250, verbose: bool = False,
                        scenario: str = "gradual",
                        device: Optional[Union[str, torch.device]] = None):
    """The paper's experiment built for real-compute execution on
    ``device`` (the current CUDA device by default): returns (stages,
    batch_params, stream, cost), as the reference's does.  History length,
    seeds (series 0, drift 1, batch pretrain key 0), drift, epoch pairs and
    the Kafka-ingest formula live only here."""
    from repro_torch.configs import get_config
    from repro_torch.core import (
        PipelineStages,
        WindowedStream,
        WindowPlan,
        lstm_forecaster,
        make_supervised,
        pretrain_batch_model,
    )
    from repro_torch.runtime import CostModel
    from repro_torch.streams.normalize import MinMaxScaler
    from repro_torch.streams.sources import apply_scenario, wind_turbine_series

    batch_epochs, speed_epochs = (8, 10) if fast else (50, 100)
    rpw = records_per_window
    cfg = get_config("lstm-paper")
    series = wind_turbine_series(1600 + rpw * n_windows + 5, seed=0)
    hist, stream_raw = series[:1600], series[1600:]
    alphas = np.full(5, 1.5e-3) if scenario == "gradual" else None
    stream_raw = apply_scenario(stream_raw, scenario, seed=1, alphas=alphas)
    scaler = MinMaxScaler.fit(hist)

    fc_batch = lstm_forecaster(cfg, epochs=batch_epochs, batch_size=256,
                               device=device)
    fc_speed = lstm_forecaster(cfg, epochs=speed_epochs, batch_size=64,
                               device=device)
    if verbose:
        print(f"pretraining batch model M^b ({batch_epochs} epochs) ...")
    bp, t_pre = pretrain_batch_model(
        fc_batch, make_supervised(scaler.transform(hist), 5, 0), 0)
    if verbose:
        print(f"  done in {t_pre:.1f}s")

    stream = WindowedStream(scaler.transform(stream_raw),
                            WindowPlan(n_windows, rpw, lag=5))
    stages = PipelineStages.build(fc_speed, mode=mode)
    # only the unmeasurable parts come from the cost model: the Kafka ingest
    # throttle and the training-job memory footprint (capacity model)
    cost = CostModel(ingest_s=rpw / 7.0 * 0.45)
    return stages, bp, stream, cost


def build_fleet_pipeline(n_streams: int, n_windows: int, fast: bool = True,
                         mode="dynamic", records_per_window: int = 250,
                         scenario="gradual", verbose: bool = False,
                         device: Optional[Union[str, torch.device]] = None):
    """The fleet analog of :func:`build_real_pipeline` on ``device``: N
    correlated turbines (``streams.sources.fleet_windowed_streams``), each
    scaled by its own history, all served by one shared pre-trained batch
    model (key 0); returns (fleet_stages, batch_params, {stream_id:
    WindowedStream}, cost), as the reference's does.  ``scenario`` is one
    drift scenario for the whole fleet or one per stream."""
    from repro_torch.configs import get_config
    from repro_torch.core import (
        FleetStages,
        lstm_fleet_forecaster,
        lstm_forecaster,
        pretrain_batch_model,
    )
    from repro_torch.runtime import CostModel
    from repro_torch.streams.sources import fleet_windowed_streams

    batch_epochs, speed_epochs = (8, 10) if fast else (50, 100)
    rpw = records_per_window
    cfg = get_config("lstm-paper")
    has_gradual = ("gradual" in scenario if not isinstance(scenario, str)
                   else scenario == "gradual")
    alphas = np.full(5, 1.5e-3) if has_gradual else None
    streams, hist0 = fleet_windowed_streams(
        n_streams, n_windows, rpw, scenario, alphas=alphas)

    fc_batch = lstm_forecaster(cfg, epochs=batch_epochs, batch_size=256,
                               device=device)
    if verbose:
        print(f"pretraining shared batch model M^b ({batch_epochs} epochs, "
              f"{n_streams} streams) ...")
    bp, t_pre = pretrain_batch_model(fc_batch, hist0, 0)
    if verbose:
        print(f"  done in {t_pre:.1f}s")

    fleet_fc = lstm_fleet_forecaster(cfg, epochs=speed_epochs, batch_size=64,
                                     device=device)
    stages = FleetStages.build(fleet_fc, mode=mode)
    cost = CostModel(ingest_s=rpw / 7.0 * 0.45)
    return stages, bp, streams, cost


def run_real_fleet(args, device=None) -> Dict[str, Any]:
    """N streams on real LSTM compute through the TopicBus on ``device``
    (the current CUDA device by default): per-stream topics under one
    deployment, the whole fleet's speed training one stacked fit a window,
    optionally drift-gated, with the request plane (``args.qps``,
    ``args.slots``) and the placement plane (``args.elastic``) when asked.
    Prints each deployment's breakdown and returns {deployment name:
    FleetBusRunResult}."""
    from repro_torch.core.drift import DriftGate
    from repro_torch.runtime import (
        ALL_DEPLOYMENTS,
        FleetBusExecutor,
        paper_topology,
    )

    mode = ("static", 0.5) if args.static else "dynamic"
    stages, bp, streams, cost = build_fleet_pipeline(
        args.streams, args.windows, fast=args.fast, mode=mode,
        scenario=args.scenario, verbose=True, device=device)

    deps = {
        "edge": ["edge-centric"],
        "cloud": ["cloud-centric"],
        "integrated": ["edge-cloud-integrated"],
        "all": list(ALL_DEPLOYMENTS),
    }[args.deployment]

    results = {}
    for name in deps:
        dep = ALL_DEPLOYMENTS[name]()
        gate = DriftGate() if args.gated else None
        ex = FleetBusExecutor(stages, dep, paper_topology(), cost,
                              window_period_s=args.period, gate=gate,
                              quantized_sync=args.quantized,
                              qps=args.qps, serve_slots=args.slots,
                              elastic=args.elastic or False)
        res = results[name] = ex.run(streams, bp, 1)
        print(f"\n[{dep.name}] {args.streams} streams x {args.windows} "
              f"windows ({args.scenario} scenario"
              f"{', drift-gated' if args.gated else ''}"
              f"{', int8 sync' if args.quantized else ''}), measured "
              f"Table-3 breakdown:")
        _print_table(res.table3(),
                     e2e=(res.mean_e2e_s()
                          if any(res.e2e_s.values()) else None))
        if any(r.records for r in res.results.values()):
            m = res.mean_rmse()
            print(f"  fleet mean RMSE: batch={m['batch']:.4f} "
                  f"speed={m['speed']:.4f} hybrid={m['hybrid']:.4f}")
        else:
            print("  (no inference windows: window 0 only trains; "
                  "use --windows >= 2)")
        print(f"  speed training: {res.train_dispatches} fleet fits "
              f"for {res.total_retrains()} retrains "
              f"({res.skipped_retrains()} skipped)")
        if res.gate_stats is not None:
            per = res.gate_stats["per_stream"]
            gated = " ".join(
                f"{sid}:{st['retrained']}R/{st['skipped']}S"
                for sid, st in sorted(per.items()))
            print(f"  gate: {gated}")
        if res.serving is not None:
            s = res.serving
            print(f"  request plane: {s['n_answered']}/{s['n_requests']} "
                  f"answered ({s['n_starved']} starved) over "
                  f"{s['ticks']} ticks, "
                  f"{s['dispatches_per_tick']:.2f} dispatches/tick, "
                  f"{s['slots']} slots")
            print(f"    offered={s['offered_qps']:.1f} qps "
                  f"sustained={s['sustained_qps']:.1f} qps "
                  f"p50={s['p50_s']*1e3:.2f}ms p99={s['p99_s']*1e3:.2f}ms")
        if res.placement is not None:
            pl = res.placement
            ctl = pl["controller"]
            print(f"  elastic ({pl['mode']}, interval "
                  f"{pl['control_interval_s']:.1f}s): "
                  f"{ctl['migrations']} migrations, "
                  f"{ctl['scale_events']} scale events "
                  f"({ctl['proactive_scale_events']} proactive), "
                  f"{ctl['ticks']} control ticks")
            for m in pl["migrations"]:
                print(f"    t={m['t']:.1f}s {m['sid']}: {m['from']} -> "
                      f"{m['to']} ({m['state_nbytes']/1e3:.1f} KB state)")
            placed = " ".join(f"{sid}@{site}" for sid, site
                              in sorted(pl["stream_site"].items()))
            print(f"    final placement: {placed}; workers "
                  f"{pl['base_workers']} -> {pl['final_workers']}")
        if res.failures:
            print(f"  !! {len(res.failures)} capacity failures "
                  f"(first: {res.failures[0]})")
    return results


def table3_claim_checks(results) -> Dict[str, bool]:
    """The paper's Table-3 claims on measured runs ({deployment name:
    BusRunResult}), as ``benchmarks/table3_deployment_latency.py`` checks
    them; the e2e ordering needs every deployment's end-to-end latency."""
    tables = {d: r.table3() for d, r in results.items()}
    tot = {d: sum(t.get(m, {}).get("total", 0.0) for m in ROWS)
           for d, t in tables.items()}
    comm = {d: t["batch_inference"]["communication"]
            for d, t in tables.items()}
    e2e = {d: r.mean_e2e_s() for d, r in results.items()}
    return {
        "cloud_comm>edge_comm (inference)": (
            comm["cloud-centric"] > comm["edge-cloud-integrated"]),
        "edge_centric_training_OOM": bool(results["edge-centric"].failures),
        "integrated_beats_edge_centric_total": (
            tot["edge-cloud-integrated"] < tot["edge-centric"]),
        "integrated_trains_without_capacity_limits": (
            not results["edge-cloud-integrated"].failures),
        "e2e: integrated < cloud < edge": (
            e2e["edge-cloud-integrated"] < e2e["cloud-centric"]
            < e2e["edge-centric"]),
    }


def run_real(args, device=None) -> Dict[str, Any]:
    """The chosen deployments on real LSTM compute through the TopicBus, on
    ``device`` (the current CUDA device by default): prints each one's
    breakdown and, with all three, the paper-claim checks.  Returns
    {deployment name: BusRunResult}."""
    from repro_torch.runtime import (
        ALL_DEPLOYMENTS,
        BusExecutor,
        paper_topology,
    )
    from repro_torch.runtime.modules import T_MODEL

    mode = ("static", 0.5) if args.static else "dynamic"
    stages, bp, stream, cost = build_real_pipeline(
        args.windows, fast=args.fast, mode=mode, verbose=True,
        scenario=args.scenario, device=device)

    deps = {
        "edge": ["edge-centric"],
        "cloud": ["cloud-centric"],
        "integrated": ["edge-cloud-integrated"],
        "all": list(ALL_DEPLOYMENTS),
    }[args.deployment]

    results = {}
    for name in deps:
        dep = ALL_DEPLOYMENTS[name]()
        ex = BusExecutor(stages, dep, paper_topology(), cost,
                         window_period_s=args.period,
                         quantized_sync=args.quantized)
        res = results[name] = ex.run(stream, bp, 1)
        print(f"\n[{dep.name}] {args.windows} windows, measured Table-3 "
              f"breakdown ({'static' if args.static else 'dynamic'} "
              f"weighting, real LSTM compute"
              f"{', int8 sync' if args.quantized else ''}):")
        _print_table(res.table3(),
                     e2e=res.mean_e2e_s() if res.e2e_s else None)
        sizes = sorted({int(m.nbytes) for m in res.message_log
                        if m.topic == T_MODEL})
        n_pub = sum(m.topic == T_MODEL for m in res.message_log)
        print(f"  model topic: {n_pub} publishes of {sizes} bytes")
        if res.records:
            m = res.to_hybrid_result().mean_rmse()
            print(f"  mean RMSE: batch={m['batch']:.4f} "
                  f"speed={m['speed']:.4f} hybrid={m['hybrid']:.4f}")
        else:
            print("  (no inference windows: window 0 only trains; "
                  "use --windows >= 2)")
        if res.failures:
            print(f"  !! {len(res.failures)} capacity failures "
                  f"(first: {res.failures[0]})")

    if len(deps) < 3:
        return results
    e2e = {n: r.mean_e2e_s() for n, r in results.items()}
    order = sorted(e2e, key=e2e.get)
    checks = table3_claim_checks(results)
    print("\n# paper-claim checks (measured)")
    print("  e2e window latency: " + " < ".join(
        f"{n} ({e2e[n]:.6f}s)" for n in order)
        + f"  [{'PASS' if order == E2E_ORDER else 'FAIL'}]")
    print(f"  edge-centric speed-training capacity failure: "
          f"{'PASS' if results['edge-centric'].failures else 'FAIL'}")
    for claim, ok in checks.items():
        print(f"  {claim}: {'PASS' if ok else 'FAIL'}")
    return results


def run_calibrated(args, device=None) -> Dict[str, Any]:
    """The calibrated simulation (the launcher's default mode): the
    ``CostModel`` measured on ``device`` (the current CUDA device by
    default) by ``launch.calibrate``, then each chosen deployment simulated
    for ``--windows`` windows.  Prints the calibration, each deployment's
    Table-3 breakdown and its failures.  Returns {deployment name:
    SimulationResult}."""
    import dataclasses

    from repro_torch.launch.calibrate import calibrate
    from repro_torch.runtime import (
        EdgeCloudSimulation,
        cloud_centric,
        edge_centric,
        edge_cloud_integrated,
        paper_topology,
    )

    if args.scenario != "gradual":
        # the calibrated path replays measured latency constants; the drift
        # scenario shapes accuracy, not latency, so it changes nothing here
        print(f"(calibrated simulation: --scenario {args.scenario} noted, "
              "but only --real runs data through the models)")
    cal = calibrate(fast=args.fast, device=device)
    cost = cal.cost
    if args.quantized:
        cost = dataclasses.replace(cost, model_nbytes=cost.model_nbytes / 4
                                   + 256)  # int8 weights + f32 scales

    names = {
        "edge": [edge_centric],
        "cloud": [cloud_centric],
        "integrated": [edge_cloud_integrated],
        "all": [edge_centric, cloud_centric, edge_cloud_integrated],
    }[args.deployment]

    print(f"calibration: {cal.details}")
    results = {}
    for factory in names:
        dep = factory()
        sim = EdgeCloudSimulation(dep, paper_topology(), cost,
                                  dynamic_weighting=not args.static)
        res = results[dep.name] = sim.run(args.windows)
        print(f"\n[{dep.name}] {args.windows} windows, "
              f"{'static' if args.static else 'dynamic'} weighting"
              f"{', int8 sync' if args.quantized else ''}")
        _print_table(res.table3())
        if res.failures:
            print(f"  !! {len(res.failures)} failures "
                  f"(first: {res.failures[0]})")
    return results


def run_chaos(args, device=None):
    """One chaos scenario end to end on ``device`` (the current CUDA device
    by default): the fleet pipeline under the named fault plane, its
    degradation envelope printed (see ``core.scenarios``).  Returns the
    scenario's (envelope, FleetBusRunResult)."""
    from repro_torch.core.scenarios import ChaosHarness

    # chaos-sized defaults where the generic flags were left untouched:
    # small fleet, short run, fast virtual period, live query load
    n_streams = args.streams if args.streams > 1 else 3
    n_windows = args.windows if args.windows != 25 else 6
    period = args.period if args.period != 30.0 else 5.0
    qps = args.qps if args.qps > 0 else 8.0

    h = ChaosHarness(n_streams=n_streams, n_windows=n_windows,
                     records_per_window=120, period_s=period, qps=qps,
                     serve_slots=args.slots, verbose=True, device=device)
    seed = args.chaos_seed
    print(f"\n[chaos:{args.chaos}] {n_streams} streams x {n_windows} "
          f"windows, period {period}s, {qps} qps, seed {seed}")
    env, res = h.run_scenario(args.chaos, seed=seed)
    if env["unhandled_exception"] is not None:
        raise SystemExit(f"chaos run crashed: {env['unhandled_exception']}")
    if args.chaos != "fault_free":
        env_ff, _ = h.run_scenario("fault_free", seed=seed)
        ratio = env["rmse_hybrid"] / env_ff["rmse_hybrid"]
        print(f"  hybrid RMSE {env['rmse_hybrid']:.4f} "
              f"(x{ratio:.3f} vs fault-free)")
    else:
        print(f"  hybrid RMSE {env['rmse_hybrid']:.4f}")
    print(f"  answered {env['n_answered']} queries "
          f"(starved {env['n_starved']}), p99 {env['p99_latency_s']*1e3:.1f}"
          f"ms, max served staleness {env['max_staleness']}, "
          f"fallback {env['fallback_frac']:.2f}")
    print(f"  dead letters {env['dead_letters']}, quarantined "
          f"{env.get('quarantined', {})}, corrupt rejected "
          f"{env.get('corrupt_rejected', 0)}, forged rejected "
          f"{env.get('forged_rejected', 0)}, resync requests "
          f"{env.get('resync_requests', 0)}")
    stats = env.get("fault_stats", {})
    if stats:
        print("  fault events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(stats.items())))
    hlt = env.get("health")
    if hlt:
        print(f"  health: {hlt['n_suspected']} suspected, "
              f"{hlt['n_site_down']} down, {hlt['n_recovered']} recovered; "
              f"byzantine {hlt['byz_flagged']}/{hlt['byz_screened']} "
              f"flagged; {hlt['threshold_adaptations']} threshold "
              f"adaptation(s)")
        if hlt.get("detection_latency_s") is not None:
            print(f"  health: fault detected "
                  f"{hlt['detection_latency_s']:.2f}s after onset "
                  f"({hlt['detection_latency_hb_intervals']:.2f} heartbeat "
                  f"intervals)")
    return env, res


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags, refused where the reference's ``main`` refuses
    them; ``--chaos`` must name a scenario."""
    p = argparse.ArgumentParser()
    p.add_argument("--deployment",
                   choices=["edge", "cloud", "integrated", "all"],
                   default="all")
    p.add_argument("--windows", type=int, default=25)
    p.add_argument("--scenario",
                   choices=["none", "gradual", "abrupt", "seasonal"],
                   default="gradual",
                   help="the paper's drift scenario (Sec. 6.1.3): stationary"
                        " stream, Eq. 6 gradual drift, or Eq. 7 abrupt "
                        "drift, plus the seasonal excursion-and-return "
                        "extension")
    p.add_argument("--static", action="store_true",
                   help="static 5:5 weighting instead of dynamic")
    p.add_argument("--quantized", action="store_true",
                   help="int8 model sync: the training site publishes the "
                        "int8 tree and the edge serves it through the int8 "
                        "dequant-matmul kernel")
    p.add_argument("--fast", action="store_true")
    p.add_argument("--real", action="store_true",
                   help="run real LSTM compute through the TopicBus "
                        "(BusExecutor, or FleetBusExecutor with --streams "
                        "> 1); --chaos runs its scenario without it")
    p.add_argument("--period", type=float, default=30.0,
                   help="virtual seconds between stream windows; shrink it "
                        "below the training time to watch stale-model "
                        "inference emerge from event ordering")
    p.add_argument("--streams", type=int, default=1,
                   help="fleet size: >1 multiplexes N correlated turbine "
                        "streams over per-stream topics under one "
                        "deployment, the whole fleet's speed models trained "
                        "in one stacked fit per window")
    p.add_argument("--gated", action="store_true",
                   help="drift-gated retraining (fleet mode): stationary "
                        "streams skip their window's speed training and "
                        "keep serving the prior model")
    p.add_argument("--qps", type=float, default=0.0,
                   help="request plane: open-loop user-query arrival rate "
                        "across the fleet (point, horizon and what-if "
                        "forecast queries on per-stream request topics, "
                        "answered by serving ticks, one stacked predict a "
                        "tick, from the fleet's device-resident models; "
                        "fleet mode, i.e. --real --streams > 1)")
    p.add_argument("--slots", type=int, default=4,
                   help="request plane: fixed batch slots in the "
                        "slot-recycling batcher")
    p.add_argument("--elastic", nargs="?", const="proactive", default=None,
                   choices=["reactive", "proactive"],
                   help="the elastic placement plane (fleet mode): a "
                        "PlacementController migrates hot or queued "
                        "streams to the cloud and cold ones back to the "
                        "edge, and scales Site.workers from queue-depth "
                        "EWMAs; 'proactive' (the default when the flag is "
                        "bare) also scales ahead of load by forecasting "
                        "each site's backlog with a small LSTM on the card")
    p.add_argument("--chaos", default=None,
                   help="run one chaos scenario from core.scenarios "
                        "(fault_free, site_crash, partitioned_sync, "
                        "sensor_chaos, corrupted_int8_sync, forged_sync, "
                        "byzantine, compound_drift) against the fleet under "
                        "a seeded fault plane with the health plane "
                        "attached, and print its degradation envelope and "
                        "health verdicts; honours --streams, --windows, "
                        "--period, --qps and --slots, with chaos-sized "
                        "defaults otherwise")
    p.add_argument("--chaos-seed", type=int, default=0,
                   help="fault-plane seed for --chaos: another seed draws "
                        "another (equally reproducible) fault schedule")
    args = p.parse_args(argv)

    if args.chaos is not None:
        from repro_torch.core.scenarios import SCENARIOS

        if args.chaos not in SCENARIOS:
            p.error(f"--chaos {args.chaos!r}: pick from "
                    f"{', '.join(SCENARIOS)}")
        return args
    if args.streams > 1 and not args.real:
        p.error("--streams > 1 requires --real (the fleet executors run "
                "real compute)")
    if args.gated and args.streams <= 1:
        p.error("--gated requires --streams > 1 (drift-gated retraining is "
                "a fleet-executor policy)")
    if args.qps > 0 and not (args.real and args.streams > 1):
        p.error("--qps requires fleet mode (--real with --streams > 1): the "
                "request plane serves from the fleet executor's "
                "device-resident state")
    if args.elastic and not (args.real and args.streams > 1):
        p.error("--elastic requires fleet mode (--real with --streams > 1): "
                "placement is a per-stream fleet decision")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.chaos is not None:
        run_chaos(args)
    elif args.real and args.streams > 1:
        run_real_fleet(args)
    elif args.real:
        run_real(args)
    else:
        run_calibrated(args)


if __name__ == "__main__":
    main()
