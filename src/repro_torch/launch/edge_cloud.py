"""Edge-cloud deployment launcher: the paper's three deployments on real
LSTM compute, scheduled on the TopicBus by ``BusExecutor``, with each
stage's wall measured on the card and rescaled to its site's hardware class
(paper Table 3, Sec. 6.2).

    PYTHONPATH=src python -m repro_torch.launch.edge_cloud --real \\
        --deployment all --fast [--quantized] [--period S] [--windows N] \\
        [--scenario none|gradual|abrupt|seasonal] [--static]
    PYTHONPATH=src python -m repro_torch.launch.edge_cloud --real \\
        --streams 8 --windows 4 --fast --gated --deployment integrated
    PYTHONPATH=src python -m repro_torch.launch.edge_cloud --real \\
        --streams 8 --windows 4 --fast --qps 20 --slots 4 --elastic \\
        --deployment integrated [--quantized]

It prints each deployment's Table-3 breakdown, its mean end-to-end window
latency and model-topic bytes, and the paper's claims as measured, PASS or
FAIL.  With ``--streams N > 1`` it runs a fleet of N correlated turbines
through ``FleetBusExecutor`` (``--gated``: drift-gated retraining;
``--quantized``: per-stream int8 sync; ``--qps``/``--slots``: the request
plane, user queries answered by serving ticks on ``--slots`` batch slots;
``--elastic [reactive|proactive]``: the placement plane) and prints the
request plane's and the placement plane's lines.  The reference's other
modes (``--chaos``, the calibrated simulation) raise, naming the slice that
brings each.
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


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags; a mode the port has not yet is an error that
    names the slice bringing it."""
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
                        "> 1); the port has no other mode yet")
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
    # the reference's chaos scenarios, refused until their slice lands
    p.add_argument("--chaos", default=None)
    args = p.parse_args(argv)

    if args.chaos is not None:
        p.error("--chaos: the chaos scenarios come with the port's chaos and "
                "health slice")
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
    if not args.real:
        p.error("the calibrated simulation (the default without --real) "
                "replays benchmarks/calibrate.py's constants and comes with "
                "the slice that ports the benchmarks; pass --real")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.streams > 1:
        run_real_fleet(args)
    else:
        run_real(args)


if __name__ == "__main__":
    main()
