"""The int8 encoder-decoder's forward eager against replayed from its CUDA
graphs, at the forward calls of one cell of ``portbench/`` (built as its
harness builds it: seeded weights, calibration, the program's model):

* per forward call (each input key the cell's requests send), the host's
  µs to issue the call from an idle card and the card's ms between CUDA
  events around it, medians of ``--calls`` calls, eager and graphed;
* one whole request of the cell, eager and graphed (ms, host clock to the
  map on the card);
* the kernels, copies and memsets of one call under ``torch.profiler``, and
  its graph launches;
* what the spans' event pairs inside a graph cost when no profiler reads
  them: the card's ms a replay of the eager forward captured plainly and
  captured with its spans (``profiling.capture_spans``), in alternating
  rounds of ``--reps`` replays.

On one CUDA card; the numbers also go to ``chiprun_out/int8_graph_probe_<cell>.json``.

    python probes/int8_graph_probe.py [--workload seresnext50-fpn-int8.msd4-1024] [--seed N] [--calls N] \
        [--rounds N] [--reps N]
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def _call(fn, x):
    """(host µs to issue fn(x) from an idle card, card ms between events around it)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn(x)
    end.record()
    host_us = (time.perf_counter() - t0) * 1e6
    end.synchronize()
    return host_us, start.elapsed_time(end)


def _medians(fn, x, calls: int) -> dict:
    fn(x)  # a graphed key's first call captures
    times = [_call(fn, x) for _ in range(calls)]
    return {"host_us": statistics.median(t[0] for t in times), "card_ms": statistics.median(t[1] for t in times),
            "card_ms_min_max": [min(t[1] for t in times), max(t[1] for t in times)]}


def _profiled(fn, x) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return {"device_ops": len(device), "kernels": sum(not e.name.startswith(("Memcpy", "Memset")) for e in device),
            "graph_launches": sum(e.name == "cudaGraphLaunch" for e in events),
            "kernel_launches": sum(e.name == "cudaLaunchKernel" or e.name == "cuLaunchKernel" for e in events)}


def _event_nodes(fn, x, rounds: int, reps: int) -> dict:
    from pytorch_toolbelt_tpu_torch.utils import profiling

    fn(x)  # warms every shape up: nothing is made from the host inside a capture
    static, pool, graphs = x.clone(), torch.cuda.graph_pool_handle(), {}
    for kind in ("plain", "events"):
        graph, spans = torch.cuda.CUDAGraph(), profiling.GraphSpans()
        with profiling.capture_spans(spans) if kind == "events" else contextlib.nullcontext():
            with torch.cuda.graph(graph, pool=pool):
                fn(static)
        graphs[kind] = graph, len(spans.records) if kind == "events" else 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {kind: [] for kind in graphs}
    for k in range(rounds):
        for kind in (("plain", "events") if k % 2 == 0 else ("events", "plain")):
            graph = graphs[kind][0]
            graph.replay()
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                graph.replay()
            end.record()
            end.synchronize()
            times[kind].append(start.elapsed_time(end) / reps)
    plain, events = (statistics.median(times[kind]) for kind in ("plain", "events"))
    return {"event_pairs": graphs["events"][1], "plain_ms": plain, "events_ms": events,
            "cost_pct": (events - plain) / plain * 100, "rounds_ms": times}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="seresnext50-fpn-int8.msd4-1024")
    parser.add_argument("--seed", type=int, default=2**31 + 11)
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    from portbench import entries, harness, inputs, weights
    from portbench.spans import Spans

    if not torch.cuda.is_available():
        print("int8_graph_probe: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    cfg, traffic = cell.cfg, cell.traffic
    w = weights.make(cell.reference.param_spec(cfg), device, inputs.subseed(args.seed, "weights"))
    cal = inputs.calibration_images(cfg, device, inputs.subseed(args.seed, "calibration"))
    pool = inputs.image_pool(traffic, device, inputs.subseed(args.seed, "images"))
    forward = cell.builder.build(cfg, w, cal, device)
    if not hasattr(forward, "eager"):
        print("int8_graph_probe: the program's forward has no graphs", file=sys.stderr)
        return 2
    keys = sorted(set(entries.views(traffic, tuple(pool[0].shape[:2]))), reverse=True)
    if traffic["entry"] == "stream":  # batches of the cell's batch size and the tail
        n = keys[0][0]
        keys = sorted({(min(traffic["batch"], n - s), keys[0][1], keys[0][2]) for s in range(0, n, traffic["batch"])},
                      reverse=True)
    gen = torch.Generator(device=device).manual_seed(args.seed % 2**63)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"workload": args.workload, "device": smi, "calls": args.calls, "forward": {}}
    for n, h, wd in keys:
        x = torch.rand(n, 3, h, wd, generator=gen, device=device)
        row = {"eager": _medians(forward.eager, x, args.calls), "graphed": _medians(forward, x, args.calls)}
        row["eager"].update(_profiled(forward.eager, x))
        row["graphed"].update(_profiled(forward, x))
        row["bit_equal"] = bool(torch.equal(forward(x), forward.eager(x)))
        row["event_nodes"] = _event_nodes(forward.eager, x, args.rounds, args.reps)
        result["forward"][f"{n}x{h}x{wd}"] = row

    def serve(fn, image):
        entry = entries.ENTRIES[traffic["entry"]](traffic, fn, device, Spans(), cfg["num_classes"])
        try:
            entry.serve(image)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.serve(image)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        finally:
            if hasattr(entry, "close"):
                entry.close()

    result["request_ms"] = {"eager": [serve(forward.eager, pool[i % len(pool)]) for i in range(3)],
                            "graphed": [serve(forward, pool[i % len(pool)]) for i in range(3)]}
    out = ROOT / "chiprun_out" / f"int8_graph_probe_{args.workload}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"{args.workload} on {smi}: medians of {args.calls} calls")
    for key, row in result["forward"].items():
        for kind in ("eager", "graphed"):
            r = row[kind]
            print(f"  {key:14s} {kind:7s} host {r['host_us']:9.1f} us  card {r['card_ms']:8.3f} ms "
                  f"[{r['card_ms_min_max'][0]:.3f}-{r['card_ms_min_max'][1]:.3f}]  device ops {r['device_ops']} "
                  f"(kernels {r['kernels']}), graph launches {r['graph_launches']}, kernel launches "
                  f"{r['kernel_launches']}")
        print(f"  {key:14s} graphed equals eager bit for bit: {row['bit_equal']}")
        e = row["event_nodes"]
        print(f"  {key:14s} a replay of the eager forward: plain {e['plain_ms']:.4f} ms, with its "
              f"{e['event_pairs']} span event pairs {e['events_ms']:.4f} ms ({e['cost_pct']:+.3f}%; medians of "
              f"{args.rounds} rounds of {args.reps})")
    for kind, ms in result["request_ms"].items():
        print(f"  request {kind:7s} " + ", ".join(f"{v:.2f}" for v in ms) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
