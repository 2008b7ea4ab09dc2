"""Where the card waits inside the port: one cell of ``portbench/`` built and
warmed up as its harness does, a few requests served under
``torch.profiler``, and

* each gap in the card's work summed by the port's innermost span
  (``ptt.*``, ``utils/profiling.py``), the innermost host op and the
  innermost CUDA runtime call open where the gap starts;
* the host's time in each runtime call that waits for the card
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``, a blocking ``cudaMemcpy``) by the same keys;
* the port's span totals (``span_totals()``) per request;
* the kernels inside each span: each kernel under the innermost span open
  on the host where the runtime call that launched it started (the spans'
  fast ranges leave no range on the card's timeline).

All in ms per request, on one CUDA card; the full lists go to
``chiprun_out/span_gaps_<cell>.json``.

    python probes/span_gaps.py --workload <cell> [--seed N] [--requests N]
"""

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
TOP = 12


def _kind(name: str) -> str:
    if name.startswith("ptt."):
        return "span"
    if name.startswith("portbench."):
        return "bench"
    return "runtime" if name.startswith("cuda") else "op"


def _where(host, points):
    """For each time in ``points`` (ascending), the innermost open (span, op,
    runtime call) of the host events (start, end, name), sorted by start."""
    stacks = {"span": [], "op": [], "runtime": [], "bench": []}
    out, i = [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            s, e, name = host[i]
            stack = stacks[_kind(name)]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        for stack in stacks.values():
            while stack and stack[-1][1] <= t:
                stack.pop()
        out.append(" / ".join(stacks[k][-1][2] if stacks[k] else "-" for k in ("span", "op", "runtime")))
    return out


def _by_host_launch(prof, host, n):
    """{innermost span open on the host at the launch: {kernel: ms a request}},
    a kernel matched to its runtime call by the profiler's correlation id."""
    from torch.autograd import DeviceType

    from portbench import trace

    launches = {e.id: e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CPU and "Launch" in e.name}
    kernels = sorted((launches[e.id], e.time_range.end - e.time_range.start, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                     and e.id in launches)
    inside = defaultdict(lambda: defaultdict(float))
    for (_, us, name), key in zip(kernels, _where(host, [t for t, _, _ in kernels])):
        inside[key.split(" / ")[0]][trace.short(name)] += us / 1e3 / n
    return inside


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=2**31 + 7)
    parser.add_argument("--requests", type=int, default=4)
    args = parser.parse_args()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench import entries, harness, inputs, trace, weights
    from portbench.spans import Spans
    from pytorch_toolbelt_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("span_gaps: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    cfg, traffic = cell.cfg, cell.traffic
    w = weights.make(cell.reference.param_spec(cfg), device, inputs.subseed(args.seed, "weights"))
    cal = inputs.calibration_images(cfg, device, inputs.subseed(args.seed, "calibration"))
    pool = inputs.image_pool(traffic, device, inputs.subseed(args.seed, "images"))
    spans = Spans()
    entry = entries.ENTRIES[traffic["entry"]](traffic, cell.builder.build(cfg, w, cal, device), device, spans,
                                               cfg["num_classes"])

    def serve(i):
        with spans("request"):
            entry.serve(pool[i % len(pool)])
            torch.cuda.synchronize(device)

    for i in range(traffic["warmup"]):
        serve(i)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.requests):
            serve(i)
    if hasattr(entry, "close"):
        entry.close()

    n = args.requests
    lo, hi = trace.window(prof)
    device_events = trace.clip(trace.device_events(prof), lo, hi)
    gaps, end = [], lo
    for a, b, _ in device_events:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    threads = {e.thread for e in cpu if e.name == "portbench.request"}
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu if e.thread in threads)
    idle = defaultdict(float)
    for (g0, g1), key in zip(gaps, _where(host, [g0 for g0, _ in gaps])):
        idle[key] += (g1 - g0) / 1e3 / n
    waits = [(s, e, name) for s, e, name in host if name.startswith(WAITS) and "Async" not in name]
    waited = defaultdict(float)
    for (s, e, name), key in zip(waits, _where(host, [s for s, _, _ in waits])):
        waited[key.rsplit(" / ", 1)[0] + " / " + name] += (e - s) / 1e3 / n
    totals = {name: {"calls": t["calls"] / n, **{k[:-1] + "ms": 1e3 * t[k] / n for k in ("host_s", "self_host_s",
                                                                                        "device_s")}}
              for name, t in profiling.span_totals().items()}  # a request's calls and ms
    busy_ms = trace.busy_s(device_events) * 1e3 / n
    kernels = {span: sorted(ks.items(), key=lambda kv: -kv[1]) for span, ks in _by_host_launch(prof, host, n).items()}
    result = {"workload": args.workload, "requests": args.requests, "device": torch.cuda.get_device_name(device),
              "window_ms_per_request": (hi - lo) / 1e3 / n, "busy_ms_per_request": busy_ms,
              "idle_ms": sorted(idle.items(), key=lambda kv: -kv[1]),
              "wait_ms": sorted(waited.items(), key=lambda kv: -kv[1]), "span_ms_per_request": totals,
              "kernels_ms": kernels}
    out = ROOT / "chiprun_out" / f"span_gaps_{args.workload}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"{args.workload}: {args.requests} requests, window {result['window_ms_per_request']:.3f} ms a request, "
          f"busy {busy_ms:.3f}")
    print("idle ms a request (span / op / runtime call at the gap's start):")
    for key, ms in result["idle_ms"][:TOP]:
        print(f"  {ms:9.4f}  {key}")
    print("host ms a request waiting for the card (span / op / call):")
    for key, ms in result["wait_ms"][:TOP]:
        print(f"  {ms:9.4f}  {key}")
    print("spans a request (calls; host, self host and card ms):")
    for name, t in sorted(totals.items()):
        print(f"  {name:16s} {t['calls']:8.2f}  host {t['host_ms']:9.4f}  self {t['self_host_ms']:9.4f}"
              f"  device {t['device_ms']:9.4f}")
    print("kernels inside each span, by the span open at the launch (ms a request):")
    for span, ks in sorted(kernels.items()):
        print(f"  {span:16s} " + "; ".join(f"{k} {ms:.4f}" for k, ms in ks[:TOP]) +
              (f"; {len(ks) - TOP} more" if len(ks) > TOP else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
