"""One run of one cell: set-up, the measured window (or the traced one), the
comparison with the plain reference that decides ``correct``, and the
result line.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names its
configuration and traffic; ``configs/<config>.json`` holds the sizes,
``configs/<config>.py`` builds the program's model and
``reference/<config>.py`` is its plain reference; ``traffic/<traffic>.json``
holds the mix; ``limits/<cell>.json`` the limits of the numbers compared;
``metrics/<quantity>.py`` reads one per-layer metric from the traced window.

A metric's name is ``<quantity>`` or ``<quantity>.<qualifier>``: the part
before the first dot says what is measured (``mpix_per_s``, ``idle_pct``)
and which reader takes it; a qualifier gives cells whose runs spread
differently a metric, and a bound, of their own (as ``mpix_per_s.stream``
would be).
"""

import gc
import importlib.util
import json
import math
import random
import statistics
import sys
import time
import traceback
import types
from pathlib import Path

import torch

from portbench import entries, inputs, trace, weights, yardstick
from portbench.reference import entries as ref_entries
from portbench.spans import Spans

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_toolbelt_tpu")  # top-level module names, compared whole


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}".replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _applies(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def quantity(metric_name: str) -> str:
    return metric_name.split(".")[0]


class Cell:
    """A workload of ``BENCHMARK.json`` with its files resolved by name."""

    def __init__(self, name: str, root: Path = HERE.parent):
        """``root`` holds ``BENCHMARK.json`` and the benchmark's folder ``portbench``."""
        home = Path(root) / "portbench"
        bench = load_json(Path(root) / "BENCHMARK.json")
        self.name, self.bench = name, bench
        self.workload = next((w for w in bench["workloads"] if w["name"] == name), None)
        if self.workload is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        self.config_name, self.traffic_name = self.workload["config"], self.workload["traffic"]
        self.cfg = load_json(home / "configs" / f"{self.config_name}.json")
        self.traffic = load_json(home / "traffic" / f"{self.traffic_name}.json")
        self.limits = load_json(home / "limits" / f"{name}.json")
        self.reference = load_module(home / "reference" / f"{self.config_name}.py")
        self.builder = load_module(home / "configs" / f"{self.config_name}.py")
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
        self.readers = {m["name"]: load_module(home / "metrics" / f"{quantity(m['name'])}.py")
                        for m in self.per_layer}


def gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers compared: the largest and the RMS difference between the
    program's map and the reference's, each relative to the reference's own
    largest and RMS value; inf where the shapes differ or a value is not
    finite."""
    if tuple(got.shape) != tuple(want.shape) or not bool(torch.isfinite(got).all()):
        return {"max_gap": math.inf, "rms_gap": math.inf}
    d_max = r_max = d_sq = r_sq = 0.0
    for g, w in zip(got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)):  # channel by channel
        d = g.to(w.device, torch.float64) - w.double()
        d_max, r_max = max(d_max, float(d.abs().max())), max(r_max, float(w.abs().max()))
        d_sq, r_sq = d_sq + float(d.square().sum()), r_sq + float(w.double().square().sum())
    return {"max_gap": d_max / max(r_max, 1e-30), "rms_gap": math.sqrt(d_sq / max(r_sq, 1e-30))}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, traced: bool, t_process: float, device="cuda", overrides=None,
        root: Path = HERE.parent) -> tuple:
    """One run; returns (result dict, lines for standard error).  ``overrides``
    replaces traffic and configuration keys (the tests' small sizes)."""
    cell = Cell(workload, root)
    cfg, traffic = dict(cell.cfg), dict(cell.traffic)
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = value
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialised
        torch.cuda.reset_peak_memory_stats(device)
    spec = cell.reference.param_spec(cfg)

    # ---- set-up: inputs and weights from the seed, the program built and calibrated, every shape warmed up
    phases = [("start", time.perf_counter())]
    w = weights.make(spec, device, inputs.subseed(seed, "weights"))
    cal = inputs.calibration_images(cfg, device, inputs.subseed(seed, "calibration"))
    pool = inputs.image_pool(traffic, device, inputs.subseed(seed, "images"))
    _sync(device)
    phases.append(("inputs", time.perf_counter()))
    forward = cell.builder.build(cfg, w, cal, device)
    _sync(device)
    phases.append(("build", time.perf_counter()))
    del w
    spans = Spans()
    entry = entries.ENTRIES[traffic["entry"]](traffic, forward, device, spans, cfg["num_classes"])
    outs = []

    def serve(i: int, slot: int) -> None:
        image = pool[i % len(pool)]
        with spans("request"):
            y = entry.serve(image)
            with spans("d2h"):
                if not outs:
                    outs.extend(torch.empty(y.shape, dtype=y.dtype, pin_memory=on_card) for _ in range(2))
                outs[slot].copy_(y, non_blocking=True)
                _sync(device)

    for i in range(traffic["warmup"]):
        serve(i, 0)
    spans.reset()
    _sync(device)
    phases.append(("warm-up", time.perf_counter()))

    # ---- the window: a closed loop, one request in flight; one request of the window is kept for the check
    sampler = random.Random(inputs.subseed(seed, "sample"))
    latencies, done, failed, kept, slot = [], [], 0, None, 0
    t_start = time.perf_counter()
    setup_s = t_start - t_process

    def one(i: int):
        nonlocal failed, kept, slot
        t0 = time.perf_counter()
        try:
            serve(i, slot)
        except Exception:  # a request that fails counts against the run; the loop goes on
            traceback.print_exc()
            failed += 1
            return
        latencies.append(time.perf_counter() - t0)
        done.append(i)
        if sampler.randrange(len(done)) == 0:  # reservoir of one over the completed requests
            kept, slot = (i, slot), 1 - slot

    if traced:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            for i in range(traffic["trace_requests"]):
                one(i)
    else:
        t_end = t_start + seconds
        i = 0
        while time.perf_counter() < t_end:
            one(i)
            i += 1
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    attempted = len(done) + failed

    # ---- metrics
    megapixels = sum(pool[i % len(pool)].shape[0] * pool[i % len(pool)].shape[1] for i in done) / 1e6
    metrics, device_info, breakdown = {}, {}, None
    if traced:
        host_spans = dict(spans.seconds)
        events, lo, hi = trace.device_events(prof), *trace.window(prof)
        events = trace.clip(events, lo, hi)
        ctx = types.SimpleNamespace(
            events=events, window_s=(hi - lo) / 1e6, busy_s=trace.busy_s(events), requests=len(done),
            spans=host_spans, cfg=cfg, traffic=traffic, reference=cell.reference, yardstick=yardstick,
            request_views=[entries.views(traffic, tuple(pool[i % len(pool)].shape[:2])) for i in done])
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
        breakdown = {"device_ops": trace.top_device_ops(events), "idle_gaps": trace.idle_gaps(prof, events, lo, hi)}
        del prof
    else:
        values = {"mpix_per_s": megapixels / window_s, "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        if len(latencies) >= 2:
            values["latency_p95_ms"] = 1e3 * statistics.quantiles(latencies, n=100, method="inclusive")[94]
        for m in cell.end_to_end:
            if quantity(m["name"]) in values:
                metrics[m["name"]] = {"value": values[quantity(m["name"])], "unit": m["unit"]}

    # ---- the check: the kept request against the reference, once the program's state is freed
    if hasattr(entry, "close"):  # an entry's own threads end with the window
        entry.close()
    del entry, forward
    if "pytorch_toolbelt_tpu_torch.inference" in sys.modules:
        sys.modules["pytorch_toolbelt_tpu_torch.inference"].clear_tiled_cache()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = {name: {"value": math.inf, "limit": limit} for name, limit in cell.limits.items()}
    if kept is not None:
        want = reference_output(cell, cfg, traffic, seed, cal, pool[kept[0] % len(pool)], device)
        for name, value in gaps(outs[kept[1]], want).items():
            checks[name]["value"] = value
        del want
    correct = failed == 0 and kept is not None and all(c["value"] <= c["limit"] for c in checks.values())

    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1,
                         "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"{workload} seed {seed}: {len(done)} requests, {failed} failed, window {window_s:.3f} s, "
             f"set-up {setup_s:.3f} s (imports and card {phases[0][1] - t_process:.3f}, "
             + ", ".join(f"{name} {t - phases[k][1]:.3f}" for k, (name, t) in enumerate(phases[1:]))
             + f"), kept request {kept[0] if kept else None}; host spans (s): "
             + ", ".join(f"{name} {v:.3f}" for name, v in sorted(spans.seconds.items()))]
    lines += [f"check {k} {c['value']!r} <= {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def reference_output(cell, cfg, traffic, seed, cal, image, device, qmax=None) -> torch.Tensor:
    """The reference's map for one request: the same seeded weights made
    anew, its own calibration and integer network, its own entry."""
    w = weights.make(cell.reference.param_spec(cfg), device, inputs.subseed(seed, "weights"))
    kwargs = {} if qmax is None else {"qmax": qmax}
    model = cell.reference.Model(cfg, w, cal, **kwargs)
    del w
    with torch.no_grad():
        return ref_entries.ENTRIES[traffic["entry"]](traffic, model, image, device)
