"""The readers of the program's spans (``program_spans.py`` and the
per-layer metrics that use it): nothing without spans, and each metric's
per-request or per-call value from a stubbed set of span totals."""

import types

import pytest

from portbench import harness

from conftest import REPO

# metric: what it reads from TOTALS over 4 requests (q1_host_us: per call)
READERS = {
    "add_ms": 1e3 * 0.2 / 4, "se_ms": 1e3 * 0.1 / 4, "head_ms": 1e3 * 0.02 / 4, "pool_ms": 1e3 * 0.06 / 4,
    "tta_ms": 1e3 * (0.01 + 0.03) / 4, "merge_ms": 1e3 * (0.004 + 0.008 + 0.012) / 4, "q1_host_us": 1e6 * 0.5 / 10000,
}


def _span(calls, host_s, device_s):
    return {"calls": calls, "host_s": host_s, "self_host_s": host_s, "device_s": device_s, "parents": {None: calls},
            "roots": 1}


TOTALS = {"int8.add": _span(80, 0.05, 0.2), "int8.se": _span(64, 0.04, 0.1), "int8.head": _span(4, 0.01, 0.02),
          "int8.pool": _span(12, 0.01, 0.06), "tta.augment": _span(8, 0.001, 0.01), "tta.deaugment": _span(8, 0.002, 0.03),
          "tiles.stack": _span(8, 0.001, 0.004), "tiles.merge": _span(4, 0.001, 0.008),
          "tiles.integrate": _span(12, 0.003, 0.012), "int8.forward": _span(4, 0.9, 0.8),
          "q1.call": _span(10000, 0.5, 0.0)}


def _reader(name):
    return harness.load_module(REPO / "portbench" / "metrics" / f"{name}.py")


def _ctx(requests=4, events=((0.0, 1.0, "kernel"),)):
    return types.SimpleNamespace(requests=requests, events=list(events))


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_takes_its_spans_per_request(name, monkeypatch):
    from pytorch_toolbelt_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)
    assert _reader(name).read(_ctx()) == pytest.approx(READERS[name], rel=1e-12)
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert _reader(name).read(_ctx()) is None  # a cell whose requests enter none of its spans
    no_card = {k: dict(v, device_s=0.0) for k, v in TOTALS.items()}
    monkeypatch.setattr(profiling, "span_totals", lambda: no_card)
    assert _reader(name).read(_ctx(events=())) is None  # a run on the CPU
    monkeypatch.delattr(profiling, "span_totals")
    assert _reader(name).read(_ctx()) is None  # a program without spans


def test_every_reader_of_the_programs_spans_is_a_metric_of_the_benchmark():
    cells = {name: harness.Cell(name) for name in ("unet32-int8.d4-5000", "seresnext50-fpn-int8.msd4-1024",
                                                   "seresnext50-fpn-int8.stream-5000")}
    taken = {m["name"]: m for cell in cells.values() for m in cell.per_layer if m["name"] in READERS}
    assert set(taken) == set(READERS)
    assert all(m["source"] == "program_span" and m["moves"] == "mpix_per_s" for m in taken.values())
