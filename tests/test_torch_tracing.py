"""The port's spans (``utils/profiling.py`` ``span``): off without a
profiler, the names, counts, parents, roots and self times the layers
record under one, and the int8 models' outputs unchanged by them.  The
cases build small int8 models and tilings on the CPU; the ``cuda`` case
times the card between the spans' events."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pytorch_toolbelt_tpu_torch.inference import MultiscaleTTA, TileMerger, d4_image2mask, tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.utils import profiling
from pytorch_toolbelt_tpu_torch.zoo import (
    EncoderDecoderModel,
    FPNDecoder,
    ResizeHead,
    UNetSegmentationModel,
    quantize_encoder_decoder_inference,
    quantize_unet_inference,
)
from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE
from pytorch_toolbelt_tpu_torch.zoo.encoders.resnet import ResNetEncoder, seresnext50_encoder


def _unet(device="cpu"):
    torch.manual_seed(0)
    model = UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3).eval().to(device)
    return quantize_unet_inference(model, torch.rand(2, 3, 32, 32, device=device)), 3


def _encdec_model(device="cpu"):
    torch.manual_seed(0)
    enc = ResNetEncoder(stage_blocks=(1, 1, 1, 1), bottleneck=False, use_se=True)
    dec = FPNDecoder(enc.get_output_spec(), out_channels=16)
    return EncoderDecoderModel(enc, dec, ResizeHead(dec.get_output_spec(), num_classes=5)).eval().to(device)


def _encdec(device="cpu"):
    model = _encdec_model(device)
    return quantize_encoder_decoder_inference(model, torch.rand(2, 3, 64, 64, device=device)), model


def _graph_ops(model) -> collections.Counter:
    g, _, _ = TQE._build_encdec_graph(model)
    return collections.Counter(node.op for node in g.nodes)


@pytest.fixture(scope="module")
def models():
    unet, unet_layers = _unet()
    encdec, model = _encdec()
    return dict(unet=unet, unet_layers=unet_layers, encdec=encdec, encdec_ops=_graph_ops(model))


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    profiling.reset_spans()
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, profiling.span_totals(), prof


# each case: the call, and from the models its expected {span: (calls, {parent: calls}, roots)}
def _case_tiled_d4(m):
    image = torch.rand(3, 40, 40)
    fn = lambda: tiled_apply_d4_tta(m["unet"], image, tile_size=16, tile_step=8, batch_size=4)  # noqa: E731
    # 16 tiles in four parity groups of 4: one batch each
    n = 4
    return fn, {"tiles.apply": (1, {None: 1}, 1), "tiles.stack": (n, {"tiles.apply": n}, 1),
                "tiles.merge": (1, {"tiles.apply": 1}, 1), "tta.augment": (n, {"tiles.apply": n}, 1),
                "tta.deaugment": (n, {"tiles.apply": n}, 1), "int8.forward": (n, {"tiles.apply": n}, 1),
                "int8.pool": (n * (m["unet_layers"] - 1), {"int8.forward": n * (m["unet_layers"] - 1)}, 1),
                "int8.head": (n, {"int8.forward": n}, 1)}


def _case_multiscale(m):
    x = torch.rand(1, 3, 64, 64)
    fn = lambda: MultiscaleTTA(lambda v: d4_image2mask(m["encdec"], v), size_offsets=[0, -32])(x)  # noqa: E731
    ops = m["encdec_ops"]
    per = lambda k, n=1: (2 * n * ops[k], {"int8.forward": 2 * n * ops[k]}, 1)  # noqa: E731
    # the head's span twice a forward: its conv and dequant, then the resize to the input's size
    return fn, {"tta.multiscale": (1, {None: 1}, 1), "tta.augment": (3, {"tta.multiscale": 3}, 1),
                "tta.deaugment": (3, {"tta.multiscale": 3}, 1), "int8.forward": (2, {"tta.multiscale": 2}, 1),
                "int8.add": per("add"), "int8.se": per("se"), "int8.head": per("head", 2),
                "int8.pool": per("maxpool3s2")}


def _case_encdec_forward(m):
    x = torch.rand(2, 3, 32, 32)
    ops = m["encdec_ops"]
    return (lambda: m["encdec"](x)), {
        "int8.forward": (1, {None: 1}, 1), "int8.add": (ops["add"], {"int8.forward": ops["add"]}, 1),
        "int8.se": (ops["se"], {"int8.forward": ops["se"]}, 1), "int8.head": (2, {"int8.forward": 2}, 1),
        "int8.pool": (1, {"int8.forward": 1}, 1)}


def _case_tile_merger(m):
    tiles, coords = torch.rand(6, 2, 8, 8), np.array([[x, y, 8, 8] for y in (0, 4, 8) for x in (0, 8)])

    def fn():
        merger = TileMerger((16, 16), channels=2, weight=np.ones((8, 8), np.float32), device="cpu", use_pallas=True)
        for start in range(0, 6, 2):
            merger.integrate_batch(tiles[start:start + 2], coords[start:start + 2])
        return merger.merge()

    return fn, {"tiles.integrate": (3, {None: 3}, 3), "tiles.merge": (1, {None: 1}, 1)}


CASES = {"tiled_d4": _case_tiled_d4, "multiscale_d4": _case_multiscale, "encdec_forward": _case_encdec_forward,
         "tile_merger": _case_tile_merger}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_under_a_profiler(models, case):
    fn, want = CASES[case](models)
    untraced = fn()
    out, totals, prof = _traced(fn)
    assert torch.equal(out, untraced)  # the spans change nothing the program computes
    assert {name: (t["calls"], t["parents"], t["roots"]) for name, t in totals.items()} == want
    assert {e.name for e in prof.events() if e.name.startswith("ptt.")} == {"ptt." + name for name in want}
    for name, t in totals.items():
        assert 0 < t["self_host_s"] <= t["host_s"] and t["device_s"] == 0.0  # no card: host time only
        children = sum(c["host_s"] for c in totals.values() if name in c["parents"] and c is not t)
        assert t["host_s"] - t["self_host_s"] == pytest.approx(children, rel=1e-6, abs=1e-9)
    # no span inside a span of its own name, on the profiler's own timeline
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("ptt."):
            ranges[(e.name, e.thread)].append((e.time_range.start, e.time_range.end))
    for spans in ranges.values():
        spans.sort()
        assert all(b[0] >= a[1] for a, b in zip(spans, spans[1:]))


def test_a_span_without_a_profiler_is_the_shared_noop(models, monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "_range", lambda name: entered.append(name))
    profiling.reset_spans()
    assert profiling.span("int8.add") is profiling.span("q1.call", device=False) is profiling._OFF
    with profiling.span("tiles.merge", torch.zeros(1)) as s:
        assert s is profiling._OFF
    fn, _ = _case_tiled_d4(models)
    fn()
    models["encdec"](torch.rand(1, 3, 32, 32))
    assert entered == [] and profiling.span_totals() == {}


def test_a_span_opened_inside_its_own_name_is_not_counted_again():
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            assert profiling.span("a") is profiling._OFF
            with profiling.span("b"):
                with profiling.span("a"):
                    pass
        with profiling.span("a"):
            pass
    totals = profiling.span_totals()
    assert {n: (t["calls"], t["parents"], t["roots"]) for n, t in totals.items()} == {
        "a": (2, {None: 2}, 2), "b": (1, {"a": 1}, 1)}
    profiling.reset_spans()
    assert profiling.span_totals() == {}


def test_spans_from_many_threads_lose_no_call(monkeypatch):
    """Each thread keeps its own stack of open spans; the sums take every
    call.  torch's profiler records the thread that started it, so this
    test stands in for it on every thread."""
    import contextlib

    threads, calls = 16, 200
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(profiling, "_range", lambda name: contextlib.nullcontext())

    def work():
        for _ in range(calls):
            with profiling.span("outer", device=False):
                with profiling.span("inner", device=False):
                    pass

    profiling.reset_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    totals = profiling.span_totals()
    n = threads * calls
    assert {k: (t["calls"], t["parents"], t["roots"]) for k, t in totals.items()} == {
        "outer": (n, {None: n}, n), "inner": (n, {"outer": n}, n)}


class _FakeEvent:
    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t  # ms


def test_a_long_profile_sums_the_spans_the_card_has_passed(monkeypatch):
    """Past the limit of spans not summed, a span sums, oldest first, those
    whose events the card has passed and gives the events back to the pool;
    the rest wait for ``span_totals``."""
    totals = profiling._totals
    profiling.reset_spans()
    monkeypatch.setattr(totals, "free", collections.defaultdict(list))
    pairs = [("a", _FakeEvent(0.0), _FakeEvent(2.0)), ("b", _FakeEvent(0.0), _FakeEvent(5.0)),
             ("a", _FakeEvent(0.0), _FakeEvent(7.0, done=False)), ("a", _FakeEvent(0.0), _FakeEvent(1.0))]
    totals.closed = [(name, None, k, 1.0, 1.0, start, end, 0) for k, (name, start, end) in enumerate(pairs, 1)]
    totals.fold(wait=False)
    assert [r[0] for r in totals.closed] == ["a", "a"] and totals.closed[0][6].t == 7.0
    assert totals.sums["a"].device_s == pytest.approx(2e-3) and totals.sums["b"].device_s == pytest.approx(5e-3)
    assert len(totals.free[0]) == 4
    monkeypatch.setattr(torch.cuda, "synchronize", lambda index: None)
    totals.closed[0][6].done = True
    got = profiling.span_totals()
    assert totals.closed == [] and len(totals.free[0]) == 8
    assert got["a"]["device_s"] == pytest.approx(1e-2) and (got["a"]["calls"], got["a"]["roots"]) == (3, 3)
    profiling.reset_spans()


def test_the_seresnext50_fpn_graph_has_20_adds_16_se_gates_and_a_head():
    """The counts the benchmark's per-request span totals divide into: 16
    residual adds and 4 FPN top-down adds, one SE gate a bottleneck."""
    enc = seresnext50_encoder()
    dec = FPNDecoder(enc.get_output_spec(), out_channels=128)
    model = EncoderDecoderModel(enc, dec, ResizeHead(dec.get_output_spec(), num_classes=19))
    ops = _graph_ops(model)
    assert (ops["add"], ops["se"], ops["head"], ops["maxpool3s2"]) == (20, 16, 1, 1)


@pytest.mark.cuda
def test_spans_time_the_card_and_change_nothing_there():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    encdec, model = _encdec("cuda")
    unet, _ = _unet("cuda")
    x = torch.rand(2, 3, 64, 64, device="cuda")
    want_encdec, want_unet = encdec(x), unet(x)
    (got_encdec, got_unet), totals, prof = _traced(lambda: (encdec(x), unet(x)),
                                                   (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    assert torch.equal(got_encdec, want_encdec) and torch.equal(got_unet, want_unet)
    # the spans are host ranges: nothing on the card's timeline that a reader of kernels would count
    names = {(e.device_type, e.name) for e in prof.events() if e.name.startswith("ptt.")}
    assert {d for d, _ in names} == {DeviceType.CPU} and {"ptt.int8.graph", "ptt.int8.pool"} <= {n for _, n in names}
    ops = _graph_ops(model)
    # the encoder-decoder replays its CUDA graph: the spans inside it count once a replay, under int8.graph
    assert totals["int8.graph"]["calls"] == 1 and totals["int8.graph"]["device_s"] > 0
    assert totals["int8.add"]["calls"] == ops["add"] and totals["int8.add"]["device_s"] > 0
    assert totals["int8.add"]["parents"] == {"int8.graph": ops["add"]}
    # the encoder-decoder's head in the graph and its resize after it, the UNet's head
    assert totals["int8.head"]["calls"] == 3 and totals["int8.head"]["device_s"] > 0
    assert totals["q1.call"]["calls"] > 0 and totals["q1.call"]["device_s"] == 0.0
    assert totals["q1.call"]["parents"].get("int8.forward", 0) > 0
