"""The int8 encoder-decoder's CUDA graphs on the CPU (``zoo/quantized_encdec.py``):
the head's interpolation matrices made once, a CPU forward that runs
eagerly and counts so, and the bookkeeping of spans captured into a graph
(``utils/profiling.py``).  The graphs themselves run only on a card:
``tests/test_torch_cuda.py`` holds them against the eager forward."""

import contextlib

import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu_torch.nn.functional import _linear_weights
from pytorch_toolbelt_tpu_torch.utils import profiling
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead
from pytorch_toolbelt_tpu_torch.zoo import quantize_encoder_decoder_inference
from pytorch_toolbelt_tpu_torch.zoo import quantized_encdec as TQE
from pytorch_toolbelt_tpu_torch.zoo.encoders.resnet import ResNetEncoder
from pytorch_toolbelt_tpu_torch.zoo.quantized_unet import _linear_matrix


@pytest.mark.parametrize("in_size,out_size,align", [(16, 64, False), (16, 64, True), (192, 768, False), (7, 3, False)])
def test_the_heads_interpolation_matrix_is_made_once(in_size, out_size, align):
    first = _linear_matrix(in_size, out_size, align, torch.device("cpu"))
    assert _linear_matrix(in_size, out_size, align, torch.device("cpu")) is first
    assert first.dtype == torch.float32 and first.shape == (out_size, in_size)
    assert np.array_equal(first.numpy(), _linear_weights(in_size, out_size, align, np.float32))


_ENCODERS = {
    "se_resnext": dict(stage_blocks=(1, 1, 1, 1), bottleneck=True, use_se=True, groups=2, base_width=4),
    "se_resnet": dict(stage_blocks=(1, 1, 1, 1), bottleneck=False, use_se=True),
}


def _counts():
    return dict(vars(TQE.int8_graph))


@pytest.mark.parametrize("output_name", [None, "mask"])
@pytest.mark.parametrize("name", list(_ENCODERS))
def test_a_cpu_forward_runs_eagerly_and_counts_so(name, output_name):
    """On the CPU the forward is the eager forward, bit for bit, call after
    call, and each call counts one eager call and no capture or replay; the
    build's bias-correction replay counts one eager call too."""
    torch.manual_seed(0)
    enc = ResNetEncoder(**_ENCODERS[name])
    dec = FPNDecoder(enc.get_output_spec(), out_channels=16)
    head = ResizeHead(dec.get_output_spec(), num_classes=3, output_name=output_name)
    model = EncoderDecoderModel(enc, dec, head).eval()
    gen = torch.Generator().manual_seed(1)
    cal, x = torch.rand(2, 3, 32, 32, generator=gen), torch.rand(2, 3, 64, 32, generator=gen)
    before = _counts()
    forward = quantize_encoder_decoder_inference(model, cal)
    assert _counts() == dict(before, eager_calls=before["eager_calls"] + 1)
    outs = [forward(x), forward(x), forward.eager(x)]
    assert _counts() == dict(before, eager_calls=before["eager_calls"] + 4)
    if output_name is not None:
        assert all(list(out) == [output_name] for out in outs)
        outs = [out[output_name] for out in outs]
    assert outs[0].shape == (2, 3, 64, 32) and outs[0].dtype == torch.float32
    assert all(torch.equal(out, outs[0]) for out in outs[1:])


class _FakeEvent:
    def __init__(self, t):
        self.t, self.waited = t, 0

    def query(self):
        return True

    def synchronize(self):
        self.waited += 1

    def elapsed_time(self, end):
        return end.t - self.t  # ms


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def profiler_on(monkeypatch):
    """Spans on as under a profiler, with no profiler range."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(profiling, "_range", lambda name: contextlib.nullcontext())
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _captured(records):
    spans = profiling.GraphSpans()
    spans.records = [(name, inner, _FakeEvent(0.0), _FakeEvent(ms)) for name, inner, ms in records]
    return spans


def test_a_graphs_spans_count_once_a_replay_under_the_span_open_there(profiler_on):
    spans = _captured([("int8.add", None, 2.0), ("int8.se", None, 1.0), ("inner", "int8.se", 0.5)])
    graph = _FakeGraph()
    with profiling.span("int8.forward", device=False):
        with profiling.span("int8.graph", device=False):
            spans.replay(graph)
            assert spans.records[-1][3].waited == 0  # nothing to sum yet before the first replay
            spans.replay(graph)  # sums the first replay before its events are recorded anew
            assert spans.records[-1][3].waited == 1
    totals = profiling.span_totals()
    assert graph.replays == 2 and spans.pending is None
    assert {name: (t["calls"], t["parents"], t["roots"]) for name, t in totals.items()} == {
        "int8.forward": (1, {None: 1}, 1), "int8.graph": (1, {"int8.forward": 1}, 1),
        "int8.add": (2, {"int8.graph": 2}, 1), "int8.se": (2, {"int8.graph": 2}, 1), "inner": (2, {"int8.se": 2}, 1)}
    assert totals["int8.add"]["device_s"] == pytest.approx(4e-3) and totals["inner"]["device_s"] == pytest.approx(1e-3)
    assert totals["int8.add"]["host_s"] == totals["int8.add"]["self_host_s"] == 0.0


def test_a_replay_with_no_profiler_counts_nothing_and_a_reset_forgets_a_pending_one(profiler_on, monkeypatch):
    spans, graph = _captured([("int8.add", None, 2.0)]), _FakeGraph()
    spans.replay(graph)
    assert spans.pending == (None, spans.pending[1])  # a replay at no open span is a root
    profiling.reset_spans()
    assert spans.pending is None and profiling.span_totals() == {}
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: False)
    spans.replay(graph)
    assert graph.replays == 2 and spans.pending is None and profiling.span_totals() == {}


@pytest.mark.parametrize("timed", [False, True], ids=["plain", "timed"])
@pytest.mark.parametrize("name,device", [("int8.add", torch.zeros(1)), ("q1.call", False), ("int8.forward", False)],
                         ids=["cpu-tensor", "host-only", "host-only-root"])
def test_spans_in_a_capture_are_off_but_those_it_times_on_the_card(profiler_on, name, device, timed):
    """While a graph captures, a span is off under a profiler: with no
    GraphSpans every span, and with one every span that times no card (a CPU
    tensor or ``device=False``); after the capture it is on again."""
    with profiling.capture_spans(profiling.GraphSpans() if timed else None):
        assert profiling.span(name, device) is profiling._OFF
    assert profiling._captures == 0 and getattr(profiling._totals.local, "capture", None) is None
    assert profiling.span(name, device) is not profiling._OFF  # on again: the profiler records


def test_a_key_replays_its_plain_graph_and_under_a_profiler_its_two_timed_copies_in_turns(profiler_on, monkeypatch):
    """Under a profiler a replay sums the spans of the replay before last, its
    own copy's; with none the plain graph replays.  Every replay adds its
    graph's launches to the kernels' counters."""
    key = object.__new__(TQE._KeyGraphs)
    key.x, key.turn = torch.zeros(2), 0
    key.plain = (_FakeGraph(), None, torch.full((1,), -1.0))
    key.traced = [(_FakeGraph(), _captured([("int8.add", None, 2.0)]), torch.full((1,), float(k))) for k in range(2)]
    key.launches = {(TQE.q_add, "launches", None): 20, (TQE.q_add, "gated", None): 16}
    launches, gated = TQE.q_add.launches, TQE.q_add.gated
    outs = [key(torch.ones(2)) for _ in range(3)]
    assert [int(y) for y in outs] == [0, 1, 0] and [g.replays for g, _, _ in key.traced] == [2, 1]
    assert [spans.records[-1][3].waited for _, spans, _ in key.traced] == [1, 0]
    assert profiling.span_totals()["int8.add"]["calls"] == 3 and torch.equal(key.x, torch.ones(2))
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: False)
    assert int(key(torch.ones(2))) == -1 and key.plain[0].replays == 1 and key.turn == 1
    assert (TQE.q_add.launches - launches, TQE.q_add.gated - gated) == (80, 64)
    TQE._count_launches({k: -4 * n for k, n in key.launches.items()})


def test_launch_counts_add_and_take_back():
    before = TQE._launch_counts()
    launched = {(TQE.q_add, "launches", None): 20, (TQE.q_add, "gated", None): 16,
                (TQE.q_add, "launches_by_route", "vec16"): 20, (TQE.qconv2d, "launches", None): 3}
    TQE._count_launches(launched)
    assert TQE._launches_since(before) == launched
    TQE._count_launches({k: -n for k, n in launched.items()})
    assert TQE._launch_counts() == before
