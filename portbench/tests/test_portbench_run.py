"""A run end to end at small sizes on the CPU (the harness's look for a card
skipped): sound runs come out correct; the control and the timed path broken
underneath come out not correct; run.py without a card prints no result."""

import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import control, entries, harness

from conftest import REPO, SEED, SMALL

CELLS = sorted(SMALL)


def test_run_without_a_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, also on a machine that has one
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode != 0 and out.stdout == "" and "CUDA" in out.stderr


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, traced):
    result, lines = harness.run(cell, SEED, 1.0, traced, time.perf_counter(), device="cpu", overrides=SMALL[cell])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks" and lines[-1].startswith("check ")
    assert all(c["value"] == 0.0 for c in result["checks"].values())


def _half_batch(forward):
    """Half of each batch left out; its outputs are the other half's."""
    def broken(x):
        y = forward(x[: (x.shape[0] + 1) // 2])
        return torch.cat([y, y])[: x.shape[0]]

    return broken


def _alter(forward):
    """One sample of each batch altered, by 1% of its largest logit, where it is produced."""
    def broken(x):
        y = forward(x).clone()
        y[0] += 0.01 * float(y[0].abs().max())
        return y

    return broken


def _stale(entry_class):
    """Each request answered with the map of the one before it."""
    class Stale(entry_class):
        def serve(self, image):
            self.last = getattr(self, "last", []) + [super().serve(image)]
            return self.last.pop(0) if len(self.last) > 1 else self.last[0]

    return Stale


@pytest.mark.parametrize("fault", ["half_batch", "alter", "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_timed_path_broken_underneath_is_not_correct(cell, fault, monkeypatch):
    real_cell = harness.Cell

    def broken_cell(*args, **kwargs):
        c = real_cell(*args, **kwargs)
        if fault in ("half_batch", "alter"):
            wrap, build = {"half_batch": _half_batch, "alter": _alter}[fault], c.builder.build
            c.builder = types.SimpleNamespace(build=lambda *a: wrap(build(*a)))
        return c

    monkeypatch.setattr(harness, "Cell", broken_cell)
    if fault == "stale":
        monkeypatch.setitem(entries.ENTRIES, harness.Cell(cell).traffic["entry"],
                            _stale(entries.ENTRIES[harness.Cell(cell).traffic["entry"]]))
    result, _ = harness.run(cell, SEED, 1.0, False, time.perf_counter(), device="cpu", overrides=SMALL[cell])
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_int4_control_is_not_correct(cell):
    row = control.control(cell, SEED, "cpu", overrides=SMALL[cell])
    assert not row["correct"]
    assert all(c["value"] > c["limit"] for c in row["checks"].values())


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct(card):
    cell = CELLS[0]
    result, _ = harness.run(cell, SEED, 1.0, False, time.perf_counter(), device=card, overrides=SMALL[cell])
    assert result["correct"] and result["device"]["platform"] == "gpu"
