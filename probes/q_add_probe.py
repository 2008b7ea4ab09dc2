"""Q3 (``csrc/q_add.cu``) alone, on one GPU, at the adds of one call of the
``seresnext50-fpn-int8.msd4-1024`` cell's TTA: the int8 SEResNeXt50-FPN(128)
on its 8 d4 views at 1024^2 and at 768^2, 20 adds a scale (16 residual adds
with their SE gates and ReLU, 4 FPN top-down adds without).

At each distinct shape, on seeded operands: Q3 held bit for bit against
``q_add_reference``; its device time between CUDA events, with the launches
queued behind a sleeping kernel so that the host's cost per call does not
enter it, and that host cost (µs per call, the host's clock over the same
launches); its bound (the two int8 addends read and the int8 sum written
once, over 3.35 TB/s); and the eager int32 formula the graph ran before Q3
(the SE excitation as its own pass where gated, then the add's passes) at
the same shape, timed the same way; then the sums over the call's 40 adds.

    python probes/q_add_probe.py
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pytorch_toolbelt_tpu_torch.ops import q_add, q_add_reference  # noqa: E402

BATCH = 8  # d4's eight views of one image
SCALES = (1024, 768)  # MultiscaleTTA's size offsets [0, -256]
# (C, stride, adds a scale, gated and ReLU): SEResNeXt50's 3/4/6/3 bottlenecks, then the FPN's top-down adds
ADDS = ((256, 4, 3, True), (512, 8, 4, True), (1024, 16, 6, True), (2048, 32, 3, True),
        (128, 2, 1, False), (128, 4, 1, False), (128, 8, 1, False), (128, 16, 1, False))


def queued_ms(fn, reps: int, windows: int = 5):
    """(device ms per call, host µs per call): ``reps`` calls enqueued
    behind ~10 ms of ``torch.cuda._sleep``, so that the events around them
    time the card alone; the medians over ``windows`` windows."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    device, host = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) / reps * 1e6)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / reps)
    return cs.Timing(device), statistics.median(host)


def eager(a, b, ma, mb, relu, gate):
    """The graph's SE excitation and add as the torch passes it ran before Q3."""
    cl = torch.channels_last
    if gate is not None:
        x = a.to(torch.int32) * gate[:, :, None, None]
        a = ((x + 8192) >> 14).clamp(-127, 127).to(torch.int8).contiguous(memory_format=cl)
    acc = a.to(torch.int32) * ma.view(1, -1, 1, 1) + b.to(torch.int32) * mb.view(1, -1, 1, 1)
    if relu:
        acc = torch.clamp_min(acc, 0)
    return ((acc + 2048) >> 12).clamp(-127, 127).to(torch.int8).contiguous(memory_format=cl)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(23)
    total = dict(q3=0.0, bound=0.0, eager=0.0, adds=0)
    for size in SCALES:
        for c, stride, count, gated in ADDS:
            h = size // stride
            a, b = (torch.randint(-128, 128, (BATCH, h, h, c), generator=gen, device=dev, dtype=torch.int8)
                    .permute(0, 3, 1, 2) for _ in range(2))
            ma, mb = (torch.randint(0, 1 << 14, (c,), generator=gen, device=dev, dtype=torch.int32) for _ in range(2))
            gate = torch.randint(0, (1 << 14) + 1, (BATCH, c), generator=gen, device=dev,
                                 dtype=torch.int32) if gated else None
            launches = dict(q_add.launches_by_route)
            got = q_add(a, b, ma, mb, gated, gate)
            route = next(k for k, n in q_add.launches_by_route.items() if n != launches[k])
            if not (torch.equal(got, q_add_reference(a, b, ma, mb, gated, gate))
                    and torch.equal(got, eager(a, b, ma, mb, gated, gate))):
                raise AssertionError(f"Q3 differs from its plain version at [{BATCH}, {c}, {h}, {h}]")
            del got
            ms, host_us = queued_ms(lambda: q_add(a, b, ma, mb, gated, gate), reps=20)
            eager_ms, _ = queued_ms(lambda: eager(a, b, ma, mb, gated, gate), reps=2)
            bound = cs.bound_ms(3 * a.numel())[0]
            for key, value in (("q3", ms), ("bound", bound), ("eager", eager_ms)):
                total[key] += count * value
            total["adds"] += count
            cs.log(f"[q3] {'gated ReLU' if gated else 'FPN'} add [{BATCH}, {c}, {h}, {h}] x{count} ({route}): {ms} = "
                   f"{3 * a.numel() / ms / 1e6:.0f} GB/s, bound {bound:.4f} ms = {bound / ms:.1%}, host "
                   f"{host_us:.1f} us a call; eager {eager_ms} ({smi})")
            del a, b
            torch.cuda.empty_cache()
    cs.log(f"[q3] one msd4 TTA call, {total['adds']} adds: Q3 {total['q3']:.3f} ms, bound {total['bound']:.3f} ms = "
           f"{total['bound'] / total['q3']:.1%}; the eager passes {total['eager']:.3f} ms "
           f"({total['eager'] / total['q3']:.1f}x) ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
