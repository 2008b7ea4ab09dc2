"""Q1 on the int8 SEResNeXt50-FPN(128), on one GPU: ``chip_smoke.py``'s
phase 16.5 alone (``phase_int8_encdec``: one 1024^2 forward at batch 1 and
one call of config 3's d4 + multiscale TTA, every distinct conv shape held
bit for bit against ``qconv2d_reference`` and timed, the times summed by
class of conv), after the build and its compiler and SASS report (phase 1).

Before it, the host's cost of one ``qconv2d`` call on each route at a tiny
shape ([1, C, 8, 8], where the kernel takes a few µs): back-to-back calls on
the host's clock and between CUDA events, then the wrapper alone (its C entry
point replaced by a no-op) and the C entry point alone (tensor maps, launch)
with the arguments the wrapper passed.

``--package DIR`` runs it on the package of another checkout (the parent
commit unpacked with ``git archive``, say) with this checkout's phase code,
so that two versions are compared with the same measurement in one call;
``--loose`` drops the route expectations that such an older package does not
meet.

    python probes/q1_probe.py [--package DIR] [--loose]
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


# route: (C_in, C_out, kernel, stride, pads, groups) of a conv that takes it, at [1, C_in, 8, 8]
HOST_SHAPES = {
    "mma_v16": (64, 64, 3, 2, (0, 1, 0, 1), 1),
    "tma_wgmma": (128, 128, 3, 1, (1, 1, 1, 1), 1),
    "gemm_wgmma": (256, 256, 1, 1, (0, 0, 0, 0), 1),
    "grouped_wgmma": (128, 128, 3, 1, (1, 1, 1, 1), 32),
}
HOST_CALLS = 2000


def _host_us(fn) -> float:
    """µs of the host's clock per call of ``fn``, over HOST_CALLS calls issued
    back to back (the device keeps up: each call's kernel is shorter)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


class _EntryPoint:
    """Stands in for the kernel library: records ``ptt_qconv2d``'s arguments
    and calls the real entry point, or nothing (``noop``)."""

    def __init__(self, lib, noop: bool):
        self.lib, self.noop, self.args = lib, noop, None

    def ptt_qconv2d(self, *args):
        self.args = args
        return 0 if self.noop else self.lib.ptt_qconv2d(*args)


def host_costs(dev, smi) -> None:
    from pytorch_toolbelt_tpu_torch.ops import _build, pack_qconv2d_weights, qconv2d
    from pytorch_toolbelt_tpu_torch.ops import quantized

    lib = _build.library()
    for route, (c_in, c_out, k, stride, pads, groups) in HOST_SHAPES.items():
        gen = torch.Generator().manual_seed(0)
        x = torch.randint(-127, 128, (1, c_in, 8, 8), generator=gen, dtype=torch.int8)
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
        w = pack_qconv2d_weights(torch.randint(-127, 128, (c_out, c_in // groups, k, k), generator=gen,
                                               dtype=torch.int8).to(dev), groups)
        ops = {name: torch.ones(c_out, dtype=torch.int32, device=dev) for name in ("bias", "mult", "clamp")}
        call = lambda: qconv2d(x, w, stride, pads, "mul", relu=True, **ops)  # noqa: E731
        before = dict(qconv2d.launches_by_route)
        call()
        took = next(r for r, n in qconv2d.launches_by_route.items() if n != before[r])
        wrapper = _host_us(call)
        events = float(cs.cuda_ms(call, reps=HOST_CALLS // 10)) * 1e3
        real = quantized._build.library
        try:
            for noop in (False, True):
                entry = _EntryPoint(lib, noop)
                quantized._build.library = lambda entry=entry: entry
                call()
                if noop:
                    python = _host_us(call)
                else:
                    args = entry.args
        finally:
            quantized._build.library = real
        c_entry = _host_us(lambda: lib.ptt_qconv2d(*args))
        cs.log(f"[probe] host per qconv2d call, a {route} shape ({c_in}->{c_out} {k}x{k}/{stride} g{groups} at "
               f"[1, {c_in}, 8, 8]) on {took}: the wrapper {wrapper:.1f} us on the host's clock, {events:.1f} us "
               f"between CUDA events; the wrapper with a no-op entry point {python:.1f} us; the C entry point alone "
               f"(tensor maps, launch) {c_entry:.1f} us ({smi})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", help="the checkout whose pytorch_toolbelt_tpu_torch to measure")
    parser.add_argument("--loose", action="store_true", help="do not hold the calls to the new routes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("q1_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    import pytorch_toolbelt_tpu_torch

    cs.log(f"[probe] package {Path(pytorch_toolbelt_tpu_torch.__file__).resolve().parent}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.phase_build()
    dev = torch.device("cuda", 0)
    host_costs(dev, smi)
    cs.phase_int8_encdec(dev, smi, strict=not args.loose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
