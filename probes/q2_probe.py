"""Q2 (``csrc/q_upsample.cu``) under the microscope, on one GPU.

Builds two copies of the Q2 source beside the port's library, both with the
first design's 16-channel per-pixel instance (``-DPTT_Q2_PIXEL16``, route 3)
and one with every lerp replaced by an XOR of its operands
(``-DPTT_Q2_NO_ARITH``), and at the int8 UNet-32's three decoder shapes of
config 2's 5000^2 run (batch 90) times, in each copy: the first design alone,
the banded route alone and the banded route writing the decoder input.  Then
each kernel's SASS instructions per output byte (the helpers of
``chip_smoke.py`` phase 1).  The arithmetic copy's outputs are held against
each other bit for bit.

    python probes/q2_probe.py
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pytorch_toolbelt_tpu_torch.ops import _build, upsample_taps  # noqa: E402
from pytorch_toolbelt_tpu_torch.ops.quantized import _band_tile  # noqa: E402
from pytorch_toolbelt_tpu_torch.zoo.quantized_unet import _q_upsample_matrices  # noqa: E402

BATCH = 90  # config 2's 5000^2 int8 run calls the decoder at batches of 80-100 views
STAGES = ((256, 128, 64), (128, 64, 128), (64, 32, 256))  # (C, Cs, input size): the decoder's x2 upsamples
VARIANTS = {"arithmetic": ["-DPTT_Q2_PIXEL16"], "no arithmetic": ["-DPTT_Q2_PIXEL16", "-DPTT_Q2_NO_ARITH"]}
ROUTE_BANDED, ROUTE_V16 = 0, 3


def build() -> dict:
    """{variant: (library, SASS listing)}, compiled all at once."""
    out_dir = _build.BUILD_DIR / "q2_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"libq2_{name.replace(' ', '_')}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib), str(_build.CSRC_DIR / "q_upsample.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        cs.log(f"[probe] {name}: " + " | ".join(line.strip() for line in text.splitlines()
                                                 if "registers" in line or "spill" in line))
        dll = ctypes.CDLL(str(lib))
        dll.ptt_q_upsample.argtypes = _build._SIGNATURES["ptt_q_upsample"][1]
        dll.ptt_q_upsample.restype = ctypes.c_int
        cuobjdump = str(Path(nvcc).parent / "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout
        libs[name] = (dll, sass)
    return libs


def launch(dll, x, skip, mh, mw, taps, route):
    b, c, h, w = x.shape
    cs_ = 0 if skip is None else skip.shape[1]
    y = torch.empty(b, c + cs_, mh.shape[0], mw.shape[0], dtype=torch.int8, device=x.device,
                    memory_format=torch.channels_last)
    tile = (ctypes.c_int * 4)(*(_band_tile(c, mh, mw) if route == ROUTE_BANDED else (0, 0, 0, 0)))
    err = dll.ptt_q_upsample(x.device.index, x.data_ptr(), 0 if skip is None else skip.data_ptr(), y.data_ptr(),
                             taps[0].data_ptr(), taps[1].data_ptr(), b, h, w, c, cs_, mh.shape[0], mw.shape[0], route,
                             tile, _build.stream_of(x.device))
    if err:
        raise RuntimeError(f"ptt_q_upsample route {route}: CUDA error {err}")
    return y


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build()
    gen = torch.Generator(device=dev).manual_seed(18)
    totals = {}
    for c, c_skip, size in STAGES:
        x = torch.randint(-127, 128, (BATCH, c, size, size), generator=gen, device=dev, dtype=torch.int8)
        x = x.contiguous(memory_format=torch.channels_last)
        skip = torch.randint(-127, 128, (BATCH, c_skip, 2 * size, 2 * size), generator=gen, device=dev,
                             dtype=torch.int8).contiguous(memory_format=torch.channels_last)
        mh, mw, _ = _q_upsample_matrices(size, size, 2 * size, 2 * size)
        taps = (upsample_taps(mh, dev), upsample_taps(mw, dev))
        alone_bytes = x.numel() * 5
        cat_bytes = alone_bytes + 2 * skip.numel()
        dll = libs["arithmetic"][0]
        first = launch(dll, x, None, mh, mw, taps, ROUTE_V16)
        banded = launch(dll, x, None, mh, mw, taps, ROUTE_BANDED)
        fused = launch(dll, x, skip, mh, mw, taps, ROUTE_BANDED)
        if not (torch.equal(first, banded) and torch.equal(fused[:, :c], banded) and torch.equal(fused[:, c:], skip)):
            raise AssertionError(f"{c} channels at {size}^2: the banded route disagrees with the first design")
        del first, banded, fused
        for name, (dll, _) in libs.items():
            for what, skip_, route, nbytes in (("first design alone", None, ROUTE_V16, alone_bytes),
                                               ("banded alone", None, ROUTE_BANDED, alone_bytes),
                                               ("banded decoder input", skip, ROUTE_BANDED, cat_bytes)):
                ms = cs.cuda_ms(lambda: launch(dll, x, skip_, mh, mw, taps, route), reps=5)
                bound = cs.bound_ms(nbytes)[0]
                totals[(name, what)] = totals.get((name, what), 0.0) + ms
                totals[("bound", what)] = totals.get(("bound", what), 0.0) + bound
                cs.log(f"[probe] {name}: {what} [{BATCH}, {c}, {size}, {size}] -> {2 * size}^2"
                       f"{f' + skip {c_skip}' if skip_ is not None else ''}: {ms} = {nbytes / ms / 1e6:.0f} GB/s, "
                       f"bound {bound:.3f} ms = {bound / ms:.1%} ({smi})")
        del x, skip
        torch.cuda.empty_cache()
    for (name, what), ms in totals.items():
        if name != "bound":
            bound = totals[("bound", what)] / len(libs)
            cs.log(f"[probe] {name}: {what}, the three stages: {ms:.3f} ms, bound {bound:.3f} ms = {bound / ms:.1%}")
    for name, (_, sass) in libs.items():
        functions = cs._sass_functions(sass)
        for fname, code in functions.items():
            match = next((v for v in (16, 4, 1) if f"q_upsample_kernelILi{v}E" in fname), None)
            if match:
                useful = [op for _, op, _ in code if op not in ("NOP", "BRA")]
                cs.log(f"[probe] {name}: per-pixel instance V={match}: {len(useful)} SASS instructions (both "
                       f"branches) for {match} output bytes = {len(useful) / match:.2f} per byte")
        if name == "arithmetic":
            cs._log_q2_sass(sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
