"""The int8 UNet-32's distance from its float model on ``chip_smoke.py``'s
seeded weights, in the JAX package and in the port, on the CPU.

``chip_smoke.py`` phase 16 calibrates the port's ``quantize_unet_inference``
on ``seeded_unet(SEED)`` (He-normal convs, BatchNorm statistics near their
identity values) and gates its ``int8_forward_rel_rms``.  This script builds
the same weights with ``chip_smoke.seeded_unet``, hands them to the JAX
package as flax variables (the inverse of ``load_flax_variables``), runs both
packages' ``quantize_unet_inference`` on the same calibration tiles, and
prints one JSON line: each int8 output's relative RMS against its own float32
forward, and the two int8 outputs' relative RMS against each other.

The tiles are the first tiles of a 5000^2 image of uniform [0, 1) noise cut
by the port's ``ImageSlicer`` at 512 / 256, as chip_smoke cuts them (the
first ones hold the slicer's zero border).  chip_smoke draws the image on
the card; ``--draw-on-card FILE`` (on a machine with a CUDA GPU; torch only)
draws it there the same way and saves those tiles, and ``--tiles-file FILE``
then runs the comparison on them.  Without a file, ``--draws N`` images are
drawn on the CPU from seeds SEED + 5, SEED + 6, ...

Run from the repository root (about two minutes per draw):

    python tools/int8_unet_fidelity.py [--tiles 4] [--size 512] [--draws 1]
    python tools/int8_unet_fidelity.py --draw-on-card int8_cal_tiles.npy
    python tools/int8_unet_fidelity.py --tiles-file int8_cal_tiles.npy
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pytorch_toolbelt_tpu_torch.inference import ImageSlicer  # noqa: E402
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, load_flax_variables  # noqa: E402
from pytorch_toolbelt_tpu_torch.zoo import quantize_unet_inference  # noqa: E402
from pytorch_toolbelt_tpu_torch.zoo.porting import _hwio_to_oihw, _leaves  # noqa: E402


def first_tiles(image: torch.Tensor, tiles: int, size: int) -> np.ndarray:
    """[tiles, 3, size, size]: the first tiles ImageSlicer cuts from a [3, H, W] image at step size / 2."""
    hwc = image.permute(1, 2, 0).cpu().numpy()
    cut = ImageSlicer(hwc.shape[:2], size, size // 2).split(hwc)[:tiles]
    return np.ascontiguousarray(np.stack(cut).transpose(0, 3, 1, 2))


def flax_variables(model: torch.nn.Module) -> dict:
    """The flax variables tree that ``load_flax_variables`` would turn into
    ``model``'s tensors (plain convs and BatchNorms, as the UNet has)."""
    tree: dict = {}
    for collection, path, tensor, transform in _leaves(model, ()):
        value = tensor.detach().cpu().numpy()
        if transform is _hwio_to_oihw:
            value = value.transpose(2, 3, 1, 0)
        node = tree.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return tree


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(((got - ref) ** 2).mean()) / np.sqrt((ref**2).mean()))


def compare(model, variables, tiles: np.ndarray) -> dict:
    """Both packages' int8 UNet on ``tiles`` ([N, 3, H, W]), each against its own float32 forward."""
    import jax.numpy as jnp
    from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNet
    from pytorch_toolbelt_tpu.zoo import quantize_unet_inference as j_quantize_unet_inference

    x = torch.from_numpy(tiles)
    x_nhwc = jnp.asarray(tiles.transpose(0, 2, 3, 1))
    with torch.no_grad():
        port_f32 = model(x).numpy()
    port_int8 = quantize_unet_inference(model, x)(x).numpy()
    jmodel = JUNet(num_classes=1, encoder_channels=32, num_layers=4, growth_factor=2)
    jax_f32 = np.moveaxis(np.asarray(jmodel.apply(variables, x_nhwc)), -1, 1)
    jax_int8 = np.moveaxis(np.asarray(j_quantize_unet_inference(jmodel, variables, x_nhwc)(x_nhwc)), -1, 1)
    return {"port_int8_vs_port_f32": rel_rms(port_int8, port_f32), "jax_int8_vs_jax_f32": rel_rms(jax_int8, jax_f32),
            "port_int8_vs_jax_int8": rel_rms(port_int8, jax_int8), "port_f32_vs_jax_f32": rel_rms(port_f32, jax_f32)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tiles", type=int, default=chip_smoke.INT8_CAL_TILES)
    parser.add_argument("--size", type=int, default=chip_smoke.TILE)
    parser.add_argument("--draws", type=int, default=1)
    parser.add_argument("--tiles-file", help="compare on the tiles saved by --draw-on-card")
    parser.add_argument("--draw-on-card", metavar="FILE", help="save chip_smoke's calibration tiles, drawn on the card")
    args = parser.parse_args()

    if args.draw_on_card:  # chip_smoke phase 16's draw: its generator, seed and device
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 5)
        image = torch.rand(3, 5000, 5000, device=dev, generator=gen)
        np.save(args.draw_on_card, first_tiles(image, args.tiles, args.size))
        print(json.dumps({"saved": args.draw_on_card, "device": torch.cuda.get_device_name(0)}))
        return

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    model = chip_smoke.seeded_unet(chip_smoke.SEED, torch.device("cpu"))
    variables = flax_variables(model)
    twin = UNetSegmentationModel(num_classes=1, encoder_channels=32, num_layers=4, growth_factor=2)
    twin = load_flax_variables(twin, variables).eval()  # the round trip gives the same tensors
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), twin.state_dict().values()))

    if args.tiles_file:
        draws = [("card", np.load(args.tiles_file))]
    else:
        draws = []
        for i in range(args.draws):
            gen = torch.Generator().manual_seed(chip_smoke.SEED + 5 + i)
            draws.append((f"cpu seed {chip_smoke.SEED + 5 + i}",
                          first_tiles(torch.rand(3, 5000, 5000, generator=gen), args.tiles, args.size)))
    for name, tiles in draws:
        t0 = time.perf_counter()
        row = compare(model, variables, tiles)
        print(json.dumps({"draw": name, "tiles": list(tiles.shape), "seed": chip_smoke.SEED, **row,
                          "s": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    main()
