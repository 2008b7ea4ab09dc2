"""The control of a cell's comparison: the plain reference put in the
program's place, computed in int4 (the precision below the configurations'
int8), against the reference in int8 on one request of the cell's own size
and traffic, drawn from each seed.  It has to come out not correct: each
line gives the numbers compared beside the cell's limits.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
"""

import argparse
import json
import random
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CONTROL_QMAX = 7  # int4


def control(workload: str, seed: int, device, overrides=None, root=REPO) -> dict:
    """The numbers compared for the int4 reference in the program's place."""
    from portbench import harness, inputs

    cell = harness.Cell(workload, root)
    cfg, traffic = dict(cell.cfg), dict(cell.traffic)
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = value
    cal = inputs.calibration_images(cfg, device, inputs.subseed(seed, "calibration"))
    pool = inputs.image_pool(traffic, device, inputs.subseed(seed, "images"))
    image = pool[random.Random(inputs.subseed(seed, "sample")).randrange(len(pool))]
    want = harness.reference_output(cell, cfg, traffic, seed, cal, image, device)
    got = harness.reference_output(cell, cfg, traffic, seed, cal, image, device, qmax=CONTROL_QMAX)
    found = harness.gaps(got, want)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in found.items()}
    return {"workload": workload, "seed": seed, "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = control(args.workload, seed, torch.device("cuda", 0))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
