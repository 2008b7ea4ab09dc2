"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``pytorch_toolbelt_tpu_torch``.  The
cell, its configuration, traffic, limits and per-layer metrics are named in
``BENCHMARK.json`` and found by name under ``portbench/``.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, which the last lines of
standard error repeat).  Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits with another code than 0.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# every cache of the program at a fixed path inside the checkout, so that only the first run of a checkout compiles
os.environ["TRITON_CACHE_DIR"] = str(REPO / "portbench" / ".cache" / "triton")
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "4")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    chips = harness.Cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS,
                                device=torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}, which the port must not use", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
