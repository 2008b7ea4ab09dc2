"""Small sizes of each cell for the benchmark's CPU tests: the same
configurations at their published widths, on images, tiles and calibration
batches a test run can hold."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = {
    "unet32-int8.d4-5000": {"image": {"sizes": [[80, 72]], "pool": 2}, "tile": 32, "step": 16, "batch": 4,
                            "calibration": {"images": 2, "size": 32}, "warmup": 1, "trace_requests": 2},
    "seresnext50-fpn-int8.msd4-1024": {"image": {"sizes": [[64, 64]], "pool": 2}, "size_offsets": [0, -32],
                                       "calibration": {"images": 2, "size": 64}, "warmup": 1, "trace_requests": 2},
    "seresnext50-fpn-int8.stream-5000": {"image": {"sizes": [[100, 90]], "pool": 2}, "tile": 64, "step": 32,
                                         "batch": 4, "calibration": {"images": 2, "size": 64}, "warmup": 1,
                                         "trace_requests": 2},
}
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's are


@pytest.fixture
def card():
    """The card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
