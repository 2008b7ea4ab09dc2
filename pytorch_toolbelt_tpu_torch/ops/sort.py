"""Row-wise key/payload sorts: two hand-written CUDA kernels and their plain version.

Counterpart of ``pytorch_toolbelt_tpu/ops/sort.py``.  Both kernels sort each
row of ``[R, N]`` 4-byte keys (float32 or int32) ascending, carrying a 4-byte
payload (int32 or float32) that they move without reading it.  Both are
stable and order keys as ``torch.sort`` does on the CPU (-0.0 ties +0.0;
every NaN ties and sorts last), so each equals :func:`sort_reference` bit for
bit, ties included, for any ``R >= 1`` and ``N >= 1``.  (``torch.sort`` on
CUDA orders NaNs by their bit pattern instead; with one NaN pattern the two
agree.)

* :func:`bitonic_sort_chunked` (K4) -> ``csrc/radix_sort.cu``, a segmented
  LSD radix sort in one sweep per 8-bit digit: one histogram launch for all
  four digit places, one launch of per-row digit bases, then four passes,
  each a single launch that ranks a tile, finds its place in the row by
  decoupled look-back and writes each digit's run coalesced (a memset and
  six launches per sort).  The TPU kernel of the same name is a bitonic
  network because the TPU has no element-granular scatter; Hopper has one.
* :func:`split_sort` (K5) -> ``csrc/merge_sort.cu``, the TPU kernel's contract
  (sort each chunk, then merge across chunks): one launch sorts each
  8192-pair chunk in shared memory, then each merge round merges up to 32
  sorted runs at once, in two launches: one finds each 8192-pair output
  tile's exact split points in its runs (a bisection on the key bits, one
  warp per tile), the other stages each tile's segments in shared memory and
  merges them there.  ``ceil(log_32(ceil(N / 8192)))`` rounds: five launches
  per sort at ``N = 2^23``.

On a CPU tensor each wrapper runs :func:`sort_reference`; on a CUDA tensor
it launches its kernel (counted in ``<wrapper>.launches``) or raises.  The
TPU package's geometry predicates and ``lax.sort`` fallbacks have no
counterpart: the kernels take every shape.
"""

from typing import Tuple

import torch

from . import _build

__all__ = ["bitonic_sort_chunked", "sort_reference", "split_sort"]

_KEY_KINDS = {torch.float32: 0, torch.int32: 1}
_PAYLOAD_DTYPES = (torch.int32, torch.float32)


def sort_reference(keys: torch.Tensor, payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of both kernels: a stable ascending sort of each row of
    ``keys``, with ``payload`` gathered in the same order."""
    keys_sorted, index = torch.sort(keys, dim=-1, stable=True)
    return keys_sorted, torch.gather(payload, -1, index)


def _check(name: str, keys: torch.Tensor, payload: torch.Tensor) -> None:
    if keys.dtype not in _KEY_KINDS or payload.dtype not in _PAYLOAD_DTYPES:
        raise TypeError(f"{name} takes float32/int32 keys and int32/float32 payload, got {keys.dtype}, {payload.dtype}")
    if keys.dim() != 2 or payload.shape != keys.shape or keys.numel() == 0:
        raise ValueError(f"{name} takes non-empty [R, N] keys and payload of one shape, got "
                         f"{tuple(keys.shape)} and {tuple(payload.shape)}")
    if payload.device != keys.device:
        raise ValueError(f"{name}: keys on {keys.device}, payload on {payload.device}")


def _launch(name: str, entry: str, keys: torch.Tensor, payload: torch.Tensor):
    if keys.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {keys.device}")
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError(f"{name}: keys and payload must be contiguous")
    rows, n = keys.shape
    keys_out = torch.empty_like(keys)
    payload_out = torch.empty_like(payload)
    lib = _build.library()
    words = getattr(lib, f"{entry}_workspace")(rows, n)
    # freed on return: the caching allocator hands it out again only in stream order
    workspace = torch.empty(words, dtype=torch.int32, device=keys.device)
    err = getattr(lib, entry)(
        keys.device.index, keys.data_ptr(), payload.data_ptr(), keys_out.data_ptr(), payload_out.data_ptr(),
        workspace.data_ptr(), _KEY_KINDS[keys.dtype], rows, n, _build.stream_of(keys.device),
    )
    _build.check(err, name)
    return keys_out, payload_out


def bitonic_sort_chunked(keys: torch.Tensor, payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of ``keys`` [R, N] ascending, carrying ``payload`` [R, N];
    the K4 port, a radix sort (``csrc/radix_sort.cu``)."""
    _check("bitonic_sort_chunked", keys, payload)
    if keys.device.type == "cpu":
        return sort_reference(keys, payload)
    out = _launch("bitonic_sort_chunked", "ptt_radix_sort", keys, payload)
    bitonic_sort_chunked.launches += 1
    return out


def split_sort(keys: torch.Tensor, payload: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row of ``keys`` [R, N] ascending, carrying ``payload`` [R, N];
    the K5 port, chunk sort then merge (``csrc/merge_sort.cu``)."""
    _check("split_sort", keys, payload)
    if keys.device.type == "cpu":
        return sort_reference(keys, payload)
    out = _launch("split_sort", "ptt_merge_sort", keys, payload)
    split_sort.launches += 1
    return out


bitonic_sort_chunked.launches = 0
split_sort.launches = 0
