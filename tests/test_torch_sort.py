"""Parity of the port's row sorts (``pytorch_toolbelt_tpu_torch.ops.sort``)
with the JAX package's Pallas sorts, on the CPU.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them, at the one non-slow size each that ``tests/test_ops.py`` uses.  Their
bitonic networks are unstable under ties, so those comparisons use distinct
keys; ties, +-0.0 and NaN are held against ``sort_reference`` and numpy's
stable sort.  The CUDA kernels themselves are tested in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.ops import bitonic_sort_chunked as j_bitonic_sort_chunked
from pytorch_toolbelt_tpu.ops import split_sort as j_split_sort
from pytorch_toolbelt_tpu_torch.ops import bitonic_sort_chunked, sort_reference, split_sort

# (JAX kernel, port wrapper, rows, n, TPU chunk)
KERNELS = {
    "K4": (j_bitonic_sort_chunked, bitonic_sort_chunked, 3, 4096, 512),
    "K5": (j_split_sort, split_sort, 1, 2048, 256),
}
PAIRS = {"f32_i32": (np.float32, np.int32), "i32_f32": (np.int32, np.float32)}


def _distinct_rows(rng, rows, n, key_dtype, payload_dtype):
    keys = np.stack([rng.permutation(n) - n // 2 for _ in range(rows)])
    keys = (keys * 0.37).astype(np.float32) if key_dtype == np.float32 else keys.astype(np.int32)
    if payload_dtype == np.int32:
        payload = rng.randint(-(2**31), 2**31 - 1, size=(rows, n), dtype=np.int64).astype(np.int32)
    else:
        payload = rng.standard_normal((rows, n)).astype(np.float32)
    return keys, payload


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32)


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_sort_matches_jax_kernel(kernel, pair):
    j_sort, t_sort, rows, n, chunk = KERNELS[kernel]
    keys, payload = _distinct_rows(np.random.RandomState(rows * n), rows, n, *PAIRS[pair])
    want_k, want_p = (np.asarray(a) for a in j_sort(jnp.asarray(keys), jnp.asarray(payload), chunk_size=chunk,
                                                   interpret=True))
    for fn in (sort_reference, t_sort):
        got_k, got_p = fn(torch.from_numpy(keys), torch.from_numpy(payload))
        np.testing.assert_array_equal(_bits(got_k.numpy()), _bits(want_k))
        np.testing.assert_array_equal(_bits(got_p.numpy()), _bits(want_p))


def _awkward_rows(rng, rows, n, key_dtype, payload_dtype):
    """Heavy ties; for float keys also -0.0 / +0.0, +-inf and NaN."""
    if key_dtype == np.float32:
        keys = (rng.randint(-6, 6, size=(rows, n)) * 0.5).astype(np.float32)
        pick = rng.rand(rows, n)
        keys[pick < 0.1] = -0.0
        keys[(pick >= 0.1) & (pick < 0.2)] = 0.0
        keys[(pick >= 0.2) & (pick < 0.25)] = np.nan
        keys[(pick >= 0.25) & (pick < 0.28)] = np.inf
        keys[(pick >= 0.28) & (pick < 0.31)] = -np.inf
    else:
        keys = rng.randint(-9, 9, size=(rows, n)).astype(np.int32)
        keys[:, ::7] = np.iinfo(np.int32).min
        keys[:, 3::11] = np.iinfo(np.int32).max
    _, payload = _distinct_rows(rng, rows, n, np.int32, payload_dtype)
    return keys, payload


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("wrapper", [bitonic_sort_chunked, split_sort], ids=["K4", "K5"])
def test_cpu_wrappers_match_stable_sort_with_ties_zeros_and_nan(wrapper, pair):
    keys, payload = _awkward_rows(np.random.RandomState(5), 3, 1001, *PAIRS[pair])
    # numpy's stable sort: -0.0 ties +0.0, NaNs last in input order
    order = np.argsort(keys, axis=-1, kind="stable")
    want_k, want_p = np.take_along_axis(keys, order, -1), np.take_along_axis(payload, order, -1)
    launches = wrapper.launches
    for fn in (sort_reference, wrapper):
        got_k, got_p = fn(torch.from_numpy(keys), torch.from_numpy(payload))
        np.testing.assert_array_equal(_bits(got_k.numpy()), _bits(want_k))
        np.testing.assert_array_equal(_bits(got_p.numpy()), _bits(want_p))
    assert wrapper.launches == launches  # CPU tensors never reach the kernel


@pytest.mark.parametrize("wrapper", [bitonic_sort_chunked, split_sort], ids=["K4", "K5"])
def test_wrappers_reject_what_the_kernels_do_not_take(wrapper):
    k, p = torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        wrapper(k.double(), p)
    with pytest.raises(TypeError):
        wrapper(k, p.long())
    with pytest.raises(ValueError):
        wrapper(k[0], p[0])
    with pytest.raises(ValueError):
        wrapper(k, p[:, :4])
    with pytest.raises(ValueError):
        wrapper(k[:, :0], p[:, :0])
    with pytest.raises(ValueError):
        wrapper(k.to("meta"), p.to("meta"))
