"""Every factory of the port's NFNet file (NFNet-F0..F7, NF-RegNet-B0..B5)
against the flax tree of the same factory, built at its published widths
on the meta device (``_assert_fits_the_flax_tree``), with the output specs
compared."""

import jax.numpy as jnp
import pytest
import torch

from pytorch_toolbelt_tpu.zoo.encoders import nfnet as jnfnet
from pytorch_toolbelt_tpu_torch import zoo as tzoo
from test_torch_mobile_encoders import _assert_fits_the_flax_tree, _spec


@pytest.mark.parametrize("name", [f"nfnet_f{i}_encoder" for i in range(8)] + [f"nf_regnet_b{i}_encoder" for i in range(6)])
def test_nfnet_factories_fit_the_jax_parameter_tree(name):
    jenc = getattr(jnfnet, name)()
    with torch.device("meta"):
        tenc = getattr(tzoo, name)()
    _assert_fits_the_flax_tree(tenc, jenc, jnp.zeros((1, 32, 32, 3)))
    assert _spec(tenc) == _spec(jenc)
