"""Every factory of the port's MaxViT, TResNet, Stacked Hourglass and
SqueezeNet files against the flax tree of the same factory: the modules are
built at their published widths on the meta device and held against
``jax.eval_shape`` of the flax init (``_assert_fits_the_flax_tree``: one
tensor per leaf at the bridge's path and of the bridge's shape, and no
tensor without a leaf), with the output specs compared.  NFNet's factories
are in ``test_torch_nfnet_factories.py``."""

import jax.numpy as jnp
import pytest
import torch

from pytorch_toolbelt_tpu.zoo.encoders import hourglass as jhourglass
from pytorch_toolbelt_tpu.zoo.encoders import maxvit as jmaxvit
from pytorch_toolbelt_tpu.zoo.encoders import squeezenet as jsqueezenet
from pytorch_toolbelt_tpu.zoo.encoders import tresnet as jtresnet
from pytorch_toolbelt_tpu_torch import zoo as tzoo
from test_torch_mobile_encoders import _assert_fits_the_flax_tree, _spec

_FACTORIES = {
    **{name: (jmaxvit, name, 64) for name in ["maxvit_tiny_encoder", "maxvit_small_encoder", "maxvit_base_encoder",
                                              "maxvit_large_encoder", "maxvit_xlarge_encoder"]},
    **{name: (jtresnet, name, 64) for name in ["tresnet_m_encoder", "tresnet_l_encoder", "tresnet_xl_encoder"]},
    "squeezenet_encoder": (jsqueezenet, "squeezenet_encoder", 64),
    "StackedHGEncoder": (jhourglass, "StackedHGEncoder", 64),
    "StackedSupervisedHGEncoder": (jhourglass, "StackedSupervisedHGEncoder", 64),
}


@pytest.mark.parametrize("name", list(_FACTORIES))
def test_factory_fits_the_jax_parameter_tree(name):
    jmodule, jname, size = _FACTORIES[name]
    jenc = getattr(jmodule, jname)()
    with torch.device("meta"):
        tenc = getattr(tzoo, name)()
    _assert_fits_the_flax_tree(tenc, jenc, jnp.zeros((1, size, size, 3)))
    assert _spec(tenc) == _spec(jenc)
