"""Every factory of the port's DenseNet, DPN and InceptionV4 (both padding
modes) encoders at its published width and depth against the flax tree of
the JAX factory of the same name, as ``test_torch_cnn_factories.py`` checks
the others.  No forward runs.
"""

import pytest

from pytorch_toolbelt_tpu.zoo.encoders import densenet as jdensenet
from pytorch_toolbelt_tpu.zoo.encoders import dpn as jdpn
from pytorch_toolbelt_tpu.zoo.encoders import inception as jinception
from pytorch_toolbelt_tpu_torch import zoo
from test_torch_cnn_factories import check_factory, factories

_JAX_MODULES = (jdensenet, jdpn, jinception)


def test_every_jax_factory_is_listed():
    assert len(factories(_JAX_MODULES)) == 4 + 5 + 1
    assert all(name in zoo.__all__ for name in factories(_JAX_MODULES))


@pytest.mark.parametrize("name", factories(_JAX_MODULES))
def test_factories_fit_the_jax_parameter_tree(name):
    check_factory(_JAX_MODULES, name)


def test_inception_v4_torch_compat_fits_the_jax_parameter_tree():
    check_factory(_JAX_MODULES, "inception_v4_encoder", torch_compat=True)
