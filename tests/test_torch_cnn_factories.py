"""Every factory of the port's HRNet, XResNet, Res2Net, SKResNet and
WiderResNet encoders at its published width and depth (DenseNet's, DPN's
and InceptionV4's are in ``test_torch_densenet_dpn_inception_factories.py``),
against the flax tree of the JAX factory of the same name: each
leaf of the flax init (shapes from ``jax.eval_shape``) has one tensor of
the port's module (built on the meta device) at the weight bridge's path,
of the shape the bridge's layout change gives, every tensor has a leaf,
and the output specs agree.  No forward runs.
"""

import jax.numpy as jnp
import pytest
import torch

from pytorch_toolbelt_tpu.zoo.encoders import hrnet as jhrnet
from pytorch_toolbelt_tpu.zoo.encoders import res2net as jres2net
from pytorch_toolbelt_tpu.zoo.encoders import skresnet as jskresnet
from pytorch_toolbelt_tpu.zoo.encoders import wide_resnet as jwide
from pytorch_toolbelt_tpu.zoo.encoders import xresnet as jxresnet
from pytorch_toolbelt_tpu_torch import zoo
from test_torch_mobile_encoders import _assert_fits_the_flax_tree, _spec

_JAX_MODULES = (jhrnet, jxresnet, jres2net, jskresnet, jwide)


def factories(modules):
    return [name for m in modules for name in m.__all__ if name.endswith("_encoder") or name == "WiderResNetA2Encoder"]


def check_factory(modules, name, **kwargs):
    """The port's factory ``name`` (on the meta device) against the flax
    tree of the JAX factory of that name in ``modules``, traced at 32^2
    (96^2 for InceptionV4, whose VALID stem needs more)."""
    jenc = next(getattr(m, name) for m in modules if hasattr(m, name))(**kwargs)
    with torch.device("meta"):
        tenc = getattr(zoo, name)(**kwargs)
    size = 96 if name.startswith("inception") else 32
    _assert_fits_the_flax_tree(tenc, jenc, jnp.zeros((1, size, size, 3)))
    assert _spec(tenc) == _spec(jenc)


def test_every_jax_factory_is_listed():
    assert len(factories(_JAX_MODULES)) == 5 + 10 + 3 + 4 + 7
    assert all(name in zoo.__all__ for name in factories(_JAX_MODULES))


@pytest.mark.parametrize("name", factories(_JAX_MODULES))
def test_factories_fit_the_jax_parameter_tree(name):
    check_factory(_JAX_MODULES, name)
