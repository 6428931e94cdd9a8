"""The port's vision model zoo (``gluon/model_zoo/vision``) against the JAX
package's: the same ``_models`` names, the same parameter names for every
one of them, ``get_model`` refusing an unknown name, and each family's
inference forward from the same weights carried across in a ``.params``
file (the port's into JAX, and once JAX's into the port), at the sizes
of ``tests/test_model_zoo.py`` (batch 1). BatchNorm's values are drawn at
random first, so that its inference path reads them. DenseNet's and
Inception V3's blocks (dense layers and a transition; the A to E mixed
blocks) are held alone too."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_vision_layers import name_counters  # noqa: F401
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

# a whole model's forward: the packages sum convolutions in other orders
MODEL = dict(rtol=2e-4, atol=2e-4)


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _draw_statistics(net, seed=0):
    """BatchNorm's gamma, beta and moving statistics drawn at random, so
    that an inference forward reads values a fresh net does not hold."""
    rs = np.random.RandomState(100 + seed)
    for name, p in net.collect_params().items():
        n = p.shape[0] if p.shape else 1
        if name.endswith(("running_var", "gamma")):
            p.set_data(rs.uniform(0.5, 1.5, n).astype(np.float32))
        elif name.endswith(("running_mean", "beta")):
            p.set_data(rs.randn(n).astype(np.float32) * 0.1)


def _names(net):
    """The parameter names under the net's prefix (whose number counts the
    nets of its class made so far in the process) and the prefix's
    alias."""
    n = len(net.prefix)
    return net.prefix.rstrip("_0123456789"), \
        [k[n:] for k in net.collect_params().keys()]


def _forward_matches(jfactory, tfactory, x, tmp_path, tol=MODEL):
    """The port's net, initialized, its shapes resolved by one forward and
    its BatchNorm values drawn, saved to a .params file that the JAX net
    loads (drawing the weights on the JAX side costs a compilation per
    shape), hybridized (one compiled forward, a third of the eager calls'
    compile time); both inference forwards on ``x`` agree."""
    with tmx.cpu():
        tmx.random.seed(0)
        tnet = tfactory()
        tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        tnet(tmx.nd.array(x))
    _draw_statistics(tnet)
    f = str(tmp_path / "port.params")
    tnet.save_parameters(f)
    jnet = jfactory()
    assert _names(tnet) == _names(jnet)
    jnet.load_parameters(f)
    jnet.hybridize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        got = tnet(tmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    return jnet, tnet


def test_zoo_lists_the_jax_names():
    assert sorted(tvision._models) == sorted(jvision._models)


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_zoo_parameter_names_match_jax(name):
    jnet = jvision.get_model(name, classes=7)
    with tmx.cpu():
        tnet = tvision.get_model(name, classes=7)
    assert _names(tnet) == _names(jnet)
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())


def test_get_model_refuses_an_unknown_name():
    for get in (jmx.gluon.model_zoo.get_model,
                tmx.gluon.model_zoo.get_model):
        with pytest.raises(ValueError, match="not in zoo"):
            get("resnext9000")


def test_get_model_places_parameters_on_ctx():
    net = tvision.get_model("resnet18_v1", classes=3, ctx=tmx.cpu())
    p = net.collect_params()[net.prefix + "dense0_weight"]
    assert p.tensor().device.type == "cpu" and p.shape == (3, 512)
    with pytest.raises(tmx.MXNetError, match="pretrained"):
        tvision.get_model("lenet", pretrained=True)


FAMILIES = [("lenet", 28), ("resnet18_v1", 32), ("resnet34_v2", 32),
            ("vgg11_bn", 32), ("alexnet", 224), ("squeezenet1.1", 64),
            ("mobilenet0.25", 32), ("mobilenetv2_0.5", 32),
            ("se_resnext50_32x4d", 64), ("densenet121", 32),
            ("inceptionv3", 299)]


@pytest.mark.parametrize("name,size", FAMILIES)
def test_zoo_forward_matches_jax(name, size, tmp_path):
    x = _x((1, 1 if name == "lenet" else 3, size, size), 1)
    _forward_matches(lambda: jvision.get_model(name, classes=11),
                     lambda: tvision.get_model(name, classes=11), x,
                     tmp_path)


def _densenet_blocks(mx):
    from importlib import import_module

    d = import_module(mx.__name__ + ".gluon.model_zoo.vision.densenet")
    net = mx.gluon.nn.HybridSequential(prefix="dn_")
    with net.name_scope():
        net.add(d._DenseLayer(8, 2), d._DenseLayer(8, 2), d._transition(6))
    return net


def _inception_block(mx, which):
    from importlib import import_module

    inc = import_module(mx.__name__ + ".gluon.model_zoo.vision.inception")
    make = {"A": lambda: inc._make_A(8), "B": inc._make_B,
            "C": lambda: inc._make_C(8), "D": inc._make_D,
            "E": inc._make_E}[which]
    net = mx.gluon.nn.HybridSequential(prefix=f"inc{which}_")
    with net.name_scope():
        net.add(make())
    return net


def test_densenet_blocks_match_jax(tmp_path):
    x = _x((1, 5, 8, 8), 2)
    _forward_matches(lambda: _densenet_blocks(jmx),
                     lambda: _densenet_blocks(tmx), x, tmp_path)


@pytest.mark.parametrize("which", ["A", "B", "C", "D", "E"])
def test_inception_blocks_match_jax(which, tmp_path):
    x = _x((1, 6, 9, 9), 3)
    _forward_matches(lambda: _inception_block(jmx, which),
                     lambda: _inception_block(tmx, which), x, tmp_path)


def test_params_file_from_jax_loads_in_the_port(tmp_path):
    """A .params file saved by the JAX net (weights set in JAX from numpy
    draws, as a JAX initializer would compile a draw per shape; moving
    statistics included) loads into the port's and gives JAX's
    outputs."""
    x = _x((1, 3, 32, 32), 4)
    jnet = jvision.get_model("resnet18_v1", classes=5)
    jnet.initialize(jmx.init.Zero())
    jnet(jmx.nd.array(x))
    rs = np.random.RandomState(5)
    for p in jnet.collect_params().values():
        p.set_data((rs.randn(*p.shape) * 0.05).astype(np.float32))
    _draw_statistics(jnet, seed=1)
    f = str(tmp_path / "jax.params")
    jnet.save_parameters(f)
    with tmx.cpu():
        tnet = tvision.get_model("resnet18_v1", classes=5)
    tnet.load_parameters(f)
    with tmx.cpu():
        got = tnet(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, jnet(jmx.nd.array(x)).asnumpy(), **MODEL)
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            tnet._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy(), err_msg=k)
