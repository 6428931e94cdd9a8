"""The vision model zoo: the port of ``mxnet_tpu/gluon/model_zoo/vision/``,
the same names in ``_models`` and ``get_model``."""
from ._common import _no_pretrained, _on
from .resnet import (  # noqa: F401
    ResNetV1, ResNetV2, resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
    resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
    resnet152_v2, get_resnet,
)
from .alexnet import AlexNet, alexnet  # noqa: F401
from .lenet import LeNet, lenet  # noqa: F401
from .vgg import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn,
)
from .mobilenet import (  # noqa: F401
    MobileNet, MobileNetV2, mobilenet1_0, mobilenet0_5, mobilenet0_25,
    mobilenet_v2_1_0, mobilenet_v2_0_5,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
)
from .inception import Inception3, inception_v3  # noqa: F401
from .resnext import (  # noqa: F401
    ResNext, get_resnext, resnext50_32x4d, resnext101_32x4d,
    se_resnext50_32x4d, se_resnext101_32x4d,
)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1, "resnet50_v1": resnet50_v1,
    "resnet101_v1": resnet101_v1, "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "alexnet": alexnet, "lenet": lenet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.5": mobilenet0_5,
    "mobilenet0.25": mobilenet0_25, "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
    "resnext50_32x4d": resnext50_32x4d, "resnext101_32x4d": resnext101_32x4d,
    "se_resnext50_32x4d": se_resnext50_32x4d,
    "se_resnext101_32x4d": se_resnext101_32x4d,
}


def get_model(name, **kwargs):
    """The zoo model ``name``; ``ctx=`` places its parameters (default: the
    current context), the other keywords go to its constructor."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"model {name!r} not in zoo; available: {sorted(_models)}")
    ctx = kwargs.pop("ctx", None)
    _no_pretrained(kwargs.pop("pretrained", False))
    with _on(ctx):
        return _models[name](**kwargs)
