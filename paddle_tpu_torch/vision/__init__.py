"""Vision: the transforms and the vision models, re-exported as the JAX
package's ``paddle_tpu.vision`` re-exports them."""

from . import transforms  # noqa: F401
from ..models.lenet import LeNet  # noqa: F401
from ..models.resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa
                             resnet101, resnet152)
from ..models.mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                                mobilenet_v1, mobilenet_v2)
from ..models.vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
