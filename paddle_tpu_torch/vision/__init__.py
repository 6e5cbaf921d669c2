"""paddle.vision in the port (``paddle_tpu/vision``): datasets, transforms and
the model zoo's image models."""
from . import datasets  # noqa: F401
from . import transforms  # noqa: F401
from ..models import LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152  # noqa: F401

from .models import *  # noqa: F401,F403
