"""paddle.vision.models (``paddle_tpu/vision/models.py``): the model zoo's names."""
from ..models import (  # noqa: F401
    LeNet,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)

__all__ = [
    "LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152",
]
