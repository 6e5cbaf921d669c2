"""Models of the port."""
from .bert import (  # noqa: F401
    BertConfig,
    BertEmbeddings,
    BertForPretraining,
    BertLMPredictionHead,
    BertModel,
    BertPooler,
    BertPretrainingCriterion,
    bert_base_config,
    bert_tiny_config,
)
from .resnet import (  # noqa: F401
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
