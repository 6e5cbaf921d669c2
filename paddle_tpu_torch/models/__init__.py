"""Models of the port."""
from .bert import (  # noqa: F401
    BertConfig,
    BertEmbeddings,
    BertForPretraining,
    BertLMPredictionHead,
    BertModel,
    BertPooler,
    BertPretrainingCriterion,
    ErnieForPretraining,
    ErnieModel,
    bert_base_config,
    bert_tiny_config,
    ernie_base_config,
    knowledge_masking,
)
from .gpt import (  # noqa: F401
    GPTConfig,
    GPTForCausalLM,
    GPTModel,
    gpt_tiny_config,
    load_gpt_model,
    save_gpt_model,
    truncated_draft,
)
from .lenet import LeNet  # noqa: F401
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
from .seq2seq import TransformerSeq2Seq  # noqa: F401
