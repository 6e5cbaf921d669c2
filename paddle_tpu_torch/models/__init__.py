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
