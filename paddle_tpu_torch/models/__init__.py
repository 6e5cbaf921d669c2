"""Models of the port."""
from .bert import (  # noqa: F401
    BertConfig,
    BertEmbeddings,
    BertModel,
    BertPooler,
    bert_base_config,
    bert_tiny_config,
)
