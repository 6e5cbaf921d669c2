"""BERT encoder and pretraining model (``paddle_tpu/models/bert.py:33-272``) on torch tensors.

The config, embeddings, post-norm encoder, pooler, the MLM + NSP
pretraining heads and their criterion, with the JAX package's parameter
names, so ``paddle_tpu`` weights load by name
(:mod:`paddle_tpu_torch.convert`). Pipelining and sharding constraints
are not ported. With ``use_flash_attention`` and sequences of at least
``FLASH_ATTENTION_MIN_SEQ`` the attention runs the flash kernels
(forward, and dQ and dK/dV in the backward); every encoder layer runs the
fused residual-add + LayerNorm kernels twice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["BertConfig", "bert_base_config", "bert_tiny_config", "BertEmbeddings",
           "BertPooler", "BertModel", "BertLMPredictionHead", "BertForPretraining",
           "BertPretrainingCriterion"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    pad_token_id: int = 0
    # dispatch attention to the flash kernel (ops/cuda/flash_attention.py)
    use_flash_attention: bool = False


def bert_base_config() -> BertConfig:
    return BertConfig()


def bert_tiny_config() -> BertConfig:
    """For tests: 2 layers, 128 hidden."""
    return BertConfig(
        vocab_size=1024, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=512,
        max_position_embeddings=128, type_vocab_size=2,
    )


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            seq_len = input_ids.shape[1]
            position_ids = torch.arange(seq_len, device=input_ids.device)[None, :].expand(
                input_ids.shape[0], seq_len)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, device=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, generator=generator, device=device)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


def _init_bert_weights(model, initializer_range, generator=None):
    """Truncated-normal (sigma = initializer_range, cut at 2 sigma) for every
    linear/embedding weight, zeros for biases, norms left at 1 and 0: the
    JAX package's BERT scheme, drawn from ``generator``."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                continue
            if p.dim() >= 2 and name.split(".")[-1] == "weight":
                nn.init.trunc_normal_(p, 0.0, initializer_range, -2 * initializer_range,
                                      2 * initializer_range, generator=generator)
            elif name.endswith("bias"):
                p.zero_()


class BertModel(nn.Module):
    """``forward(input_ids, token_type_ids=None, position_ids=None,
    attention_mask=None) -> (sequence_output, pooled_output)``."""

    def __init__(self, cfg: BertConfig | None = None, generator=None, device=None, **kwargs):
        super().__init__()
        self.config = cfg or BertConfig(**kwargs)
        cfg = self.config
        kw = dict(generator=generator, device=device)
        self.embeddings = BertEmbeddings(cfg, **kw)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, act_dropout=0.0,
            use_flash_attention=cfg.use_flash_attention, **kw)
        self.encoder = TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg, **kw)
        _init_bert_weights(self, cfg.initializer_range, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).to(torch.float32)
        # [B, L] -> additive [B, 1, 1, L]: -1e4 on pad keys
        ext = (1.0 - attention_mask[:, None, None, :]) * -1e4
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(emb, ext)
        return seq, self.pooler(seq)


class BertLMPredictionHead(nn.Module):
    """MLM head whose decoder weight is the input embedding table ``[V, H]``
    (tied). The tied weight stays registered under the embeddings alone,
    so the state dict names it once, as the JAX package's does."""

    def __init__(self, cfg: BertConfig, embedding_weights, generator=None, device=None):
        super().__init__()
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, generator=generator,
                                device=device)
        self.activation = getattr(F, cfg.hidden_act)
        self.layer_norm = LayerNorm(cfg.hidden_size, device=device)
        # a plain attribute, not a second registration of the parameter
        self.__dict__["decoder_weight"] = embedding_weights
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))

    def forward(self, hidden_states, masked_positions=None):
        if masked_positions is not None:
            # the masked tokens' rows of the flat [B*L, H] hidden states
            b, l, h = hidden_states.shape
            hidden_states = F.gather(hidden_states.reshape(b * l, h), masked_positions)
        x = self.layer_norm(self.activation(self.transform(hidden_states)))
        return torch.matmul(x, self.decoder_weight.t()) + self.decoder_bias


class BertForPretraining(nn.Module):
    """MLM + next-sentence-prediction pretraining model:
    ``forward(input_ids, token_type_ids=None, position_ids=None,
    attention_mask=None, masked_positions=None) -> (prediction_scores,
    seq_relationship_score)``."""

    def __init__(self, cfg: BertConfig | None = None, generator=None, device=None, **kwargs):
        super().__init__()
        self.bert = BertModel(cfg, generator=generator, device=device, **kwargs)
        cfg = self.bert.config
        self.cls = BertLMPredictionHead(cfg, self.bert.embeddings.word_embeddings.weight,
                                        generator=generator, device=device)
        self.seq_relationship = Linear(cfg.hidden_size, 2, generator=generator, device=device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None,
                masked_positions=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids, attention_mask)
        return self.cls(seq, masked_positions), self.seq_relationship(pooled)


class BertPretrainingCriterion(nn.Module):
    """MLM + NSP loss: the mean cross entropy of each head (``ignore_index``
    -100 masks MLM labels), the MLM term divided by ``masked_lm_scale``."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score, masked_lm_labels,
                next_sentence_labels, masked_lm_scale=1.0):
        mlm = F.cross_entropy(prediction_scores.reshape(-1, self.vocab_size),
                              masked_lm_labels.reshape(-1))
        nsp = F.cross_entropy(seq_relationship_score, next_sentence_labels.reshape(-1))
        return mlm / masked_lm_scale + nsp
