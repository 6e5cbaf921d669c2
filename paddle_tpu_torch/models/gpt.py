"""GPT decoder-only causal language model (``paddle_tpu/models/gpt.py``) on torch tensors.

Embeddings, a pre-norm decoder-only stack
(``TransformerDecoderLayer(normalize_before=True, with_cross_attention=False)``),
a final LayerNorm and an LM head tied to the word embeddings, with the JAX
package's parameter names, so a ``paddle_tpu`` GPT's state dict loads by name
(:func:`load_gpt_model`, :func:`paddle_tpu_torch.convert.load_gpt`). The
defaults are GPT-2 small (Radford et al. 2019): 12 layers, 768 wide, 12
heads, 1024 positions, a 50,304-token vocabulary.

The forward takes an optional list of per-layer :class:`nn.StaticCache` and
then runs the incremental path: the step's keys and values are written into
the caches in place (``nn/transformer.py``), which is how
:class:`~paddle_tpu_torch.generation.GenerationEngine` decodes through its
persistent buffers. ``attention_window`` gives the model sliding-window
attention; serving sets it to the KV-cache capacity, the function a ring of
that capacity computes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import torch

from ..framework.serialization import load, save
from ..nn import functional as F
from ..nn.layer_base import Layer
from ..nn.layers import Dropout, Embedding, LayerList, LayerNorm
from ..nn.transformer import TransformerDecoderLayer, causal_mask
from .bert import _init_bert_weights

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny_config", "save_gpt_model",
           "load_gpt_model", "truncated_draft"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 1024
    initializer_range: float = 0.02
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 2
    # sliding-window attention width (None: full causal); serving sets it to
    # the KV-cache capacity
    attention_window: int | None = None


def gpt_tiny_config() -> GPTConfig:
    """For tests: 2 layers, 64 hidden."""
    return GPTConfig(
        vocab_size=211, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=128, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
    )


class GPTModel(Layer):
    """Embeddings + pre-norm decoder-only stack + final LayerNorm."""

    def __init__(self, cfg: GPTConfig | None = None, generator=None, device=None, **kwargs):
        super().__init__()
        self.config = cfg or GPTConfig(**kwargs)
        cfg = self.config
        kw = dict(generator=generator, device=device)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.layers = LayerList([
            TransformerDecoderLayer(
                cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
                attn_dropout=cfg.attention_probs_dropout_prob, act_dropout=0.0,
                normalize_before=True, with_cross_attention=False, **kw)
            for _ in range(cfg.num_hidden_layers)
        ])
        self.norm_f = LayerNorm(cfg.hidden_size, device=device)
        _init_bert_weights(self, cfg.initializer_range, generator)

    def forward(self, input_ids, position_ids=None, attention_mask=None, caches=None):
        """Hidden states ``[B, T, H]``; with ``caches`` (a list of per-layer
        :class:`StaticCache`) also the caches, written in place."""
        b, t = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(t, device=input_ids.device)[None, :].expand(b, t)
        if attention_mask is None:
            attention_mask = causal_mask(t, window=self.config.attention_window,
                                         device=input_ids.device)
        x = self.dropout(self.word_embeddings(input_ids) + self.position_embeddings(position_ids))
        new_caches = []
        for i, layer in enumerate(self.layers):
            if caches is None:
                x = layer(x, tgt_mask=attention_mask)
            else:
                x, c = layer(x, tgt_mask=attention_mask, cache=caches[i])
                new_caches.append(c)
        x = self.norm_f(x)
        return x if caches is None else (x, new_caches)


class GPTForCausalLM(Layer):
    """:class:`GPTModel` + the LM head tied to the word embeddings: logits
    ``[B, T, V]`` (with ``caches``, ``(logits, caches)``)."""

    def __init__(self, cfg: GPTConfig | None = None, generator=None, device=None, **kwargs):
        super().__init__()
        self.gpt = GPTModel(cfg, generator=generator, device=device, **kwargs)
        self.config = self.gpt.config

    def forward(self, input_ids, position_ids=None, attention_mask=None, caches=None):
        out = self.gpt(input_ids, position_ids, attention_mask, caches)
        hidden = out[0] if caches is not None else out
        logits = F.matmul(hidden, self.gpt.word_embeddings.weight, transpose_y=True)
        return logits if caches is None else (logits, out[1])

    def cache_spec(self):
        """(num_layers, num_heads, head_dim) for KV-cache allocation."""
        cfg = self.config
        return (cfg.num_hidden_layers, cfg.num_attention_heads,
                cfg.hidden_size // cfg.num_attention_heads)


def save_gpt_model(model: GPTForCausalLM, dirname):
    """Write ``config.json`` + ``model.pdparams`` (the ``paddle_tpu.save``
    format), the directory the JAX package's ``load_gpt_model`` reads."""
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(model.config), f, indent=1, sort_keys=True)
    save(model.state_dict(), os.path.join(dirname, "model.pdparams"))
    return dirname


def load_gpt_model(dirname, device=None) -> GPTForCausalLM:
    """A :class:`GPTForCausalLM` (eval mode) of a directory written by
    :func:`save_gpt_model` of either package, every name and shape checked;
    on ``device`` when given."""
    from ..convert import gpt_state_from_numpy

    with open(os.path.join(dirname, "config.json")) as f:
        cfg = GPTConfig(**json.load(f))
    model = GPTForCausalLM(cfg)
    model.load_state_dict(gpt_state_from_numpy(
        load(os.path.join(dirname, "model.pdparams"), return_numpy=True), model))
    model.eval()
    return model if device is None else model.to(device)


def truncated_draft(model: GPTForCausalLM, num_layers: int = 1) -> GPTForCausalLM:
    """A layer-skip draft: the target's embeddings, its FIRST ``num_layers``
    decoder layers, final norm and tied head, copied into a shallower GPT
    (eval mode) on the target's device."""
    cfg = dataclasses.replace(model.config, num_hidden_layers=int(num_layers))
    device = model.gpt.word_embeddings.weight.device
    draft = GPTForCausalLM(cfg, device=device)
    src = model.state_dict()
    draft.load_state_dict({k: src[k] for k, v in draft.state_dict().items()
                           if k in src and tuple(src[k].shape) == tuple(v.shape)})
    draft.eval()
    return draft
