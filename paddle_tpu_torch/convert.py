"""Carry ``paddle_tpu`` weights into the port.

The port's modules keep the JAX package's parameter names and Paddle's
layouts, so a ``paddle_tpu`` ``BertModel.state_dict()`` maps by name:
``encoder.layers.0.self_attn.q_proj.weight`` is the same tensor in both.
The port's :class:`~paddle_tpu_torch.nn.layers.Linear` stores Paddle's
``[in, out]`` weight, so nothing is transposed; each name is checked
against the receiving module's type and shape, and a missing or extra
name raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.serialization import load
from .models.bert import BertConfig, BertModel
from .nn.layers import Embedding, LayerNorm, Linear

__all__ = ["bert_state_from_numpy", "load_bert"]

# module type -> shape of its weight given the module
_WEIGHT_SHAPES = {
    Linear: lambda m: (m.in_features, m.out_features),
    Embedding: lambda m: (m.num_embeddings, m.embedding_dim),
    LayerNorm: lambda m: tuple(m.normalized_shape),
}


def bert_state_from_numpy(np_state, model: BertModel) -> dict:
    """A state dict for ``model`` from a ``paddle_tpu`` ``BertModel``
    state dict of numpy arrays (as ``paddle_tpu.load(...,
    return_numpy=True)`` returns it)."""
    modules = dict(model.named_modules())
    own = model.state_dict()
    missing = sorted(set(own) - set(np_state))
    extra = sorted(set(np_state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    out = {}
    for name, arr in np_state.items():
        owner, _, leaf = name.rpartition(".")
        mod = modules[owner]
        shape = tuple(np.shape(arr))
        if leaf == "weight" and type(mod) in _WEIGHT_SHAPES:
            want = _WEIGHT_SHAPES[type(mod)](mod)
        else:
            want = tuple(own[name].shape)
        if shape != want:
            raise ValueError(f"{name}: shape {shape} does not fit {type(mod).__name__} "
                             f"(wants {want})")
        out[name] = torch.as_tensor(np.asarray(arr), dtype=own[name].dtype)
    return out


def load_bert(path, cfg: BertConfig | None = None, device=None) -> BertModel:
    """A :class:`BertModel` holding the weights of a ``paddle_tpu.save``
    file of a ``paddle_tpu`` ``BertModel.state_dict()``."""
    model = BertModel(cfg or BertConfig())
    model.load_state_dict(bert_state_from_numpy(load(path, return_numpy=True), model))
    return model if device is None else model.to(device)
