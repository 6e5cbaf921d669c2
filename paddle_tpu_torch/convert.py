"""Carry ``paddle_tpu`` weights and optimizer state into the port.

The port's modules keep the JAX package's parameter names and Paddle's
layouts, so a ``paddle_tpu`` ``BertModel.state_dict()`` maps by name:
``encoder.layers.0.self_attn.q_proj.weight`` is the same tensor in both.
The port's :class:`~paddle_tpu_torch.nn.layers.Linear` stores Paddle's
``[in, out]`` weight, so nothing is transposed; each name is checked
against the receiving module's type and shape, and a missing or extra
name raises. ``BertForPretraining`` ties its MLM decoder weight to the
word embeddings; the JAX state dict lists it once, under
``bert.embeddings.word_embeddings.weight``, and so does the port's. An
AdamW ``state_dict`` indexes its moments by the position of the
parameter in ``model.parameters()``, the same order in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.serialization import load
from .models.bert import BertConfig, BertForPretraining, BertModel
from .nn.layers import Embedding, LayerNorm, Linear

__all__ = ["bert_state_from_numpy", "load_bert", "bert_pretraining_state_from_numpy",
           "load_bert_pretraining", "adamw_state_from_numpy"]

_TIED = ("cls.decoder_weight", "bert.embeddings.word_embeddings.weight")

# module type -> shape of its weight given the module
_WEIGHT_SHAPES = {
    Linear: lambda m: (m.in_features, m.out_features),
    Embedding: lambda m: (m.num_embeddings, m.embedding_dim),
    LayerNorm: lambda m: tuple(m.normalized_shape),
}


def bert_state_from_numpy(np_state, model) -> dict:
    """A state dict for ``model`` (a :class:`BertModel` or
    :class:`BertForPretraining`) from the ``paddle_tpu`` model's state dict
    of numpy arrays (as ``paddle_tpu.load(..., return_numpy=True)``
    returns it)."""
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


def bert_pretraining_state_from_numpy(np_state, model: BertForPretraining) -> dict:
    """:func:`bert_state_from_numpy` for a ``paddle_tpu``
    ``BertForPretraining.state_dict()``. A dict that also lists the tied
    decoder weight under ``cls.decoder_weight`` must hold the embedding
    table there; the port loads the one tensor."""
    np_state = dict(np_state)
    tied, table = _TIED
    if tied in np_state:
        if table in np_state and not np.array_equal(np.asarray(np_state[tied]),
                                                    np.asarray(np_state[table])):
            raise ValueError(f"{tied} differs from {table}: the decoder weight is tied")
        np_state.setdefault(table, np_state[tied])
        del np_state[tied]
    return bert_state_from_numpy(np_state, model)


def load_bert_pretraining(path, cfg: BertConfig | None = None,
                          device=None) -> BertForPretraining:
    """A :class:`BertForPretraining` holding the weights of a
    ``paddle_tpu.save`` file of a ``paddle_tpu``
    ``BertForPretraining.state_dict()``."""
    model = BertForPretraining(cfg or BertConfig())
    model.load_state_dict(bert_pretraining_state_from_numpy(load(path, return_numpy=True),
                                                            model))
    return model if device is None else model.to(device)


def adamw_state_from_numpy(np_state, optimizer) -> dict:
    """A state dict for the port's ``optimizer`` (``Adam``/``AdamW``) from
    a ``paddle_tpu`` one of numpy arrays: ``global_step`` and the moments
    ``moment1_{i}``/``moment2_{i}`` of parameter ``i``, each checked
    against the shape of the port's parameter ``i``."""
    params = optimizer._parameter_list
    out = {"global_step": int(np_state["global_step"])}
    for name in ("moment1", "moment2"):
        keys = [k for k in np_state if k.rsplit("_", 1)[0] == name]
        if not keys:
            continue
        if sorted(keys) != sorted(f"{name}_{i}" for i in range(len(params))):
            raise KeyError(f"{name}: state holds {len(keys)} entries for {len(params)} "
                           "parameters")
        for i, p in enumerate(params):
            arr = np.array(np_state[f"{name}_{i}"])
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}_{i}: shape {arr.shape} does not fit parameter "
                                 f"{optimizer._param_names[i]} {tuple(p.shape)}")
            out[f"{name}_{i}"] = torch.as_tensor(arr, dtype=p.dtype)
    return out
