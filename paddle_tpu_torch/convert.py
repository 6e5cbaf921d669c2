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
AdamW ``state_dict`` indexes its moments (a Momentum one its
``velocity_{i}``) by the position of the parameter in
``model.parameters()``, the same order in both packages, and so does any
other optimizer's (:func:`optimizer_state_from_numpy`). ERNIE's state
dict is BERT's (its pretraining model ties the same weight). A
``TransformerSeq2Seq`` state dict holds its parameters and the
``pos_enc`` buffer, which must equal the port's own table. A ResNet state
dict holds the parameters and the batch norms' running ``_mean`` and
``_variance`` buffers (267 entries for ResNet-50: 161 parameters, 106
buffers), all checked the same way. A saved static program (an int8 one
from post-training quantization, or any other) is carried over by
:func:`int8_model_from_numpy`: the JSON program as it is, the parameters
into a scope with the dtypes they were saved in. A JAX scope's
persistables (name -> numpy, a training program's parameters, velocities,
moments and lr) go into a port scope by :func:`scope_from_numpy`, so both
executors start a program from the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .framework.serialization import load
from .models.bert import (BertConfig, BertForPretraining, BertModel, ErnieForPretraining,
                          ernie_base_config)
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.resnet import resnet50
from .models.seq2seq import TransformerSeq2Seq
from .nn.layers import Embedding, LayerNorm, Linear

__all__ = ["bert_state_from_numpy", "load_bert", "bert_pretraining_state_from_numpy",
           "load_bert_pretraining", "load_ernie_pretraining", "seq2seq_state_from_numpy",
           "load_seq2seq", "adamw_state_from_numpy", "resnet_state_from_numpy",
           "load_resnet", "momentum_state_from_numpy", "int8_model_from_numpy",
           "load_int8_model", "scope_from_numpy", "optimizer_state_from_numpy",
           "gpt_state_from_numpy", "load_gpt", "vgg_state_from_numpy",
           "mobilenet_state_from_numpy", "se_resnext_state_from_numpy",
           "word2vec_state_from_numpy"]

_TIED = ("cls.decoder_weight", "bert.embeddings.word_embeddings.weight")

# module type -> shape of its weight given the module
_WEIGHT_SHAPES = {
    Linear: lambda m: (m.in_features, m.out_features),
    Embedding: lambda m: (m.num_embeddings, m.embedding_dim),
    LayerNorm: lambda m: tuple(m.normalized_shape),
}


def _state_from_numpy(np_state, model) -> dict:
    """A state dict for ``model`` from a ``paddle_tpu`` state dict of numpy
    arrays (as ``paddle_tpu.load(..., return_numpy=True)`` returns it):
    every name must be one of the model's, every shape fit."""
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


def bert_state_from_numpy(np_state, model) -> dict:
    """A state dict for ``model`` (a :class:`BertModel` or
    :class:`BertForPretraining`) from the ``paddle_tpu`` model's state dict
    of numpy arrays."""
    return _state_from_numpy(np_state, model)


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


def load_ernie_pretraining(path, cfg: BertConfig | None = None,
                           device=None) -> ErnieForPretraining:
    """An :class:`ErnieForPretraining` (``ernie_base_config()`` unless
    ``cfg``) holding the weights of a ``paddle_tpu.save`` file of a
    ``paddle_tpu`` ``ErnieForPretraining.state_dict()``."""
    model = ErnieForPretraining(cfg or ernie_base_config())
    model.load_state_dict(bert_pretraining_state_from_numpy(load(path, return_numpy=True),
                                                            model))
    return model if device is None else model.to(device)


def seq2seq_state_from_numpy(np_state, model: TransformerSeq2Seq) -> dict:
    """A state dict for the port's :class:`TransformerSeq2Seq` from the
    ``paddle_tpu`` model's state dict of numpy arrays: every parameter by
    name and shape, and the ``pos_enc`` buffer, which must equal the
    port's own table bit for bit (both compute it in float64 and round
    once)."""
    if "pos_enc" in np_state:
        own = model.pos_enc.detach().cpu().numpy()
        got = np.asarray(np_state["pos_enc"])
        if got.shape != own.shape or not np.array_equal(got, own):
            raise ValueError("pos_enc differs from the port's positional encoding of shape "
                             f"{own.shape}")
    return _state_from_numpy(np_state, model)


def load_seq2seq(path, device=None, **model_kwargs) -> TransformerSeq2Seq:
    """A :class:`TransformerSeq2Seq` of ``model_kwargs`` (``src_vocab``,
    ``tgt_vocab``, ``d_model``, ...: the saved model's) holding the weights
    of a ``paddle_tpu.save`` file of a ``paddle_tpu`` ``TransformerSeq2Seq``'s
    ``state_dict()``."""
    model = TransformerSeq2Seq(**model_kwargs)
    model.load_state_dict(seq2seq_state_from_numpy(load(path, return_numpy=True), model))
    return model if device is None else model.to(device)


def gpt_state_from_numpy(np_state, model: GPTForCausalLM) -> dict:
    """A state dict for the port's :class:`~paddle_tpu_torch.models.GPTForCausalLM`
    (or ``GPTModel``) from the ``paddle_tpu`` model's state dict of numpy
    arrays, by name and shape."""
    return _state_from_numpy(np_state, model)


def load_gpt(path, cfg: GPTConfig | None = None, device=None) -> GPTForCausalLM:
    """A :class:`GPTForCausalLM` of ``cfg`` (GPT-2 small unless given),
    eval mode, holding the weights of a ``paddle_tpu.save`` file of a
    ``paddle_tpu`` ``GPTForCausalLM.state_dict()``."""
    model = GPTForCausalLM(cfg or GPTConfig())
    model.load_state_dict(gpt_state_from_numpy(load(path, return_numpy=True), model))
    model.eval()
    return model if device is None else model.to(device)


def resnet_state_from_numpy(np_state, model) -> dict:
    """A state dict for the port's :class:`~paddle_tpu_torch.models.ResNet`
    from the ``paddle_tpu`` ResNet's state dict of numpy arrays: its
    parameters and running statistics, by name."""
    return _state_from_numpy(np_state, model)


def vgg_state_from_numpy(np_state, model) -> dict:
    """A state dict for the port's :class:`~paddle_tpu_torch.models.VGG`
    from the ``paddle_tpu`` VGG's: its parameters (and batch-norm
    statistics with ``batch_norm=True``), by name."""
    return _state_from_numpy(np_state, model)


def mobilenet_state_from_numpy(np_state, model) -> dict:
    """A state dict for the port's ``MobileNetV1``/``MobileNetV2`` from the
    ``paddle_tpu`` model's: parameters and running statistics, by name."""
    return _state_from_numpy(np_state, model)


def se_resnext_state_from_numpy(np_state, model) -> dict:
    """A state dict for the port's ``SEResNeXt`` from the ``paddle_tpu``
    model's: parameters and running statistics, by name."""
    return _state_from_numpy(np_state, model)


def word2vec_state_from_numpy(np_state, model) -> dict:
    """A state dict for the port's ``Word2Vec`` from the ``paddle_tpu``
    model's: the embedding and the head, by name."""
    return _state_from_numpy(np_state, model)


def load_resnet(path, model_fn=resnet50, device=None, **kwargs):
    """The ResNet ``model_fn(**kwargs)`` holding the weights and running
    statistics of a ``paddle_tpu.save`` file of a ``paddle_tpu`` ResNet's
    ``state_dict()``."""
    model = model_fn(**kwargs)
    model.load_state_dict(resnet_state_from_numpy(load(path, return_numpy=True), model))
    return model if device is None else model.to(device)


def optimizer_state_from_numpy(np_state, optimizer) -> dict:
    """A state dict for the port's ``optimizer`` (any of its optimizers,
    ``Lookahead`` and its ``slow_{i}`` included) from a ``paddle_tpu`` one
    of numpy arrays: ``global_step``, the lr scheduler's state if any, and
    every accumulator ``{name}_{i}`` the state holds, one per parameter,
    each checked against the shape of the port's parameter ``i`` and given
    the dtype of the port's accumulator (the parameter's where it has none
    yet)."""
    params = optimizer._parameter_list
    out = {"global_step": int(np_state["global_step"])}
    if "LR_Scheduler" in np_state:
        out["LR_Scheduler"] = np_state["LR_Scheduler"]
    names = {k.rsplit("_", 1)[0] for k in np_state if k not in ("global_step", "LR_Scheduler")}
    for name in sorted(names):
        keys = [k for k in np_state if k.rsplit("_", 1)[0] == name]
        if sorted(keys) != sorted(f"{name}_{i}" for i in range(len(params))):
            raise KeyError(f"{name}: state holds {len(keys)} entries for {len(params)} "
                           "parameters")
        own = optimizer._accumulators.get(name)
        for i, p in enumerate(params):
            arr = np.array(np_state[f"{name}_{i}"])
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}_{i}: shape {arr.shape} does not fit parameter "
                                 f"{optimizer._param_names[i]} {tuple(p.shape)}")
            out[f"{name}_{i}"] = torch.as_tensor(arr, dtype=own[i].dtype if own else p.dtype)
    return out


def adamw_state_from_numpy(np_state, optimizer) -> dict:
    """:func:`optimizer_state_from_numpy` for ``Adam``/``AdamW``:
    ``global_step`` and the moments ``moment1_{i}``/``moment2_{i}``."""
    return optimizer_state_from_numpy(np_state, optimizer)


def momentum_state_from_numpy(np_state, optimizer) -> dict:
    """:func:`optimizer_state_from_numpy` for ``Momentum``: ``global_step``
    and the velocities ``velocity_{i}``."""
    return optimizer_state_from_numpy(np_state, optimizer)


def int8_model_from_numpy(program_dict, np_params, scope=None):
    """The port's ``Program`` of a serialized one (``Program.to_dict()`` of
    either package), its parameters set into ``scope`` (a new one when
    None) as tensors of the dtypes they were saved in: int8 weights stay
    int8 and no float copy of them is made. Every persistable variable an
    op reads must be among ``np_params``. Returns ``(program, scope)``."""
    from .static.executor import Scope
    from .static.program import Program

    program = Program.from_dict(program_dict)
    scope = Scope() if scope is None else scope
    block = program.global_block()
    read = {n for op in block.ops for n in op.input_names()}
    written = {n for op in block.ops for n in op.output_names()}
    missing = sorted(n for n in read - written
                     if block.has_var(n) and block.var(n).persistable
                     and n not in np_params and n not in program._constants)
    if missing:
        raise KeyError(f"the saved parameters lack {missing}")
    for name, arr in np_params.items():
        arr = np.asarray(arr)
        if block.has_var(name):
            var = block.var(name)
            if var.dtype != arr.dtype.name or list(var.shape) != list(arr.shape):
                raise ValueError(f"parameter {name!r} is {arr.dtype.name}{list(arr.shape)}, the "
                                 f"program declares {var.dtype}{var.shape}")
        scope.set(name, arr)
    return program, scope


def load_int8_model(dirname, scope=None):
    """``(program, feed_names, fetch_names)`` of a directory written by
    ``save_inference_model`` / ``save_int8_model`` of either package."""
    from .static.io import load_inference_model

    return load_inference_model(dirname, None, scope=scope)


def scope_from_numpy(np_vars, scope=None, device=None):
    """``scope`` (a new one when None) holding each ``name -> array`` of
    ``np_vars`` (a ``paddle_tpu`` scope's values as numpy) as a tensor of
    its dtype on ``device`` (the card unless the caller names another), a
    copy of its own. Returns the scope."""
    from .static.executor import Scope

    device = resolve_device(device)
    scope = Scope() if scope is None else scope
    for name, arr in np_vars.items():
        scope.set(name, torch.from_numpy(np.array(arr)).to(device))
    return scope
