"""Every signature ``tools/api_spec.txt`` pins for the top level, ``tensor``,
``linalg``, ``nn``, ``device``, ``monitor``, ``static``, ``io``, ``metric``,
``reader``, ``text``, ``incubate`` (``auto_checkpoint`` and ``hapi_text``),
``analysis``, ``inference``, ``runtime``, ``distributed``,
``distributed.fleet``, ``parallel`` and the model zoo's VGG, MobileNet,
SE-ResNeXt and Word2Vec names against the port's parameter names. Of
``distributed`` and ``parallel``, the names of later slices are left out
(``LATER``: elastic training, the parameter server, the quantized
all-reduce, pipeline, expert, ring and Ulysses parallelism).

A pinned name's parameters must lead the port's, in order, by name and by
kind (``*args``, ``**kwargs``); the port may add parameters after them
only with defaults (``generator=``, ``device=``). A class is compared by
its constructor; a name pinned as ``(...)`` (an exception class) only
resolves. The port has every name of these. A name whose port object is
another API keeps its pin on its counterpart (``COUNTERPART``): the port's
``inference.Predictor`` serves an ``nn.Module``, and the JAX package's
``Predictor(config)`` is the port's ``ProgramPredictor``, which
``create_predictor`` returns."""
import ast
import inspect
import os
import re

import pytest

pytest.importorskip("torch")

import paddle_tpu_torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(REPO, "tools", "api_spec.txt")
NAMESPACES = ("tensor", "linalg", "nn", "device", "monitor", "static", "io", "metric",
              "reader", "text", "incubate", "analysis", "inference", "runtime", "distributed",
              "parallel")
LATER = {"elastic", "ps", "quantized_all_reduce", "GPipe", "PipelineParallel",
         "pipeline_schedule", "ring_attention", "ulysses_attention", "MoELayer", "SwitchFFN"}
ZOO = {"VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1", "MobileNetV2",
       "mobilenet_v1", "mobilenet_v2", "SEResNeXt", "se_resnext50_32x4d",
       "se_resnext101_32x4d", "Word2Vec"}
NOT_PORTED = set()
COUNTERPART = {"inference.Predictor": "inference.ProgramPredictor"}


def _pins():
    out = []
    with open(SPEC) as f:
        for line in f:
            line = line.strip()
            head, _, rest = line.partition("(")
            if not head.startswith("paddle_tpu."):
                continue
            dotted = head[len("paddle_tpu."):]
            ns = dotted.rpartition(".")[0]
            if LATER & set(dotted.split(".")):
                continue
            if (ns.split(".")[0] in NAMESPACES or ns in NAMESPACES or ns == ""
                    or (ns == "models" and dotted.split(".")[-1] in ZOO)):
                out.append((dotted, "(" + rest))
    return out


def _params(sig_text):
    """``[(name, kind)]`` of a pinned signature's text, kind ``*``/``**``/``""``."""
    depth, end = 0, 0
    for i, ch in enumerate(sig_text):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0:
            end = i
            break
    # a default's repr in angle brackets (<factory>, <built-in function ...>)
    src = re.sub(r"<[^<>]*>", "None", sig_text[:end + 1])
    args = ast.parse(f"def f{src}: pass").body[0].args
    out = [(a.arg, "") for a in args.posonlyargs + args.args]
    if args.vararg:
        out.append((args.vararg.arg, "*"))
    out += [(a.arg, "") for a in args.kwonlyargs]
    if args.kwarg:
        out.append((args.kwarg.arg, "**"))
    return out


def _resolve(dotted):
    obj = paddle_tpu_torch
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _port_params(obj):
    sig = inspect.signature(obj)
    kinds = {inspect.Parameter.VAR_POSITIONAL: "*", inspect.Parameter.VAR_KEYWORD: "**"}
    return [(p.name, kinds.get(p.kind, ""), p.default is not inspect.Parameter.empty
             or p.kind in kinds or p.kind == inspect.Parameter.KEYWORD_ONLY)
            for p in sig.parameters.values()]


PINS = [p for p in _pins() if p[0].split(".")[-1] not in NOT_PORTED]


@pytest.mark.parametrize("dotted,sig", PINS, ids=[p[0] for p in PINS])
def test_pinned_signature_leads_the_ports(dotted, sig):
    obj = _resolve(COUNTERPART.get(dotted, dotted))
    assert obj is not None, f"paddle_tpu_torch.{dotted} is missing"
    if sig.startswith("(...)"):
        return
    want = _params(sig)
    got = _port_params(obj)
    assert [(n, k) for n, k, _ in got[:len(want)]] == want, (
        f"{dotted}: pinned {want}, port {[(n, k) for n, k, _ in got]}")
    extra = [n for n, _, has_default in got[len(want):] if not has_default]
    assert not extra, f"{dotted}: the port's extra parameters {extra} have no default"


def test_only_the_hapi_and_distributed_names_are_missing():
    missing = {d for d, _ in _pins() if _resolve(d) is None}
    assert missing == NOT_PORTED
