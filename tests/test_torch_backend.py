"""The port's backend CLI (``python -m paddle_tpu_torch.serving.backend``) and
the router's process entry point, against the JAX CLI.

``build_server`` for each kind with ``--device cpu``; the CLI refuses what
the JAX CLI refuses; one subprocess run of each entry point: the port file
written after warmup, requests answered, SIGTERM -> drain -> exit 0.
"""
import json
import os
import signal
import subprocess
import sys
import time
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.serving import backend as jbackend  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import flags as pflags  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch import monitor as pmon  # noqa: E402
from paddle_tpu_torch import static  # noqa: E402
from paddle_tpu_torch.inference import Config, create_predictor  # noqa: E402
from paddle_tpu_torch.serving import GenerationServer, InferenceServer  # noqa: E402
from paddle_tpu_torch.serving import backend as pbackend  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM = 6


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A saved static program and a saved tiny GPT (and its one-layer draft)."""
    root = tmp_path_factory.mktemp("backend")
    model_dir = str(root / "model")
    static.enable_static()
    static.reset_default_programs()
    static.global_scope().clear()
    try:
        ptt.seed(6)
        x = static.data("x", [None, IN_DIM], "float32")
        y = static.nn.fc(static.nn.fc(x, 8, activation="relu"), 3)
        exe = static.Executor("cpu")
        exe.run_startup()
        static.save_inference_model(model_dir, ["x"], [y], exe)
    finally:
        static.disable_static()
        static.reset_default_programs()
        static.global_scope().clear()
    cfg = pmodels.gpt_tiny_config()
    cfg.attention_window = 24
    gpt = pmodels.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(2)).eval()
    gpt_dir = pmodels.save_gpt_model(gpt, str(root / "gpt"))
    draft_dir = pmodels.save_gpt_model(pmodels.truncated_draft(gpt, 1), str(root / "draft"))
    return model_dir, gpt_dir, draft_dir


GEN = ["--slots", "2", "--cache-len", "24", "--prefill-buckets", "4,8", "--device", "cpu"]


@pytest.mark.parametrize("kind", ["predict", "generate", "prefill", "decode"])
def test_build_server_for_each_kind(kind, dirs):
    model_dir, gpt_dir, _ = dirs
    if kind == "predict":
        argv = ["--kind", kind, "--model-dir", model_dir, "--device", "cpu", "--buckets", "1,2"]
    else:
        argv = ["--kind", kind, "--gpt-dir", gpt_dir] + GEN
    # the counter is the process's: what ran before in it may have booked captures
    unexpected = pmon.counter("serving/unexpected_compiles" if kind == "predict"
                              else "serving/gen_unexpected_compiles")
    base = unexpected.value
    srv = pbackend.build_server(pbackend._parse_args(argv))
    try:
        if kind == "predict":
            assert isinstance(srv, InferenceServer) and srv.batcher.buckets == (1, 2)
            assert srv.pool._preds[0].device.type == "cpu"
        else:
            assert isinstance(srv, GenerationServer) and srv.kind == kind
            e = srv.engine
            assert e.device.type == "cpu" and e.slots == 2 and e.cache_len == 24
            assert e.prefill_buckets == (4, 8) and not e.speculative
        srv.start()
        lz = srv.loadz()
        assert lz["kind"] == kind and lz["ready"] and lz["compiles"]["unexpected"] == base
    finally:
        srv.stop(drain=False)


def test_speculative_from_the_flag_or_the_option(dirs, monkeypatch):
    _, gpt_dir, draft_dir = dirs
    base = ["--kind", "decode", "--gpt-dir", gpt_dir, "--draft-dir", draft_dir] + GEN
    plain = pbackend.build_server(pbackend._parse_args(base))
    assert not plain.engine.speculative  # a draft directory alone does not speculate
    spec = pbackend.build_server(pbackend._parse_args(base + ["--speculative", "--draft-k",
                                                              "2"]))
    assert spec.engine.speculative and spec.engine.draft_k == 2
    monkeypatch.setattr(pflags._REGISTRY["speculative_enabled"], "value", True)
    flagged = pbackend.build_server(pbackend._parse_args(base))
    assert flagged.engine.speculative and flagged.engine.draft_k == pflags.flag(
        "speculative_draft_k")
    for s in (plain, spec, flagged):
        s.stop(drain=False)


@pytest.mark.parametrize("argv", [
    [],
    ["--kind", "predict"],
    ["--kind", "generate"],
    ["--kind", "decode", "--gpt-dir", "d", "--speculative"],
    ["--kind", "train", "--gpt-dir", "d"],
    ["--kind", "predict", "--model-dir", "d", "--port", "x"],
])
def test_cli_refuses_what_the_jax_cli_refuses(argv, capsys):
    for mod in (jbackend, pbackend):
        with pytest.raises(SystemExit) as e:
            mod._parse_args(argv)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("error:") == 2


def test_the_cli_takes_every_jax_option_but_mesh_dp():
    def options(mod):
        import argparse

        seen = set()
        orig = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            seen.update({o for a in self._actions for o in a.option_strings})
            return orig(self, ["--kind", "predict", "--model-dir", "d"])

        argparse.ArgumentParser.parse_args = grab
        try:
            mod._parse_args([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    jax_opts, port_opts = options(jbackend), options(pbackend)
    assert jax_opts - port_opts == {"--mesh-dp"}
    assert port_opts - jax_opts == {"--device"}


def test_announce_port_is_atomic(tmp_path):
    path = str(tmp_path / "port")
    pbackend._announce_port(path, 4242)
    assert open(path).read() == "4242" and os.listdir(tmp_path) == ["port"]


def _wait_file(path, proc, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return int(open(path).read())
        if proc.poll() is not None:
            raise AssertionError(f"process exited {proc.returncode}: {proc.stdout.read()}")
        time.sleep(0.05)
    raise AssertionError(f"no port file after {timeout} s")


def _spawn(module, args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-m", module] + args, cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_backend_and_router_processes(dirs, tmp_path):
    """A predict backend process and a router process in front of it: the
    port files appear once ready, /predict through the router equals the
    predictor's answer, SIGTERM drains each and it exits 0."""
    model_dir, _, _ = dirs
    bfile, rfile = str(tmp_path / "backend.port"), str(tmp_path / "router.port")
    backend = _spawn("paddle_tpu_torch.serving.backend",
                     ["--kind", "predict", "--model-dir", model_dir, "--device", "cpu",
                      "--buckets", "1,2,4", "--port-file", bfile])
    router = None
    try:
        url = f"http://127.0.0.1:{_wait_file(bfile, backend)}"
        assert json.loads(urlopen(url + "/healthz").read())["ready"]
        assert json.loads(urlopen(url + "/loadz").read())["kind"] == "predict"
        router = _spawn("paddle_tpu_torch.serving.router",
                        ["--backend", url, "--port-file", rfile, "--probe-interval-s", "0.1"])
        rurl = f"http://127.0.0.1:{_wait_file(rfile, router)}"
        a = np.random.RandomState(1).randn(3, IN_DIM).astype("float32")
        r = urlopen(Request(rurl + "/predict", data=json.dumps({"inputs": a.tolist()}).encode()),
                    timeout=60)
        got = np.asarray(next(iter(json.loads(r.read())["outputs"].values())), "float32")
        want = create_predictor(Config(model_dir), device="cpu").run([a])[0]
        np.testing.assert_array_equal(got, want)
        assert json.loads(urlopen(rurl + "/statz").read())["fleet"]["requests"] == 1
        for proc in (router, backend):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
        assert "serving backend ready" in backend.stdout.read()
        assert "serving router ready" in router.stdout.read()
    finally:
        for proc in (backend, router):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
