"""The port's package boundary: ``paddle_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor ``paddle_tpu``; entry points never fall back to
the CPU on their own; the kernels build from the package's sources."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.inference import Predictor  # noqa: E402
from paddle_tpu_torch.jit_api import InputSpec  # noqa: E402
from paddle_tpu_torch.ops.cuda import _build  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "paddle_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _port_files():
    files = [SMOKE]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu") or top.startswith("jax")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_paddle_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_covers_every_generation_module():
    """The paging module keeps its own copy of what it needs: the scan above
    reaches it and every other module of ``generation/``."""
    gen = os.path.join(PORT_DIR, "generation")
    mods = {os.path.join(gen, n) for n in os.listdir(gen) if n.endswith(".py")}
    assert os.path.join(gen, "paging.py") in mods and mods <= set(_port_files())


def test_scan_covers_the_dygraph_front_end():
    """The scan above reaches every module of the dygraph front end: the
    Tensor and the places, the op front and its kernels, the tensor and
    linalg namespaces, ``nn``'s layers and ``jit``."""
    rel = {os.path.relpath(p, PORT_DIR) for p in _port_files()}
    tensor_ns = {f"tensor/{n}" for n in os.listdir(os.path.join(PORT_DIR, "tensor"))
                 if n.endswith(".py")}
    assert len(tensor_ns) == 10
    assert tensor_ns | {"framework/tensor.py", "framework/place.py", "framework/dtype.py",
                        "framework/autograd.py", "ops/__init__.py", "ops/tensor_kernels.py",
                        "linalg.py", "device.py", "nn/layer_base.py", "nn/layers.py",
                        "nn/functional.py", "nn/rnn.py", "nn/initializer.py",
                        "jit_api.py"} <= rel


def test_scan_covers_the_single_card_api():
    """The scan reaches the lint and its gate, the hapi text layers, the
    program statistics, the custom op loader, the utilities and the
    distributions."""
    rel = {os.path.relpath(p, PORT_DIR) for p in _port_files()}
    assert {"analysis/lint.py", "analysis/waivers.py", "analysis/graphlint.py",
            "incubate/hapi_text.py", "incubate/model_stat.py", "framework/op_library.py",
            "utils/download.py", "utils/install_check.py", "distribution.py",
            "inference/predictor.py", "runtime/compiled.py"} <= rel


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom paddle_tpu.flags import flag\nimport jax.numpy as jnp\n"
                 "from paddle_tpu_torch import flags\n")
    assert [m for m in _imported_modules(str(p)) if _forbidden(m)] == [
        "paddle_tpu.flags", "jax.numpy"]


def test_predictor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = [InputSpec([None, 4], "float32", "x")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(torch.nn.Identity(), spec, ["y"])
    pred = Predictor(torch.nn.Identity(), spec, ["y"], device="cpu")
    assert pred.device.type == "cpu"


def test_kernels_build_from_package_sources_for_sm90a():
    for name in _build.KERNEL_SOURCES:
        src, so = _build._target(name)
        assert os.path.isfile(src) and src.startswith(os.path.join(PORT_DIR, "csrc"))
        assert os.path.dirname(so) == os.path.join(REPO, "build", "paddle_tpu_torch")
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


def test_every_kernel_source_is_built_counted_and_present():
    """``KERNEL_SOURCES`` names every ``csrc/*.cu`` (the int8 matmul and the
    max-pool backward among them), and every kernel has a launch counter."""
    from paddle_tpu_torch.ops import cuda

    on_disk = sorted(n[:-3] for n in os.listdir(os.path.join(PORT_DIR, "csrc"))
                     if n.endswith(".cu"))
    assert sorted(_build.KERNEL_SOURCES) == on_disk
    assert {"int8_matmul", "pool_backward"} <= set(_build.KERNEL_SOURCES)
    counts = cuda.launch_counts()
    assert {"int8_matmul", "max_pool2d_backward"} <= set(counts)
    cuda.reset_launch_counts()
    assert set(cuda.launch_counts().values()) == {0}


def test_program_predictor_without_a_card_raises(monkeypatch, tmp_path):
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.static import Executor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_predictor(Config(str(tmp_path)))


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Away from the package (and here, without CUDA) the smoke exits
    non-zero and prints nothing on stdout."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
