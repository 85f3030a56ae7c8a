"""Import hygiene of the port: ``paddle_tpu_torch``, ``chip_smoke.py``,
``scripts/profile_torch_train_step.py``, ``scripts/ab_eager_amp.py``,
``scripts/ab_data_parallel.py``, ``scripts/chip_grad_comm.py``,
``scripts/chip_auto_parallel.py``, ``scripts/chip_pipeline_3d.py``,
``scripts/chip_jit.py``, ``scripts/chip_context_hybrid.py`` and
``scripts/chip_elastic.py`` import neither ``jax`` nor anything of
``paddle_tpu`` — not even its modules that do not import JAX. Later
slices that reach into the JAX package fail here."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "scripts" / "profile_torch_train_step.py",
                    ROOT / "scripts" / "ab_eager_amp.py",
                    ROOT / "scripts" / "ab_data_parallel.py",
                    ROOT / "scripts" / "chip_grad_comm.py",
                    ROOT / "scripts" / "chip_auto_parallel.py",
                    ROOT / "scripts" / "chip_pipeline_3d.py",
                    ROOT / "scripts" / "chip_jit.py",
                    ROOT / "scripts" / "chip_context_hybrid.py",
                    ROOT / "scripts" / "chip_elastic.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_port_has_files_to_scan():
    assert len(_port_files()) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_package():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.convert\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.text.gpt, paddle_tpu_torch.ops\n"
        "import paddle_tpu_torch.optimizer, paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.nn.clip, paddle_tpu_torch.nn.functional\n"
        "import paddle_tpu_torch.nn.layer\n"
        "import paddle_tpu_torch.text.ernie, paddle_tpu_torch.text.bert\n"
        "import paddle_tpu_torch.vision.models, paddle_tpu_torch.hapi\n"
        "import paddle_tpu_torch.io, paddle_tpu_torch.metric\n"
        "import paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.utils.flags\n"
        "import paddle_tpu_torch.ops.dispatch, paddle_tpu_torch.ops.math\n"
        "import paddle_tpu_torch.optimizer.lr\n"
        "import paddle_tpu_torch.optimizer.lbfgs\n"
        "import paddle_tpu_torch.observability.perf\n"
        "import paddle_tpu_torch.distributed.store\n"
        "import paddle_tpu_torch.distributed.substrate\n"
        "import paddle_tpu_torch.distributed.elastic\n"
        "import paddle_tpu_torch.distributed.elastic.agent\n"
        "import paddle_tpu_torch.distributed.elastic.rendezvous\n"
        "import paddle_tpu_torch.distributed.store_ha\n"
        "import paddle_tpu_torch.distributed.rpc\n"
        "import paddle_tpu_torch.distributed.checkpoint\n"
        "import paddle_tpu_torch.framework.io\n"
        "import paddle_tpu_torch.utils.dlpack\n"
        "import paddle_tpu_torch.hapi.summary, paddle_tpu_torch.hapi.flops\n"
        "import paddle_tpu_torch.utils.native_build\n"
        "import paddle_tpu_torch.observability.metrics\n"
        "import paddle_tpu_torch.observability.trace\n"
        "import paddle_tpu_torch.observability.requesttrace\n"
        "import paddle_tpu_torch.observability.flight\n"
        "import paddle_tpu_torch.observability.slo\n"
        "import paddle_tpu_torch.observability.expo\n"
        "import paddle_tpu_torch.inference.serving.compile_cache\n"
        "import paddle_tpu_torch.inference.serving.fleet\n"
        "import paddle_tpu_torch.inference.serving.degrade\n"
        "import paddle_tpu_torch.inference.serving.replica\n"
        "import paddle_tpu_torch.inference.serving.router\n"
        "import paddle_tpu_torch.inference.serving.load\n"
        "import paddle_tpu_torch.inference.serving.autoscaler\n"
        "import paddle_tpu_torch.framework, paddle_tpu_torch.tensor\n"
        "import paddle_tpu_torch.framework.dtype\n"
        "import paddle_tpu_torch.framework.place\n"
        "import paddle_tpu_torch.framework.random\n"
        "import paddle_tpu_torch.tensor_methods\n"
        "import paddle_tpu_torch.autograd, paddle_tpu_torch.autograd.tape\n"
        "import paddle_tpu_torch.autograd.grad_mode\n"
        "import paddle_tpu_torch.autograd.functional\n"
        "import paddle_tpu_torch.autograd.py_layer\n"
        "import paddle_tpu_torch.ops.op_table, paddle_tpu_torch.ops.registry\n"
        "import paddle_tpu_torch.ops.common, paddle_tpu_torch.ops.comparison\n"
        "import paddle_tpu_torch.ops.creation\n"
        "import paddle_tpu_torch.ops.random_ops\n"
        "import paddle_tpu_torch.ops.manipulation\n"
        "import paddle_tpu_torch.ops.indexing, paddle_tpu_torch.ops.linalg\n"
        "import paddle_tpu_torch.ops.sweep\n"
        "import paddle_tpu_torch.nn.layer.layers\n"
        "import paddle_tpu_torch.distributed.collective\n"
        "import paddle_tpu_torch.distributed.comm_plane\n"
        "import paddle_tpu_torch.distributed.comm_quant\n"
        "import paddle_tpu_torch.distributed.fleet.meta_optimizers\n"
        "import paddle_tpu_torch.distributed.sharding_api\n"
        "import paddle_tpu_torch.distributed.auto_parallel\n"
        "import paddle_tpu_torch.distributed.fleet_executor\n"
        "import paddle_tpu_torch.distributed.parallel\n"
        "import paddle_tpu_torch.distributed.spawn\n"
        "import paddle_tpu_torch.distributed.launch.main\n"
        "import paddle_tpu_torch.distributed.communication.stream\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
