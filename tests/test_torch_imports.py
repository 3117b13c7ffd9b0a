"""The port stands alone: no file of ``src/repro_torch/``, of ``tools/``
and not ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro`` (the
module name ``repro`` itself; ``repro_torch`` is the port), and importing
its modules builds no kernel."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
         + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_the_port():
    assert len(FILES) > 10
    assert any(m.startswith("repro_torch") for m in _imported(ROOT / "chip_smoke.py"))


SLICE_MODULES = ("repro_torch.prng", "repro_torch.core.secure", "repro_torch.kernels.secure_mask",
                 "repro_torch.kernels.sparsify", "repro_torch.core.steps",
                 "repro_torch.core.scheduler", "repro_torch.kernels.swa_attention",
                 "repro_torch.kernels.ssd_chunk", "repro_torch.models.config",
                 "repro_torch.models.common", "repro_torch.models.attention",
                 "repro_torch.models.transformer", "repro_torch.models.ssm",
                 "repro_torch.models.hybrid", "repro_torch.models.api", "repro_torch.convert",
                 "repro_torch.serving.engine", "repro_torch.configs.smollm_135m",
                 "repro_torch.configs.mamba2_370m", "repro_torch.configs.zamba2_1_2b",
                 "repro_torch.serve", "repro_torch.core.topology", "repro_torch.core.sharing",
                 "repro_torch.core.mixing", "repro_torch.core.compression",
                 "repro_torch.core.engine", "repro_torch.core.node", "repro_torch.models.mlp",
                 "repro_torch.optim.optimizers", "repro_torch.checkpoint.checkpoint",
                 "repro_torch.utils.io", "repro_torch.topologies_dynamic",
                 "repro_torch.sparsification", "repro_torch.core.faults",
                 "repro_torch.core.federated", "repro_torch.faults",
                 "repro_torch.churn", "repro_torch.fl_vs_dl", "repro_torch.core.network",
                 "repro_torch.runtime.__init__", "repro_torch.runtime.transport",
                 "repro_torch.runtime.membership", "repro_torch.runtime.peer",
                 "repro_torch.runtime.runner", "repro_torch.runtime.calibrate",
                 "repro_torch.processes", "repro_torch.secure_aggregation",
                 "repro_torch.models.moe", "repro_torch.training.trainer",
                 "repro_torch.launch.train", "repro_torch.models.encdec",
                 "repro_torch.configs.deepseek_v2_236b", "repro_torch.configs.whisper_tiny",
                 "repro_torch.configs.qwen2_vl_72b", "repro_torch.launch.mesh",
                 "repro_torch.launch.specs", "repro_torch.launch.analytic",
                 "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
                 "repro_torch.kernels.cost", "repro_torch.launch.shard",
                 "repro_torch.core.__init__", "repro_torch.data.__init__",
                 "repro_torch.utils.__init__", "repro_torch.data.partition",
                 "repro_torch.utils.pytree")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_module_is_covered_and_builds_nothing_at_import(module):
    """Each module of the slice is among the files checked above, and a
    fresh interpreter imports it with the kernel builder disabled, loads no
    ``jax`` or ``repro`` module on the way, touches no CUDA device, starts
    no process group, and creates no build output."""
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path in FILES
    code = (
        "import sys; import repro_torch.kernels.build as b\n"
        "def refuse(*a, **k): raise AssertionError('a kernel was built at import')\n"
        "b.build = refuse\n"
        f"import {module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "import torch, torch.distributed as dist\n"
        "assert not torch.cuda.is_initialized(), 'a device was touched at import'\n"
        "assert not dist.is_initialized(), 'a process group was started at import'\n"
    )
    before = set(b.name for b in (ROOT / "build").glob("**/*")) if (ROOT / "build").exists() else set()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    after = set(b.name for b in (ROOT / "build").glob("**/*")) if (ROOT / "build").exists() else set()
    assert after == before
