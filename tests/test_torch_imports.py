"""The port imports neither jax nor flax, and nothing of the JAX package.

Checked in a fresh interpreter: this suite's conftest imports jax into the
test process itself.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, json, pkgutil, sys
import multimodalemotionrecognition_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
tpu = sorted(m for m in sys.modules if m.startswith("multimodalemotionrecognition_tpu"))
print(json.dumps({"modules": names, "heavy": heavy, "tpu": tpu}))
"""


def test_port_imports_no_jax_or_flax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "multimodalemotionrecognition_torch.runtime.runner" in report["modules"]
    assert "multimodalemotionrecognition_torch.kernels.wavlm_attn" in report["modules"]
    assert "multimodalemotionrecognition_torch.kernels.fused_block" in report["modules"]
    assert "multimodalemotionrecognition_torch.runtime.fused" in report["modules"]
    for module in ("train.trainer", "train.freeze", "utils.metrics", "utils.seed", "utils.device",
                   "ops.stochastic", "bench", "bench.attn_tile", "bench.forward", "entry",
                   "ops.mel", "ops.image", "models.audio", "kernels.wavlm_attn_tiled",
                   "__main__", "data", "data.face", "data.haar", "data.media", "utils.profiling",
                   "serving", "serving.preprocess", "serving.predictor", "serving.batcher",
                   "serving.streaming", "serving.http", "serving.server_direct",
                   "serving.server_queued", "serving.redis_transport", "data.ravdess",
                   "data.pipeline", "data.synthetic", "data.qa_export", "train.cli", "train.eval",
                   "bench.convergence_gate", "runtime.export", "models.blazeface",
                   "convert.blazeface_export", "data.synthface"):
        assert f"multimodalemotionrecognition_torch.{module}" in report["modules"]
    assert report["heavy"] == []
    # Not even the JAX package's framework-free modules: the port has its own config.
    assert report["tpu"] == []
