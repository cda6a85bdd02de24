"""The port imports neither jax nor flax.

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
    assert report["heavy"] == []
    # Of the JAX package only its framework-free config module is used.
    assert set(report["tpu"]) <= {
        "multimodalemotionrecognition_tpu",
        "multimodalemotionrecognition_tpu.config",
        "multimodalemotionrecognition_tpu.version",
    }
