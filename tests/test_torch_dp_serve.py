"""Data-parallel serving in the port against the JAX package, on the CPU.

`TorchModelRunner(mesh=make_mesh((2, 1), ["cpu", "cpu"]))` keeps two
replicas of the model in one process and splits each bucket's rows between
them; it is held against JAX's runner on `make_mesh((2, 1))` over two of the
suite's host devices, on the same checkpoint (the flagship at SMALL widths),
within 1e-5 (`tests/test_runner.py::test_runner_mesh_dp_matches_single`'s
bound): buckets rounded to multiples of dp as JAX's are, from host arrays,
from staged batches and on the blank-video route.  Every runner option on a
dp mesh (kernels through their plain versions, `fused=True`,
`quantize_int8`, bf16) is held against the same option on one device: the
replicas run the same modules on fewer rows, float32 within 1e-6, bf16
within 1e-2.  `ServeConfig.make_mesh` from `EMO_MESH_SHAPE` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.config import ModelConfig as JaxModelConfig
from multimodalemotionrecognition_tpu.config import ServeConfig as JaxServeConfig
from multimodalemotionrecognition_tpu.convert import torch_import
from multimodalemotionrecognition_tpu.models.factory import build_model as jax_build_model
from multimodalemotionrecognition_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodalemotionrecognition_tpu.runtime.runner import JaxModelRunner
from multimodalemotionrecognition_torch.config import ServeConfig
from multimodalemotionrecognition_torch.parallel.mesh import Mesh, make_mesh
from multimodalemotionrecognition_torch.runtime.runner import TorchModelRunner
from multimodalemotionrecognition_torch.serving.predictor import EmotionPredictor

from tests.test_wavlm_fused_attn import SMALL

FRAMES = (8, 3, 32, 32)
JAX_TOL = 1e-5
SAME_MODULES_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
SAME_MODULES = dict(atol=SAME_MODULES_TOL["float32"], rtol=0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxModelConfig(
        fusion="xattn", num_classes=8, use_wavlm=True, spec_augment=False,
        xattn_d_model=32, xattn_attn_dropout=0.0, xattn_stochastic_depth=0.0,
        wavlm_geometry=dict(SMALL),
    )
    model = jax_build_model(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1,) + FRAMES), jnp.zeros((1, 1, 48000))
    )
    path = tmp_path_factory.mktemp("dp_serve") / "best_xattn_wavlm.pt"
    torch_import.save_torch_checkpoint(path, variables, config=cfg.to_checkpoint_dict())
    return str(path)


def _clips(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n, *FRAMES).astype(np.float32), (rng.randn(n, 1, 48000) * 0.1).astype(np.float32)


def _dp2():
    return make_mesh((2, 1), devices=["cpu", "cpu"])


def test_dp_runner_matches_the_jax_mesh_runner(ckpt):
    """3 clips (bucket 4) from host arrays against JAX's mesh runner (1e-5);
    1 clip (bucket 2), the staged and the blank-video routes against the
    port's own single-device runner, which the rest of the suite holds
    against JAX (1e-6)."""
    jax_runner = JaxModelRunner(ckpt, mesh=jax_make_mesh((2, 1), devices=jax.devices()[:2]),
                                batch_buckets=(1, 2, 4, 8))
    port = TorchModelRunner(ckpt, device="cpu", mesh=_dp2(), batch_buckets=(1, 2, 4, 8))
    single = TorchModelRunner(ckpt, device="cpu")
    assert port.batch_buckets == jax_runner.batch_buckets == (2, 4, 8)
    assert len(port.replicas) == 2 and port.replicas[0].forward is not port.replicas[1].forward
    video, audio = _clips(1, seed=1)
    got = port.predict_probs(video, audio)
    assert got.shape == (1, 8)
    np.testing.assert_allclose(got, single.predict_probs(video, audio), **SAME_MODULES)
    video, audio = _clips(3, seed=3)
    got = port.predict_probs(video, audio)
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got, jax_runner.predict_probs(video, audio), atol=JAX_TOL, rtol=0)
    v_staged, a_staged, m = port.stage(video, audio)
    assert m == 3 and [t.shape[0] for t in v_staged] == [2, 2]  # bucket 4 over 2 replicas
    np.testing.assert_allclose(port.predict_probs(v_staged, a_staged, n=m), got, **SAME_MODULES)
    blank = single.predict_probs_blank_video(audio)
    np.testing.assert_allclose(port.predict_probs_blank_video(audio), blank, **SAME_MODULES)
    a_staged, m = port.stage_audio(audio)
    np.testing.assert_allclose(port.predict_probs_blank_video(a_staged, n=m), blank, **SAME_MODULES)


@pytest.mark.parametrize("options", [
    dict(fused_wavlm=True),
    dict(fused_wavlm=True, fused=True),
    dict(quantize_int8=True, fused=True),
    dict(compute_dtype="bfloat16", fused_wavlm=True),
], ids=["kernels", "fused", "int8_fused", "bf16"])
def test_every_option_on_a_dp_mesh_equals_one_device(ckpt, options):
    single = TorchModelRunner(ckpt, device="cpu", **options)
    dp = TorchModelRunner(ckpt, device="cpu", mesh=_dp2(), **options)
    assert dp.batch_buckets == (2, 4, 8) and bool(dp.quantized) == bool(single.quantized)
    assert (dp._fused_forward is not None) == options.get("fused", False)
    video, audio = _clips(3, seed=7)
    tol = SAME_MODULES_TOL[options.get("compute_dtype", "float32")]
    np.testing.assert_allclose(dp.predict_probs(video, audio), single.predict_probs(video, audio),
                               atol=tol, rtol=0)


def test_serve_config_make_mesh_from_the_environment(monkeypatch):
    monkeypatch.setenv("EMO_MESH_SHAPE", "2")
    cfg, jax_cfg = ServeConfig.from_env(), JaxServeConfig.from_env()
    assert cfg.mesh_shape == jax_cfg.mesh_shape == (2, 1)
    mesh = cfg.make_mesh("cpu")
    assert isinstance(mesh, Mesh) and mesh.shape == dict(jax_cfg.make_mesh().shape)
    assert mesh.data_devices == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 2 CUDA cards"):
            cfg.make_mesh()
    monkeypatch.setenv("EMO_MESH_SHAPE", "")
    assert ServeConfig.from_env().make_mesh("cpu") is None


def test_predictor_serves_through_the_configs_mesh(ckpt):
    predictor = EmotionPredictor(checkpoint_path=ckpt, config=ServeConfig(mesh_shape=(2, 1)),
                                 device="cpu")
    assert predictor.runner.mesh.shape == {"data": 2, "model": 1}
    assert predictor.runner.batch_buckets == (2, 4, 8)
