"""The port's BlazeFace slice against the JAX package's: `models/blazeface.py`
(anchors, decode, weighted NMS, the forward), `data/synthface.py` (scenes
and anchor targets, byte for byte), `data/face.py::BlazeFaceDetector` (the
same boxes on held-out scenes), `convert/blazeface_export.py` and the
bundled weights file.

Tolerance: the forward's raw boxes and scores within 1e-4 (float32
convolutions in another order); everything else is equal.
"""

import hashlib

import numpy as np
import pytest
import torch

from multimodalemotionrecognition_tpu.convert import blazeface_export as jax_export
from multimodalemotionrecognition_tpu.data import face as jax_face
from multimodalemotionrecognition_tpu.data import synthface as jax_sf
from multimodalemotionrecognition_tpu.models import blazeface as jax_bf
from multimodalemotionrecognition_torch.convert import blazeface_export
from multimodalemotionrecognition_torch.data import face, synthface
from multimodalemotionrecognition_torch.models import blazeface as bf

ATOL = 1e-4


def test_bundled_weights_are_the_jax_asset():
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (face.BUNDLED_BLAZEFACE_WEIGHTS, jax_face.BUNDLED_BLAZEFACE_WEIGHTS)]
    assert digest[0] == digest[1]
    assert face.BUNDLED_BLAZEFACE_WEIGHTS.parent.parent.name == "multimodalemotionrecognition_torch"


def test_anchors_spec_and_random_state_equal_jax():
    np.testing.assert_array_equal(bf.generate_anchors(), jax_bf.generate_anchors())
    assert bf.BLAZEFACE_SPEC == jax_bf.BLAZEFACE_SPEC
    for k in (3, 5):
        assert bf._spec(k) == jax_bf._spec(k)
        ours, theirs = bf.random_blazeface_state_dict(k, k), jax_bf.random_blazeface_state_dict(k, k)
        assert ours.keys() == theirs.keys()
        assert all(np.array_equal(ours[key], theirs[key]) for key in ours)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_and_nms_equal_jax(seed):
    rng = np.random.default_rng(seed)
    anchors = bf.generate_anchors()
    raw = rng.normal(0.0, 20.0, (896, 16)).astype(np.float32)
    boxes = bf.decode_boxes_np(raw, anchors)
    np.testing.assert_array_equal(boxes, jax_bf.decode_boxes_np(raw, anchors))
    scores = rng.uniform(0.0, 1.0, 896).astype(np.float32)
    for min_score in (0.5, 0.99, 1.1):
        ours = bf.weighted_nms_np(boxes, scores, min_score)
        theirs = jax_bf.weighted_nms_np(boxes, scores, min_score)
        if theirs is None:
            assert ours is None
        else:
            np.testing.assert_array_equal(ours[0], theirs[0])
            assert ours[1] == theirs[1]
    np.testing.assert_array_equal(bf._iou_np(boxes[0], boxes), jax_bf._iou_np(boxes[0], boxes))


def _state(name):
    if name == "bundled":
        return dict(np.load(face.BUNDLED_BLAZEFACE_WEIGHTS))
    return jax_bf.random_blazeface_state_dict(seed=int(name[-1]), kernel_size=int(name[-1]))


@pytest.mark.parametrize("weights", ["bundled", "random_k3", "random_k5"])
def test_forward_matches_jax(weights):
    state = _state(weights)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    want_boxes, want_scores = jax_bf.blazeface_forward(jax_bf.load_params(state), x)
    _, want_logits = jax_bf.blazeface_forward_logits(jax_bf.load_params(state), x)
    model = bf.load_blazeface(state)
    with torch.no_grad():
        boxes, scores = model(torch.from_numpy(x))
        _, logits = model.forward_logits(torch.from_numpy(x))
    assert boxes.shape == (2, 896, 16) and scores.shape == (2, 896)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)


def test_state_dict_keys_are_the_spec():
    model = bf.BlazeFace(5)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == bf._spec(5)


@pytest.mark.parametrize("seed, p_face", [(0, 0.9), (7, 0.9), (123, 0.5), (4242, 1.0)])
def test_scenes_and_targets_byte_equal_jax(seed, p_face):
    ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        img, bbox = synthface.make_scene(ours, p_face=p_face)
        jax_img, jax_bbox = jax_sf.make_scene(theirs, p_face=p_face)
        assert img.tobytes() == jax_img.tobytes() and bbox == jax_bbox
        for got, want in zip(synthface.anchor_targets(bbox), jax_sf.anchor_targets(jax_bbox)):
            assert got.tobytes() == want.tobytes()
    for got, want in zip(synthface.make_dataset(3, seed, p_face), jax_sf.make_dataset(3, seed, p_face)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_detector_boxes_equal_jax_on_held_out_scenes():
    """The JAX test's 24 held-out scenes (`tests/test_blazeface.py`): the
    same boxes, and the JAX test's bar (>= 0.8 found, mean IoU >= 0.5)."""
    from tests.test_blazeface import bbox_iou

    ours = face.BlazeFaceDetector(face.BUNDLED_BLAZEFACE_WEIGHTS)
    theirs = jax_face.BlazeFaceDetector(jax_face.BUNDLED_BLAZEFACE_WEIGHTS)
    rng = np.random.default_rng(4242)
    ious = []
    for _ in range(24):
        img, truth = synthface.make_scene(rng, p_face=1.0)
        got = ours.detect_face_bbox(img)
        assert got == theirs.detect_face_bbox(img)
        if got is not None:
            ious.append(bbox_iou(got, truth))
    assert len(ious) / 24 >= 0.8 and np.mean(ious) >= 0.5
    # Frames of another size and dtype map back to their own pixels.
    frame = np.random.default_rng(1).uniform(0, 1, (240, 320, 3)).astype(np.float32)
    assert ours.detect_face_bbox(frame) == theirs.detect_face_bbox(frame)
    assert ours.detect_face_bbox(np.zeros((8, 8), np.uint8)) is None


def test_crafted_weights_give_jax_box(tmp_path):
    """Zero weights and crafted head biases (`tests/test_blazeface.py`): the
    blended box mapped back to the original frame, as JAX's."""
    state = {k: np.zeros(v, np.float32) for k, v in bf.BLAZEFACE_SPEC.items()}
    state["classifier_8.bias"][:] = 4.0
    state["classifier_16.bias"][:] = -10.0
    state["regressor_8.bias"][2::16] = 24.0
    state["regressor_8.bias"][3::16] = 24.0
    path = tmp_path / "crafted.npz"
    np.savez(path, **state)
    img = np.random.default_rng(0).integers(0, 255, (240, 320, 3), np.uint8)
    got = face.BlazeFaceDetector(path).detect_face_bbox(img)
    assert got is not None and got == jax_face.BlazeFaceDetector(path).detect_face_bbox(img)


def test_export_equals_jax(tmp_path):
    state = jax_bf.random_blazeface_state_dict(seed=4)
    np.savez(tmp_path / "src.npz", **state)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "src.pth")
    for src in ("src.npz", "src.pth"):
        ours = blazeface_export.export_blazeface(tmp_path / src, tmp_path / f"ours_{src}.npz")
        theirs = jax_export.export_blazeface(tmp_path / src, tmp_path / f"jax_{src}.npz")
        with np.load(ours) as a, np.load(theirs) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
    blazeface_export.main([str(tmp_path / "src.pth"), str(tmp_path / "main.npz")])
    assert (tmp_path / "main.npz").exists()
    # The wrong layout: the same error as JAX's.
    bad = dict(state)
    bad.pop("classifier_8.bias")
    bad["extra.weight"] = np.zeros(3, np.float32)
    bad["regressor_8.weight"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError) as ours_err:
        blazeface_export.validate_blazeface_state_dict(bad)
    with pytest.raises(ValueError) as jax_err:
        jax_export.validate_blazeface_state_dict(bad)
    assert str(ours_err.value) == str(jax_err.value)
    assert "missing: classifier_8.bias" in str(ours_err.value)
