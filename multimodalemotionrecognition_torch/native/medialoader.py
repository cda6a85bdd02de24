"""ctypes bindings for the native libav media loader (`medialoader.cc`).

The port's copy of the JAX package's bindings, with its names and return
types.  It stands in for the reference's ffmpeg *subprocess* extraction
(`backend/app/preprocess.py:354-383`) and OpenCV decode loop
(`src/data/ravdess.py:306-357`) with in-process libav calls: no fork/exec, no
temp files, one pass over the container, frames delivered straight into numpy
buffers.  The library is built from this package's source at first use
(`native/build.py`); it is available when pkg-config finds libav, and a
build that then fails raises.

API:
  available() -> bool
  decode_audio(path, target_rate=16000) -> (float32 mono waveform, rate)
  decode_video_frames(path, indices, out_w, out_h, crop=None)
      -> uint8 [N, H, W, 3] RGB; crop=(x, y, w, h) in SOURCE pixels is applied
      at native resolution before the resize (face-crop path)
  probe(path) -> dict(frames, fps, duration_sec, has_audio)
  probe_video(path) -> probe() plus width, height
  encode_av(path, frames, fps, audio, sample_rate)
      mux uint8 [N,H,W,3] RGB frames + f32 mono audio into .mp4 (h264+aac)
      or .webm (vp8+opus); cv2.VideoWriter cannot write audio tracks
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, None when pkg-config does not find libav; builds
    it at the first call and raises when the build or the load fails."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    from multimodalemotionrecognition_torch.native import build as _build

    if _build.missing() is not None:
        _load_attempted = True
        return None
    path = _build.build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"medialoader: cannot load {path}: {e}") from e

    lib.ml_decode_audio.restype = ctypes.c_int
    lib.ml_decode_audio.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,  # target rate
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ml_probe.restype = ctypes.c_int
    lib.ml_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # frame count
        ctypes.POINTER(ctypes.c_double),  # fps
        ctypes.POINTER(ctypes.c_double),  # duration
        ctypes.POINTER(ctypes.c_int),  # has audio
    ]
    lib.ml_decode_video.restype = ctypes.c_int
    lib.ml_decode_video.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # indices
        ctypes.c_int,  # num indices
        ctypes.c_int,  # out w
        ctypes.c_int,  # out h
        ctypes.POINTER(ctypes.c_ubyte),  # out buffer [N*H*W*3]
    ]
    lib.ml_probe_video.restype = ctypes.c_int
    lib.ml_probe_video.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # frame count
        ctypes.POINTER(ctypes.c_double),  # fps
        ctypes.POINTER(ctypes.c_double),  # duration
        ctypes.POINTER(ctypes.c_int),  # width
        ctypes.POINTER(ctypes.c_int),  # height
        ctypes.POINTER(ctypes.c_int),  # has audio
    ]
    lib.ml_decode_video_crop.restype = ctypes.c_int
    lib.ml_decode_video_crop.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # indices
        ctypes.c_int,  # num indices
        ctypes.c_int,  # crop x
        ctypes.c_int,  # crop y
        ctypes.c_int,  # crop w (<=0 -> full frame)
        ctypes.c_int,  # crop h
        ctypes.c_int,  # out w
        ctypes.c_int,  # out h
        ctypes.POINTER(ctypes.c_ubyte),  # out buffer [N*H*W*3]
    ]
    lib.ml_encode_av.restype = ctypes.c_int
    lib.ml_encode_av.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_ubyte),  # frames [N*H*W*3]
        ctypes.c_int,  # n frames
        ctypes.c_int,  # w
        ctypes.c_int,  # h
        ctypes.c_double,  # fps
        ctypes.POINTER(ctypes.c_float),  # audio
        ctypes.c_longlong,  # n samples
        ctypes.c_int,  # sample rate
    ]
    lib.ml_free.restype = None
    lib.ml_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    _load_attempted = True
    return _lib


def _missing() -> str:
    from multimodalemotionrecognition_torch.native import build as _build

    return _build.missing()


def available() -> bool:
    return _load() is not None


def decode_audio(path: str, target_rate: int = 16000) -> Tuple[np.ndarray, int]:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"medialoader unavailable: {_missing()}")
    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_longlong(0)
    rc = lib.ml_decode_audio(
        str(path).encode(), target_rate, ctypes.byref(buf), ctypes.byref(n)
    )
    if rc != 0:
        raise RuntimeError(f"medialoader: audio decode failed (rc={rc}) for {path}")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.ml_free(buf)
    return out.astype(np.float32), target_rate


def probe(path: str) -> dict:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"medialoader unavailable: {_missing()}")
    frames = ctypes.c_longlong(0)
    fps = ctypes.c_double(0)
    duration = ctypes.c_double(0)
    has_audio = ctypes.c_int(0)
    rc = lib.ml_probe(
        str(path).encode(),
        ctypes.byref(frames),
        ctypes.byref(fps),
        ctypes.byref(duration),
        ctypes.byref(has_audio),
    )
    if rc != 0:
        raise RuntimeError(f"medialoader: probe failed (rc={rc}) for {path}")
    return {
        "frames": frames.value,
        "fps": fps.value,
        "duration_sec": duration.value,
        "has_audio": bool(has_audio.value),
    }


def probe_video(path: str) -> dict:
    """probe() plus the native frame dimensions."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"medialoader unavailable: {_missing()}")
    frames = ctypes.c_longlong(0)
    fps = ctypes.c_double(0)
    duration = ctypes.c_double(0)
    width = ctypes.c_int(0)
    height = ctypes.c_int(0)
    has_audio = ctypes.c_int(0)
    rc = lib.ml_probe_video(
        str(path).encode(),
        ctypes.byref(frames),
        ctypes.byref(fps),
        ctypes.byref(duration),
        ctypes.byref(width),
        ctypes.byref(height),
        ctypes.byref(has_audio),
    )
    if rc != 0:
        raise RuntimeError(f"medialoader: probe failed (rc={rc}) for {path}")
    return {
        "frames": frames.value,
        "fps": fps.value,
        "duration_sec": duration.value,
        "width": width.value,
        "height": height.value,
        "has_audio": bool(has_audio.value),
    }


def decode_video_frames(
    path: str,
    indices: Sequence[int],
    out_w: int,
    out_h: int,
    crop: Optional[Tuple[int, int, int, int]] = None,
) -> np.ndarray:
    """Decode the given frame indices; optional (x, y, w, h) crop in SOURCE
    pixels applied at native resolution before the bilinear resize."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"medialoader unavailable: {_missing()}")
    idx = np.asarray(sorted(indices), dtype=np.int64)
    out = np.empty((len(idx), out_h, out_w, 3), dtype=np.uint8)
    cx, cy, cw, ch = crop if crop is not None else (0, 0, -1, -1)
    rc = lib.ml_decode_video_crop(
        str(path).encode(),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(idx),
        int(cx),
        int(cy),
        int(cw),
        int(ch),
        out_w,
        out_h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0:
        raise RuntimeError(f"medialoader: video decode failed (rc={rc}) for {path}")
    return out


def encode_av(
    path: str,
    frames: Optional[np.ndarray],
    fps: float,
    audio: Optional[np.ndarray] = None,
    sample_rate: int = 16000,
) -> None:
    """Mux RGB frames [N,H,W,3] uint8 + float32 mono audio into .mp4
    (h264+aac) or .webm (vp8+opus)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"medialoader unavailable: {_missing()}")
    if frames is None:
        frames = np.empty((0, 2, 2, 3), dtype=np.uint8)
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w = frames.shape[:3]
    if audio is None:
        audio = np.empty(0, dtype=np.float32)
    audio = np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)
    rc = lib.ml_encode_av(
        str(path).encode(),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        int(n),
        int(w),
        int(h),
        float(fps),
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(audio.size),
        int(sample_rate),
    )
    if rc != 0:
        raise RuntimeError(f"medialoader: encode failed (rc={rc}) for {path}")
