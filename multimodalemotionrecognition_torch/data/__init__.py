"""Host-side media decode and face crop of the serving path (the port's
copies of the JAX package's `data/media.py`, `data/face.py` and
`data/haar.py`).  The dataset side of that package (RAVDESS pairing,
splits, the synthetic corpus, the prefetching pipeline) comes with the data
slice (ROADMAP queue 1, item 4)."""

from multimodalemotionrecognition_torch.data.face import (
    HaarFaceDetector,
    HeuristicFaceDetector,
    crop_with_padding,
    get_face_detector,
    padded_crop_rect,
    set_face_detector,
)
from multimodalemotionrecognition_torch.data.media import (
    decode_video_frames_u8,
    decode_wav_bytes,
    load_audio_file,
    load_audio_wav,
    load_video_frames,
    load_video_frames_u8,
    resample_waveform,
)

__all__ = [
    "HaarFaceDetector",
    "HeuristicFaceDetector",
    "crop_with_padding",
    "decode_video_frames_u8",
    "decode_wav_bytes",
    "get_face_detector",
    "load_audio_file",
    "load_audio_wav",
    "load_video_frames",
    "load_video_frames_u8",
    "padded_crop_rect",
    "resample_waveform",
    "set_face_detector",
]
