"""Host-side data: RAVDESS pairing and splits, media decode with the face
crop and the training augmentations, the synthetic corpus and the
prefetching loaders (the port's copies of the JAX package's `data/`
modules; the native libav loader is not copied)."""

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
from multimodalemotionrecognition_torch.data.ravdess import (
    EMOTION_ID_TO_NAME,
    PairRecord,
    build_pairs,
    map_emotion_label,
    parse_ravdess_name,
    save_pairs_csv,
    split_pairs_by_actor,
    split_pairs_stratified,
)

__all__ = [
    "EMOTION_ID_TO_NAME",
    "HaarFaceDetector",
    "HeuristicFaceDetector",
    "PairRecord",
    "build_pairs",
    "crop_with_padding",
    "decode_video_frames_u8",
    "decode_wav_bytes",
    "get_face_detector",
    "load_audio_file",
    "load_audio_wav",
    "load_video_frames",
    "load_video_frames_u8",
    "map_emotion_label",
    "padded_crop_rect",
    "parse_ravdess_name",
    "resample_waveform",
    "save_pairs_csv",
    "set_face_detector",
    "split_pairs_by_actor",
    "split_pairs_stratified",
]
