"""Native (C++) host-side components, the port's copy of the JAX package's
`native/`, exposed over ctypes:

  * medialoader: libavformat/libavcodec/swscale/swresample demux + decode of
    video frames (RGB24) and audio (f32 mono at a target rate) from
    mp4/webm/wav, and the .mp4/.webm muxer the tests and the chip smoke run
    make their clips with.

Built at first use (`native/build.py`), or ahead with
`python -m multimodalemotionrecognition_torch build-native`.
"""

from multimodalemotionrecognition_torch.native import medialoader

__all__ = ["medialoader"]
