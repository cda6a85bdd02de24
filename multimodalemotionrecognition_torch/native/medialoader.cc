// In-process media decoder and encoder: libavformat, libavcodec,
// libswresample and libswscale behind a plain C ABI, loaded by
// medialoader.py with ctypes.
//
// It stands in for the reference's ffmpeg *subprocess* audio extraction
// (backend/app/preprocess.py:354-383) and OpenCV's decode loop
// (src/data/ravdess.py:306-357): one demux pass, no fork/exec, no temp
// files, output written directly into caller-provided numpy buffers.  The
// C ABI and the behaviour are those of the JAX package's loader, so both
// packages read a file to the same bytes when they link the same libav.
//
// C ABI (see medialoader.py):
//   ml_decode_audio(path, target_rate, **out, *n)   f32 mono @ target_rate
//   ml_decode_video(path, indices, n, w, h, out)    RGB24 frames, bilinear
//   ml_decode_video_crop(path, indices, n, cx, cy, cw, ch, out_w, out_h, out)
//       decode at NATIVE resolution, crop rect in source pixels (cw<=0 =
//       full frame), then bilinear-resize -> the face-crop pipeline stays
//       intact (the plain ml_decode_video resizes before a crop could run)
//   ml_probe(path, *frames, *fps, *duration, *has_audio)
//   ml_probe_video(path, *frames, *fps, *duration, *w, *h, *has_audio)
//   ml_encode_av(path, frames, n, w, h, fps, audio, n_samples, rate)
//       mux RGB24 frames + f32 mono audio into .mp4 (h264+aac) or
//       .webm (vp8+opus): the asset generator for tests and the chip smoke
//       run, since cv2.VideoWriter cannot write audio tracks
//   ml_free(ptr)
//
// Environment switches, read per call: EMO_DECODE_SKIP ("0" off, "2" force
// the non-reference skip for every codec, else per codec), EMO_SWS_FULL
// ("1" converts whole frames to RGB instead of the crop band) and
// EMO_ENCODE_X264OPTS (extra x264 options, "key=val:key=val").
//
// Build: python -m multimodalemotionrecognition_torch.native.build (also
// done at first use; g++ and pkg-config's flags for the five libraries).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Demux {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;

  ~Demux() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path, AVMediaType type, bool fast = false) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    const AVCodec* codec = nullptr;
    stream_index = av_find_best_stream(fmt, type, -1, -1, &codec, 0);
    if (stream_index < 0 || !codec) return -3;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return -4;
    if (avcodec_parameters_to_context(dec, fmt->streams[stream_index]->codecpar) < 0)
      return -5;
    dec->thread_count = 0;  // auto: frame-threaded decode scales with cores
    if (fast) {
      // Sampled-frame extraction tolerates non-spec-exact decode: skipping
      // the h264 in-loop deblocking filter cuts ~25% of decode time with
      // imperceptible pixel drift at 112px model input.
      dec->skip_loop_filter = AVDISCARD_ALL;
      dec->flags2 |= AV_CODEC_FLAG2_FAST;
    }
    if (avcodec_open2(dec, codec, nullptr) < 0) return -6;
    return 0;
  }
};

}  // namespace

extern "C" {

void ml_free(void* p) { free(p); }

int ml_probe(const char* path, long long* out_frames, double* out_fps,
             double* out_duration, int* out_has_audio) {
  Demux d;
  int rc = d.open(path, AVMEDIA_TYPE_VIDEO);
  *out_frames = 0;
  *out_fps = 0.0;
  *out_duration = 0.0;
  *out_has_audio = 0;
  if (rc == 0) {
    AVStream* st = d.fmt->streams[d.stream_index];
    AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    *out_fps = fr.den ? av_q2d(fr) : 0.0;
    if (d.fmt->duration > 0)
      *out_duration = static_cast<double>(d.fmt->duration) / AV_TIME_BASE;
    long long n = st->nb_frames;
    if (n <= 0 && *out_fps > 0 && *out_duration > 0)
      n = static_cast<long long>(*out_duration * *out_fps + 0.5);
    *out_frames = n;
    for (unsigned i = 0; i < d.fmt->nb_streams; ++i)
      if (d.fmt->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_AUDIO)
        *out_has_audio = 1;
    return 0;
  }
  // Audio-only containers still probe fine.
  Demux a;
  if (a.open(path, AVMEDIA_TYPE_AUDIO) == 0) {
    *out_has_audio = 1;
    if (a.fmt->duration > 0)
      *out_duration = static_cast<double>(a.fmt->duration) / AV_TIME_BASE;
    return 0;
  }
  return rc;
}

int ml_decode_audio(const char* path, int target_rate, float** out,
                    long long* out_n) {
  Demux d;
  int rc = d.open(path, AVMEDIA_TYPE_AUDIO);
  if (rc != 0) return rc;

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (d.dec->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &d.dec->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 2);
  }
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, target_rate,
                          &in_layout, d.dec->sample_fmt, d.dec->sample_rate,
                          0, nullptr) < 0)
    return -10;
  if (swr_init(swr) < 0) {
    swr_free(&swr);
    return -11;
  }

  std::vector<float> samples;
  samples.reserve(static_cast<size_t>(target_rate) * 4);

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  std::vector<float> chunk;

  auto drain_frame = [&](AVFrame* f) {
    int max_out = swr_get_out_samples(swr, f ? f->nb_samples : 0);
    if (max_out <= 0) max_out = 4096;
    chunk.resize(static_cast<size_t>(max_out));
    uint8_t* outbuf = reinterpret_cast<uint8_t*>(chunk.data());
    int got = swr_convert(swr, &outbuf, max_out,
                          f ? const_cast<const uint8_t**>(f->data) : nullptr,
                          f ? f->nb_samples : 0);
    if (got > 0) samples.insert(samples.end(), chunk.begin(), chunk.begin() + got);
  };

  while (av_read_frame(d.fmt, pkt) >= 0) {
    if (pkt->stream_index == d.stream_index) {
      if (avcodec_send_packet(d.dec, pkt) >= 0) {
        while (avcodec_receive_frame(d.dec, frame) >= 0) drain_frame(frame);
      }
    }
    av_packet_unref(pkt);
  }
  avcodec_send_packet(d.dec, nullptr);  // flush decoder
  while (avcodec_receive_frame(d.dec, frame) >= 0) drain_frame(frame);
  drain_frame(nullptr);  // flush resampler

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  av_channel_layout_uninit(&in_layout);

  *out_n = static_cast<long long>(samples.size());
  *out = static_cast<float*>(malloc(samples.size() * sizeof(float)));
  if (!*out) return -12;
  memcpy(*out, samples.data(), samples.size() * sizeof(float));
  return 0;
}

int ml_probe_video(const char* path, long long* out_frames, double* out_fps,
                   double* out_duration, int* out_w, int* out_h,
                   int* out_has_audio) {
  // Single demux pass (ml_probe opens the container up to twice; audio-only
  // uploads were paying 3x avformat_find_stream_info).
  *out_frames = 0;
  *out_fps = 0.0;
  *out_duration = 0.0;
  *out_w = 0;
  *out_h = 0;
  *out_has_audio = 0;
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -2;
  }
  if (fmt->duration > 0)
    *out_duration = static_cast<double>(fmt->duration) / AV_TIME_BASE;
  int video_index = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                        nullptr, 0);
  for (unsigned i = 0; i < fmt->nb_streams; ++i)
    if (fmt->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_AUDIO)
      *out_has_audio = 1;
  if (video_index >= 0) {
    AVStream* st = fmt->streams[video_index];
    *out_w = st->codecpar->width;
    *out_h = st->codecpar->height;
    AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    *out_fps = fr.den ? av_q2d(fr) : 0.0;
    long long n = st->nb_frames;
    if (n <= 0 && *out_fps > 0 && *out_duration > 0)
      n = static_cast<long long>(*out_duration * *out_fps + 0.5);
    *out_frames = n;
  }
  avformat_close_input(&fmt);
  return 0;
}

namespace {

// -21 = pts-indexed skip mode could not account for every requested frame
// (unusable timestamps / VFR drift); the caller retries in legacy mode.
constexpr int kSkipModeFailed = -21;

// Demux-only pre-scan (no decode — ~1% of a clip's decode cost): skip mode
// needs an EXACT pts -> frame-index map, and rate metadata can't provide one
// (mp4 avg_frame_rate divides nb_frames by the CONTAINER duration, which an
// audio tail stretches — measured 30.34 "fps" on a true-30fps mux, enough to
// alias sampled indices one frame off).  Accept only timestamp sets that
// form a perfect arithmetic progression start + k*dur covering 0..n-1; VFR
// or gapped streams fall back to the counting decoder.
bool scan_cfr_pts(const char* path, int64_t* start_out, int64_t* dur_out,
                  long long* nframes_out, bool force_any_codec) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return false;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return false;
  }
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (si < 0) {
    avformat_close_input(&fmt);
    return false;
  }
  if (!force_any_codec) {
    // Per-codec gate: NONREF skip only pays when the
    // stream can contain droppable non-reference frames.  VP8 has no
    // B-frames and its altref/golden frames are reference frames, so
    // AVDISCARD_NONREF drops nothing — the pre-scan's full-packet demux
    // (a few ms per clip on webm) is pure loss.
    // Same for lossless/intra codecs.  h264/h265/mpeg4 keep the lever.
    switch (fmt->streams[si]->codecpar->codec_id) {
      case AV_CODEC_ID_VP8:
      case AV_CODEC_ID_VP9:
      case AV_CODEC_ID_AV1:
      case AV_CODEC_ID_MJPEG:
      case AV_CODEC_ID_RAWVIDEO:
      case AV_CODEC_ID_FFV1:
        avformat_close_input(&fmt);
        return false;
      default:
        break;
    }
  }
  std::vector<int64_t> pts;
  AVPacket* pkt = av_packet_alloc();
  bool ok = true;
  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == si) {
      if (pkt->pts == AV_NOPTS_VALUE) {
        ok = false;
        av_packet_unref(pkt);
        break;
      }
      pts.push_back(pkt->pts);
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  avformat_close_input(&fmt);
  if (!ok || pts.size() < 2) return false;
  std::sort(pts.begin(), pts.end());
  const int64_t start = pts[0];
  const int64_t dur = pts[1] - pts[0];
  if (dur <= 0) return false;
  for (size_t k = 0; k < pts.size(); ++k)
    if (pts[k] != start + static_cast<int64_t>(k) * dur) return false;
  *start_out = start;
  *dur_out = dur;
  *nframes_out = static_cast<long long>(pts.size());
  return true;
}

int decode_video_crop_impl(const char* path, const long long* indices,
                           int n_indices, int crop_x, int crop_y, int crop_w,
                           int crop_h, int out_w, int out_h, unsigned char* out,
                           bool use_skip, int64_t skip_start,
                           int64_t skip_dur) {
  Demux d;
  int rc = d.open(path, AVMEDIA_TYPE_VIDEO, /*fast=*/true);
  if (rc != 0) return rc;

  // NONREF skip mode: sampled-frame extraction decodes ~8 of ~90 frames but
  // must reconstruct every frame other frames REFERENCE.  Non-reference
  // frames (x264 emits ~half its frames as non-ref B at default bframes)
  // that are not themselves sampled can be dropped by the decoder before
  // reconstruction.  skip_frame is toggled per packet: AVDISCARD_DEFAULT
  // when the packet's presentation index is a sampled index, NONREF
  // otherwise — the decoder keeps every reference frame regardless, so
  // sampled frames decode bit-identically.  Frames are then matched to
  // indices by pts (output order still ascends in presentation time, but
  // with gaps), which needs trustworthy CFR timestamps: any NOPTS packet,
  // index regression, or missing sampled frame at EOF aborts to the exact
  // counting-based legacy path (return kSkipModeFailed -> caller retries).
  bool skip_mode = use_skip;
  bool skip_failed = false;

  SwsContext* to_rgb = nullptr;   // native fmt -> RGB24 (crop band only)
  SwsContext* resize = nullptr;   // cropped RGB24 -> out size
  std::vector<unsigned char> rgb_full;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();

  long long current = 0;  // legacy mode: decoded-frame counter
  int next_slot = 0;      // indices are sorted ascending
  const size_t frame_bytes = static_cast<size_t>(out_w) * out_h * 3;

  // Exact integer mapping from the CFR pre-scan; any timestamp off the
  // progression (or before start) aborts skip mode.
  auto pts_to_index = [&](int64_t pts) -> long long {
    if (pts < skip_start || (pts - skip_start) % skip_dur != 0) return -1;
    return (pts - skip_start) / skip_dur;
  };

  auto handle_frame = [&](AVFrame* f) {
    long long idx = current;
    if (skip_mode) {
      if (f->pts == AV_NOPTS_VALUE) {
        skip_failed = true;
        return;
      }
      idx = pts_to_index(f->pts);
      if (idx < 0) {
        skip_failed = true;
        return;
      }
      if (next_slot < n_indices && indices[next_slot] < idx) {
        skip_failed = true;  // a sampled frame never surfaced: bad mapping
        return;
      }
    }
    if (next_slot < n_indices && indices[next_slot] == idx) {
      const int w = f->width, h = f->height;

      // Crop rect clipped to the frame; cw<=0 selects the full frame.
      int cx = crop_w > 0 ? crop_x : 0;
      int cy = crop_w > 0 ? crop_y : 0;
      int cw = crop_w > 0 ? crop_w : w;
      int ch = crop_w > 0 ? crop_h : h;
      if (cx < 0) cx = 0;
      if (cy < 0) cy = 0;
      if (cx + cw > w) cw = w - cx;
      if (cy + ch > h) ch = h - cy;
      if (cw <= 0 || ch <= 0) { cx = cy = 0; cw = w; ch = h; }

      // Convert only the crop's row band (+4-row margin so chroma
      // upsampling at the band edges sees its full vertical context and
      // interior rows stay bit-identical to a full-frame conversion;
      // start row aligned down to 4 for 4:2:0/4:1:0 chroma grids).
      // EMO_SWS_FULL=1 forces whole-frame conversion (equivalence tests;
      // read per call so tests can toggle it via os.environ/putenv).
      const char* fs_env = getenv("EMO_SWS_FULL");
      const bool full_sws = fs_env && fs_env[0] == '1';
      int by0 = full_sws ? 0 : (cy - 4 < 0 ? 0 : (cy - 4) & ~3);
      int by1 = full_sws ? h : (cy + ch + 4 + 3) & ~3;
      if (by1 > h) by1 = h;

      if (!to_rgb) {
        // The context is sized to the band itself (swscale's generic path
        // rejects slices that start mid-image); the band is presented as a
        // standalone [w, by1-by0] image whose plane pointers are offset
        // into the frame.  The crop rect is constant across the clip, so
        // one context serves every frame.
        to_rgb = sws_getContext(w, by1 - by0,
                                static_cast<AVPixelFormat>(f->format), w,
                                by1 - by0, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                                nullptr, nullptr, nullptr);
        rgb_full.resize(static_cast<size_t>(w) * h * 3);
      }
      const AVPixFmtDescriptor* desc =
          av_pix_fmt_desc_get(static_cast<AVPixelFormat>(f->format));
      const uint8_t* slice[4] = {nullptr, nullptr, nullptr, nullptr};
      for (int p = 0; p < 4 && f->data[p]; ++p) {
        int shift = (p == 1 || p == 2) && desc ? desc->log2_chroma_h : 0;
        slice[p] = f->data[p] +
                   static_cast<ptrdiff_t>(by0 >> shift) * f->linesize[p];
      }
      uint8_t* band_dst[1] = {rgb_full.data() +
                              static_cast<size_t>(by0) * w * 3};
      int full_stride[1] = {w * 3};
      sws_scale(to_rgb, slice, f->linesize, 0, by1 - by0, band_dst,
                full_stride);

      const uint8_t* crop_src =
          rgb_full.data() + static_cast<size_t>(cy) * w * 3 +
          static_cast<size_t>(cx) * 3;
      const int crop_stride = w * 3;
      const bool identity = (cw == out_w && ch == out_h);
      if (!identity && !resize) {
        resize = sws_getContext(cw, ch, AV_PIX_FMT_RGB24, out_w, out_h,
                                AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                                nullptr, nullptr);
      }
      while (next_slot < n_indices && indices[next_slot] == idx) {
        uint8_t* dst = out + static_cast<size_t>(next_slot) * frame_bytes;
        if (identity) {
          // Same-size "resize" is a row copy; skip the sws pass entirely
          // (the serving hot path decodes at native resolution, so every
          // frame used to pay a full-frame identity sws_scale here).
          for (int r = 0; r < ch; ++r)
            memcpy(dst + static_cast<size_t>(r) * out_w * 3,
                   crop_src + static_cast<size_t>(r) * crop_stride,
                   static_cast<size_t>(out_w) * 3);
        } else {
          uint8_t* dsts[1] = {dst};
          int dst_stride[1] = {out_w * 3};
          const uint8_t* srcs[1] = {crop_src};
          int src_strides[1] = {crop_stride};
          sws_scale(resize, srcs, src_strides, 0, ch, dsts, dst_stride);
        }
        ++next_slot;
      }
    }
    ++current;
  };

  while (next_slot < n_indices && !skip_failed &&
         av_read_frame(d.fmt, pkt) >= 0) {
    if (pkt->stream_index == d.stream_index) {
      if (skip_mode) {
        long long pidx =
            pkt->pts == AV_NOPTS_VALUE ? -1 : pts_to_index(pkt->pts);
        if (pidx < 0) {
          skip_failed = true;
        } else {
          bool needed = false;
          for (int s = next_slot; s < n_indices && indices[s] <= pidx; ++s)
            if (indices[s] == pidx) { needed = true; break; }
          d.dec->skip_frame =
              needed ? AVDISCARD_DEFAULT : AVDISCARD_NONREF;
        }
      }
      if (!skip_failed && avcodec_send_packet(d.dec, pkt) >= 0) {
        while (avcodec_receive_frame(d.dec, frame) >= 0) handle_frame(frame);
      }
    }
    av_packet_unref(pkt);
  }
  if (next_slot < n_indices && !skip_failed) {
    if (skip_mode) d.dec->skip_frame = AVDISCARD_DEFAULT;
    avcodec_send_packet(d.dec, nullptr);
    while (avcodec_receive_frame(d.dec, frame) >= 0) handle_frame(frame);
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  if (to_rgb) sws_freeContext(to_rgb);
  if (resize) sws_freeContext(resize);

  if (skip_failed) return kSkipModeFailed;
  if (skip_mode && next_slot < n_indices && next_slot > 0) {
    // Could be a genuinely short video (legacy pads by repeating the last
    // frame) — or a frame the skip mapping lost.  Legacy mode decides.
    return kSkipModeFailed;
  }
  if (next_slot > 0) {  // short video: repeat last frame (reference behavior)
    while (next_slot < n_indices) {
      memcpy(out + static_cast<size_t>(next_slot) * frame_bytes,
             out + static_cast<size_t>(next_slot - 1) * frame_bytes,
             frame_bytes);
      ++next_slot;
    }
  }
  return next_slot == n_indices ? 0 : -20;
}

}  // namespace

int ml_decode_video_crop(const char* path, const long long* indices,
                         int n_indices, int crop_x, int crop_y, int crop_w,
                         int crop_h, int out_w, int out_h, unsigned char* out) {
  if (n_indices <= 0) return 0;
  // Read per call (not latched) so tests can toggle via os.environ/putenv.
  // "0" = off; "2" = force (attempt skip even for codecs the per-codec gate
  // excludes — used by tests/benches to exercise the gated path); else auto.
  const char* skip_env = getenv("EMO_DECODE_SKIP");
  const bool try_skip = !(skip_env && skip_env[0] == '0');
  const bool force_any_codec = skip_env && skip_env[0] == '2';
  if (try_skip) {
    int64_t start = 0, dur = 0;
    long long nframes = 0;
    if (scan_cfr_pts(path, &start, &dur, &nframes, force_any_codec)) {
      int rc = decode_video_crop_impl(path, indices, n_indices, crop_x,
                                      crop_y, crop_w, crop_h, out_w, out_h,
                                      out, /*use_skip=*/true, start, dur);
      if (rc != kSkipModeFailed) return rc;
    }
  }
  return decode_video_crop_impl(path, indices, n_indices, crop_x, crop_y,
                                crop_w, crop_h, out_w, out_h, out,
                                /*use_skip=*/false, 0, 1);
}

int ml_decode_video(const char* path, const long long* indices, int n_indices,
                    int out_w, int out_h, unsigned char* out) {
  if (n_indices <= 0) return 0;
  Demux d;
  int rc = d.open(path, AVMEDIA_TYPE_VIDEO);
  if (rc != 0) return rc;

  SwsContext* sws = nullptr;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();

  long long current = 0;
  int next_slot = 0;  // indices are sorted ascending
  const size_t frame_bytes = static_cast<size_t>(out_w) * out_h * 3;

  auto handle_frame = [&](AVFrame* f) {
    while (next_slot < n_indices && indices[next_slot] == current) {
      if (!sws) {
        sws = sws_getContext(f->width, f->height,
                             static_cast<AVPixelFormat>(f->format), out_w,
                             out_h, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                             nullptr, nullptr);
      }
      uint8_t* dst[1] = {out + static_cast<size_t>(next_slot) * frame_bytes};
      int dst_stride[1] = {out_w * 3};
      sws_scale(sws, f->data, f->linesize, 0, f->height, dst, dst_stride);
      ++next_slot;
    }
    ++current;
  };

  while (next_slot < n_indices && av_read_frame(d.fmt, pkt) >= 0) {
    if (pkt->stream_index == d.stream_index) {
      if (avcodec_send_packet(d.dec, pkt) >= 0) {
        while (avcodec_receive_frame(d.dec, frame) >= 0) handle_frame(frame);
      }
    }
    av_packet_unref(pkt);
  }
  if (next_slot < n_indices) {
    avcodec_send_packet(d.dec, nullptr);
    while (avcodec_receive_frame(d.dec, frame) >= 0) handle_frame(frame);
  }

  // Short video: replicate the last decoded frame (reference pads by
  // repeating the final frame, src/data/ravdess.py:361-362).
  if (next_slot > 0) {
    while (next_slot < n_indices) {
      memcpy(out + static_cast<size_t>(next_slot) * frame_bytes,
             out + static_cast<size_t>(next_slot - 1) * frame_bytes,
             frame_bytes);
      ++next_slot;
    }
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  if (sws) sws_freeContext(sws);
  return next_slot == n_indices ? 0 : -20;
}

}  // extern "C"

namespace {

// One encoder stream (video or audio) with its packet-writing loop.
struct EncStream {
  AVStream* st = nullptr;
  AVCodecContext* enc = nullptr;

  ~EncStream() {
    if (enc) avcodec_free_context(&enc);
  }

  int write_frames(AVFormatContext* ofmt, AVFrame* frame) {
    // frame == nullptr flushes the encoder.
    if (avcodec_send_frame(enc, frame) < 0) return -1;
    AVPacket* pkt = av_packet_alloc();
    int rc = 0;
    while (true) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
      if (r < 0) { rc = -2; break; }
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(ofmt, pkt) < 0) { rc = -3; break; }
    }
    av_packet_free(&pkt);
    return rc;
  }
};

bool ends_with(const char* s, const char* suffix) {
  size_t ls = strlen(s), lf = strlen(suffix);
  return ls >= lf && strcmp(s + ls - lf, suffix) == 0;
}

}  // namespace

extern "C" {

int ml_encode_av(const char* path, const unsigned char* frames, int n_frames,
                 int w, int h, double fps, const float* audio,
                 long long n_samples, int sample_rate) {
  const bool webm = ends_with(path, ".webm");
  const char* vname = webm ? "libvpx" : "libx264";
  const char* aname = webm ? "libopus" : "aac";

  AVFormatContext* ofmt = nullptr;
  if (avformat_alloc_output_context2(&ofmt, nullptr, nullptr, path) < 0 || !ofmt)
    return -30;

  EncStream v, a;
  SwsContext* sws = nullptr;
  SwrContext* swr = nullptr;
  AVFrame* vframe = nullptr;
  AVFrame* aframe = nullptr;

  auto fail = [&](int code) {
    if (sws) sws_freeContext(sws);
    if (swr) swr_free(&swr);
    if (vframe) av_frame_free(&vframe);
    if (aframe) av_frame_free(&aframe);
    if (ofmt && !(ofmt->oformat->flags & AVFMT_NOFILE) && ofmt->pb)
      avio_closep(&ofmt->pb);
    avformat_free_context(ofmt);
    return code;
  };

  // ---- video stream (RGB24 -> yuv420p) ----
  if (n_frames > 0) {
    const AVCodec* vc = avcodec_find_encoder_by_name(vname);
    if (!vc) return fail(-31);
    v.st = avformat_new_stream(ofmt, nullptr);
    v.enc = avcodec_alloc_context3(vc);
    if (!v.st || !v.enc) return fail(-32);
    v.enc->width = w;
    v.enc->height = h;
    v.enc->pix_fmt = AV_PIX_FMT_YUV420P;
    v.enc->time_base = AVRational{1000, static_cast<int>(fps * 1000 + 0.5)};
    v.enc->bit_rate = 2'000'000;
    if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
      v.enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    AVDictionary* opts = nullptr;
    if (!webm) {
      av_dict_set(&opts, "preset", "veryfast", 0);
      // Extra x264 private options (colon-separated key=val), e.g.
      // "bf=8:b_strategy=0:b-pyramid=none:sc_threshold=0" — lets a caller mux a
      // B-frame-heavy clip to quantify what NONREF skip buys on real
      // browser-style x264 uploads.
      const char* extra = getenv("EMO_ENCODE_X264OPTS");
      if (extra && extra[0])
        av_dict_parse_string(&opts, extra, "=", ":", 0);
    }
    int r = avcodec_open2(v.enc, vc, &opts);
    av_dict_free(&opts);
    if (r < 0) return fail(-33);
    if (avcodec_parameters_from_context(v.st->codecpar, v.enc) < 0)
      return fail(-34);
    v.st->time_base = v.enc->time_base;
  }

  // ---- audio stream (f32 mono -> encoder sample format) ----
  if (n_samples > 0) {
    const AVCodec* ac = avcodec_find_encoder_by_name(aname);
    if (!ac) return fail(-35);
    a.st = avformat_new_stream(ofmt, nullptr);
    a.enc = avcodec_alloc_context3(ac);
    if (!a.st || !a.enc) return fail(-36);
    a.enc->sample_rate = sample_rate;
    av_channel_layout_default(&a.enc->ch_layout, 1);
    a.enc->sample_fmt =
        ac->sample_fmts ? ac->sample_fmts[0] : AV_SAMPLE_FMT_FLTP;
    a.enc->time_base = AVRational{1, sample_rate};
    a.enc->bit_rate = 96'000;
    if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
      a.enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(a.enc, ac, nullptr) < 0) return fail(-37);
    if (avcodec_parameters_from_context(a.st->codecpar, a.enc) < 0)
      return fail(-38);
    a.st->time_base = a.enc->time_base;

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    if (swr_alloc_set_opts2(&swr, &a.enc->ch_layout, a.enc->sample_fmt,
                            a.enc->sample_rate, &mono, AV_SAMPLE_FMT_FLT,
                            sample_rate, 0, nullptr) < 0 ||
        swr_init(swr) < 0)
      return fail(-39);
  }

  if (!(ofmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&ofmt->pb, path, AVIO_FLAG_WRITE) < 0)
    return fail(-40);
  if (avformat_write_header(ofmt, nullptr) < 0) return fail(-41);

  // ---- encode video frames ----
  if (n_frames > 0) {
    sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                         SWS_BILINEAR, nullptr, nullptr, nullptr);
    vframe = av_frame_alloc();
    vframe->format = AV_PIX_FMT_YUV420P;
    vframe->width = w;
    vframe->height = h;
    if (av_frame_get_buffer(vframe, 0) < 0) return fail(-42);
    const size_t fbytes = static_cast<size_t>(w) * h * 3;
    for (int i = 0; i < n_frames; ++i) {
      av_frame_make_writable(vframe);
      const uint8_t* src[1] = {frames + i * fbytes};
      int stride[1] = {w * 3};
      sws_scale(sws, src, stride, 0, h, vframe->data, vframe->linesize);
      vframe->pts = i;  // time_base is 1000/(fps*1000) = one tick per frame
      if (v.write_frames(ofmt, vframe) != 0) return fail(-43);
    }
    if (v.write_frames(ofmt, nullptr) != 0) return fail(-44);
  }

  // ---- encode audio in encoder-sized chunks ----
  if (n_samples > 0) {
    const int chunk = a.enc->frame_size > 0 ? a.enc->frame_size : 1024;
    aframe = av_frame_alloc();
    aframe->format = a.enc->sample_fmt;
    av_channel_layout_copy(&aframe->ch_layout, &a.enc->ch_layout);
    aframe->sample_rate = a.enc->sample_rate;
    aframe->nb_samples = chunk;
    if (av_frame_get_buffer(aframe, 0) < 0) return fail(-45);
    long long pos = 0;
    int64_t pts = 0;
    std::vector<float> padded(static_cast<size_t>(chunk));
    while (pos < n_samples) {
      av_frame_make_writable(aframe);
      int take = static_cast<int>(
          n_samples - pos < chunk ? n_samples - pos : chunk);
      memcpy(padded.data(), audio + pos, take * sizeof(float));
      if (take < chunk)
        memset(padded.data() + take, 0, (chunk - take) * sizeof(float));
      const uint8_t* in[1] = {reinterpret_cast<const uint8_t*>(padded.data())};
      int got = swr_convert(swr, aframe->data, chunk, in, chunk);
      if (got < 0) return fail(-46);
      aframe->nb_samples = got;
      aframe->pts = pts;
      pts += got;
      if (a.write_frames(ofmt, aframe) != 0) return fail(-47);
      pos += take;
    }
    if (a.write_frames(ofmt, nullptr) != 0) return fail(-48);
  }

  if (av_write_trailer(ofmt) < 0) return fail(-49);
  if (sws) sws_freeContext(sws);
  if (swr) swr_free(&swr);
  if (vframe) av_frame_free(&vframe);
  if (aframe) av_frame_free(&aframe);
  if (!(ofmt->oformat->flags & AVFMT_NOFILE) && ofmt->pb)
    avio_closep(&ofmt->pb);
  avformat_free_context(ofmt);
  return 0;
}

}  // extern "C"
