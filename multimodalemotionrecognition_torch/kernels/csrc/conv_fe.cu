// K3: one wide-K layer of the WavLM conv feature extractor (L1..L6).
//
// Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
// pallas_conv_fe.py::_conv_kernel` (launched by `fused_conv_layer`).
// A strided, bias-free conv1d in NWC layout written as an implicit GEMM:
// output row t of batch b reads the contiguous span of k*Cin input values
// that starts at t*stride*Cin of the unreshaped [B, T, Cin] input, so
//
//   out[b, t, n] = gelu_out?( sum_{j < k*Cin} gelu_in?(x[b, t*stride*Cin + j]) * W[j, n] )
//
// for t < t_out = (t_in - k) / stride + 1, with W the tap-major [k*Cin, Cout]
// flattened kernel, float32 accumulation and one write in the input dtype.
// The TPU kernel needed a 16-row halo view for the rows of the next time
// block; here a tile of A simply reads its rows where they lie.
//
// What bounds it on an H100: at the serving shapes (B = 8, Cin = Cout = 512,
// k = 3 for L1..L4 and 2 for L5..L6, t_out = 4799 ... 149) it is ~117 GFLOP
// per forward over ~0.47 GB of float32 activations in and out (half that in
// bf16): 250-500 FLOP per byte, at or above the ridge, so compute bound.  The design below runs that work on CUDA cores in float32
// (a classic 64 x 64 tile, 16-deep, 4 x 4 outputs per thread from shared
// memory), so it is bound by the FMA rate, not by tensor cores; the GELUs
// ride in the load and the epilogue so no activation pass touches device
// memory.  Tensor cores (wgmma with TMA-fed tiles) are the later step.
//
// Rows at or past t_out are not written (the caller's buffer keeps
// whatever it held); input rows at or past t_in are never read.

#include "common.cuh"

namespace {

using emo::from_f;
using emo::to_f;

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <typename T, bool kGeluIn, bool kGeluOut>
__global__ void __launch_bounds__(kThreads)
conv_fe_kernel(const T* __restrict__ y, const T* __restrict__ w,
               T* __restrict__ out, int rows, int t_out, int K, int N, int s_cin,
               long long in_batch_stride) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* yb = y + (size_t)b * in_batch_stride;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int t = m0 + r, kk = k0 + c;
      float a = 0.f;
      if (t < t_out && kk < K) {
        a = to_f(yb[(size_t)t * s_cin + kk]);
        if (kGeluIn) a = emo::gelu_erf(a);
      }
      As[c][r] = a;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const int kk = k0 + r, n = n0 + c;
      Bs[r][c] = (kk < K && n < N) ? to_f(w[(size_t)kk * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* ob = out + (size_t)b * rows * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + ty * 4 + i;
    if (t >= t_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (kGeluOut) v = emo::gelu_erf(v);
      ob[(size_t)t * N + n] = from_f<T>(v);
    }
  }
}

template <typename T, bool kGeluIn, bool kGeluOut>
int launch_one(const T* y, const T* w, T* out, int B, int rows, int t_out, int K,
               int N, int s_cin, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (t_out + kBM - 1) / kBM, B);
  conv_fe_kernel<T, kGeluIn, kGeluOut><<<grid, kThreads, 0, stream>>>(
      y, w, out, rows, t_out, K, N, s_cin, (long long)rows * s_cin);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* y, const void* w, void* out, int B, int rows, int t_in,
           int k, int stride, int cin, int cout, int gelu_in, int gelu_out,
           void* stream_ptr) {
  if (B < 1 || k < 1 || stride < 1 || cin < 1 || cout < 1 || t_in < k ||
      t_in > rows * stride)
    return cudaErrorInvalidValue;
  const int t_out = (t_in - k) / stride + 1;
  if ((t_out + kBM - 1) / kBM > 65535 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const T* yt = static_cast<const T*>(y);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const int K = k * cin, s_cin = stride * cin;
  if (gelu_in && gelu_out)
    return launch_one<T, true, true>(yt, wt, ot, B, rows, t_out, K, cout, s_cin, stream);
  if (gelu_in)
    return launch_one<T, true, false>(yt, wt, ot, B, rows, t_out, K, cout, s_cin, stream);
  if (gelu_out)
    return launch_one<T, false, true>(yt, wt, ot, B, rows, t_out, K, cout, s_cin, stream);
  return launch_one<T, false, false>(yt, wt, ot, B, rows, t_out, K, cout, s_cin, stream);
}

}  // namespace

#define EMO_CONV_FE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* y, const void* w, void* out, int B, int rows,  \
                      int t_in, int k, int stride, int cin, int cout,            \
                      int gelu_in, int gelu_out, void* stream) {                 \
    return launch<T>(y, w, out, B, rows, t_in, k, stride, cin, cout, gelu_in,    \
                     gelu_out, stream);                                          \
  }

EMO_CONV_FE_ENTRY(emo_conv_fe_f32, float)
EMO_CONV_FE_ENTRY(emo_conv_fe_bf16, __nv_bfloat16)
