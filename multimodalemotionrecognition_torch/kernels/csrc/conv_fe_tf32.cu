// K3 in float32 on the tensor cores: one wide-K layer of the WavLM conv
// feature extractor (L1..L6) as an implicit GEMM fed by TMA and run by wgmma
// in TF32 with split products (3xTF32), at float32 accuracy.
//
// Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
// pallas_conv_fe.py::_conv_kernel` (launched by `fused_conv_layer`) for
// float32 operands without the input-side GELU; `conv_fe_tc.cu` takes
// bfloat16, and `conv_fe.cu` keeps `gelu_input` on CUDA cores.  Same
// function as theirs:
//
//   out[b, t, n] = gelu_out?( sum_{kk < k*Cin} x[b, t*stride*Cin + kk] * W[kk, n] )
//
// float32 accumulation, one float32 write for t < t_out.
//
// Accuracy.  A single TF32 product keeps ~11 significant bits, a different
// result from float32's.  Each operand is split as x = hi + lo, both TF32
// (`split_tf32` in `hopper.cuh`), and every product is the sum of three
// TF32 products, hi.hi + hi.lo + lo.hi, each exact in the float32
// accumulator: about 2^-21 relative per product, float32's own order.  The
// tensor cores' accumulator truncates, though: a model of it
// (`tests/test_torch_tf32x3.py`) drifts 6.0e-5 from float32's result over
// L1's 192 steps of 8 on outputs of ~1, over half of the 1e-4 tolerance.  So
// each chunk of kPromote stages accumulates afresh and is then added to a
// float32 total in registers with rounded additions (L1 on an H100: 1.3e-5
// from the plain version).  The fold waits for the chunk's last products
// after the next stage's split, so that the split still runs under them.
//
// What bounds it on an H100: at B = 8 the six layers are 117 GFLOP.  On
// CUDA cores (`conv_fe.cu`, and cuDNN's float32 conv1d) that is 1.75 ms at
// the 67 TFLOP/s float32 peak; here it is three TF32 passes at 495 TFLOP/s,
// 165 TFLOP/s of float32 work: 0.71 ms.  The activations are ~0.4 GB of
// float32 in and out, 0.12 ms at 3.35 TB/s: bound by the tensor cores.
//
// Design, from `conv_fe_tc.cu` (whose addressing note applies unchanged:
// Y2 = y as the [B*rows, stride*Cin] matrix, each K step a row shift and a
// column of Y2 from `kernels/conv_fe.py::conv_tile_plan`, with 32-deep
// steps here).  A 128 x 128 output tile per block: one producer warp keeps a
// ring of kStages stages in flight with TMA under full/empty mbarriers,
// each stage a 128 x 32 box of Y2 (16 KB) and 128 x 32 boxes of W_hi and
// W_lo (16 KB each); two consumer warpgroups run wgmma.m64n128k8 on 64 rows
// each.  TF32 wgmma has no transposed mode, so both operands are K-major:
// the wrapper passes the weight as [2, Cout, k*Cin], W^T already split into
// hi and lo (a constant of the model, made once when serving).  The
// activation is split per stage in shared memory: each consumer warpgroup
// rewrites its 64 rows of the Y2 box in place as A_hi and writes A_lo into
// its own double buffer at the same offsets (so the 128-byte swizzle that
// TMA wrote holds for both, and one descriptor form reads either), then
// fences the generic proxy's writes before wgmma reads them.  Three wgmmas
// per 8-deep step: lo.W_hi, hi.W_lo, hi.W_hi.  Shared memory: four stages
// of 48 KB and the A_lo buffers (2 x 2 x 8 KB), one block per SM.  The
// epilogue applies the exact-erf GELU to the total and writes float32 pairs
// from registers, rows t < t_out only.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace emo::sm90;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kTileBytes = kBM * kBK * 4;        // 128 rows x 128 bytes: 16 KB (A, W_hi, W_lo)
constexpr int kStageBytes = 3 * kTileBytes;
constexpr int kHalfBytes = kTileBytes / kConsumers;  // a warpgroup's 64 rows of A: 8 KB
constexpr int kLoBytes = kConsumers * 2 * kHalfBytes;  // A_lo, double-buffered per warpgroup
constexpr int kSmemBytes = kStages * kStageBytes + kLoBytes + 2 * kStages * 8 + 1024;
constexpr int kMaxSteps = 256;                   // K <= 8192
constexpr int kPromote = 4;                      // stages per accumulation chunk

struct TilePlan {
  int steps;
  int row[kMaxSteps];
  int col[kMaxSteps];
  int wrow[kMaxSteps];
};

template <bool kGeluOut>
__global__ void __launch_bounds__(kThreads, 1)
conv_fe_tf32(__grid_constant__ const CUtensorMap map_y, __grid_constant__ const CUtensorMap map_wh,
             __grid_constant__ const CUtensorMap map_wl, __grid_constant__ const TilePlan plan,
             float* __restrict__ out, int m_total, int rows, int t_out, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* lo_base = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + kLoBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int steps = plan.steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        tma_load_2d(st, &map_y, &full[s], plan.col[i], m0 + plan.row[i]);
        tma_load_2d(st + kTileBytes, &map_wh, &full[s], plan.wrow[i], n0);
        tma_load_2d(st + 2 * kTileBytes, &map_wl, &full[s], plan.wrow[i], n0);
      }
    }
    return;
  }

  const int wg = warp / 4, tid = threadIdx.x % 128;
  float acc[64], total[64];  // the chunk's wgmma accumulator; the rounded sum of chunks
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    uint8_t* a = smem + s * kStageBytes + wg * kHalfBytes;  // this warpgroup's 64 rows
    uint8_t* a_lo = lo_base + (wg * 2 + (i & 1)) * kHalfBytes;
    // Split in place: A_hi over the box, A_lo at the same offsets.  The
    // buffer of parity i & 1 was last read by step i - 2, whose wgmmas
    // finished before step i - 1's wait below returned.
#pragma unroll
    for (int c = 0; c < kHalfBytes / 16 / 128; ++c) {
      const int off = (c * 128 + tid) * 16;
      split_tf32_16b(a + off, a_lo + off);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);  // the warpgroup's 64 rows are split

    const uint8_t* wh = smem + s * kStageBytes + kTileBytes;
    const uint8_t* wl = wh + kTileBytes;
    const int fresh = i % kPromote == 0;  // a chunk's first product overwrites acc
    if (fresh && i > 0) {
      // Fold the previous chunk into the total: its last products ran under
      // this stage's split above, so only their tail is waited for here.
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < 64; ++j) total[j] += acc[j];
    }
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      // K-major rows of 128 bytes: 8 columns = 32 bytes further per step.
      const uint64_t d_hi = wgmma_desc(a + kk * 32, 16, 1024);
      const uint64_t d_lo = wgmma_desc(a_lo + kk * 32, 16, 1024);
      const uint64_t d_wh = wgmma_desc(wh + kk * 32, 16, 1024);
      const uint64_t d_wl = wgmma_desc(wl + kk * 32, 16, 1024);
      wgmma_m64n128k8_tf32(acc, d_lo, d_wh, kk > 0 || !fresh);
      wgmma_m64n128k8_tf32(acc, d_hi, d_wl, 1);
      wgmma_m64n128k8_tf32(acc, d_hi, d_wh, 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 64; ++j) total[j] += acc[j];

  const int r_lo = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = r_lo + 8 * half;
    if (m >= m_total || m % rows >= t_out) continue;
    float* orow = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= N) continue;
      float2 v = make_float2(total[4 * j + 2 * half], total[4 * j + 2 * half + 1]);
      if (kGeluOut) {
        v.x = emo::gelu_erf(v.x);
        v.y = emo::gelu_erf(v.y);
      }
      *reinterpret_cast<float2*>(orow + n) = v;
    }
  }
}

// Elementwise x -> (hi, lo), the device's split, for the tests to hold
// against the plain helper (`kernels/conv_fe.py::split_tf32`).
__global__ void split_tf32_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    split_tf32(x[i], hi[i], lo[i]);
}

// A row-major float32 [outer, inner] matrix read in boxes of [kBM or kBN
// rows, kBK columns] with 128-byte swizzle; zeros outside it.
cudaError_t make_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer) {
  static_assert(kBM == kBN, "one box shape for A and W");
  return make_tma_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), base, inner, outer,
                         kBK, kBM);
}

template <bool kGeluOut>
cudaError_t launch_one(const CUtensorMap& map_y, const CUtensorMap& map_wh,
                       const CUtensorMap& map_wl, const TilePlan& plan, float* out, int m_total,
                       int rows, int t_out, int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_fe_tf32<kGeluOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (m_total + kBM - 1) / kBM);
  conv_fe_tf32<kGeluOut><<<grid, kThreads, kSmemBytes, stream>>>(map_y, map_wh, map_wl, plan,
                                                                 out, m_total, rows, t_out, N);
  return cudaGetLastError();
}

}  // namespace

// w: [2, cout, k*cin] float32, W^T split into hi then lo.  plan: `steps`
// triples (row shift, column, W column), one per kBK-deep step.
extern "C" int emo_conv_fe_wgmma_tf32x3(const void* y, const void* w, void* out, int B, int rows,
                                        int t_in, int k, int stride, int cin, int cout,
                                        int gelu_out, const int* plan, int steps, void* stream) {
  const int s_cin = stride * cin, K = k * cin;
  if (B < 1 || k < 1 || stride < 1 || cin < 1 || cout < 8 || cout % 8 != 0 || t_in < k ||
      t_in > rows * stride || steps < 1 || steps > kMaxSteps || steps * kBK != K ||
      s_cin % 4 != 0)
    return cudaErrorInvalidValue;
  const long long m_total = (long long)B * rows;
  if ((m_total + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  TilePlan tp;
  tp.steps = steps;
  for (int i = 0; i < steps; ++i) {
    tp.row[i] = plan[3 * i];
    tp.col[i] = plan[3 * i + 1];
    tp.wrow[i] = plan[3 * i + 2];
    if (tp.col[i] < 0 || tp.col[i] + kBK > s_cin || tp.wrow[i] < 0 || tp.wrow[i] + kBK > K)
      return cudaErrorInvalidValue;
  }
  const float* w_hi = static_cast<const float*>(w);
  const float* w_lo = w_hi + (size_t)cout * K;
  CUtensorMap map_y, map_wh, map_wl;
  cudaError_t err = make_map(&map_y, y, s_cin, m_total);
  if (err == cudaSuccess) err = make_map(&map_wh, w_hi, K, cout);
  if (err == cudaSuccess) err = make_map(&map_wl, w_lo, K, cout);
  if (err != cudaSuccess) return err;
  const int t_out = (t_in - k) / stride + 1;
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gelu_out
             ? launch_one<true>(map_y, map_wh, map_wl, tp, o, (int)m_total, rows, t_out, cout, st)
             : launch_one<false>(map_y, map_wh, map_wl, tp, o, (int)m_total, rows, t_out, cout, st);
}

extern "C" int emo_split_tf32(const void* x, void* hi, void* lo, long long n, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  split_tf32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(hi), static_cast<float*>(lo), n);
  return cudaGetLastError();
}
