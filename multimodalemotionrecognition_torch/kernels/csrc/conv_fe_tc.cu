// K3 in bfloat16 on the tensor cores: one wide-K layer of the WavLM conv
// feature extractor (L1..L6) as an implicit GEMM fed by TMA and run by wgmma.
//
// Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
// pallas_conv_fe.py::_conv_kernel` (launched by `fused_conv_layer`) for
// bfloat16 operands without the input-side GELU; `conv_fe.cu` keeps the
// float32 path and `gelu_input` on CUDA cores.  Same function:
//
//   out[b, t, n] = gelu_out?( sum_{kk < k*Cin} x[b, t*stride*Cin + kk] * W[kk, n] )
//
// bf16 products, float32 accumulation, one bf16 write for t < t_out.
//
// Addressing.  With Y2 = y viewed as the 2-D [B*rows, stride*Cin] matrix, the
// reduction index kk of output row m = b*rows + t lies at Y2[m + kk /
// (stride*Cin), kk % (stride*Cin)]: the TPU kernel's split of W into the
// taps of this row and the halo of the next, as a row shift.  So every
// kBK-deep step of the K loop is one plain 2-D TMA box of Y2 (rows m0 +
// shift, columns col) and one of w_flat (rows kk0, N contiguous).  The
// wrapper computes the (shift, col, w_flat row) of each step
// (`kernels/conv_fe.py::conv_tile_plan`) and passes them in.  M runs over
// all B*rows rows; rows with t >= t_out are computed from whatever follows
// and never stored, and boxes past the end of Y2 arrive as zeros.  An output
// row t < t_out reads only input samples < t_in.
//
// What bounds it on an H100: at B = 8 the six layers are 117 GFLOP over
// ~0.2 GB of bf16 activations, 250-500 FLOP per byte, above the card's ridge
// (~295): bound by the tensor cores' 989 TFLOP/s, 0.118 ms at B = 8.  The
// CUDA-core kernel (`conv_fe.cu`) runs that work as float32 FMAs: 4.71 ms at
// B = 8 on an H100 80GB HBM3 at 700 W, against 0.31 ms for this one.
//
// Design.  A 128 x 128 output tile per block of three roles: one producer
// warp keeps a ring of kStages stages (a 128 x 64 slice of Y2, 16 KB, and a
// 64 x 128 slice of w_flat as two 64 x 64 boxes, 16 KB) in flight with TMA
// under full/empty mbarriers, and two consumer warpgroups each run
// wgmma.m64n128k16 on 64 of the tile's rows (64 float32 accumulators a
// thread).  w_flat is [K, N] with N contiguous, so B is read in wgmma's
// transposed (MN-major) mode; no copy of the weight is made.  Both
// operands arrive with 128-byte swizzle, which is the layout wgmma reads.
// The epilogue applies the exact-erf GELU to the accumulators and writes
// bf16 pairs straight from registers, rows t < t_out only.
//
// Tile and schedule: N = 512 gives 4 column tiles; L1 at B = 8 has 300 row
// tiles (1,200 blocks, 9 waves at one block per SM), L6 40 row tiles (160
// blocks).  A plain grid (columns fastest, so the four blocks of a row tile
// share its Y2 slice in L2) rather than persistent blocks: the 96 KB ring of
// three stages lets two blocks share an SM, so one block's epilogue runs
// under the other's products, which is what a persistent schedule buys.
// L5-L6 are 3 % of the work, so their partial last wave is accepted.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace emo::sm90;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kConsumers = 2;                       // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;     // + the producer warp
constexpr int kABytes = kBM * kBK * 2;              // 16 KB
constexpr int kBHalfBytes = kBK * 64 * 2;           // 64 K rows x 64 columns: 8 KB
constexpr int kStageBytes = kABytes + 2 * kBHalfBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
constexpr int kMaxSteps = 128;                      // K <= 8192

// Per K step of kBK: the row shift and column of the Y2 box, the w_flat row.
struct TilePlan {
  int steps;
  int row[kMaxSteps];
  int col[kMaxSteps];
  int wrow[kMaxSteps];
};

template <bool kGeluOut>
__global__ void __launch_bounds__(kThreads, 1)
conv_fe_wgmma(__grid_constant__ const CUtensorMap map_y, __grid_constant__ const CUtensorMap map_w,
              __grid_constant__ const TilePlan plan, __nv_bfloat16* __restrict__ out,
              int m_total, int rows, int t_out, int N) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
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
        tma_load_2d(st + kABytes, &map_w, &full[s], n0, plan.wrow[i]);
        tma_load_2d(st + kABytes + kBHalfBytes, &map_w, &full[s], n0 + 64, plan.wrow[i]);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* a = smem + s * kStageBytes + wg * 64 * 128;  // this warpgroup's 64 rows
    const uint8_t* bt = smem + s * kStageBytes + kABytes;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: K-major rows of 128 bytes, 16 columns = 32 bytes further per
      // step.  B: MN-major, 16 K rows = 2048 bytes further per step; the
      // second 64-column box is kBHalfBytes away.
      wgmma_m64n128k16_bf16_tb(acc, wgmma_desc(a + kk * 32, 16, 1024),
                               wgmma_desc(bt + kk * 2048, kBHalfBytes, 1024));
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int r_lo = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = r_lo + 8 * half;
    if (m >= m_total || m % rows >= t_out) continue;
    __nv_bfloat16* orow = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= N) continue;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (kGeluOut) {
        v0 = emo::gelu_erf(v0);
        v1 = emo::gelu_erf(v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// A row-major bf16 [outer, inner] matrix read in boxes of [box_outer,
// box_inner] with 128-byte swizzle; zeros outside it.
cudaError_t make_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                     uint32_t box_inner, uint32_t box_outer) {
  return make_tma_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(__nv_bfloat16), base, inner,
                         outer, box_inner, box_outer);
}

template <bool kGeluOut>
cudaError_t launch_one(const CUtensorMap& map_y, const CUtensorMap& map_w, const TilePlan& plan,
                       __nv_bfloat16* out, int m_total, int rows, int t_out, int N,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_fe_wgmma<kGeluOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (m_total + kBM - 1) / kBM);
  conv_fe_wgmma<kGeluOut><<<grid, kThreads, kSmemBytes, stream>>>(map_y, map_w, plan, out,
                                                                  m_total, rows, t_out, N);
  return cudaGetLastError();
}

}  // namespace

// plan: `steps` triples (row shift, column, w_flat row), one per kBK-deep step.
extern "C" int emo_conv_fe_wgmma_bf16(const void* y, const void* w, void* out, int B, int rows,
                                      int t_in, int k, int stride, int cin, int cout,
                                      int gelu_out, const int* plan, int steps, void* stream) {
  const int s_cin = stride * cin;
  if (B < 1 || k < 1 || stride < 1 || cin < 1 || cout < 8 || cout % 8 != 0 || t_in < k ||
      t_in > rows * stride || steps < 1 || steps > kMaxSteps || steps * kBK != k * cin ||
      s_cin % 8 != 0)
    return cudaErrorInvalidValue;
  const long long m_total = (long long)B * rows;
  if ((m_total + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(w)) & 15)
    return cudaErrorMisalignedAddress;
  TilePlan tp;
  tp.steps = steps;
  for (int i = 0; i < steps; ++i) {
    tp.row[i] = plan[3 * i];
    tp.col[i] = plan[3 * i + 1];
    tp.wrow[i] = plan[3 * i + 2];
    if (tp.col[i] < 0 || tp.col[i] + kBK > s_cin || tp.wrow[i] < 0 || tp.wrow[i] + kBK > k * cin)
      return cudaErrorInvalidValue;
  }
  CUtensorMap map_y, map_w;
  cudaError_t err = make_map(&map_y, y, s_cin, m_total, kBK, kBM);
  if (err == cudaSuccess) err = make_map(&map_w, w, cout, (uint64_t)k * cin, 64, kBK);
  if (err != cudaSuccess) return err;
  const int t_out = (t_in - k) / stride + 1;
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gelu_out ? launch_one<true>(map_y, map_w, tp, o, (int)m_total, rows, t_out, cout, st)
                  : launch_one<false>(map_y, map_w, tp, o, (int)m_total, rows, t_out, cout, st);
}
