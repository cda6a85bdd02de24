// K1 in float32 on the tensor cores: the attention core and the
// out-projection of the WavLM attention sublayer, in TF32 with split
// products (3xTF32, `hopper.cuh`) on wgmma and mma.sync, at float32
// accuracy.  Included by `wavlm_attn.cu` only, which calls
// `launch_core_and_proj` for float32 when dh = 64 and seq_len <= 160 and
// then runs its LayerNorm.  The grid and the softmax mirror the bfloat16
// kernels of `wavlm_attn_tc.cuh`; float32 beyond those shapes, and K6, keep
// the CUDA-core device code of `wavlm_sublayer.cuh`.
//
// Replaces, with `wavlm_attn.cu`, the TPU kernel `multimodalemotionrecognition_tpu/
// ops/pallas_wavlm_attn.py::_sublayer_kernel`, whose float32 dots are
// float32 products: a single TF32 product is not (~11 significant bits), so
// every operand is split as hi + lo and each product is lo.hi + hi.lo +
// hi.hi, each exact in the float32 accumulator.
//
// What bounds it on an H100: at B = 8 (Tp = 149, E = 768, 12 heads) the
// sublayer is 1.95 GFLOP of scores, contexts and out-projection over ~22 MB
// of float32 operands: three TF32 passes at 495 TFLOP/s take 0.012 ms, the
// bytes 0.0065 ms.  The CUDA-core kernels take 0.24 ms there (H100 80GB
// HBM3, 700 W), bound by float32 FMA issue and by each warp re-reading K_h
// and V_h from shared memory per query row.  On mma.sync alone the three
// products ran at ~5 % of the TF32 rate on that card (0.084 ms for the
// core); the score product on wgmma took the core to 0.066 ms.
//
// (a) `attn_core_tf32`: one block per (64-query tile, head, element), one
//     warpgroup (four warps of 16 query rows).  S = Q . K^T runs on
//     wgmma.m64n{kKeys}k8: cp.async writes Q and K of the tile and element
//     into shared memory in the 128-byte-swizzled K-major layout wgmma reads
//     (keys past seq_len as zeros), the block splits them there (hi in
//     place, lo beside), and 8 steps of lo.hi, hi.lo, hi.hi follow.  The
//     accumulators come out in mma.sync's fragment layout: a warp's 16 x
//     kKeys score rows, 80 float32 registers a lane at kKeys = 160, so the
//     softmax is exact over the whole row in the TPU kernel's order (s = q.k,
//     s += gate * bias, keys >= seq_len excluded, max and sum with quad
//     shuffles, p = exp(s - m) / l, the dropout from the stateless hash).
//     V then takes K's space (rows of 68 floats: conflict-free fragment
//     loads), loaded under the softmax, and P . V runs on mma.sync.m16n8k8
//     from registers, permuting the reduction index instead of moving P:
//     the score tile's accumulator columns 2q and 2q+1 are used as the A
//     operand's k-columns q and q+4, and V's B fragment reads keys 2q and
//     2q+1 to match, so no shuffle.  ctx is written in float32 to the [B,
//     Tp, E] scratch K2 reads.
// (b) `out_proj_tf32`: ctx . W_o as a GEMM on wgmma, the pipeline of
//     `conv_fe_tf32.cu` at a 64 x 64 tile: a producer warp brings 64 x 32
//     boxes of ctx and of W_o^T ([E_out, E_in], which the wrapper passes:
//     TF32 wgmma has no transposed mode) by TMA into a ring of four stages,
//     the consumer warpgroup splits both boxes in shared memory (hi in
//     place, lo beside) and runs lo.hi, hi.lo and hi.hi, folding each chunk
//     of four steps into a float32 total (the tensor cores' accumulator
//     truncates, `hopper.cuh`).  228 blocks at B = 8, two per SM.  Rows of
//     ctx past seq_len hold whatever the scratch held; their products land
//     in rows that are never stored.  Epilogue as the other kernels': + b_o,
//     the hidden dropout at index (row % Tp) * E + n of hidden_stream(seed,
//     row / Tp), + hidden, float32 pre-LayerNorm rows (K2 reads them).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace emo {
namespace tf32 {

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 160;     // 80 score registers a thread
constexpr int kRowStride = 68;    // floats per shared row of V: 272 bytes
constexpr int kCoreWarps = 4;     // 16 query rows each
constexpr int kCoreRows = 16 * kCoreWarps;

// Shared memory of one core block: Q and K as TF32 hi and lo parts in
// K-major tiles of 128-byte rows (two 32-float halves of the head width),
// swizzled as wgmma reads them; V takes K's space once S is computed; 1 KB
// to align the tiles to the swizzle's 1024-byte atoms.
constexpr int core_smem_bytes(int keys) { return 4 * (kCoreRows + keys) * 128 + 1024; }

// The score tile's wgmma: N = kKeys (64 or 160).
template <int kKeys>
__device__ __forceinline__ void score_wgmma(float (&d)[kKeys / 2], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  if constexpr (kKeys == 64)
    sm90::wgmma_m64n64k8_tf32(d, desc_a, desc_b, accumulate);
  else
    sm90::wgmma_m64n160k8_tf32(d, desc_a, desc_b, accumulate);
}

template <int kKeys>
__global__ void __launch_bounds__(kCoreWarps * 32)
attn_core_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ gate,
               const float* __restrict__ bias, float* __restrict__ ctx, int Tp, int seq_len,
               int E, int H, unsigned seed, const int* __restrict__ seed_dev, unsigned attn_thr,
               float attn_inv) {
  using namespace sm90;
  seed = k1_seed(seed, seed_dev);  // issued first: its latency hides under the loads
  static_assert(kKeys == 64 || kKeys == kMaxKeys, "the score tile's N: 64 or 160 keys");
  static_assert(kCoreWarps == 4, "one warpgroup: wgmma's 64 rows");
  constexpr int kTiles = kKeys / 8;  // n8 score tiles, and k8 steps of P . V
  constexpr int kQHalf = kCoreRows * 128, kKHalf = kKeys * 128;  // a 32-float half, all rows
  extern __shared__ uint8_t core_smem_raw[];
  uint8_t* Qh = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(core_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Ql = Qh + 2 * kQHalf;
  uint8_t* Kh = Ql + 2 * kQHalf;
  uint8_t* Kl = Kh + 2 * kKHalf;
  float* Vs = reinterpret_cast<float*>(Kh);  // [kKeys][kRowStride], once S is computed

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kCoreRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t base = (size_t)b * Tp * E + (size_t)h * kHeadDim;

  // Q and K in 16-byte pieces, 16 a row; piece c of 128-byte row r of a
  // half lands at piece (c % 8) ^ (r % 8): the 128-byte swizzle that TMA
  // writes and wgmma reads.  Rows past seq_len are zeros.
  for (int idx = threadIdx.x; idx < kKeys * 16; idx += kCoreWarps * 32) {
    const int j = idx / 16, c = idx % 16;
    const bool ok = j < seq_len;
    cp_async_16(Kh + (c / 8) * kKHalf + j * 128 + (((c % 8) ^ (j % 8)) * 16),
                k + base + (size_t)(ok ? j : 0) * E + c * 4, ok);
  }
  for (int idx = threadIdx.x; idx < kCoreRows * 16; idx += kCoreWarps * 32) {
    const int r = idx / 16, c = idx % 16;
    const bool ok = i0 + r < seq_len;
    cp_async_16(Qh + (c / 8) * kQHalf + r * 128 + (((c % 8) ^ (r % 8)) * 16),
                q + base + (size_t)(ok ? i0 + r : 0) * E + c * 4, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int off = threadIdx.x * 16; off < 2 * kQHalf; off += kCoreWarps * 32 * 16)
    split_tf32_16b(Qh + off, Ql + off);
  for (int off = threadIdx.x * 16; off < 2 * kKHalf; off += kCoreWarps * 32 * 16)
    split_tf32_16b(Kh + off, Kl + off);
  fence_proxy_async();
  __syncthreads();

  // S = Q . K^T on wgmma, 64 x kKeys: eight 8-deep steps of three products.
  // The accumulators are laid out as mma.sync's: s[t] holds (g, 8t + 2qd
  // + e) and (g + 8, ...) of this warp's 16 rows.
  float s[kTiles][4];
  float(&sf)[kTiles * 4] = *reinterpret_cast<float(*)[kTiles * 4]>(&s[0][0]);
#pragma unroll
  for (int i = 0; i < kTiles * 4; ++i) sf[i] = 0.f;
  wgmma_fence();
  fence_regs(sf);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk) {
    const int qo = (kk / 4) * kQHalf + (kk % 4) * 32, ko = (kk / 4) * kKHalf + (kk % 4) * 32;
    const uint64_t q_hi = wgmma_desc(Qh + qo, 16, 1024), q_lo = wgmma_desc(Ql + qo, 16, 1024);
    const uint64_t k_hi = wgmma_desc(Kh + ko, 16, 1024), k_lo = wgmma_desc(Kl + ko, 16, 1024);
    score_wgmma<kKeys>(sf, q_lo, k_hi, 1);
    score_wgmma<kKeys>(sf, q_hi, k_lo, 1);
    score_wgmma<kKeys>(sf, q_hi, k_hi, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sf);
  __syncthreads();  // every warp's products are done: V takes K's space, under the softmax
  for (int idx = threadIdx.x; idx < kKeys * 16; idx += kCoreWarps * 32) {
    const int j = idx / 16, c = (idx % 16) * 4;
    const bool ok = j < seq_len;
    cp_async_16(&Vs[j * kRowStride + c], v + base + (size_t)(ok ? j : 0) * E + c, ok);
  }
  cp_async_commit();

  const int r0 = i0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < seq_len, ok1 = r1 < seq_len;

  // + gate * bias, keys >= seq_len excluded, then the exact softmax per row.
  const float g0 = ok0 ? gate[((size_t)b * H + h) * Tp + r0] : 0.f;
  const float g1 = ok1 ? gate[((size_t)b * H + h) * Tp + r1] : 0.f;
  const float* b0 = bias + ((size_t)h * Tp + (ok0 ? r0 : 0)) * Tp;
  const float* b1 = bias + ((size_t)h * Tp + (ok1 ? r1 : 0)) * Tp;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = t * 8 + 2 * qd + e;
      if (j < seq_len) {
        if (ok0) s[t][e] += g0 * b0[j];
        if (ok1) s[t][2 + e] += g1 * b1[j];
      } else {
        s[t][e] = s[t][2 + e] = -INFINITY;
      }
      m0 = fmaxf(m0, s[t][e]);
      m1 = fmaxf(m1, s[t][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[t][e] = expf(s[t][e] - m0);
      s[t][2 + e] = expf(s[t][2 + e] - m1);
      l0 += s[t][e];
      l1 += s[t][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const unsigned stream = attn_stream(seed, b, h);
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const unsigned j = (unsigned)(t * 8 + 2 * qd + e);
      float p0 = s[t][e] / l0, p1 = s[t][2 + e] / l1;
      if (attn_thr) {
        p0 = hash_keep(stream, (unsigned)r0 * (unsigned)Tp + j, attn_thr) ? p0 * attn_inv : 0.f;
        p1 = hash_keep(stream, (unsigned)r1 * (unsigned)Tp + j, attn_thr) ? p1 * attn_inv : 0.f;
      }
      s[t][e] = p0;
      s[t][2 + e] = p1;
    }
  }

  cp_async_wait<0>();
  __syncthreads();                        // V has landed
  if (i0 + warp * 16 >= seq_len) return;  // no row of this warp is valid

  // ctx = P . V over k8 steps of 8 keys.  Score tile kc holds (g, keys 2qd
  // and 2qd+1) and (g+8, the same keys): taken as A's k-columns qd and qd+4,
  // with V's B fragment reading keys 2qd and 2qd+1 of the step.
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int t = 0; t < kHeadDim / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kTiles; ++kc) {
    float ph[4], pl[4];
    split_tf32(s[kc][0], ph[0], pl[0]);  // (g, key 2qd)      -> (g, k qd)
    split_tf32(s[kc][2], ph[1], pl[1]);  // (g+8, key 2qd)    -> (g+8, k qd)
    split_tf32(s[kc][1], ph[2], pl[2]);  // (g, key 2qd+1)    -> (g, k qd+4)
    split_tf32(s[kc][3], ph[3], pl[3]);  // (g+8, key 2qd+1)  -> (g+8, k qd+4)
    const float* vr = Vs + (kc * 8 + 2 * qd) * kRowStride + g;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt) {
      float b0h, b0l, b1h, b1l;
      split_tf32(vr[dt * 8], b0h, b0l);               // (key 2qd, d g)
      split_tf32(vr[kRowStride + dt * 8], b1h, b1l);  // (key 2qd+1, d g)
      mma_3xtf32_1688(o[dt], ph, pl, b0h, b1h, b0l, b1l);
    }
  }
#pragma unroll
  for (int t = 0; t < kHeadDim / 8; ++t) {
    const int d = t * 8 + 2 * qd;
    if (ok0) *reinterpret_cast<float2*>(ctx + base + (size_t)r0 * E + d) = make_float2(o[t][0], o[t][1]);
    if (ok1) *reinterpret_cast<float2*>(ctx + base + (size_t)r1 * E + d) = make_float2(o[t][2], o[t][3]);
  }
}

// The out-projection's tile: 64 x 64 outputs a block, one consumer warpgroup
// on wgmma.m64n64k8 and one producer warp keeping kPStages stages of TMA
// boxes in flight (ctx and W_o^T, 64 rows x 32 float32 each); the split
// parts' lo halves are double-buffered by step.
constexpr int kPM = 64, kPN = 64, kPK = 32, kPStages = 4, kPromote = 4;
constexpr int kPThreads = 128 + 32;
constexpr int kPTileBytes = kPM * kPK * 4;  // 64 rows x 128 bytes: 8 KB
constexpr int kPStageBytes = 2 * kPTileBytes;
constexpr int kProjSmemBytes = kPStages * kPStageBytes + 2 * kPStageBytes + 2 * kPStages * 8 + 1024;

static __global__ void __launch_bounds__(kPThreads)
out_proj_tf32(__grid_constant__ const CUtensorMap map_ctx, __grid_constant__ const CUtensorMap map_wt,
              const float* __restrict__ hidden, const float* __restrict__ bo,
              float* __restrict__ proj, int M, int Tp, int seq_len, int E, unsigned seed,
              const int* __restrict__ seed_dev, unsigned hid_thr, float hid_inv) {
  using namespace sm90;
  seed = k1_seed(seed, seed_dev);  // issued first: its latency hides under the loads
  extern __shared__ uint8_t proj_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(proj_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* lo_base = smem + kPStages * kPStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + 2 * kPStageBytes);
  uint64_t* empty = full + kPStages;
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int steps = E / kPK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kPStages;
        if (i >= kPStages) mbar_wait(&empty[s], ((i / kPStages) - 1) & 1);
        uint8_t* st = smem + s * kPStageBytes;
        mbar_arrive_expect_tx(&full[s], kPStageBytes);
        tma_load_2d(st, &map_ctx, &full[s], i * kPK, m0);
        tma_load_2d(st + kPTileBytes, &map_wt, &full[s], i * kPK, n0);
      }
    }
    return;
  }

  float acc[32], total[32];  // as in `conv_fe_tf32.cu`: a chunk's wgmma sum, the rounded total
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = total[j] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % kPStages;
    mbar_wait(&full[s], (i / kPStages) & 1);
    uint8_t* st = smem + s * kPStageBytes;
    uint8_t* lo = lo_base + (i & 1) * kPStageBytes;  // last read by step i - 2
#pragma unroll
    for (int c = 0; c < kPStageBytes / 16 / 128; ++c) {  // both boxes: hi in place, lo beside
      const int off = (c * 128 + threadIdx.x) * 16;
      split_tf32_16b(st + off, lo + off);
    }
    fence_proxy_async();
    named_barrier(1, 128);
    const int fresh = i % kPromote == 0;
    if (fresh && i > 0) {  // fold the previous chunk, whose tail ran under this split
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < 32; ++j) total[j] += acc[j];
    }
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kPK / 8; ++kk) {
      const uint64_t a_hi = wgmma_desc(st + kk * 32, 16, 1024);
      const uint64_t a_lo = wgmma_desc(lo + kk * 32, 16, 1024);
      const uint64_t b_hi = wgmma_desc(st + kPTileBytes + kk * 32, 16, 1024);
      const uint64_t b_lo = wgmma_desc(lo + kPTileBytes + kk * 32, 16, 1024);
      wgmma_m64n64k8_tf32(acc, a_lo, b_hi, kk > 0 || !fresh);
      wgmma_m64n64k8_tf32(acc, a_hi, b_lo, 1);
      wgmma_m64n64k8_tf32(acc, a_hi, b_hi, 1);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kPStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 32; ++j) total[j] += acc[j];

  const int g = lane / 4, qd = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + warp * 16 + g + 8 * half;
    if (row >= M || (row % Tp) >= seq_len) continue;
    const unsigned stream = hidden_stream(seed, row / Tp);
    const unsigned index0 = (unsigned)(row % Tp) * (unsigned)E;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * qd;
      float2 val;
      val.x = total[4 * j + 2 * half] + bo[n];
      val.y = total[4 * j + 2 * half + 1] + bo[n + 1];
      if (hid_thr) {
        val.x = hash_keep(stream, index0 + n, hid_thr) ? val.x * hid_inv : 0.f;
        val.y = hash_keep(stream, index0 + n + 1, hid_thr) ? val.y * hid_inv : 0.f;
      }
      const float2 res = *reinterpret_cast<const float2*>(hidden + (size_t)row * E + n);
      val.x += res.x;
      val.y += res.y;
      *reinterpret_cast<float2*>(proj + (size_t)row * E + n) = val;
    }
  }
}

template <int kKeys>
static cudaError_t launch_core(dim3 grid, const float* q, const float* k, const float* v,
                               const float* gate, const float* bias, float* ctx, int Tp,
                               int seq_len, int E, int H, unsigned seed, const int* seed_dev,
                               unsigned attn_thr, float attn_inv, cudaStream_t stream) {
  constexpr int bytes = core_smem_bytes(kKeys);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_core_tf32<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  attn_core_tf32<kKeys><<<grid, kCoreWarps * 32, bytes, stream>>>(
      q, k, v, gate, bias, ctx, Tp, seq_len, E, H, seed, seed_dev, attn_thr, attn_inv);
  return cudaGetLastError();
}

// (a) then (b) on `stream`; the caller launches the LayerNorm.  `wo_t` is
// W_o transposed, [E_out, E_in] (TF32 wgmma reads both operands K-major).
// Q, K, V, W_o^T and ctx are read in 16-byte pieces, hidden and proj in
// 8-byte pairs: misaligned pointers are refused.
static cudaError_t launch_core_and_proj(
    const float* hidden, const float* q, const float* k, const float* v, const float* gate,
    const float* bias, const float* wo_t, const float* bo, float* ctx, float* proj, int B, int Tp,
    int seq_len, int E, int H, unsigned seed, const int* seed_dev, unsigned attn_thr,
    float attn_inv, unsigned hid_thr, float hid_inv, cudaStream_t stream) {
  if (E % kPN != 0 || seq_len > kMaxKeys || wo_t == nullptr) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(hidden) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(wo_t) | reinterpret_cast<uintptr_t>(ctx) |
       reinterpret_cast<uintptr_t>(proj)) & 15)
    return cudaErrorMisalignedAddress;
  const dim3 grid_a((seq_len + kCoreRows - 1) / kCoreRows, H, B);
  cudaError_t err =
      seq_len <= 64
          ? launch_core<64>(grid_a, q, k, v, gate, bias, ctx, Tp, seq_len, E, H, seed, seed_dev,
                            attn_thr, attn_inv, stream)
          : launch_core<kMaxKeys>(grid_a, q, k, v, gate, bias, ctx, Tp, seq_len, E, H, seed,
                                  seed_dev, attn_thr, attn_inv, stream);
  if (err != cudaSuccess) return err;
  const int M = B * Tp;
  CUtensorMap map_ctx, map_wt;
  err = sm90::make_tma_map_2d(&map_ctx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), ctx, E, M,
                              kPK, kPM);
  if (err == cudaSuccess)
    err = sm90::make_tma_map_2d(&map_wt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), wo_t, E,
                                E, kPK, kPN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(out_proj_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kProjSmemBytes);
  if (err != cudaSuccess) return err;
  out_proj_tf32<<<dim3(E / kPN, (M + kPM - 1) / kPM), kPThreads, kProjSmemBytes, stream>>>(
      map_ctx, map_wt, hidden, bo, proj, M, Tp, seq_len, E, seed, seed_dev, hid_thr, hid_inv);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace emo
