// K6 in float32 on the tensor cores: K1's float32 tensor-core arithmetic
// (`wavlm_attn_tf32.cuh`: TF32 split products, 3xTF32, the scores and the
// out-projection on wgmma, P . V on mma.sync) with G batch elements per
// block.  Included by `wavlm_attn_tiled.cu`, whose
// `emo_wavlm_attn_tiled_tc_f32` runs it when `kernels/wavlm_attn_tiled.py::
// tensor_core_route` says so (head width 64, seq_len <= 160); the LayerNorm
// pass is K1's (`wavlm_sublayer.cuh`).
//
// Every product and every sum of an output element is K1's, in K1's order
// (the same wgmma shapes, the same chunk folding of the out-projection), so
// on rows < seq_len the result equals K1's bit for bit, and G changes which
// block computes a row, never how.  All Tp query rows are computed and
// written, as the TPU kernel does.
//
// (a) `tiled_core_tf32`: one block per (64-query tile, head, B / G), one
//     warpgroup, walking its G elements in K1's shared memory (113 KB: Q and
//     K_h as TF32 hi and lo in the swizzled K-major tiles wgmma reads, V_h
//     in K's space once the scores are taken), so that two blocks share an
//     SM as K1's do.  What stays resident across the G elements: nothing
//     but the block.  The head's bias rows of the tile (38 KB at seq_len
//     149) and a second buffer of K would take a block past half the SM's
//     shared memory: one block an SM, which ran the core far slower than
//     K1's two (a first version).  The bias rows are read from device
//     memory in the softmax as K1 reads them (L2 keeps the 1.2 MB of
//     them).  What G buys: the next element's Q lands in Q's hi
//     tile under this element's softmax and P . V; its K follows P . V.
// (b) `tiled_proj_tf32`: one block per (64 columns of W_o, B / G), K1's
//     out-projection pipeline (a producer warp, TMA boxes of ctx and W_o^T
//     through a ring of four stages, the consumer warpgroup splitting both
//     and running lo.hi, hi.lo, hi.hi on wgmma.m64n64k8, the sum folded
//     every four steps) walking the G * Tp rows of its elements 64 at a
//     time, the ring running on across row tiles.  A split W_o^T column
//     tile (768 x 64 float32, hi and lo: 384 KB) does not fit in shared
//     memory, so W_o streams as in K1: what G changes is how often the same
//     2.4 MB of W_o^T crosses from L2, where all of it stays.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace emo {
namespace tiled_tf32 {

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 160;     // 80 score registers a thread
constexpr int kRowStride = 68;    // floats per shared row of V: 272 bytes
constexpr int kCoreWarps = 4;     // 16 query rows each
constexpr int kCoreRows = 16 * kCoreWarps;

// Shared memory of a core block, as K1's: Q and K as TF32 hi and lo parts
// in K-major tiles of 128-byte rows; V takes K's space; 1 KB of alignment.
__host__ __device__ constexpr size_t core_smem_bytes(int keys) {
  return 4 * (size_t)(kCoreRows + keys) * 128 + 1024;
}

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
tiled_core_tf32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ gate,
                const float* __restrict__ bias, float* __restrict__ ctx, int G, int Tp,
                int seq_len, int E, int H) {
  using namespace sm90;
  static_assert(kKeys == 64 || kKeys == kMaxKeys, "the score tile's N: 64 or 160 keys");
  constexpr int kTiles = kKeys / 8;  // n8 score tiles, and k8 steps of P . V
  constexpr int kQHalf = kCoreRows * 128, kKHalf = kKeys * 128;  // a 32-float half, all rows
  extern __shared__ uint8_t tiled_core_raw[];
  uint8_t* Qh = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tiled_core_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Ql = Qh + 2 * kQHalf;
  uint8_t* Kh = Ql + 2 * kQHalf;
  uint8_t* Kl = Kh + 2 * kKHalf;
  float* Vs = reinterpret_cast<float*>(Kh);  // [kKeys][kRowStride], once S is computed

  const int h = blockIdx.y, i0 = blockIdx.x * kCoreRows, b0 = blockIdx.z * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int r0 = i0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < Tp, ok1 = r1 < Tp;
  const size_t hoff = (size_t)h * kHeadDim;

  // Q and K of element b in 16-byte pieces, 16 a row; piece c of 128-byte
  // row r of a half lands at piece (c % 8) ^ (r % 8): the 128-byte swizzle
  // wgmma reads.  Key rows past seq_len and query rows past Tp are zeros.
  auto load_k = [&](int b) {
    const size_t base = (size_t)b * Tp * E + hoff;
    for (int idx = threadIdx.x; idx < kKeys * 16; idx += kCoreWarps * 32) {
      const int j = idx / 16, c = idx % 16;
      const bool ok = j < seq_len;
      cp_async_16(Kh + (c / 8) * kKHalf + j * 128 + (((c % 8) ^ (j % 8)) * 16),
                  k + base + (size_t)(ok ? j : 0) * E + c * 4, ok);
    }
  };
  auto load_q = [&](int b) {
    const size_t base = (size_t)b * Tp * E + hoff;
    for (int idx = threadIdx.x; idx < kCoreRows * 16; idx += kCoreWarps * 32) {
      const int r = idx / 16, c = idx % 16;
      const bool ok = i0 + r < Tp;
      cp_async_16(Qh + (c / 8) * kQHalf + r * 128 + (((c % 8) ^ (r % 8)) * 16),
                  q + base + (size_t)(ok ? i0 + r : 0) * E + c * 4, ok);
    }
  };
  load_k(b0);
  load_q(b0);
  cp_async_commit();

  const float* bias0 = bias + ((size_t)h * Tp + (ok0 ? r0 : 0)) * Tp;
  const float* bias1 = bias + ((size_t)h * Tp + (ok1 ? r1 : 0)) * Tp;
  for (int e = 0; e < G; ++e) {
    const int b = b0 + e;
    const size_t base = (size_t)b * Tp * E + hoff;
    cp_async_wait<0>();  // this element's Q and K
    __syncthreads();
    for (int off = threadIdx.x * 16; off < 2 * kQHalf; off += kCoreWarps * 32 * 16)
      split_tf32_16b(Qh + off, Ql + off);
    for (int off = threadIdx.x * 16; off < 2 * kKHalf; off += kCoreWarps * 32 * 16)
      split_tf32_16b(Kh + off, Kl + off);
    fence_proxy_async();
    __syncthreads();

    // S = Q . K^T on wgmma, 64 x kKeys: eight 8-deep steps of three products.
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
    if (e + 1 < G) load_q(b + 1);  // Q's hi tile is free: the next element's Q
    cp_async_commit();

    // + gate * bias, keys >= seq_len excluded, then the exact softmax per row.
    const float g0 = ok0 ? gate[((size_t)b * H + h) * Tp + r0] : 0.f;
    const float g1 = ok1 ? gate[((size_t)b * H + h) * Tp + r1] : 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int j = t * 8 + 2 * qd + e2;
        if (j < seq_len) {
          if (ok0) s[t][e2] += g0 * bias0[j];
          if (ok1) s[t][2 + e2] += g1 * bias1[j];
        } else {
          s[t][e2] = s[t][2 + e2] = -INFINITY;
        }
        m0 = fmaxf(m0, s[t][e2]);
        m1 = fmaxf(m1, s[t][2 + e2]);
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
      for (int e2 = 0; e2 < 2; ++e2) {
        s[t][e2] = expf(s[t][e2] - m0);
        s[t][2 + e2] = expf(s[t][2 + e2] - m1);
        l0 += s[t][e2];
        l1 += s[t][2 + e2];
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        s[t][e2] = s[t][e2] / l0;
        s[t][2 + e2] = s[t][2 + e2] / l1;
      }
    }

    cp_async_wait<1>();  // V has landed (the next element's Q may fly)
    __syncthreads();
    if (i0 + warp * 16 < Tp) {  // this warp has a row to compute
      // ctx = P . V over k8 steps of 8 keys, as K1: score tile kc's columns
      // 2qd and 2qd+1 are A's k-columns qd and qd+4, V's B fragment reads
      // keys 2qd and 2qd+1 of the step.
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
    if (e + 1 < G) {
      __syncthreads();  // every warp is done with V: the next element's K takes its space
      load_k(b + 1);
    }
    cp_async_commit();
  }
}

// The out-projection's tile: as `tf32::out_proj_tf32`, 64 x 64 outputs, one
// consumer warpgroup on wgmma.m64n64k8 and one producer warp keeping
// kPStages stages of TMA boxes in flight (ctx and W_o^T, 64 rows x 32
// float32 each); the split parts' lo halves are double-buffered by step.
constexpr int kPM = 64, kPN = 64, kPK = 32, kPStages = 4, kPromote = 4;
constexpr int kPThreads = 128 + 32;
constexpr int kPTileBytes = kPM * kPK * 4;  // 64 rows x 128 bytes: 8 KB
constexpr int kPStageBytes = 2 * kPTileBytes;
constexpr int kProjSmemBytes = kPStages * kPStageBytes + 2 * kPStageBytes + 2 * kPStages * 8 + 1024;

static __global__ void __launch_bounds__(kPThreads)
tiled_proj_tf32(__grid_constant__ const CUtensorMap map_ctx, __grid_constant__ const CUtensorMap map_wt,
                const float* __restrict__ hidden, const float* __restrict__ bo,
                float* __restrict__ proj, int rows_per_block, int E) {
  using namespace sm90;
  extern __shared__ uint8_t tiled_proj_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tiled_proj_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* lo_base = smem + kPStages * kPStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + 2 * kPStageBytes);
  uint64_t* empty = full + kPStages;
  const int n0 = blockIdx.x * kPN;
  const int first = blockIdx.y * rows_per_block, last = first + rows_per_block;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int steps = E / kPK, tiles = (rows_per_block + kPM - 1) / kPM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: step n is row tile n / steps, K slice n % steps
    if (lane == 0) {
      for (int n = 0; n < tiles * steps; ++n) {
        const int s = n % kPStages;
        if (n >= kPStages) mbar_wait(&empty[s], ((n / kPStages) - 1) & 1);
        uint8_t* st = smem + s * kPStageBytes;
        mbar_arrive_expect_tx(&full[s], kPStageBytes);
        tma_load_2d(st, &map_ctx, &full[s], (n % steps) * kPK, first + (n / steps) * kPM);
        tma_load_2d(st + kPTileBytes, &map_wt, &full[s], (n % steps) * kPK, n0);
      }
    }
    return;
  }

  const int g = lane / 4, qd = lane % 4;
  for (int mt = 0; mt < tiles; ++mt) {
    float acc[32], total[32];  // a chunk's wgmma sum, the rounded total
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = total[j] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int n = mt * steps + i, s = n % kPStages;
      mbar_wait(&full[s], (n / kPStages) & 1);
      uint8_t* st = smem + s * kPStageBytes;
      uint8_t* lo = lo_base + (n & 1) * kPStageBytes;  // last read by step n - 2
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
      if (i > 0 && lane == 0) mbar_arrive(&empty[(n - 1) % kPStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 32; ++j) total[j] += acc[j];
    if (lane == 0) mbar_arrive(&empty[(mt * steps + steps - 1) % kPStages]);

    const int m0 = first + mt * kPM;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp * 16 + g + 8 * half;
      if (row >= last) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * j + 2 * qd;
        float2 val;
        val.x = total[4 * j + 2 * half] + bo[n];
        val.y = total[4 * j + 2 * half + 1] + bo[n + 1];
        const float2 res = *reinterpret_cast<const float2*>(hidden + (size_t)row * E + n);
        val.x += res.x;
        val.y += res.y;
        *reinterpret_cast<float2*>(proj + (size_t)row * E + n) = val;
      }
    }
  }
}

template <int kKeys>
static cudaError_t launch_core(dim3 grid, const float* q, const float* k, const float* v,
                               const float* gate, const float* bias, float* ctx, int G, int Tp,
                               int seq_len, int E, int H, cudaStream_t stream) {
  const size_t bytes = core_smem_bytes(kKeys);
  const cudaError_t err = cudaFuncSetAttribute(
      tiled_core_tf32<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  tiled_core_tf32<kKeys><<<grid, kCoreWarps * 32, bytes, stream>>>(q, k, v, gate, bias, ctx, G,
                                                                   Tp, seq_len, E, H);
  return cudaGetLastError();
}

// (a) then (b) on `stream`; the caller launches the LayerNorm over all rows.
// `wo_t` is W_o transposed, [E_out, E_in] (TF32 wgmma reads both operands
// K-major).  Q, K, V, W_o^T and ctx are read in 16-byte pieces, hidden and
// proj in 8-byte pairs: misaligned pointers are refused.
static cudaError_t launch_core_and_proj(
    const float* hidden, const float* q, const float* k, const float* v, const float* gate,
    const float* bias, const float* wo_t, const float* bo, float* ctx, float* proj, int G, int B,
    int Tp, int seq_len, int E, int H, cudaStream_t stream) {
  if (E != kHeadDim * H || seq_len > kMaxKeys || wo_t == nullptr) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(hidden) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(wo_t) | reinterpret_cast<uintptr_t>(ctx) |
       reinterpret_cast<uintptr_t>(proj)) & 15)
    return cudaErrorMisalignedAddress;
  const dim3 grid_a((Tp + kCoreRows - 1) / kCoreRows, H, B / G);
  cudaError_t err =
      seq_len <= 64
          ? launch_core<64>(grid_a, q, k, v, gate, bias, ctx, G, Tp, seq_len, E, H, stream)
          : launch_core<kMaxKeys>(grid_a, q, k, v, gate, bias, ctx, G, Tp, seq_len, E, H, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap map_ctx, map_wt;
  err = sm90::make_tma_map_2d(&map_ctx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), ctx, E,
                              (uint64_t)B * Tp, kPK, kPM);
  if (err == cudaSuccess)
    err = sm90::make_tma_map_2d(&map_wt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), wo_t, E,
                                E, kPK, kPN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tiled_proj_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kProjSmemBytes);
  if (err != cudaSuccess) return err;
  tiled_proj_tf32<<<dim3(E / kPN, B / G), kPThreads, kProjSmemBytes, stream>>>(
      map_ctx, map_wt, hidden, bo, proj, G * Tp, E);
  return cudaGetLastError();
}

}  // namespace tiled_tf32
}  // namespace emo
