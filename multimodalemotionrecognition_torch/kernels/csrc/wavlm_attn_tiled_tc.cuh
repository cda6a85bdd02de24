// K6 in bfloat16 on the tensor cores: K1's tensor-core arithmetic
// (`wavlm_attn_tc.cuh`: mma.sync.m16n8k16, bf16 operands, float32
// accumulators) with G batch elements per block.  Included by
// `wavlm_attn_tiled.cu`, whose `emo_wavlm_attn_tiled_tc_bf16` runs it when
// `kernels/wavlm_attn_tiled.py::tensor_core_route` says so (head width 64,
// seq_len <= 160); the LayerNorm pass is K1's (`wavlm_sublayer.cuh`).
//
// Every product and every sum of an output element is K1's, in K1's order,
// so on rows < seq_len the result equals K1's bit for bit, and G changes
// which block computes a row, never how.  Unlike K1, all Tp query rows are
// computed and written (rows at or past seq_len attend over the seq_len keys
// with their own bias rows, as the TPU kernel's padding rows do).
//
// (a) `tiled_core_mma`: one block per (64-query tile, head, B / G), four
//     warps of 16 query rows, walking its G elements.  The head's bias rows
//     of the tile (64 x seq_len float32, 40 KB at 160) are copied once and
//     stay in shared memory for the G elements (rows 8 floats past a
//     multiple of 32: conflict-free float2 reads).  K_h is double-buffered:
//     element e + 1's keys land by cp.async while element e computes; V_h
//     has one buffer, refilled as soon as element e's P . V is done, so it
//     lands under element e + 1's scores and softmax.  Q comes from device
//     memory into registers as A fragments, as in K1.  110 KB a block: two
//     blocks an SM.
// (b) `tiled_proj_mma`: one block per (64 columns of W_o, B / G).  The
//     block's column tile of W_o (E x 64 bf16, 108 KB in rows of 144 bytes)
//     is copied once and stays while the block walks the G * Tp rows of its
//     elements: four groups of four warps take the 64-row tiles in turn,
//     each streaming its ctx slices (64 x 32) through its own three-stage
//     cp.async ring that runs on across its row tiles.  A 64 x 64 tile is
//     K1's four warps of 32 x 32 and K1's epilogue (+ b_o + hidden, float32
//     pre-LayerNorm rows).  168 KB and 16 warps a block: one block an SM
//     (a first version with one group, four warps an SM, ran the
//     out-projection far slower than K1's many small blocks).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace emo {
namespace tiled_tc {

using sm90::cp_async_16;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16_16816;
using sm90::pack_bf16;

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 160;   // 80 score registers a thread
constexpr int kRowStride = 72;  // bf16 per shared row of K and V: 144 bytes
constexpr int kCoreWarps = 4;   // 16 query rows each
constexpr int kCoreRows = 16 * kCoreWarps;

// Floats a resident bias row takes: 8 past a multiple of 32, so that the
// float2 reads of a warp's 8 rows x 4 column pairs fall in distinct banks.
__host__ __device__ constexpr int bias_stride(int seq_len) { return (seq_len + 31) / 32 * 32 + 8; }

// Shared memory of a core block: the bias rows, K_h twice, V_h once.
__host__ __device__ constexpr size_t core_smem_bytes(int keys, int seq_len) {
  return 4 * (size_t)kCoreRows * bias_stride(seq_len) + 3 * (size_t)keys * kRowStride * 2;
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 4-byte asynchronous copy (a bias row of Tp floats need not be 16-byte
// aligned); `valid` false writes zeros.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

template <int kKeys>
__global__ void __launch_bounds__(kCoreWarps * 32)
tiled_core_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const float* __restrict__ gate,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ ctx, int G, int Tp,
               int seq_len, int E, int H) {
  static_assert(kKeys % 16 == 0 && kKeys <= kMaxKeys, "keys held: a multiple of 16, <= 160");
  constexpr int kTiles = kKeys / 8;  // n8 score tiles
  constexpr int kKeyElems = kKeys * kRowStride;
  extern __shared__ __align__(16) uint8_t tiled_core_raw[];
  const int bstride = bias_stride(seq_len);
  float* Bs = reinterpret_cast<float*>(tiled_core_raw);                 // [kCoreRows][bstride]
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(Bs + kCoreRows * bstride);  // [2][kKeys][72]
  __nv_bfloat16* Vs = Ks + 2 * kKeyElems;                               // [kKeys][72]

  const int h = blockIdx.y, i0 = blockIdx.x * kCoreRows, b0 = blockIdx.z * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix x4: row mr of matrix mi
  const int r0 = i0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < Tp, ok1 = r1 < Tp;
  const bool active = i0 + warp * 16 < Tp;  // this warp has a row to compute
  const size_t hoff = (size_t)h * kHeadDim;

  auto load_keys = [&](const __nv_bfloat16* src, int b, __nv_bfloat16* dst) {
    const size_t base = (size_t)b * Tp * E + hoff;
    for (int idx = threadIdx.x; idx < kKeys * 8; idx += kCoreWarps * 32) {
      const int j = idx / 8, c = (idx % 8) * 8;
      const bool ok = j < seq_len;
      cp_async_16(&dst[j * kRowStride + c], src + base + (size_t)(ok ? j : 0) * E + c, ok);
    }
  };

  // What the batch shares: the head's bias rows of this query tile, in
  // 16-byte pieces when the rows allow (Tp a multiple of 4), else in floats.
  if (Tp % 4 == 0 && (reinterpret_cast<uintptr_t>(bias) & 15) == 0) {
    const int pieces = (seq_len + 3) / 4;  // columns up to 4 * pieces <= Tp
    for (int idx = threadIdx.x; idx < kCoreRows * pieces; idx += kCoreWarps * 32) {
      const int r = idx / pieces, j = (idx - r * pieces) * 4;
      const bool ok = i0 + r < Tp;
      cp_async_16(&Bs[r * bstride + j], bias + ((size_t)h * Tp + (ok ? i0 + r : 0)) * Tp + j, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kCoreRows * seq_len; idx += kCoreWarps * 32) {
      const int r = idx / seq_len, j = idx - r * seq_len;
      const bool ok = i0 + r < Tp;
      cp_async_4(&Bs[r * bstride + j], bias + ((size_t)h * Tp + (ok ? i0 + r : 0)) * Tp + j, ok);
    }
  }
  load_keys(k, b0, Ks);
  sm90::cp_async_commit();  // the bias rows and K of the first element
  load_keys(v, b0, Vs);
  sm90::cp_async_commit();  // V of the first element

  const float* bias0 = Bs + (warp * 16 + g) * bstride;
  const float* bias1 = bias0 + 8 * bstride;
  for (int e = 0; e < G; ++e) {
    const int b = b0 + e;
    const size_t base = (size_t)b * Tp * E + hoff;
    const __nv_bfloat16* Kc = Ks + (e & 1) * kKeyElems;
    // The next element's keys into the other buffer (read last by element
    // e - 1's scores, done before the barrier that ended it).
    if (e + 1 < G) load_keys(k, b + 1, Ks + ((e + 1) & 1) * kKeyElems);
    sm90::cp_async_commit();

    // This lane's rows of the warp's 16; Q as A fragments, while K flies.
    uint32_t qa[kHeadDim / 16][4];
#pragma unroll
    for (int kc = 0; kc < kHeadDim / 16; ++kc) {
      const int d = kc * 16 + 2 * qd;
      qa[kc][0] = ok0 ? ld_pair(q + base + (size_t)r0 * E + d) : 0u;
      qa[kc][1] = ok1 ? ld_pair(q + base + (size_t)r1 * E + d) : 0u;
      qa[kc][2] = ok0 ? ld_pair(q + base + (size_t)r0 * E + d + 8) : 0u;
      qa[kc][3] = ok1 ? ld_pair(q + base + (size_t)r1 * E + d + 8) : 0u;
    }
    sm90::cp_async_wait<2>();  // K of this element (the next element's K and this V may fly)
    __syncthreads();

    float s[kTiles][4];
    if (active) {
      // S = Q . K^T, 16 x kKeys a warp.
#pragma unroll
      for (int t = 0; t < kTiles; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kHeadDim / 16; ++kc) {
#pragma unroll
        for (int np = 0; np < kTiles / 2; ++np) {
          uint32_t kb[4];  // (keys +0, d +0), (keys +0, d +8), (keys +8, d +0), (keys +8, d +8)
          ldmatrix_x4(kb, &Kc[(np * 16 + mr + 8 * (mi / 2)) * kRowStride + kc * 16 + 8 * (mi % 2)]);
          mma_bf16_16816(s[2 * np], qa[kc], kb[0], kb[1]);
          mma_bf16_16816(s[2 * np + 1], qa[kc], kb[2], kb[3]);
        }
      }

      // + gate * bias, keys >= seq_len excluded, then the exact softmax per row.
      const float g0 = ok0 ? gate[((size_t)b * H + h) * Tp + r0] : 0.f;
      const float g1 = ok1 ? gate[((size_t)b * H + h) * Tp + r1] : 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        const float2 bb0 = *reinterpret_cast<const float2*>(bias0 + t * 8 + 2 * qd);
        const float2 bb1 = *reinterpret_cast<const float2*>(bias1 + t * 8 + 2 * qd);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int j = t * 8 + 2 * qd + e2;
          if (j < seq_len) {
            if (ok0) s[t][e2] += g0 * (e2 ? bb0.y : bb0.x);
            if (ok1) s[t][2 + e2] += g1 * (e2 ? bb1.y : bb1.x);
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
    }
    sm90::cp_async_wait<1>();  // V of this element
    __syncthreads();

    if (active) {
      // ctx = P . V: the score tiles 2c and 2c + 1, rounded to bf16, are the
      // A fragment of the 16 keys of chunk c.
      float o[kHeadDim / 8][4];
#pragma unroll
      for (int t = 0; t < kHeadDim / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kHeadDim / 16; ++dp) {
          uint32_t vb[4];  // (keys +0, d +0), (keys +8, d +0), (keys +0, d +8), (keys +8, d +8)
          ldmatrix_x4_trans(vb, &Vs[(kc * 16 + mr + 8 * (mi % 2)) * kRowStride + dp * 16 + 8 * (mi / 2)]);
          mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < kHeadDim / 8; ++t) {
        const int d = t * 8 + 2 * qd;
        if (ok0)
          *reinterpret_cast<__nv_bfloat162*>(ctx + base + (size_t)r0 * E + d) =
              __floats2bfloat162_rn(o[t][0], o[t][1]);
        if (ok1)
          *reinterpret_cast<__nv_bfloat162*>(ctx + base + (size_t)r1 * E + d) =
              __floats2bfloat162_rn(o[t][2], o[t][3]);
      }
    }
    __syncthreads();  // every warp is done with V and with this element's K
    if (e + 1 < G) load_keys(v, b + 1, Vs);
    sm90::cp_async_commit();  // V of the next element
  }
}

// The out-projection's tile: 64 x 64 outputs, four warps of 32 x 32, K in
// steps of 32.  A block runs kPGroups such tiles at once, one a group of
// four warps with its own three-stage cp.async ring of ctx slices, over
// one resident column tile of W_o.
constexpr int kPM = 64, kPN = 64, kPK = 32, kPStages = 3, kPGroups = 4;
constexpr int kPThreads = 128 * kPGroups;
constexpr int kAStride = kPK + 8;  // 80-byte rows: conflict-free ldmatrix
constexpr int kBStride = kPN + 8;  // 144-byte rows

__host__ __device__ constexpr size_t proj_smem_bytes(int E) {
  return 2 * ((size_t)E * kBStride + (size_t)kPGroups * kPStages * kPM * kAStride);
}

static __global__ void __launch_bounds__(kPThreads)
tiled_proj_mma(const __nv_bfloat16* __restrict__ ctx, const __nv_bfloat16* __restrict__ hidden,
               const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
               float* __restrict__ proj, int rows_per_block, int E) {
  extern __shared__ __align__(16) uint8_t tiled_proj_raw[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(tiled_proj_raw);  // [E][kBStride]
  const int group = threadIdx.x / 128, tid = threadIdx.x % 128;
  // [kPStages][kPM * kAStride], this group's ring
  __nv_bfloat16* As = Ws + (size_t)E * kBStride + (size_t)group * kPStages * kPM * kAStride;
  const int n0 = blockIdx.x * kPN;
  const int first = blockIdx.y * rows_per_block, last = first + rows_per_block;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, qd = lane % 4, mi = lane / 8, mr = lane % 8;
  const int steps = E / kPK, tiles = (rows_per_block + kPM - 1) / kPM;
  // This group's row tiles: group, group + kPGroups, ...; steps n of its walk.
  const int mine = tiles > group ? (tiles - group + kPGroups - 1) / kPGroups : 0;
  const int total = mine * steps;

  // What the batch shares: this block's 64 columns of W_o, all E rows.
  for (int idx = threadIdx.x; idx < E * 8; idx += kPThreads) {
    const int r = idx / 8, c = (idx % 8) * 8;
    cp_async_16(&Ws[r * kBStride + c], wo + (size_t)r * E + n0 + c, true);
  }
  sm90::cp_async_commit();
  // Step n of the group's walk: its row tile n / steps, K slice n % steps, into stage buf.
  auto stage = [&](int n, int buf) {
    const int m0 = first + (group + (n / steps) * kPGroups) * kPM, k0 = (n % steps) * kPK;
#pragma unroll
    for (int l = 0; l < 2; ++l) {  // 64 rows x 4 chunks of 16 bytes
      const int idx = tid + l * 128;
      const int r = idx / 4, c = (idx % 4) * 8;
      const int row = m0 + r;
      const bool ok = row < last;  // rows of the next block's elements: zeros
      cp_async_16(&As[buf * kPM * kAStride + r * kAStride + c],
                  ctx + (size_t)(ok ? row : 0) * E + k0 + c, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kPStages - 1; ++st) {
    if (st < total) stage(st, st);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<kPStages - 1>();  // W_o's tile, from every thread
  __syncthreads();

  for (int t = 0; t < mine; ++t) {
    float acc[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[a][u][0] = acc[a][u][1] = acc[a][u][2] = acc[a][u][3] = 0.f;
    for (int step = 0; step < steps; ++step) {
      const int n = t * steps + step;
      sm90::cp_async_wait<kPStages - 2>();
      sm90::named_barrier(1 + group, 128);  // this step's stage landed; the oldest one is free
      if (n + kPStages - 1 < total) stage(n + kPStages - 1, (n + kPStages - 1) % kPStages);
      sm90::cp_async_commit();
      const __nv_bfloat16* A = As + (n % kPStages) * kPM * kAStride;
      const __nv_bfloat16* Bt = Ws + (size_t)step * kPK * kBStride;
#pragma unroll
      for (int kk = 0; kk < kPK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)  // (rows +0, k +0), (rows +8, k +0), (rows +0, k +8), (rows +8, k +8)
          ldmatrix_x4(af[a], &A[(wm * 32 + a * 16 + mr + 8 * (mi % 2)) * kAStride + kk + 8 * (mi / 2)]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];  // (k +0, n +0), (k +8, n +0), (k +0, n +8), (k +8, n +8)
          ldmatrix_x4_trans(bf, &Bt[(kk + mr + 8 * (mi % 2)) * kBStride + wn * 32 + np * 16 + 8 * (mi / 2)]);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            mma_bf16_16816(acc[a][2 * np], af[a], bf[0], bf[1]);
            mma_bf16_16816(acc[a][2 * np + 1], af[a], bf[2], bf[3]);
          }
        }
      }
    }

    const int m0 = first + (group + t * kPGroups) * kPM;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + a * 16 + g + 8 * half;
        if (row >= last) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = n0 + wn * 32 + u * 8 + 2 * qd;
          float2 val;
          val.x = acc[a][u][2 * half] + bo[n];
          val.y = acc[a][u][2 * half + 1] + bo[n + 1];
          const __nv_bfloat162 res =
              *reinterpret_cast<const __nv_bfloat162*>(hidden + (size_t)row * E + n);
          val.x += __bfloat162float(res.x);
          val.y += __bfloat162float(res.y);
          *reinterpret_cast<float2*>(proj + (size_t)row * E + n) = val;
        }
      }
    }
  }
}

template <int kKeys>
static cudaError_t launch_core(dim3 grid, const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const float* gate, const float* bias,
                               __nv_bfloat16* ctx, int G, int Tp, int seq_len, int E, int H,
                               cudaStream_t stream) {
  const size_t bytes = core_smem_bytes(kKeys, seq_len);
  const cudaError_t err = cudaFuncSetAttribute(
      tiled_core_mma<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  tiled_core_mma<kKeys><<<grid, kCoreWarps * 32, bytes, stream>>>(q, k, v, gate, bias, ctx, G,
                                                                  Tp, seq_len, E, H);
  return cudaGetLastError();
}

// (a) then (b) on `stream`; the caller launches the LayerNorm over all rows.
// Q, K, V, W_o, ctx and hidden are read or written in 16-byte or 4-byte
// pieces: misaligned pointers are refused.
static cudaError_t launch_core_and_proj(
    const __nv_bfloat16* hidden, const __nv_bfloat16* q, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const float* gate, const float* bias, const __nv_bfloat16* wo,
    const float* bo, __nv_bfloat16* ctx, float* proj, int G, int B, int Tp, int seq_len, int E,
    int H, cudaStream_t stream) {
  if (E != kHeadDim * H || seq_len > kMaxKeys || proj_smem_bytes(E) > 227 * 1024)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(hidden) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(wo) | reinterpret_cast<uintptr_t>(ctx) |
       reinterpret_cast<uintptr_t>(proj)) & 15)
    return cudaErrorMisalignedAddress;
  const dim3 grid_a((Tp + kCoreRows - 1) / kCoreRows, H, B / G);
  cudaError_t err =
      seq_len <= 64
          ? launch_core<64>(grid_a, q, k, v, gate, bias, ctx, G, Tp, seq_len, E, H, stream)
          : launch_core<kMaxKeys>(grid_a, q, k, v, gate, bias, ctx, G, Tp, seq_len, E, H, stream);
  if (err != cudaSuccess) return err;
  const size_t bytes = proj_smem_bytes(E);
  err = cudaFuncSetAttribute(tiled_proj_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  tiled_proj_mma<<<dim3(E / kPN, B / G), kPThreads, bytes, stream>>>(ctx, hidden, wo, bo, proj,
                                                                     G * Tp, E);
  return cudaGetLastError();
}

}  // namespace tiled_tc
}  // namespace emo
