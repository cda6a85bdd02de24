// K1 in bfloat16 on the tensor cores: the attention core and the
// out-projection of the WavLM attention sublayer, with mma.sync.m16n8k16
// (bf16 operands, float32 accumulators).  Included by `wavlm_attn.cu` only,
// which calls `launch_core_and_proj` for bfloat16 when dh = 64 and seq_len
// <= 160 and then runs its LayerNorm; the float32 path and K6 keep the
// CUDA-core device code of `wavlm_sublayer.cuh`.
//
// Replaces, with `wavlm_attn.cu`, the TPU kernel `multimodalemotionrecognition_tpu/
// ops/pallas_wavlm_attn.py::_sublayer_kernel`, whose dots take bf16 operands
// with float32 accumulation: what an mma.sync of bf16 into float32 computes.
//
// What bounds it on an H100: at B = 8 (Tp = 149, E = 768, 12 heads) the
// sublayer is 0.27 GFLOP of scores and contexts and a 1192 x 768 x 768
// out-projection (1.4 GFLOP) over ~11 MB: 0.0034 ms of bytes at 3.35 TB/s.
// The CUDA-core kernels take 0.25 ms there (H100 80GB HBM3, 700 W), bound by
// float32 FMA issue and shared-memory traffic (each warp re-reads K_h and V_h
// per query row).  Here each product is a tensor-core product from registers
// and ldmatrix (0.045 ms on that card), so what is left is latency: three
// dependent launches of a few microseconds each.
//
// (a) `attn_core_mma`: one block per (64-query tile, head, element), four
//     warps of 16 query rows.  K_h and V_h of the element sit in shared
//     memory as bf16, zero-padded to kKeys (a multiple of 16), rows 144
//     bytes apart so ldmatrix reads them without bank conflicts.  A warp
//     holds its Q rows as mma fragments and its 16 x kKeys score rows in
//     registers (80 floats a thread at kKeys = 160), so the softmax is
//     exact over the whole row, in the TPU kernel's order: s = q.k, s +=
//     gate * bias (float32 bias), keys >= seq_len excluded, max and sum
//     over the row with quad shuffles, p = exp(s - m) / l, the dropout
//     from the stateless hash, p rounded to bf16.  The score fragments
//     are re-packed in registers as the A operand of P.V.  ctx is written
//     in bf16 to the [B, Tp, E] scratch K2 reads.
// (b) `out_proj_mma`: ctx . W_o in 64 x 64 tiles (228 blocks at B = 8), four
//     warps of 32 x 32, K in steps of 32 through a three-stage cp.async
//     ring; W_o is [E_in, E_out] with N contiguous and is read with
//     ldmatrix.trans.  Epilogue as the CUDA-core kernel's: + b_o, the hidden
//     dropout at index (row % Tp) * E + n of hidden_stream(seed, row / Tp),
//     + hidden, float32 pre-LayerNorm rows (K2 reads them).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace emo {
namespace tc {

using sm90::cp_async_16;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16_16816;
using sm90::pack_bf16;

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 160;     // 80 score registers a thread
constexpr int kRowStride = 72;    // bf16 per shared row: 144 bytes
constexpr int kCoreWarps = 4;     // 16 query rows each
constexpr int kCoreRows = 16 * kCoreWarps;

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int kKeys>
__global__ void __launch_bounds__(kCoreWarps * 32)
attn_core_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ gate,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ ctx, int Tp,
              int seq_len, int E, int H, unsigned seed, const int* __restrict__ seed_dev,
              unsigned attn_thr, float attn_inv) {
  seed = k1_seed(seed, seed_dev);  // issued first: its latency hides under the loads
  static_assert(kKeys % 16 == 0 && kKeys <= kMaxKeys, "keys held: a multiple of 16, <= 160");
  constexpr int kTiles = kKeys / 8;  // n8 score tiles
  __shared__ __align__(16) __nv_bfloat16 Ks[kKeys * kRowStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kKeys * kRowStride];

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kCoreRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t base = (size_t)b * Tp * E + (size_t)h * kHeadDim;

  for (int idx = threadIdx.x; idx < kKeys * 8; idx += kCoreWarps * 32) {
    const int j = idx / 8, c = (idx % 8) * 8;
    const bool ok = j < seq_len;
    const size_t off = base + (size_t)(ok ? j : 0) * E + c;
    cp_async_16(&Ks[j * kRowStride + c], k + off, ok);
    cp_async_16(&Vs[j * kRowStride + c], v + off, ok);
  }
  sm90::cp_async_commit();

  // This lane's rows of the warp's 16; Q as A fragments, while K and V fly.
  const int r0 = i0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < seq_len, ok1 = r1 < seq_len;
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int kc = 0; kc < kHeadDim / 16; ++kc) {
    const int d = kc * 16 + 2 * qd;
    qa[kc][0] = ok0 ? ld_pair(q + base + (size_t)r0 * E + d) : 0u;
    qa[kc][1] = ok1 ? ld_pair(q + base + (size_t)r1 * E + d) : 0u;
    qa[kc][2] = ok0 ? ld_pair(q + base + (size_t)r0 * E + d + 8) : 0u;
    qa[kc][3] = ok1 ? ld_pair(q + base + (size_t)r1 * E + d + 8) : 0u;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();
  if (i0 + warp * 16 >= seq_len) return;  // no row of this warp is valid

  // ldmatrix x4: lane l gives the address of row l % 8 of matrix l / 8.
  const int mi = lane / 8, mr = lane % 8;

  // S = Q . K^T, 16 x kKeys a warp.
  float s[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kHeadDim / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < kTiles / 2; ++np) {
      uint32_t kb[4];  // (keys +0, d +0), (keys +0, d +8), (keys +8, d +0), (keys +8, d +8)
      ldmatrix_x4(kb, &Ks[(np * 16 + mr + 8 * (mi / 2)) * kRowStride + kc * 16 + 8 * (mi % 2)]);
      mma_bf16_16816(s[2 * np], qa[kc], kb[0], kb[1]);
      mma_bf16_16816(s[2 * np + 1], qa[kc], kb[2], kb[3]);
    }
  }

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

  // ctx = P . V: the score tiles 2c and 2c + 1, rounded to bf16, are the A
  // fragment of the 16 keys of chunk c.
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

// The out-projection's tile: 64 x 64 outputs a block of four warps (32 x 32
// each), K in steps of 32 through a ring of three stages.
constexpr int kPM = 64, kPN = 64, kPK = 32, kPStages = 3, kPThreads = 128;
constexpr int kAStride = kPK + 8;   // 80-byte rows: conflict-free ldmatrix
constexpr int kBStride = kPN + 8;   // 144-byte rows

static __global__ void __launch_bounds__(kPThreads)
out_proj_mma(const __nv_bfloat16* __restrict__ ctx, const __nv_bfloat16* __restrict__ hidden,
             const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
             float* __restrict__ proj, int M, int Tp, int seq_len, int E, unsigned seed,
             const int* __restrict__ seed_dev, unsigned hid_thr, float hid_inv) {
  seed = k1_seed(seed, seed_dev);  // issued first: its latency hides under the loads
  __shared__ __align__(16) __nv_bfloat16 As[kPStages][kPM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[kPStages][kPK * kBStride];
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, qd = lane % 4, mi = lane / 8, mr = lane % 8;
  const int steps = E / kPK;

  auto stage = [&](int step, int buf) {
    const int k0 = step * kPK;
#pragma unroll
    for (int l = 0; l < 2; ++l) {  // A: 64 rows x 4 chunks of 16 bytes
      const int idx = tid + l * kPThreads;
      const int r = idx / 4, c = (idx % 4) * 8;
      const int row = m0 + r;
      const bool ok = row < M && (row % Tp) < seq_len;  // other rows: zeros
      cp_async_16(&As[buf][r * kAStride + c], ctx + (size_t)(ok ? row : 0) * E + k0 + c, ok);
    }
#pragma unroll
    for (int l = 0; l < 2; ++l) {  // B: 32 rows x 8 chunks
      const int idx = tid + l * kPThreads;
      const int r = idx / 8, c = (idx % 8) * 8;
      cp_async_16(&Bs[buf][r * kBStride + c], wo + (size_t)(k0 + r) * E + n0 + c, true);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[a][t][0] = acc[a][t][1] = acc[a][t][2] = acc[a][t][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kPStages - 1; ++st) {
    if (st < steps) stage(st, st);
    sm90::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    sm90::cp_async_wait<kPStages - 2>();
    __syncthreads();  // this step's stage has landed; the oldest one is free
    if (step + kPStages - 1 < steps) stage(step + kPStages - 1, (step + kPStages - 1) % kPStages);
    sm90::cp_async_commit();
    const __nv_bfloat16* A = As[step % kPStages];
    const __nv_bfloat16* Bt = Bs[step % kPStages];
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

#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + a * 16 + g + 8 * half;
      if (row >= M || (row % Tp) >= seq_len) continue;
      const unsigned stream = hidden_stream(seed, row / Tp);
      const unsigned index0 = (unsigned)(row % Tp) * (unsigned)E;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = n0 + wn * 32 + t * 8 + 2 * qd;
        float2 val;
        val.x = acc[a][t][2 * half] + bo[n];
        val.y = acc[a][t][2 * half + 1] + bo[n + 1];
        if (hid_thr) {
          val.x = hash_keep(stream, index0 + n, hid_thr) ? val.x * hid_inv : 0.f;
          val.y = hash_keep(stream, index0 + n + 1, hid_thr) ? val.y * hid_inv : 0.f;
        }
        const __nv_bfloat162 res =
            *reinterpret_cast<const __nv_bfloat162*>(hidden + (size_t)row * E + n);
        val.x += __bfloat162float(res.x);
        val.y += __bfloat162float(res.y);
        *reinterpret_cast<float2*>(proj + (size_t)row * E + n) = val;
      }
    }
  }
}

// (a) then (b) on `stream`; the caller launches the LayerNorm.  Every
// operand is read or written in 16-byte pieces: misaligned pointers are refused.
static cudaError_t launch_core_and_proj(
    const __nv_bfloat16* hidden, const __nv_bfloat16* q, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const float* gate, const float* bias, const __nv_bfloat16* wo,
    const float* bo, __nv_bfloat16* ctx, float* proj, int B, int Tp, int seq_len, int E, int H,
    unsigned seed, const int* seed_dev, unsigned attn_thr, float attn_inv, unsigned hid_thr,
    float hid_inv, cudaStream_t stream) {
  if (E % kPN != 0 || seq_len > kMaxKeys) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(hidden) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(wo) | reinterpret_cast<uintptr_t>(ctx) |
       reinterpret_cast<uintptr_t>(proj)) & 15)
    return cudaErrorMisalignedAddress;
  const dim3 grid_a((seq_len + kCoreRows - 1) / kCoreRows, H, B);
  if (seq_len <= 64)
    attn_core_mma<64><<<grid_a, kCoreWarps * 32, 0, stream>>>(
        q, k, v, gate, bias, ctx, Tp, seq_len, E, H, seed, seed_dev, attn_thr, attn_inv);
  else
    attn_core_mma<kMaxKeys><<<grid_a, kCoreWarps * 32, 0, stream>>>(
        q, k, v, gate, bias, ctx, Tp, seq_len, E, H, seed, seed_dev, attn_thr, attn_inv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int M = B * Tp;
  out_proj_mma<<<dim3(E / kPN, (M + kPM - 1) / kPM), kPThreads, 0, stream>>>(
      ctx, hidden, wo, bo, proj, M, Tp, seq_len, E, seed, seed_dev, hid_thr, hid_inv);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace emo
