// K2 in float32 on the tensor cores: the out-projection products and the
// attention backward of the WavLM attention sublayer in TF32 with split
// products (3xTF32, `hopper.cuh`) on wgmma and mma.sync, at float32
// accuracy.  Included by `wavlm_attn_bwd.cu` only, which calls
// `launch_proj_and_attn` for float32 when dh = 64 and seq_len <= 160 (the
// rule of K1's float32 tensor-core route, `wavlm_attn_tf32.cuh`) between its
// LayerNorm backward and its bias reduction; float32 at other shapes keeps
// the CUDA-core kernels of that file.
//
// Replaces, with `wavlm_attn_bwd.cu`, the TPU kernel
// `multimodalemotionrecognition_tpu/ops/pallas_wavlm_attn.py::
// _sublayer_bwd_kernel`, whose float32 dots are float32 products: every
// operand is split as hi + lo and each product is lo.hi + hi.lo + hi.hi,
// each exact in the float32 accumulator.
//
// What bounds it on an H100: at B = 16 (Tp = 149, E = 768, 12 heads) the
// backward needs 8.4 GFLOP (two 2.8-GFLOP out-projection products and the
// T^2 * dh products of each head) over ~85 MB of float32 operands and
// results: three TF32 passes at 495 TFLOP/s take 0.051 ms, the bytes
// 0.025 ms, so operations bound it.  The CUDA-core kernels took 1.60 ms
// there (H100 80GB HBM3, 700 W), on float32 FMAs from shared memory; this
// route 0.65 ms without dropout and 0.69 with it on that card, most of it
// in (c) and (d) (0.18 and 0.19 ms: one 230 KB block of four warps an SM,
// latency-bound) and (b) (0.11 ms).
//
// The bfloat16 layout (`wavlm_attn_bwd_tc.cuh`), one block per (head,
// element) holding Q, K, V and dctx of 160 rows and the P_d and dS
// squares, needs 384,000 bytes in float32 (the tiles alone as hi and lo
// 348,160) against the 232,448 a block may have.  So the attention backward is the deterministic two-pass
// split of the CUDA-core route, on the tensor cores:
//
// (a) `bwd_transpose_tf32`: ctx and dproj transposed, [E, Mp] float32 with
//     rows of the sequence at or past seq_len (and columns past B*Tp) as
//     zeros: TF32 wgmma has no transposed mode, and dW_o = ctx^T . dproj
//     reduces over the sequence rows, which both operands store as rows.
// (b) `bwd_proj_tf32`: both out-projection products in one launch, the
//     pipeline of K1's `out_proj_tf32` (a producer warp keeping four stages
//     of 64 x 32 TMA boxes in flight, a consumer warpgroup that splits each
//     box in shared memory, hi in place and lo beside, and runs lo.hi,
//     hi.lo, hi.hi on wgmma.m64n64k8, folding each chunk of four 32-deep
//     steps into a float32 total: the tensor cores' accumulator truncates).
//     The first (E/64)^2 blocks compute dW_o = ctx^T . dproj, each 64 x 64
//     tile reducing over all B*Tp rows in its own loop (75 steps at B = 16:
//     no split, no atomics); the rest dctx = dproj . W_o^T, where W_o as
//     stored, [E_in][E_out], is already the K-major B operand.
// (c) `bwd_query_tf32`: one block per (64-query tile, head, element), one
//     warpgroup of four warps of 16 query rows.  S = Q . K^T on
//     wgmma.m64n{kKeys}k8 as K1's core computes it (cp.async into the
//     128-byte-swizzled K-major layout, split in place), the exact softmax
//     in registers (80 floats a lane at 160 keys), K1's dropout keep bits
//     from `emo::hash_keep` at K1's indices.  The row term D = sum_j P *
//     dP_d equals dctx . ctx (ctx = P_d . V is K1's saved context), 64
//     products a row, so dP = dctx . V^T is computed once, 32 keys at a
//     time on wgmma.m64n32k8, and turned into dS = P * (dP_d - D) in the
//     score registers, with dgate (a row sum with the bias) and this
//     element's bias partial gate * dS (float32, summed over the batch in
//     order by `bwd_dbias_reduce`).  dQ = dS . K on mma.sync.m16n8k8 from
//     registers, permuting the reduction index as K1's P . V does (the
//     accumulator's columns 2q, 2q+1 as A's k-columns q, q+4) and reading
//     K's split parts from the swizzled tile (conflict-free).  The row's
//     log-sum-exp and D go to device memory for (d).
// (d) `bwd_key_tf32`: one block per (64-key tile, head, element), 32
//     queries at a time: S^T = K . Q^T and dP^T = V . dctx^T on
//     wgmma.m64n32k8, P^T = exp(S^T + gate * bias - LSE) from the saved
//     log-sum-exp, and the slice's P_d^T and dS^T fed straight into
//     dV += P_d^T . dctx and dK += dS^T . Q on mma.sync.  Holding no score
//     row whole keeps a lane's state to the two 32-float accumulators (the
//     whole 160-query S^T beside them made ptxas spill at 255 registers).
//     Every sum over queries stays inside one block, so no sum crosses
//     blocks and two runs give the same bits.
//
// Shared memory (the larger pass, (d), at 160 keys): K and V of the key
// tile and Q and dctx of every query as hi and lo in 128-byte rows
// (229,376 bytes), the queries' log-sum-exp, D and gate (1,920) and 1 KB to
// align the tiles to the swizzle's 1024-byte atoms: 232,320 of the 232,448
// a block may have, one block an SM.  Mirrored by
// `kernels/wavlm_attn.py::backward_tf32_smem_bytes`.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace emo {
namespace tf32b {

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 160;
constexpr int kRows = 64;       // query rows (c) or key rows (d) of a block: wgmma's M
constexpr int kThreads = 128;   // one warpgroup
constexpr int kRowBytes = 2 * 4 * kHeadDim;  // a row of 64 float32 as TF32 hi and lo
constexpr int kSlice = 32;      // keys (c) or queries (d) of one product on wgmma.m64n32k8

// Dynamic shared memory of one block of (c) and of (d) holding `keys` keys
// (64 or 160): the four operand tiles as hi and lo, then (c) the rows' D,
// (d) the queries' log-sum-exp, D and gate, and 1 KB of alignment.
constexpr int query_smem_bytes(int keys) {
  return kRowBytes * (2 * kRows + 2 * keys) + 4 * kRows + 1024;
}
constexpr int key_smem_bytes(int keys) {
  return kRowBytes * (2 * kRows + 2 * keys) + 3 * 4 * keys + 1024;
}
static_assert(key_smem_bytes(kMaxKeys) <= 232448 && query_smem_bytes(kMaxKeys) <= 232448,
              "an attention block over 227 KB");

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// Rows [r0, r0 + rows) of one head's 64 columns of x (row stride E, from
// `base`) into a K-major tile of 128-byte rows, two 32-float halves `half`
// bytes apart; piece c of row r at piece (c % 8) ^ (r % 8): the 128-byte
// swizzle that wgmma reads.  Rows at or past seq_len are zeros.
__device__ __forceinline__ void load_rows(uint8_t* tile, int half, const float* __restrict__ x,
                                          size_t base, int r0, int rows, int seq_len, int E) {
  for (int idx = threadIdx.x; idx < rows * 16; idx += kThreads) {
    const int r = idx / 16, c = idx % 16;
    const bool ok = r0 + r < seq_len;
    sm90::cp_async_16(tile + (c / 8) * half + r * 128 + (((c % 8) ^ (r % 8)) * 16),
                      x + base + (size_t)(ok ? r0 + r : 0) * E + c * 4, ok);
  }
}

// The tile's float32 values split in place (hi), lo at the same offsets of `lo`.
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo, int bytes) {
  for (int off = threadIdx.x * 16; off < bytes; off += kThreads * 16)
    sm90::split_tf32_16b(hi + off, lo + off);
}

// Element (r, c) of a tile written by `load_rows`.
__device__ __forceinline__ float at(const uint8_t* tile, int half, int r, int c) {
  return *reinterpret_cast<const float*>(tile + (c >> 5) * half + r * 128 +
                                         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

template <int kN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kN / 2], uint64_t a, uint64_t b) {
  if constexpr (kN == 32)
    sm90::wgmma_m64n32k8_tf32(d, a, b, 1);
  else if constexpr (kN == 64)
    sm90::wgmma_m64n64k8_tf32(d, a, b, 1);
  else
    sm90::wgmma_m64n160k8_tf32(d, a, b, 1);
}

// d = A[64 x 64] . B[kN x 64]^T over the head width, both tiles split as
// `load_rows` and `split_tile` leave them: eight 8-deep steps of lo.hi,
// hi.lo, hi.hi, issued and committed as one group (`product` also waits for
// it).  The accumulators come out in mma.sync's fragment layout: d[4t + c]
// holds (g, 8t + 2qd + c % 2) for c < 2 and (g + 8, ...) for c >= 2 of the
// warp's 16 rows.
template <int kN>
__device__ __forceinline__ void issue(float (&d)[kN / 2], const uint8_t* a_hi,
                                      const uint8_t* a_lo, int a_half, const uint8_t* b_hi,
                                      const uint8_t* b_lo, int b_half) {
  using namespace sm90;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) d[i] = 0.f;
  wgmma_fence();
  fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk) {
    const int ao = (kk / 4) * a_half + (kk % 4) * 32, bo = (kk / 4) * b_half + (kk % 4) * 32;
    const uint64_t ah = wgmma_desc(a_hi + ao, 16, 1024), al = wgmma_desc(a_lo + ao, 16, 1024);
    const uint64_t bh = wgmma_desc(b_hi + bo, 16, 1024), bl = wgmma_desc(b_lo + bo, 16, 1024);
    wgmma_tf32<kN>(d, al, bh);
    wgmma_tf32<kN>(d, ah, bl);
    wgmma_tf32<kN>(d, ah, bh);
  }
  wgmma_commit();
}

template <int kN>
__device__ __forceinline__ void product(float (&d)[kN / 2], const uint8_t* a_hi,
                                        const uint8_t* a_lo, int a_half, const uint8_t* b_hi,
                                        const uint8_t* b_lo, int b_half) {
  issue<kN>(d, a_hi, a_lo, a_half, b_hi, b_lo, b_half);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
}

// o[16 x 64] += a . X[k0 .. k0 + 8) on mma.sync: `a` is an accumulator tile
// of the warp (a[c] at (g, k0 + 2qd + c % 2), (g + 8, ...) for c >= 2),
// taken as A's k-columns qd and qd + 4, with X's rows k0 + 2qd and + 1 to
// match; X is a split tile of `load_rows` (rows of 64 columns).
__device__ __forceinline__ void mma_step(float (&o)[kHeadDim / 8][4], const float (&a)[4],
                                         const uint8_t* x_hi, const uint8_t* x_lo, int half,
                                         int k0, int g, int qd) {
  float ah[4], al[4];
  sm90::split_tf32(a[0], ah[0], al[0]);  // (g, 2qd)      -> (g, k qd)
  sm90::split_tf32(a[2], ah[1], al[1]);  // (g+8, 2qd)    -> (g+8, k qd)
  sm90::split_tf32(a[1], ah[2], al[2]);  // (g, 2qd+1)    -> (g, k qd+4)
  sm90::split_tf32(a[3], ah[3], al[3]);  // (g+8, 2qd+1)  -> (g+8, k qd+4)
  const int r = k0 + 2 * qd;
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int c = dt * 8 + g;
    sm90::mma_3xtf32_1688(o[dt], ah, al, at(x_hi, half, r, c), at(x_hi, half, r + 1, c),
                          at(x_lo, half, r, c), at(x_lo, half, r + 1, c));
  }
}

// The warp's 16 rows of a [.., E] result at columns h * 64 ..: rows r0 and
// r0 + 8 where `ok0` / `ok1`.
__device__ __forceinline__ void store_rows(float* out, const float (&o)[kHeadDim / 8][4],
                                           size_t base, int r0, bool ok0, bool ok1, int E,
                                           int qd) {
  float* row0 = out + base + (size_t)r0 * E;
  float* row1 = row0 + (size_t)8 * E;
#pragma unroll
  for (int t = 0; t < kHeadDim / 8; ++t) {
    const int d = t * 8 + 2 * qd;
    if (ok0) *reinterpret_cast<float2*>(row0 + d) = make_float2(o[t][0], o[t][1]);
    if (ok1) *reinterpret_cast<float2*>(row1 + d) = make_float2(o[t][2], o[t][3]);
  }
}

// ---- (c) the query-side pass ----------------------------------------------

template <int kKeys>
__global__ void __launch_bounds__(kThreads)
bwd_query_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dctx,
               const float* __restrict__ ctx, const float* __restrict__ gate,
               const float* __restrict__ bias, float* __restrict__ dq,
               float* __restrict__ dgate, float* __restrict__ dbias_part,
               float* __restrict__ lse, float* __restrict__ delta, int Tp, int seq_len, int E,
               int H, unsigned seed, unsigned attn_thr, float attn_inv) {
  static_assert(kKeys == 64 || kKeys == kMaxKeys, "the score tile's N: 64 or 160 keys");
  constexpr int kTiles = kKeys / 8;
  constexpr int kQHalf = kRows * 128, kKHalf = kKeys * 128;
  extern __shared__ uint8_t query_smem_raw[];
  uint8_t* Qh = align_1024(query_smem_raw);
  uint8_t* Ql = Qh + 2 * kQHalf;
  uint8_t* Gh = Ql + 2 * kQHalf;  // dctx of the tile's queries
  uint8_t* Gl = Gh + 2 * kQHalf;
  uint8_t* Kh = Gl + 2 * kQHalf;
  uint8_t* Kl = Kh + 2 * kKHalf;
  uint8_t* Vh = Kl + 2 * kKHalf;
  uint8_t* Vl = Vh + 2 * kKHalf;
  float* Dq = reinterpret_cast<float*>(Vl + 2 * kKHalf);  // [kRows] the rows' D

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t base = (size_t)b * Tp * E + (size_t)h * kHeadDim;
  const size_t bh = ((size_t)b * H + h) * Tp;

  load_rows(Qh, kQHalf, q, base, i0, kRows, seq_len, E);
  load_rows(Kh, kKHalf, k, base, 0, kKeys, seq_len, E);
  sm90::cp_async_commit();
  load_rows(Gh, kQHalf, dctx, base, i0, kRows, seq_len, E);
  load_rows(Vh, kKHalf, v, base, 0, kKeys, seq_len, E);
  sm90::cp_async_commit();

  // D = dctx . ctx per query row, two threads a row, in float32.
  {
    const int r = threadIdx.x / 2, c0 = (threadIdx.x % 2) * 32;
    float acc = 0.f;
    if (i0 + r < seq_len) {
      const float4* x = reinterpret_cast<const float4*>(dctx + base + (size_t)(i0 + r) * E + c0);
      const float4* y = reinterpret_cast<const float4*>(ctx + base + (size_t)(i0 + r) * E + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = x[i], c = y[i];
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
        acc = fmaf(a.z, c.z, acc);
        acc = fmaf(a.w, c.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (threadIdx.x % 2 == 0) Dq[r] = acc;
  }

  sm90::cp_async_wait<1>();
  __syncthreads();
  split_tile(Qh, Ql, 2 * kQHalf);
  split_tile(Kh, Kl, 2 * kKHalf);
  sm90::fence_proxy_async();
  __syncthreads();
  float s[kTiles][4];
  float(&sf)[kTiles * 4] = *reinterpret_cast<float(*)[kTiles * 4]>(&s[0][0]);
  product<kKeys>(sf, Qh, Ql, kQHalf, Kh, Kl, kKHalf);  // S = Q . K^T
  sm90::cp_async_wait<0>();
  __syncthreads();
  split_tile(Gh, Gl, 2 * kQHalf);
  split_tile(Vh, Vl, 2 * kKHalf);
  sm90::fence_proxy_async();
  __syncthreads();

  const int r0 = i0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < seq_len, ok1 = r1 < seq_len;

  // + gate * bias, keys >= seq_len excluded, then the exact softmax per row.
  const float g0 = ok0 ? gate[bh + r0] : 0.f;
  const float g1 = ok1 ? gate[bh + r1] : 0.f;
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

  // P stays in s.
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[t][c] /= c < 2 ? l0 : l1;
  }

  // dS = P * (dP_d - D), dP = dctx . V^T 32 keys at a time under K1's
  // attention dropout (the keep bits from the hash at K1's indices); dgate
  // and the bias partial from dS in float32.
  const unsigned stream = attn_stream(seed, b, h);
  const float d0 = Dq[warp * 16 + g], d1 = Dq[warp * 16 + g + 8];
  float* part0 = dbias_part + (bh + (ok0 ? r0 : 0)) * Tp;
  float* part1 = dbias_part + (bh + (ok1 ? r1 : 0)) * Tp;
  float dg0 = 0.f, dg1 = 0.f;
#pragma unroll
  for (int sl = 0; sl < kKeys / kSlice; ++sl) {
    float dp[kSlice / 2];
    product<kSlice>(dp, Gh, Gl, kQHalf, Vh + sl * kSlice * 128, Vl + sl * kSlice * 128, kKHalf);
#pragma unroll
    for (int u = 0; u < kSlice / 8; ++u) {
      const int t = sl * (kSlice / 8) + u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = dp[4 * u + c];
        if (attn_thr) {
          const unsigned r = (unsigned)(c < 2 ? r0 : r1), j = (unsigned)(t * 8 + 2 * qd + c % 2);
          x = hash_keep(stream, r * (unsigned)Tp + j, attn_thr) ? x * attn_inv : 0.f;
        }
        s[t][c] *= x - (c < 2 ? d0 : d1);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = t * 8 + 2 * qd + e;
        if (j < seq_len) {
          if (ok0) {
            dg0 += s[t][e] * b0[j];
            part0[j] = g0 * s[t][e];
          }
          if (ok1) {
            dg1 += s[t][2 + e] * b1[j];
            part1[j] = g1 * s[t][2 + e];
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dg0 += __shfl_xor_sync(0xffffffffu, dg0, o);
    dg1 += __shfl_xor_sync(0xffffffffu, dg1, o);
  }
  if (qd == 0) {
    if (ok0) {
      dgate[bh + r0] = dg0;
      lse[bh + r0] = m0 + logf(l0);
      delta[bh + r0] = d0;
    }
    if (ok1) {
      dgate[bh + r1] = dg1;
      lse[bh + r1] = m1 + logf(l1);
      delta[bh + r1] = d1;
    }
  }
  if (i0 + warp * 16 >= seq_len) return;  // no row of this warp is valid

  // dQ = dS . K.
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int t = 0; t < kHeadDim / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kTiles; ++kc) mma_step(o, s[kc], Kh, Kl, kKHalf, kc * 8, g, qd);
  store_rows(dq, o, base, r0, ok0, ok1, E, qd);
}

// ---- (d) the key-side pass ------------------------------------------------

template <int kKeys>
__global__ void __launch_bounds__(kThreads)
bwd_key_tf32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dctx,
             const float* __restrict__ gate, const float* __restrict__ bias,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int Tp, int seq_len, int E, int H,
             unsigned seed, unsigned attn_thr, float attn_inv) {
  static_assert(kKeys == 64 || kKeys == kMaxKeys, "queries held: 64 or 160");
  constexpr int kKHalf = kRows * 128, kQHalf = kKeys * 128;
  extern __shared__ uint8_t key_smem_raw[];
  uint8_t* Kh = align_1024(key_smem_raw);  // the tile's keys
  uint8_t* Kl = Kh + 2 * kKHalf;
  uint8_t* Vh = Kl + 2 * kKHalf;
  uint8_t* Vl = Vh + 2 * kKHalf;
  uint8_t* Qh = Vl + 2 * kKHalf;  // every query
  uint8_t* Ql = Qh + 2 * kQHalf;
  uint8_t* Gh = Ql + 2 * kQHalf;  // dctx of every query
  uint8_t* Gl = Gh + 2 * kQHalf;
  float* Ls = reinterpret_cast<float*>(Gl + 2 * kQHalf);  // [kKeys] log-sum-exp
  float* Dl = Ls + kKeys;                                 // [kKeys] D
  float* Gt = Dl + kKeys;                                 // [kKeys] gate

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t base = (size_t)b * Tp * E + (size_t)h * kHeadDim;
  const size_t bh = ((size_t)b * H + h) * Tp;

  load_rows(Kh, kKHalf, k, base, j0, kRows, seq_len, E);
  load_rows(Vh, kKHalf, v, base, j0, kRows, seq_len, E);
  load_rows(Qh, kQHalf, q, base, 0, kKeys, seq_len, E);
  load_rows(Gh, kQHalf, dctx, base, 0, kKeys, seq_len, E);
  sm90::cp_async_commit();
  for (int i = threadIdx.x; i < kKeys; i += kThreads) {
    const bool ok = i < seq_len;
    Ls[i] = ok ? lse[bh + i] : 0.f;
    Dl[i] = ok ? delta[bh + i] : 0.f;
    Gt[i] = ok ? gate[bh + i] : 0.f;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();
  split_tile(Kh, Kl, 2 * kKHalf);
  split_tile(Vh, Vl, 2 * kKHalf);
  split_tile(Qh, Ql, 2 * kQHalf);
  split_tile(Gh, Gl, 2 * kQHalf);
  sm90::fence_proxy_async();
  __syncthreads();

  // kSlice queries at a time: S^T and dP^T = V . dctx^T on wgmma, P^T
  // from the saved log-sum-exp (zero at queries or keys past seq_len), the
  // dropout keep bits of K1's indices, then dV += P_d^T . dctx and dK +=
  // dS^T . Q on mma.sync, dS^T = P^T * (dP_d^T - D).  No score row is held
  // whole: the softmax's row terms are the saved ones.
  const int r0 = j0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two keys
  const bool ok0 = r0 < seq_len, ok1 = r1 < seq_len;
  const unsigned stream = attn_stream(seed, b, h);
  const float* bias_h = bias + (size_t)h * Tp * Tp;
  float dv_acc[kHeadDim / 8][4], dk_acc[kHeadDim / 8][4];
#pragma unroll
  for (int t = 0; t < kHeadDim / 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) dv_acc[t][c] = dk_acc[t][c] = 0.f;
#pragma unroll
  for (int sl = 0; sl < kKeys / kSlice; ++sl) {
    float st[kSlice / 2], dp[kSlice / 2];
    const int qo = sl * kSlice * 128;
    issue<kSlice>(st, Kh, Kl, kKHalf, Qh + qo, Ql + qo, kQHalf);
    issue<kSlice>(dp, Vh, Vl, kKHalf, Gh + qo, Gl + qo, kQHalf);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dp);
#pragma unroll
    for (int u = 0; u < kSlice / 8; ++u) {
      const int t = sl * (kSlice / 8) + u;
      float pd[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = t * 8 + 2 * qd + (c % 2), j = c < 2 ? r0 : r1;
        const bool valid = (c < 2 ? ok0 : ok1) && i < seq_len;
        const float p =
            valid ? expf(st[4 * u + c] + Gt[i] * bias_h[(size_t)i * Tp + j] - Ls[i]) : 0.f;
        float x = dp[4 * u + c];
        pd[c] = p;
        if (attn_thr) {
          const bool keep =
              valid && hash_keep(stream, (unsigned)i * (unsigned)Tp + (unsigned)j, attn_thr);
          pd[c] = keep ? p * attn_inv : 0.f;
          x = keep ? x * attn_inv : 0.f;
        }
        ds[c] = p * (x - Dl[i]);
      }
      mma_step(dv_acc, pd, Gh, Gl, kQHalf, t * 8, g, qd);
      mma_step(dk_acc, ds, Qh, Ql, kQHalf, t * 8, g, qd);
    }
  }
  store_rows(dv, dv_acc, base, r0, ok0, ok1, E, qd);
  store_rows(dk, dk_acc, base, r0, ok0, ok1, E, qd);
}

// ---- (a) the transposes, (b) the out-projection products --------------------

constexpr int kTT = 32;  // (a): a 32 x 32 tile a block of 32 x 8 threads

static __global__ void __launch_bounds__(kTT * 8)
bwd_transpose_tf32(const float* __restrict__ ctx, const float* __restrict__ dproj,
                   float* __restrict__ ctx_t, float* __restrict__ dproj_t, int M, int Mp, int Tp,
                   int seq_len, int E) {
  __shared__ float tile[kTT][kTT + 1];
  const float* src = blockIdx.z ? dproj : ctx;
  float* dst = blockIdx.z ? dproj_t : ctx_t;
  const int m0 = blockIdx.y * kTT, c0 = blockIdx.x * kTT;
  for (int r = threadIdx.y; r < kTT; r += 8) {
    const int m = m0 + r, c = c0 + threadIdx.x;
    const bool ok = m < M && (m % Tp) < seq_len && c < E;
    tile[r][threadIdx.x] = ok ? src[(size_t)m * E + c] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kTT; r += 8) {
    const int c = c0 + r, m = m0 + threadIdx.x;
    if (c < E && m < Mp) dst[(size_t)c * Mp + m] = tile[threadIdx.x][r];
  }
}

constexpr int kPM = 64, kPN = 64, kPK = 32, kPStages = 4, kPromote = 4;
constexpr int kPThreads = 128 + 32;
constexpr int kPTileBytes = kPM * kPK * 4;  // 64 rows x 128 bytes: 8 KB
constexpr int kPStageBytes = 2 * kPTileBytes;
constexpr int kProjSmemBytes = kPStages * kPStageBytes + 2 * kPStageBytes + 2 * kPStages * 8 + 1024;

// Blocks [0, (E/64)^2): dW_o[i][n] = sum_rows ctx^T[i][row] dproj^T[n][row];
// the rest: dctx[row][i] = sum_n dproj[row][n] W_o[i][n].  Both C = A . B^T
// with A and B K-major, 64 x 32 boxes by TMA.
static __global__ void __launch_bounds__(kPThreads)
bwd_proj_tf32(__grid_constant__ const CUtensorMap map_ctx_t,
              __grid_constant__ const CUtensorMap map_dproj_t,
              __grid_constant__ const CUtensorMap map_dproj,
              __grid_constant__ const CUtensorMap map_wo, float* __restrict__ dwo,
              float* __restrict__ dctx, int M, int Tp, int seq_len, int E) {
  using namespace sm90;
  extern __shared__ uint8_t proj_smem_raw[];
  uint8_t* smem = align_1024(proj_smem_raw);
  uint8_t* lo_base = smem + kPStages * kPStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + 2 * kPStageBytes);
  uint64_t* empty = full + kPStages;
  const int tiles_n = E / kPN;
  int tile = blockIdx.x;
  const bool wgrad = tile < tiles_n * tiles_n;
  if (!wgrad) tile -= tiles_n * tiles_n;
  const int m0 = (tile / tiles_n) * kPM, n0 = (tile % tiles_n) * kPN;
  const CUtensorMap* map_a = wgrad ? &map_ctx_t : &map_dproj;
  const CUtensorMap* map_b = wgrad ? &map_dproj_t : &map_wo;
  const int steps = wgrad ? (M + kPK - 1) / kPK : E / kPK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

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
        tma_load_2d(st, map_a, &full[s], i * kPK, m0);
        tma_load_2d(st + kPTileBytes, map_b, &full[s], i * kPK, n0);
      }
    }
    return;
  }

  float acc[32], total[32];  // a chunk's wgmma sum, the rounded total
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
  float* out = wgrad ? dwo : dctx;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + warp * 16 + g + 8 * half;
    if (wgrad ? row >= E : row >= M || (row % Tp) >= seq_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * qd;
      *reinterpret_cast<float2*>(out + (size_t)row * E + n) =
          make_float2(total[4 * j + 2 * half], total[4 * j + 2 * half + 1]);
    }
  }
}

// Rows of the transposed operands of (a): B*Tp rounded up to 4, so that a
// row is a whole number of 16-byte pieces, as TMA needs.
inline int transposed_rows(int M) { return (M + 3) / 4 * 4; }

template <int kKeys>
static cudaError_t launch_attn(dim3 grid, const float* q, const float* k, const float* v,
                               const float* dctx, const float* ctx, const float* gate,
                               const float* bias, float* dq, float* dk, float* dv, float* dgate,
                               float* dbias_part, float* lse, float* delta, int Tp, int seq_len,
                               int E, int H, unsigned seed, unsigned attn_thr, float attn_inv,
                               cudaStream_t stream) {
  constexpr int smem_q = query_smem_bytes(kKeys), smem_k = key_smem_bytes(kKeys);
  cudaError_t err = cudaFuncSetAttribute(bwd_query_tf32<kKeys>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_key_tf32<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_k);
  if (err != cudaSuccess) return err;
  bwd_query_tf32<kKeys><<<grid, kThreads, smem_q, stream>>>(
      q, k, v, dctx, ctx, gate, bias, dq, dgate, dbias_part, lse, delta, Tp, seq_len, E, H, seed,
      attn_thr, attn_inv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_key_tf32<kKeys><<<grid, kThreads, smem_k, stream>>>(
      q, k, v, dctx, gate, bias, lse, delta, dk, dv, Tp, seq_len, E, H, seed, attn_thr, attn_inv);
  return cudaGetLastError();
}

// (a) to (d) on `stream`, after the LayerNorm backward has written dproj;
// the caller then sums the bias partials.  `tscratch` holds the two
// transposed operands, 2 x E x transposed_rows(B*Tp) float32.  The caller
// has checked that every operand is 16-byte aligned.
static cudaError_t launch_proj_and_attn(
    const float* q, const float* k, const float* v, const float* gate, const float* bias,
    const float* wo, const float* ctx, const float* dproj, float* dctx, float* dq, float* dk,
    float* dv, float* dgate, float* dwo, float* dbias_part, float* lse, float* delta,
    float* tscratch, int B, int Tp, int seq_len, int E, int H, unsigned seed, unsigned attn_thr,
    float attn_inv, cudaStream_t stream) {
  if (E % kPN != 0 || E / H != kHeadDim || seq_len > kMaxKeys || tscratch == nullptr)
    return cudaErrorInvalidValue;
  const int M = B * Tp, Mp = transposed_rows(M), tiles_n = E / kPN;
  float* ctx_t = tscratch;
  float* dproj_t = tscratch + (size_t)E * Mp;
  bwd_transpose_tf32<<<dim3((E + kTT - 1) / kTT, (Mp + kTT - 1) / kTT, 2), dim3(kTT, 8), 0,
                       stream>>>(ctx, dproj, ctx_t, dproj_t, M, Mp, Tp, seq_len, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap maps[4];
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  err = sm90::make_tma_map_2d(&maps[0], f32, 4, ctx_t, Mp, E, kPK, kPM);
  if (err == cudaSuccess) err = sm90::make_tma_map_2d(&maps[1], f32, 4, dproj_t, Mp, E, kPK, kPN);
  if (err == cudaSuccess) err = sm90::make_tma_map_2d(&maps[2], f32, 4, dproj, E, M, kPK, kPM);
  if (err == cudaSuccess) err = sm90::make_tma_map_2d(&maps[3], f32, 4, wo, E, E, kPK, kPN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_proj_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kProjSmemBytes);
  if (err != cudaSuccess) return err;
  // The long dW_o tiles first; the short dctx tiles fill around them.
  bwd_proj_tf32<<<tiles_n * tiles_n + tiles_n * ((M + kPM - 1) / kPM), kPThreads, kProjSmemBytes,
                  stream>>>(maps[0], maps[1], maps[2], maps[3], dwo, dctx, M, Tp, seq_len, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid((seq_len + kRows - 1) / kRows, H, B);
  return seq_len <= 64
             ? launch_attn<64>(grid, q, k, v, dctx, ctx, gate, bias, dq, dk, dv, dgate,
                               dbias_part, lse, delta, Tp, seq_len, E, H, seed, attn_thr,
                               attn_inv, stream)
             : launch_attn<kMaxKeys>(grid, q, k, v, dctx, ctx, gate, bias, dq, dk, dv, dgate,
                                     dbias_part, lse, delta, Tp, seq_len, E, H, seed, attn_thr,
                                     attn_inv, stream);
}

}  // namespace tf32b
}  // namespace emo
