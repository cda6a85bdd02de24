// K2 in bfloat16 on the tensor cores: the out-projection products and the
// attention backward of the WavLM attention sublayer, with mma.sync.m16n8k16
// (bf16 operands, float32 accumulators).  Included by `wavlm_attn_bwd.cu`
// only, which calls `launch_proj_and_attn` for bfloat16 when dh = 64 and
// seq_len <= 160 (the rule of K1's tensor-core route) between its LayerNorm
// backward and its bias reduction; float32, and bfloat16 at other shapes,
// keep the CUDA-core kernels of that file.
//
// Replaces, with `wavlm_attn_bwd.cu`, the TPU kernel
// `multimodalemotionrecognition_tpu/ops/pallas_wavlm_attn.py::
// _sublayer_bwd_kernel`.  Its dots take dproj, dctx, probs_d and dscores
// rounded to the compute dtype, with float32 accumulation: what an mma.sync
// of bf16 into float32 computes.  dgate and the bias gradient come from the
// float32 dscores, as there.
//
// What bounds it on an H100: at B = 16 (Tp = 149, E = 768, 12 heads) the
// backward needs 8.4 GFLOP (two 2.8-GFLOP out-projection products and five
// T^2 * dh products a head) over ~46 MB of bf16 and float32 operands and
// results: 0.0085 ms of operations at 989 TFLOP/s against 0.0138 ms of
// bytes at 3.35 TB/s, so bytes bound it.  The CUDA-core kernels take
// 1.64 ms there (H100 80GB HBM3, 700 W), on float32 FMAs from shared
// memory, with the scores and dprobs computed twice (once per query-side and
// once per key-side pass); this route 0.22 ms on that card, most of it in
// (b), 192 blocks of one per SM (1.45 waves on 132 SMs), and (a).
//
// (a) `bwd_proj_mma`: one launch for both products, in 64 x 64 tiles of
//     four warps (32 x 32 each), K in steps of 32 through a three-stage
//     cp.async ring, operands read by ldmatrix (.trans where stored
//     transposed).  The first E/64 x E/64 blocks compute dW_o = ctx^T .
//     dproj in float32, each reducing over all B*Tp rows inside its own loop
//     (no split, no atomics); the rest dctx = dproj . W_o^T in bf16.  The
//     long dW_o tiles are scheduled first and the short dctx tiles fill
//     around them.  Sequence rows at or past seq_len are read as zeros.
// (b) `bwd_attn_mma`: one block per (head, element), kKeys / 16 warps of 16
//     query rows.  Q_h, K_h, V_h and dctx_h sit in shared memory as bf16,
//     zero-padded to kKeys rows (144-byte rows: conflict-free ldmatrix).
//     Each warp computes its 16 x kKeys score rows once, in registers
//     (S = Q.K^T + gate * bias, keys >= seq_len excluded), the exact softmax
//     in the TPU kernel's order and K1's dropout keep bits from
//     `emo::hash_keep` at K1's indices (held as bits in registers).  P_d is
//     stored to shared memory in bf16.  dP = dctx . V^T is computed 16 keys
//     at a time, twice: once for the row term D = sum_j P * dP_d and once
//     for dS = P * (dP_d - D) in float32, from which dgate (a row sum with
//     the bias) and this element's bias partial gate * dS (float32, summed
//     over the batch in order by `bwd_dbias_reduce`) are taken; dS is
//     stored to shared memory in bf16.  After one barrier each warp computes
//     16 rows of dQ = dS . K, dK = dS^T . Q and dV = P_d^T . dctx, each a sum
//     over all queries inside the block, so no sum crosses blocks and two
//     runs give the same bits.  Recomputing the 16-key slices of dP costs
//     one T^2 * dh product a head (six instead of five) and keeps a warp's
//     live state to the 80 probability registers: holding dP as well would
//     need 160 float registers a thread, past the 204 a 320-thread block
//     may have.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace emo {
namespace tcb {

using bf16 = __nv_bfloat16;
using sm90::cp_async_16;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16_16816;
using sm90::pack_bf16;

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 160;
constexpr int kRowStride = 72;  // bf16 per row of the Q/K/V/dctx tiles: 144 bytes

// The attention block's shared memory: four [kKeys][72] bf16 tiles (Q, K, V,
// dctx) and two [kKeys][kKeys + 8] bf16 squares (P_d, dS).  Mirrored by
// `kernels/wavlm_attn.py::backward_attention_smem_bytes`.
template <int kKeys>
struct AttnPlan {
  static constexpr int kWarps = kKeys / 16;
  static constexpr int kSquareStride = kKeys + 8;  // 336 bytes at 160: conflict-free ldmatrix
  static constexpr int kTile = kKeys * kRowStride;
  static constexpr int kSquare = kKeys * kSquareStride;
  static constexpr int kSmemBytes = (4 * kTile + 2 * kSquare) * 2;
};
static_assert(AttnPlan<kMaxKeys>::kSmemBytes <= 227 * 1024, "attention block over 227 KB");

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

template <int kKeys>
__global__ void __launch_bounds__(AttnPlan<kKeys>::kWarps * 32)
bwd_attn_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dctx,
             const float* __restrict__ gate, const float* __restrict__ bias,
             bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
             float* __restrict__ dgate, float* __restrict__ dbias_part, int Tp, int seq_len,
             int E, int H, unsigned seed, unsigned attn_thr, float attn_inv) {
  using Plan = AttnPlan<kKeys>;
  static_assert(kKeys % 16 == 0 && kKeys <= kMaxKeys, "keys held: a multiple of 16, <= 160");
  constexpr int kTiles = kKeys / 8;  // n8 tiles of a score row
  constexpr int kThreads = Plan::kWarps * 32;
  constexpr int kSq = Plan::kSquareStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + Plan::kTile;
  bf16* Vs = Ks + Plan::kTile;
  bf16* Gs = Vs + Plan::kTile;  // dctx_h
  bf16* Ps = Gs + Plan::kTile;  // P_d [query][key]
  bf16* Ss = Ps + Plan::kSquare;  // dS [query][key]

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4, mi = lane / 8, mr = lane % 8;
  const size_t base = (size_t)b * Tp * E + (size_t)h * kHeadDim;
  const size_t bh = ((size_t)b * H + h) * Tp;

  for (int idx = threadIdx.x; idx < kKeys * 8; idx += kThreads) {
    const int j = idx / 8, c = (idx % 8) * 8;
    const bool ok = j < seq_len;  // rows past seq_len are zeros, never read
    const size_t off = base + (size_t)(ok ? j : 0) * E + c;
    cp_async_16(&Qs[j * kRowStride + c], q + off, ok);
    cp_async_16(&Ks[j * kRowStride + c], k + off, ok);
    cp_async_16(&Vs[j * kRowStride + c], v + off, ok);
    cp_async_16(&Gs[j * kRowStride + c], dctx + off, ok);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  // ---- this warp's 16 query rows: scores, softmax, P_d, dS ----------------
  const int i0 = warp * 16;
  const int r0 = i0 + g, r1 = r0 + 8;
  const bool ok0 = r0 < seq_len, ok1 = r1 < seq_len;

  float s[kTiles][4];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kHeadDim / 16; ++kc) {
    uint32_t qa[4];  // (rows +0, d +0), (rows +8, d +0), (rows +0, d +8), (rows +8, d +8)
    ldmatrix_x4(qa, &Qs[(i0 + mr + 8 * (mi % 2)) * kRowStride + kc * 16 + 8 * (mi / 2)]);
#pragma unroll
    for (int np = 0; np < kTiles / 2; ++np) {
      uint32_t kb[4];  // (keys +0, d +0), (keys +0, d +8), (keys +8, d +0), (keys +8, d +8)
      ldmatrix_x4(kb, &Ks[(np * 16 + mr + 8 * (mi / 2)) * kRowStride + kc * 16 + 8 * (mi % 2)]);
      mma_bf16_16816(s[2 * np], qa, kb[0], kb[1]);
      mma_bf16_16816(s[2 * np + 1], qa, kb[2], kb[3]);
    }
  }

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

  // P (float32, rows past seq_len zero) stays in s; the keep bits of K1's
  // attention dropout, bit 4 t + c for element c of tile t; P_d to shared.
  const unsigned stream = attn_stream(seed, b, h);
  uint32_t keep[(kTiles * 4 + 31) / 32];
#pragma unroll
  for (int w = 0; w < (kTiles * 4 + 31) / 32; ++w) keep[w] = 0xffffffffu;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    float pd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c < 2 ? r0 : r1;
      const unsigned j = (unsigned)(t * 8 + 2 * qd + (c % 2));
      const float p = (c < 2 ? ok0 : ok1) ? s[t][c] / (c < 2 ? l0 : l1) : 0.f;
      s[t][c] = p;
      pd[c] = p;
      if (attn_thr && !hash_keep(stream, (unsigned)r * (unsigned)Tp + j, attn_thr)) {
        keep[(4 * t + c) / 32] &= ~(1u << ((4 * t + c) % 32));
        pd[c] = 0.f;
      } else if (attn_thr) {
        pd[c] = p * attn_inv;
      }
    }
    store_pair(&Ps[r0 * kSq + t * 8 + 2 * qd], pd[0], pd[1]);
    store_pair(&Ps[r1 * kSq + t * 8 + 2 * qd], pd[2], pd[3]);
  }

  // dctx rows of the warp as A fragments.
  uint32_t ga[kHeadDim / 16][4];
#pragma unroll
  for (int kc = 0; kc < kHeadDim / 16; ++kc)
    ldmatrix_x4(ga[kc], &Gs[(i0 + mr + 8 * (mi % 2)) * kRowStride + kc * 16 + 8 * (mi / 2)]);

  // dP_d for the 16 keys of slice np: dctx . V^T under the dropout mask.
  auto dprobs = [&](int np, float (&dp)[2][4]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) dp[u][0] = dp[u][1] = dp[u][2] = dp[u][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kHeadDim / 16; ++kc) {
      uint32_t vb[4];  // (keys +0, d +0), (keys +0, d +8), (keys +8, d +0), (keys +8, d +8)
      ldmatrix_x4(vb, &Vs[(np * 16 + mr + 8 * (mi / 2)) * kRowStride + kc * 16 + 8 * (mi % 2)]);
      mma_bf16_16816(dp[0], ga[kc], vb[0], vb[1]);
      mma_bf16_16816(dp[1], ga[kc], vb[2], vb[3]);
    }
    if (attn_thr) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int bit = 4 * (2 * np + u) + c;
          dp[u][c] = (keep[bit / 32] >> (bit % 32)) & 1u ? dp[u][c] * attn_inv : 0.f;
        }
    }
  };

  // The softmax row term D = sum_j P * dP_d.
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int np = 0; np < kTiles / 2; ++np) {
    float dp[2][4];
    dprobs(np, dp);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = 2 * np + u;
      d0 += s[t][0] * dp[u][0] + s[t][1] * dp[u][1];
      d1 += s[t][2] * dp[u][2] + s[t][3] * dp[u][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }

  // dS = P * (dP_d - D) in float32: dgate, the bias partial, dS in bf16.
  float* part0 = dbias_part + (bh + r0) * Tp;
  float* part1 = dbias_part + (bh + r1) * Tp;
  float dg0 = 0.f, dg1 = 0.f;
#pragma unroll
  for (int np = 0; np < kTiles / 2; ++np) {
    float dp[2][4];
    dprobs(np, dp);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = 2 * np + u;
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ds[c] = s[t][c] * (dp[u][c] - (c < 2 ? d0 : d1));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = t * 8 + 2 * qd + e;
        if (j < seq_len) {
          if (ok0) {
            dg0 += ds[e] * b0[j];
            part0[j] = g0 * ds[e];
          }
          if (ok1) {
            dg1 += ds[2 + e] * b1[j];
            part1[j] = g1 * ds[2 + e];
          }
        }
      }
      store_pair(&Ss[r0 * kSq + t * 8 + 2 * qd], ds[0], ds[1]);
      store_pair(&Ss[r1 * kSq + t * 8 + 2 * qd], ds[2], ds[3]);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dg0 += __shfl_xor_sync(0xffffffffu, dg0, o);
    dg1 += __shfl_xor_sync(0xffffffffu, dg1, o);
  }
  if (qd == 0) {
    if (ok0) dgate[bh + r0] = dg0;
    if (ok1) dgate[bh + r1] = dg1;
  }
  __syncthreads();  // every warp's P_d and dS rows are in shared memory

  // ---- 16 rows each of dQ (queries i0..), dK and dV (keys i0..) ----------
  if (i0 >= seq_len) return;
  float o[kHeadDim / 8][4];
  // out[16 x 64] = sum over kKeys of A . B, with B [kKeys][d] read by
  // ldmatrix.trans; A either this warp's rows of a square (a_rows) or its
  // columns, read transposed.
  auto product = [&](const bf16* sq, bool a_rows, const bf16* rhs) {
#pragma unroll
    for (int t = 0; t < kHeadDim / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t a[4];  // (rows +0, k +0), (rows +8, k +0), (rows +0, k +8), (rows +8, k +8)
      if (a_rows)
        ldmatrix_x4(a, &sq[(i0 + mr + 8 * (mi % 2)) * kSq + kc * 16 + 8 * (mi / 2)]);
      else
        ldmatrix_x4_trans(a, &sq[(kc * 16 + mr + 8 * (mi / 2)) * kSq + i0 + 8 * (mi % 2)]);
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t rb[4];  // (k +0, d +0), (k +8, d +0), (k +0, d +8), (k +8, d +8)
        ldmatrix_x4_trans(rb, &rhs[(kc * 16 + mr + 8 * (mi % 2)) * kRowStride + dp * 16 + 8 * (mi / 2)]);
        mma_bf16_16816(o[2 * dp], a, rb[0], rb[1]);
        mma_bf16_16816(o[2 * dp + 1], a, rb[2], rb[3]);
      }
    }
  };
  auto store = [&](bf16* out) {
#pragma unroll
    for (int t = 0; t < kHeadDim / 8; ++t) {
      const int d = t * 8 + 2 * qd;
      if (ok0) store_pair(out + base + (size_t)r0 * E + d, o[t][0], o[t][1]);
      if (ok1) store_pair(out + base + (size_t)r1 * E + d, o[t][2], o[t][3]);
    }
  };
  product(Ss, true, Ks);   // dQ = dS . K
  store(dq);
  product(Ss, false, Qs);  // dK = dS^T . Q
  store(dk);
  product(Ps, false, Gs);  // dV = P_d^T . dctx
  store(dv);
}

// ---- (a) the out-projection's two products ---------------------------------

constexpr int kPM = 64, kPN = 64, kPK = 32, kPStages = 3, kPThreads = 128;
constexpr int kKStride = kPK + 8;  // a [64][32] tile stored k-contiguous: 80-byte rows
constexpr int kNStride = kPN + 8;  // a [32][64] tile stored with k as its rows: 144-byte rows
constexpr int kPTile = kPM * kKStride;  // the larger of 64 x 40 and 32 x 72
static_assert(kPK * kNStride <= kPTile, "stage buffer too small");

// Is the sequence row `row` (of B*Tp) one that exists?
__device__ __forceinline__ bool seq_row(int row, int rows, int Tp, int seq_len) {
  return row < rows && (row % Tp) < seq_len;
}

// One 64 x 64 tile of C = A . B at (m0, n0), all operands with leading
// dimension `ld`, C with leading dimension N.  kAKMajor: A stored [m][k],
// else [k][m]; kBKMajor: B stored [n][k], else [k][n].  kSeqM: m runs over
// sequence rows (read as zero and not written at or past seq_len), else k
// does (read as zero there).
template <bool kAKMajor, bool kBKMajor, bool kSeqM, typename TC>
__device__ __forceinline__ void proj_tile(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                          TC* __restrict__ C, int M, int N, int K, int ld,
                                          int m0, int n0, int Tp, int seq_len,
                                          bf16 (*As)[kPTile], bf16 (*Bs)[kPTile]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, qd = lane % 4, mi = lane / 8, mr = lane % 8;
  const int steps = (K + kPK - 1) / kPK;

  // 256 chunks of 16 bytes an operand: rows x 4 chunks (k-major) or 32 k
  // rows x 8 chunks.
  auto stage_operand = [&](const bf16* X, bf16* dst, bool k_major, int r0, int rows,
                           bool seq_r, int k0) {
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int idx = tid + l * kPThreads;
      if (k_major) {
        const int r = idx / 4, c = (idx % 4) * 8;
        const int row = r0 + r;
        const bool ok = seq_r ? seq_row(row, rows, Tp, seq_len) : row < rows;
        cp_async_16(&dst[r * kKStride + c], X + (size_t)(ok ? row : 0) * ld + k0 + c, ok);
      } else {
        const int r = idx / 8, c = (idx % 8) * 8;
        const int kk = k0 + r;
        const bool ok = kSeqM ? kk < K : seq_row(kk, K, Tp, seq_len);
        cp_async_16(&dst[r * kNStride + c], X + (size_t)(ok ? kk : 0) * ld + r0 + c, ok);
      }
    }
  };
  auto stage = [&](int step, int buf) {
    const int k0 = step * kPK;
    stage_operand(A, As[buf], kAKMajor, m0, M, kSeqM, k0);
    stage_operand(B, Bs[buf], kBKMajor, n0, N, false, k0);
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
    const bf16* At = As[step % kPStages];
    const bf16* Bt = Bs[step % kPStages];
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 16) {
      uint32_t af[2][4];  // (rows +0, k +0), (rows +8, k +0), (rows +0, k +8), (rows +8, k +8)
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int mb = wm * 32 + a * 16;
        if (kAKMajor)
          ldmatrix_x4(af[a], &At[(mb + mr + 8 * (mi % 2)) * kKStride + kk + 8 * (mi / 2)]);
        else
          ldmatrix_x4_trans(af[a], &At[(kk + mr + 8 * (mi / 2)) * kNStride + mb + 8 * (mi % 2)]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nb = wn * 32 + np * 16;
        uint32_t bf[4];  // b0, b1 of n8 tile 2 np, then of 2 np + 1
        if (kBKMajor)  // (n +0, k +0), (n +0, k +8), (n +8, k +0), (n +8, k +8)
          ldmatrix_x4(bf, &Bt[(nb + mr + 8 * (mi / 2)) * kKStride + kk + 8 * (mi % 2)]);
        else  // (k +0, n +0), (k +8, n +0), (k +0, n +8), (k +8, n +8)
          ldmatrix_x4_trans(bf, &Bt[(kk + mr + 8 * (mi % 2)) * kNStride + nb + 8 * (mi / 2)]);
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
      if (kSeqM ? !seq_row(row, M, Tp, seq_len) : row >= M) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = n0 + wn * 32 + t * 8 + 2 * qd;
        const float x = acc[a][t][2 * half], y = acc[a][t][2 * half + 1];
        if constexpr (sizeof(TC) == 4)
          *reinterpret_cast<float2*>(C + (size_t)row * N + n) = make_float2(x, y);
        else
          store_pair(C + (size_t)row * N + n, x, y);
      }
    }
  }
}

// Blocks [0, (E/64)^2): dW_o[i][n] = sum_rows ctx[row][i] dproj[row][n];
// the rest: dctx[row][i] = sum_n dproj[row][n] W_o[i][n].
static __global__ void __launch_bounds__(kPThreads)
bwd_proj_mma(const bf16* __restrict__ dproj, const bf16* __restrict__ wo,
             const bf16* __restrict__ ctx, bf16* __restrict__ dctx, float* __restrict__ dwo,
             int M, int Tp, int seq_len, int E) {
  __shared__ __align__(16) bf16 As[kPStages][kPTile];
  __shared__ __align__(16) bf16 Bs[kPStages][kPTile];
  const int tiles_n = E / kPN;
  int t = blockIdx.x;
  if (t < tiles_n * tiles_n) {
    proj_tile<false, false, false>(ctx, dproj, dwo, E, E, M, E, (t / tiles_n) * kPM,
                                   (t % tiles_n) * kPN, Tp, seq_len, As, Bs);
  } else {
    t -= tiles_n * tiles_n;
    proj_tile<true, true, true>(dproj, wo, dctx, M, E, E, E, (t / tiles_n) * kPM,
                                (t % tiles_n) * kPN, Tp, seq_len, As, Bs);
  }
}

// (a) then (b) on `stream`, after the LayerNorm backward has written dproj;
// the caller then sums the bias partials.  The caller has checked that every
// bf16 operand is 16-byte aligned.
static cudaError_t launch_proj_and_attn(
    const bf16* q, const bf16* k, const bf16* v, const float* gate, const float* bias,
    const bf16* wo, const bf16* ctx, const bf16* dproj, bf16* dctx, bf16* dq, bf16* dk,
    bf16* dv, float* dgate, float* dwo, float* dbias_part, int B, int Tp, int seq_len, int E,
    int H, unsigned seed, unsigned attn_thr, float attn_inv, cudaStream_t stream) {
  if (E % kPN != 0 || E / H != kHeadDim || seq_len > kMaxKeys) return cudaErrorInvalidValue;
  const int M = B * Tp, tiles_n = E / kPN;
  bwd_proj_mma<<<tiles_n * tiles_n + tiles_n * ((M + kPM - 1) / kPM), kPThreads, 0, stream>>>(
      dproj, wo, ctx, dctx, dwo, M, Tp, seq_len, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  if (seq_len <= 64) {
    constexpr int smem = AttnPlan<64>::kSmemBytes;
    err = cudaFuncSetAttribute(bwd_attn_mma<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bwd_attn_mma<64><<<grid, AttnPlan<64>::kWarps * 32, smem, stream>>>(
        q, k, v, dctx, gate, bias, dq, dk, dv, dgate, dbias_part, Tp, seq_len, E, H, seed,
        attn_thr, attn_inv);
  } else {
    constexpr int smem = AttnPlan<kMaxKeys>::kSmemBytes;
    err = cudaFuncSetAttribute(bwd_attn_mma<kMaxKeys>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bwd_attn_mma<kMaxKeys><<<grid, AttnPlan<kMaxKeys>::kWarps * 32, smem, stream>>>(
        q, k, v, dctx, gate, bias, dq, dk, dv, dgate, dbias_part, Tp, seq_len, E, H, seed,
        attn_thr, attn_inv);
  }
  return cudaGetLastError();
}

}  // namespace tcb
}  // namespace emo
