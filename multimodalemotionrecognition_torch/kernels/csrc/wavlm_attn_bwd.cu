// K2: backward of the WavLM attention sublayer (K1, `wavlm_attn.cu`).
//
// Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
// pallas_wavlm_attn.py::_sublayer_bwd_kernel` (launched by `_backward_call`).
// From the cotangent of K1's output it gives the gradients of all ten tensor
// inputs: hidden, q, k, v [B, Tp, E], gate [B, H*Tp, 1], position bias
// [H*Tp, Tp], W_o [E, E], b_o and the LayerNorm scale and bias [1, E].
//
// The TPU kernel is one program per batch element on a sequential grid; it
// keeps nothing from the forward, recomputes it, and adds the shared
// gradients (bias, W_o, b_o, LayerNorm) into resident blocks from one grid
// step to the next.  On this card that would leave most SMs idle and there
// is no order between blocks, so the work is cut differently:
//
//  * K1 already writes the attention context (compute dtype) and the
//    pre-LayerNorm rows (float32) to device memory; they are kept for the
//    backward instead of being recomputed (O(T*E) each).  The O(T^2) scores
//    and probabilities are never stored: they are recomputed per row, and
//    both dropout masks are regenerated from the hash (`emo::hash_keep`).
//  * every sum across blocks is made from per-block partials by a second
//    pass in a fixed order, never by atomicAdd, so a run repeats bit for bit.
//
// Launches, in order:
//  (1) bwd_ln: one warp per row.  LayerNorm + residual backward -> dhidden;
//      the hidden-dropout mask applied -> dproj in the compute dtype; the
//      row's mean, rstd and the two row means of the LayerNorm backward.
//  (2) bwd_colsum + bwd_colsum_reduce: column sums over the B*T rows for
//      the LayerNorm scale and bias and for b_o (32-row partials, then one
//      ordered sum).
//  (3) bwd_gemm twice, a 64 x 64-tiled product with either operand
//      transposed by strides: dctx = dproj . W_o^T (compute dtype) and
//      dW_o = ctx^T . dproj (float32, the whole B*T reduction inside one
//      block's loop).
//  (4) bwd_attn_q: one block per (32 query rows, head, batch element), K_h
//      and V_h in shared memory, one warp per query row: scores, softmax,
//      dprobs = dctx . v^T with the attention mask, the softmax backward,
//      dq, dgate, this batch element's g * dscores (the bias partial), and
//      per row the log-sum-exp and the softmax row term for (6).
//  (5) bwd_dbias_reduce: the bias partials summed over the batch in order.
//  (6) bwd_attn_kv: the mirror of (4), one warp per key row with Q_h and
//      dctx_h in shared memory: probabilities from the saved log-sum-exp,
//      then dv = p_d^T . dctx and dk = ds^T . q, each a sum over all queries
//      inside one warp, so no sum crosses blocks.
//
// What bounds it on an H100: at B = 16, T = 149, E = 768 the score recompute
// and the seven gradient products need 8.4 GFLOP (0.12 ms at the float32
// peak outside the tensor cores; launches (4) and (6) do 9.4, recomputing
// scores and dprobs in both attention passes) against ~85 MB of float32
// operands (0.03 ms), so operations bound it in float32.  Launches (1)-(6)
// run on CUDA cores with float32 FMAs from shared memory and float32
// accumulation of operands rounded to the compute dtype where the TPU kernel
// rounds them: at head widths other than 64 or seq_len > 160.
//
// With dh = 64 and seq_len <= 160 (K1's tensor-core rule) the tensor cores
// take (3)-(6) instead.  bfloat16: `wavlm_attn_bwd_tc.cuh`, one launch for
// both out-projection products and one attention launch per (head, element)
// that computes the scores once, all on mma.sync of bf16 into float32;
// there the bytes (~46 MB at B = 16: 0.014 ms) bound it, and the order is
// (1), (2), the two products, the attention backward, (5).  float32:
// `wavlm_attn_bwd_tf32.cuh`, 3xTF32 split products on wgmma and mma.sync,
// the transposes for dW_o, both products in one launch, then a query-side
// and a key-side attention pass as (4) and (6); the order is (1), (2), the
// transposes, the products, the two passes, (5).
//
// Rows and columns at or past seq_len do not exist for this kernel: it never
// reads them (K1 leaves them unset) and their gradients are not written (the
// wrapper hands in zeroed outputs when seq_len < Tp).

#include <type_traits>

#include "wavlm_attn_bwd_tc.cuh"
#include "wavlm_attn_bwd_tf32.cuh"

namespace {

using emo::from_f;
using emo::round_to;
using emo::to_f;

constexpr int kAttnWarps = 8;
constexpr int kAttnRows = 32;  // query (4) or key (6) rows per block
constexpr int kLnWarps = 8;
constexpr int kLnMaxPerLane = 32;  // E <= 1024
constexpr int kColRows = 32;       // rows per partial of the column sums
constexpr int kColThreads = 128;
constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

// (1) ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
bwd_ln(const float* __restrict__ pre, const T* __restrict__ dout,
       const float* __restrict__ lns, T* __restrict__ dhidden,
       T* __restrict__ dproj, float* __restrict__ rowstats, int M, int Tp,
       int seq_len, int E, float eps, unsigned seed, unsigned hid_thr,
       float hid_inv) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= M || (row % Tp) >= seq_len) return;
  const float* x = pre + (size_t)row * E;
  float xn[kLnMaxPerLane], dn[kLnMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    xn[i] = c < E ? x[c] : 0.f;
    s += xn[i];
  }
  const float mean = emo::warp_sum(s) / E;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < E) q += (xn[i] - mean) * (xn[i] - mean);
  }
  const float rstd = rsqrtf(emo::warp_sum(q) / E + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    xn[i] = (xn[i] - mean) * rstd;
    dn[i] = c < E ? to_f(dout[(size_t)row * E + c]) * lns[c] : 0.f;
    s1 += dn[i];
    if (c < E) s2 += dn[i] * xn[i];
  }
  const float m1 = emo::warp_sum(s1) / E, m2 = emo::warp_sum(s2) / E;
  const unsigned stream = emo::hidden_stream(seed, row / Tp);
  const unsigned index0 = (unsigned)(row % Tp) * (unsigned)E;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c >= E) continue;
    const float dpre = rstd * (dn[i] - m1 - xn[i] * m2);
    dhidden[(size_t)row * E + c] = from_f<T>(dpre);
    float dp = dpre;
    if (hid_thr) dp = emo::hash_keep(stream, index0 + c, hid_thr) ? dpre * hid_inv : 0.f;
    dproj[(size_t)row * E + c] = from_f<T>(dp);
  }
  if (lane == 0) {
    float* st = rowstats + (size_t)row * 4;
    st[0] = mean; st[1] = rstd; st[2] = m1; st[3] = m2;
  }
}

// (2) ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kColThreads)
bwd_colsum(const float* __restrict__ pre, const T* __restrict__ dout,
           const float* __restrict__ lns, const float* __restrict__ rowstats,
           float* __restrict__ partial, int M, int Tp, int seq_len, int E,
           unsigned seed, unsigned hid_thr, float hid_inv) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= E) return;
  const float scale = lns[c];
  float a_scale = 0.f, a_bias = 0.f, a_bo = 0.f;
  const int r0 = blockIdx.y * kColRows;
  for (int r = 0; r < kColRows; ++r) {
    const int row = r0 + r;
    if (row >= M) break;
    if ((row % Tp) >= seq_len) continue;
    const float* st = rowstats + (size_t)row * 4;
    const float g = to_f(dout[(size_t)row * E + c]);
    const float normed = (pre[(size_t)row * E + c] - st[0]) * st[1];
    float dp = st[1] * (g * scale - st[2] - normed * st[3]);
    if (hid_thr) {
      const unsigned stream = emo::hidden_stream(seed, row / Tp);
      const unsigned index = (unsigned)(row % Tp) * (unsigned)E + (unsigned)c;
      dp = emo::hash_keep(stream, index, hid_thr) ? dp * hid_inv : 0.f;
    }
    a_scale += g * normed;
    a_bias += g;
    a_bo += dp;
  }
  float* out = partial + (size_t)blockIdx.y * 3 * E;
  out[c] = a_scale;
  out[E + c] = a_bias;
  out[2 * E + c] = a_bo;
}

__global__ void bwd_colsum_reduce(const float* __restrict__ partial,
                                  float* __restrict__ dlns, float* __restrict__ dlnb,
                                  float* __restrict__ dbo, int chunks, int E) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * E) return;
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) acc += partial[(size_t)k * 3 * E + idx];
  const int which = idx / E, c = idx - which * E;
  (which == 0 ? dlns : which == 1 ? dlnb : dbo)[c] = acc;
}

// (3) ----------------------------------------------------------------------

// C[m][n] = sum_k A(m, k) * B(k, n), A(m, k) = A[m * a_m + k * a_k] and
// B(k, n) = B[k * b_k + n * b_n]; C is row-major with leading dimension N.
// seq_axis 0: m runs over the B*Tp sequence rows, 1: k does; rows at or past
// seq_len are read as zero (never touched) and, for m, not written.
template <typename T, typename TC>
__global__ void __launch_bounds__(kGemmThreads)
bwd_gemm(const T* __restrict__ A, const T* __restrict__ B, TC* __restrict__ C,
         int M, int N, int K, int a_m, int a_k, int b_k, int b_n, int Tp,
         int seq_len, int seq_axis) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kGemmThreads; ++l) {
      const int idx = tid + l * kGemmThreads;
      // neighbouring threads on neighbouring addresses, whichever axis is contiguous
      const int r = a_k == 1 ? idx / kBK : idx % kBM;
      const int c = a_k == 1 ? idx % kBK : idx / kBM;
      const int m = m0 + r, kk = k0 + c;
      bool ok = m < M && kk < K;
      if (ok) ok = ((seq_axis == 0 ? m : kk) % Tp) < seq_len;
      As[c][r] = ok ? to_f(A[(size_t)m * a_m + (size_t)kk * a_k]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kGemmThreads; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = b_n == 1 ? idx / kBN : idx % kBK;
      const int c = b_n == 1 ? idx % kBN : idx / kBK;
      const int kk = k0 + r, n = n0 + c;
      bool ok = kk < K && n < N;
      if (ok && seq_axis == 1) ok = (kk % Tp) < seq_len;
      Bs[r][c] = ok ? to_f(B[(size_t)kk * b_k + (size_t)n * b_n]) : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M || (seq_axis == 0 && (m % Tp) >= seq_len)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) C[(size_t)m * N + n] = from_f<TC>(acc[i][j]);
    }
  }
}

// (4) ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
bwd_attn_q(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ gate, const float* __restrict__ bias,
           const T* __restrict__ dctx, T* __restrict__ dq, float* __restrict__ dgate,
           float* __restrict__ dbias_part, float* __restrict__ lse,
           float* __restrict__ delta, int Tp, int seq_len, int E, int H,
           unsigned seed, unsigned attn_thr, float attn_inv) {
  extern __shared__ float smem[];
  const int dh = E / H;
  const int stride = dh + 1;  // lanes on 32 different rows hit 32 banks
  float* Ks = smem;                    // [seq_len][dh + 1]
  float* Vs = Ks + seq_len * stride;   // [seq_len][dh + 1]
  float* Qs = Vs + seq_len * stride;   // [warps][dh]
  float* Gs = Qs + kAttnWarps * dh;    // [warps][dh]   dctx row
  float* Ps = Gs + kAttnWarps * dh;    // [warps][seq_len]
  float* Ds = Ps + kAttnWarps * seq_len;  // [warps][seq_len]

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * Tp * E + (size_t)h * dh;

  for (int idx = threadIdx.x; idx < seq_len * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx - j * dh;
    const size_t g = base + (size_t)j * E + d;
    Ks[j * stride + d] = to_f(k[g]);
    Vs[j * stride + d] = to_f(v[g]);
  }
  __syncthreads();

  float* qs = Qs + warp * dh;
  float* gs = Gs + warp * dh;
  float* ps = Ps + warp * seq_len;
  float* ds = Ds + warp * seq_len;
  const unsigned stream = emo::attn_stream(seed, b, h);
  for (int r = warp; r < kAttnRows; r += kAttnWarps) {
    const int i = blockIdx.x * kAttnRows + r;
    if (i >= seq_len) break;
    const size_t row = base + (size_t)i * E;
    for (int d = lane; d < dh; d += 32) {
      qs[d] = to_f(q[row + d]);
      gs[d] = to_f(dctx[row + d]);
    }
    __syncwarp();

    const size_t bhi = ((size_t)b * H + h) * Tp + i;
    const float g = gate[bhi];
    const float* brow = bias + ((size_t)h * Tp + i) * Tp;
    float m = -3.402823466e38f;  // -FLT_MAX
    for (int j = lane; j < seq_len; j += 32) {
      const float* kr = Ks + j * stride;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qs[d], kr[d], s);
      s += g * brow[j];
      ps[j] = s;
      m = fmaxf(m, s);
    }
    m = emo::warp_max(m);
    float l = 0.f;
    for (int j = lane; j < seq_len; j += 32) {
      const float p = expf(ps[j] - m);
      ps[j] = p;
      l += p;
    }
    l = emo::warp_sum(l);
    const float inv = 1.f / l;

    // dprobs = dctx . v^T under the attention mask; row term sum_j dprobs * p
    float dl = 0.f;
    for (int j = lane; j < seq_len; j += 32) {
      const float p = ps[j] * inv;
      const float* vr = Vs + j * stride;
      float dp = 0.f;
      for (int d = 0; d < dh; ++d) dp = fmaf(gs[d], vr[d], dp);
      if (attn_thr)
        dp = emo::hash_keep(stream, (unsigned)(i * Tp + j), attn_thr) ? dp * attn_inv : 0.f;
      ps[j] = p;
      ds[j] = dp;
      dl += dp * p;
    }
    dl = emo::warp_sum(dl);

    float dg = 0.f;
    float* part = dbias_part + bhi * Tp;
    for (int j = lane; j < seq_len; j += 32) {
      const float dsv = ps[j] * (ds[j] - dl);
      dg += dsv * brow[j];
      part[j] = g * dsv;
      ds[j] = round_to<T>(dsv);
    }
    dg = emo::warp_sum(dg);
    if (lane == 0) {
      dgate[bhi] = dg;
      lse[bhi] = m + logf(l);
      delta[bhi] = dl;
    }
    __syncwarp();

    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < seq_len; ++j) acc = fmaf(ds[j], Ks[j * stride + d], acc);
      dq[row + d] = from_f<T>(acc);
    }
    __syncwarp();  // qs / gs / ps / ds are rewritten for the warp's next row
  }
}

// (5) ----------------------------------------------------------------------

__global__ void bwd_dbias_reduce(const float* __restrict__ part, float* __restrict__ dbias,
                                 int B, int H, int Tp, int seq_len) {
  const size_t per_batch = (size_t)H * Tp * Tp;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_batch) return;
  const int j = idx % Tp, i = (idx / Tp) % Tp;
  float acc = 0.f;
  if (i < seq_len && j < seq_len)
    for (int b = 0; b < B; ++b) acc += part[(size_t)b * per_batch + idx];
  dbias[idx] = acc;
}

// (6) ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
bwd_attn_kv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ gate, const float* __restrict__ bias,
            const T* __restrict__ dctx, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            int Tp, int seq_len, int E, int H, unsigned seed, unsigned attn_thr,
            float attn_inv) {
  extern __shared__ float smem[];
  const int dh = E / H;
  const int stride = dh + 1;
  float* Qs = smem;                    // [seq_len][dh + 1]
  float* Gs = Qs + seq_len * stride;   // [seq_len][dh + 1]   dctx
  float* Ls = Gs + seq_len * stride;   // [seq_len] log-sum-exp
  float* Dl = Ls + seq_len;            // [seq_len] softmax row term
  float* Gt = Dl + seq_len;            // [seq_len] gate
  float* Kw = Gt + seq_len;            // [warps][dh]
  float* Vw = Kw + kAttnWarps * dh;    // [warps][dh]
  float* Pd = Vw + kAttnWarps * dh;    // [warps][seq_len] dropped probabilities
  float* Ds = Pd + kAttnWarps * seq_len;  // [warps][seq_len] dscores

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * Tp * E + (size_t)h * dh;
  const size_t bh = ((size_t)b * H + h) * Tp;

  for (int idx = threadIdx.x; idx < seq_len * dh; idx += blockDim.x) {
    const int i = idx / dh, d = idx - i * dh;
    const size_t g = base + (size_t)i * E + d;
    Qs[i * stride + d] = to_f(q[g]);
    Gs[i * stride + d] = to_f(dctx[g]);
  }
  for (int i = threadIdx.x; i < seq_len; i += blockDim.x) {
    Ls[i] = lse[bh + i];
    Dl[i] = delta[bh + i];
    Gt[i] = gate[bh + i];
  }
  __syncthreads();

  float* kw = Kw + warp * dh;
  float* vw = Vw + warp * dh;
  float* pd = Pd + warp * seq_len;
  float* ds = Ds + warp * seq_len;
  const unsigned stream = emo::attn_stream(seed, b, h);
  for (int r = warp; r < kAttnRows; r += kAttnWarps) {
    const int j = blockIdx.x * kAttnRows + r;
    if (j >= seq_len) break;
    const size_t row = base + (size_t)j * E;
    for (int d = lane; d < dh; d += 32) {
      kw[d] = to_f(k[row + d]);
      vw[d] = to_f(v[row + d]);
    }
    __syncwarp();

    const float* bcol = bias + (size_t)h * Tp * Tp + j;
    for (int i = lane; i < seq_len; i += 32) {
      const float* qr = Qs + i * stride;
      const float* gr = Gs + i * stride;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(qr[d], kw[d], s);
        dp = fmaf(gr[d], vw[d], dp);
      }
      s += Gt[i] * bcol[(size_t)i * Tp];
      const float p = expf(s - Ls[i]);
      float p_d = p;
      if (attn_thr) {
        const bool keep = emo::hash_keep(stream, (unsigned)(i * Tp + j), attn_thr);
        p_d = keep ? p * attn_inv : 0.f;
        dp = keep ? dp * attn_inv : 0.f;
      }
      pd[i] = round_to<T>(p_d);
      ds[i] = round_to<T>(p * (dp - Dl[i]));
    }
    __syncwarp();

    for (int d = lane; d < dh; d += 32) {
      float av = 0.f, ak = 0.f;
      for (int i = 0; i < seq_len; ++i) {
        av = fmaf(pd[i], Gs[i * stride + d], av);
        ak = fmaf(ds[i], Qs[i * stride + d], ak);
      }
      dv[row + d] = from_f<T>(av);
      dk[row + d] = from_f<T>(ak);
    }
    __syncwarp();  // kw / vw / pd / ds are rewritten for the warp's next row
  }
}

template <typename T>
int launch(const void* dout, const void* q, const void* k, const void* v,
           const void* gate, const void* bias, const void* wo, const void* lns,
           const void* ctx, const void* pre, void* dhidden, void* dq, void* dk,
           void* dv, void* dgate, void* dbias, void* dwo, void* dbo, void* dlns,
           void* dlnb, void* dproj, void* dctx, void* rowstats, void* colpart,
           void* dbias_part, void* lse, void* delta, void* tscratch, int B, int Tp,
           int seq_len, int E, int H, int col_chunks, float eps, int seed, unsigned attn_thr,
           float attn_inv, unsigned hid_thr, float hid_inv, void* stream_ptr) {
  const int M = B * Tp;
  if (B < 1 || H < 1 || E % H != 0 || seq_len < 1 || seq_len > Tp ||
      E > 32 * kLnMaxPerLane || col_chunks != (M + kColRows - 1) / kColRows)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int dh = E / H;
  const unsigned useed = (unsigned)seed;
  const T* dproj_c = static_cast<const T*>(dproj);
  const T* dctx_c = static_cast<const T*>(dctx);
  cudaError_t err;
  // dh = 64 and seq_len <= 160: (3)-(6) on the tensor cores (bfloat16
  // `wavlm_attn_bwd_tc.cuh`, float32 `wavlm_attn_bwd_tf32.cuh`), whose
  // operands move in 16-byte pieces: misaligned pointers are refused before
  // anything runs.
  bool tensor_cores = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    tensor_cores = dh == emo::tcb::kHeadDim && seq_len <= emo::tcb::kMaxKeys;
  else
    tensor_cores = dh == emo::tf32b::kHeadDim && seq_len <= emo::tf32b::kMaxKeys;
  if (tensor_cores &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(wo) |
        reinterpret_cast<uintptr_t>(ctx) | reinterpret_cast<uintptr_t>(dproj) |
        reinterpret_cast<uintptr_t>(dctx) | reinterpret_cast<uintptr_t>(dq) |
        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
        reinterpret_cast<uintptr_t>(dwo) | reinterpret_cast<uintptr_t>(tscratch)) & 15))
    return cudaErrorMisalignedAddress;

  bwd_ln<T><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      static_cast<const float*>(pre), static_cast<const T*>(dout),
      static_cast<const float*>(lns), static_cast<T*>(dhidden), static_cast<T*>(dproj),
      static_cast<float*>(rowstats), M, Tp, seq_len, E, eps, useed, hid_thr, hid_inv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dim3 grid_col((E + kColThreads - 1) / kColThreads, col_chunks);
  bwd_colsum<T><<<grid_col, kColThreads, 0, stream>>>(
      static_cast<const float*>(pre), static_cast<const T*>(dout),
      static_cast<const float*>(lns), static_cast<const float*>(rowstats),
      static_cast<float*>(colpart), M, Tp, seq_len, E, useed, hid_thr, hid_inv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_colsum_reduce<<<(3 * E + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(colpart), static_cast<float*>(dlns),
      static_cast<float*>(dlnb), static_cast<float*>(dbo), col_chunks, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t per_batch = (size_t)H * Tp * Tp;
  if (tensor_cores) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      using bf16 = __nv_bfloat16;
      err = emo::tcb::launch_proj_and_attn(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(gate), static_cast<const float*>(bias),
          static_cast<const bf16*>(wo), static_cast<const bf16*>(ctx),
          static_cast<const bf16*>(dproj), static_cast<bf16*>(dctx), static_cast<bf16*>(dq),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dgate),
          static_cast<float*>(dwo), static_cast<float*>(dbias_part), B, Tp, seq_len, E, H,
          useed, attn_thr, attn_inv, stream);
    } else {
      err = emo::tf32b::launch_proj_and_attn(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(gate),
          static_cast<const float*>(bias), static_cast<const float*>(wo),
          static_cast<const float*>(ctx), static_cast<const float*>(dproj),
          static_cast<float*>(dctx), static_cast<float*>(dq), static_cast<float*>(dk),
          static_cast<float*>(dv), static_cast<float*>(dgate), static_cast<float*>(dwo),
          static_cast<float*>(dbias_part), static_cast<float*>(lse), static_cast<float*>(delta),
          static_cast<float*>(tscratch), B, Tp, seq_len, E, H, useed, attn_thr, attn_inv, stream);
    }
    if (err != cudaSuccess) return err;
    bwd_dbias_reduce<<<(unsigned)((per_batch + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(dbias_part), static_cast<float*>(dbias), B, H, Tp, seq_len);
    return cudaGetLastError();
  }

  // dctx[m][i] = sum_n dproj[m][n] * wo[i][n]
  dim3 grid_dctx((E + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  bwd_gemm<T, T><<<grid_dctx, kGemmThreads, 0, stream>>>(
      dproj_c, static_cast<const T*>(wo), static_cast<T*>(dctx), M, E, E,
      /*a_m=*/E, /*a_k=*/1, /*b_k=*/1, /*b_n=*/E, Tp, seq_len, /*seq_axis=*/0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dwo[i][n] = sum_rows ctx[row][i] * dproj[row][n]
  dim3 grid_dwo((E + kBN - 1) / kBN, (E + kBM - 1) / kBM);
  bwd_gemm<T, float><<<grid_dwo, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(ctx), dproj_c, static_cast<float*>(dwo), E, E, M,
      /*a_m=*/1, /*a_k=*/E, /*b_k=*/E, /*b_n=*/1, Tp, seq_len, /*seq_axis=*/1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = sizeof(float) * ((size_t)2 * seq_len * (dh + 1) +
                                         (size_t)2 * kAttnWarps * (dh + seq_len));
  const size_t smem_kv = smem_q + sizeof(float) * 3 * (size_t)seq_len;
  if (smem_kv > kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bwd_attn_q<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_attn_kv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  dim3 grid_attn((seq_len + kAttnRows - 1) / kAttnRows, H, B);
  bwd_attn_q<T><<<grid_attn, kAttnWarps * 32, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(gate), static_cast<const float*>(bias), dctx_c,
      static_cast<T*>(dq), static_cast<float*>(dgate), static_cast<float*>(dbias_part),
      static_cast<float*>(lse), static_cast<float*>(delta), Tp, seq_len, E, H, useed,
      attn_thr, attn_inv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_dbias_reduce<<<(unsigned)((per_batch + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dbias_part), static_cast<float*>(dbias), B, H, Tp, seq_len);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_attn_kv<T><<<grid_attn, kAttnWarps * 32, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(gate), static_cast<const float*>(bias), dctx_c,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Tp, seq_len, E, H, useed, attn_thr,
      attn_inv);
  return cudaGetLastError();
}

}  // namespace

#define EMO_WAVLM_ATTN_BWD_ENTRY(NAME, T)                                        \
  extern "C" int NAME(                                                           \
      const void* dout, const void* q, const void* k, const void* v,            \
      const void* gate, const void* bias, const void* wo, const void* lns,      \
      const void* ctx, const void* pre, void* dhidden, void* dq, void* dk,      \
      void* dv, void* dgate, void* dbias, void* dwo, void* dbo, void* dlns,     \
      void* dlnb, void* dproj, void* dctx, void* rowstats, void* colpart,       \
      void* dbias_part, void* lse, void* delta, void* tscratch, int B, int Tp,  \
      int seq_len, int E, int H, int col_chunks, float eps, int seed,           \
      unsigned attn_thr, float attn_inv, unsigned hid_thr, float hid_inv,       \
      void* stream) {                                                           \
    return launch<T>(dout, q, k, v, gate, bias, wo, lns, ctx, pre, dhidden, dq, \
                     dk, dv, dgate, dbias, dwo, dbo, dlns, dlnb, dproj, dctx,   \
                     rowstats, colpart, dbias_part, lse, delta, tscratch, B,    \
                     Tp, seq_len, E, H, col_chunks, eps, seed, attn_thr,        \
                     attn_inv, hid_thr, hid_inv, stream);                       \
  }

EMO_WAVLM_ATTN_BWD_ENTRY(emo_wavlm_attn_bwd_f32, float)
EMO_WAVLM_ATTN_BWD_ENTRY(emo_wavlm_attn_bwd_bf16, __nv_bfloat16)
