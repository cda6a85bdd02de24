// K4 on the tensor cores: the whole cross-attention fusion block cut along
// its row independence into four grid-wide launches, every Linear layer in
// TF32 with split products (3xTF32) on wgmma, at float32 accuracy.
// Included by `fused_block.cu`, which takes this route when
// `kernels/fused_block.py::tensor_core_route` says so (the shapes alone
// decide: T <= 16 video tokens, Ta >= 16 audio tokens, d a multiple of 32
// up to 128, head width a multiple of 4, tower widths multiples of 8,
// shared memory within a block's); the CUDA-core kernels of
// `fused_block.cu` keep every other shape.  K5's tensor-core route
// (`xattn_tc.cuh`) cuts its attention core the same way.
//
// What bounds it on an H100: at B = 8 (T = 8, Ta = 149, Dv = 512, Ds = 768,
// d = 128, 4 heads) the block is 0.46 GFLOP over 3.4 MB, 2.8 us of 3xTF32
// work; the CUDA-core kernel took ~0.29 ms at every B, one block per sample
// running a chain of ~20 dependent products on B SMs.  Here the chain is cut
// where the data allow, and what is left is the latency of each block's
// chain of small products:
//
//  (1) fb_rows_tc: a grid over 16-row tiles of all B*Ta audio rows and all
//      B*T video rows together (rows of two samples may share a tile and
//      each weight chunk): a = (a_seq W_aseq + b) W_ain + b; the v2a keys
//      and values ([B*Ta, 2d]) and the pre-scaled a2v queries of a; with the
//      prior, the token parts of s_ak and s_aq and the tile's column sums of
//      a per sample; v = v_feat W_vin + b, its pre-scaled v2a queries and,
//      with the prior, the token parts of s_vq and s_vk (from the pre-update
//      v, as the reference).  75 + 4 blocks at B = 8.
//  (2) fb_video_tc: one block per `samples_per_block` samples, walking its
//      samples in order: the prior (means, its MLP, the four per-sample
//      constants), the v2a attention (8 queries over Ta keys; scores and
//      softmax on CUDA cores, P . V on the tensor cores), the out-projection,
//      v' = LN(v + .), the a2v keys and values of v', and v_emb.
//  (3) fb_audio_tc: a grid over the audio row tiles: the a2v attention of
//      each row over its sample's T keys (CUDA cores), the out-projection,
//      a' = LN(a + .), and per tile and sample the mean pool's column sums
//      or the attention pool's partial softmax (its max, its sum and the
//      weighted column sums: LN -> Linear -> GELU -> Linear works row by row).
//  (4) fb_head_tc: one block per `samples_per_block` samples: the partials
//      reduced in tile order, then the concat or gated head, the logits.
//
// Every Linear layer goes through `tc_product` (`tc_product.cuh`, shared with
// K5's tensor-core route), transposed: Y^T = W^T X^T,
// so that the weight's output columns fill wgmma's 64 rows (two warpgroups,
// 128 columns a product) and the few rows of X (1 to 16, or 32) are its N.
// The weight streams from device memory in 32-row chunks through a ring of
// raw chunks (cp.async, two chunks ahead); each warpgroup loads its A
// fragments from the ring into registers (int8 dequantised with its
// per-column scale there), splits them into TF32 hi and lo, and X's matching
// 32 columns are split into hi and lo blocks in the 128-byte swizzle wgmma
// reads as B.  Per 8 of depth: lo.hi, hi.lo, hi.hi; each chunk's sum (32 of
// depth) is folded into a float32 total, as the tensor cores' accumulator
// truncates; chunk c + 1's loads overlap chunk c's products (two register
// sets).  (A first design on mma.sync.m16n8k8 ran its TF32 products far
// below wgmma's rate on the H100.)  The row dots of depth <=
// 32 (scores), the <= 16-key softmaxes and contexts and the LayerNorms stay
// on the CUDA cores.  Every sum runs in a fixed order and no atomics are
// used: the logits are the same bits for any `samples_per_block` and from
// run to run (an output element of a product depends on its own row and
// column only).
#pragma once

#include "fusion.cuh"
#include "hopper.cuh"
#include "tc_product.cuh"

namespace emo {
namespace fusion_tc {

using namespace emo::fusion;

// ---- the workspace: float32 intermediates in device memory ----------------

struct Work {
  float* v;       // [B*T, d]   video tokens (pre-update)
  float* qv;      // [B*T, d]   v2a queries, pre-scaled
  float* svtok;   // [B*T, 2]   prior: token parts of the v2a query and a2v key scores
  float* satok;   // [B*Ta, 2]  prior: token parts of the v2a key and a2v query scores
  float* apart;   // [tiles, 2, d]   prior: column sums of a per tile and sample
  float* kvv;     // [B*T, 2d]  a2v keys and values of v'
  float* vemb;    // [B, d]
  float* pconst;  // [B, 4]     prior: the constants of s_vq, s_ak, s_aq, s_vk
  float* ppart;   // [tiles, 2, 2 + d]  pool partials per tile and sample
};

__host__ __device__ inline int audio_tiles(const Params& p) {
  return (p.B * p.Ta + kRows - 1) / kRows;
}
__host__ __device__ inline int video_tiles(const Params& p) {
  return (p.B * p.T + kRows - 1) / kRows;
}

// Carves `base` (may be null: sizes only) -> floats used.  Each piece starts
// on a 16-byte boundary.  Mirrored by `fused_block.py::tc_workspace_floats`.
__host__ __device__ inline size_t carve_work(const Params& p, float* base, Work* w) {
  const size_t rv = (size_t)p.B * p.T, ra = (size_t)p.B * p.Ta, d = p.d;
  const size_t tiles = audio_tiles(p);
  const size_t sizes[9] = {rv * d, rv * d, rv * 2, ra * 2, tiles * 2 * d, rv * 2 * d,
                           (size_t)p.B * d, (size_t)p.B * 4, tiles * 2 * (2 + d)};
  float** slots[9] = {&w->v, &w->qv, &w->svtok, &w->satok, &w->apart, &w->kvv, &w->vemb,
                      &w->pconst, &w->ppart};
  size_t at = 0;
  for (int i = 0; i < 9; ++i) {
    *slots[i] = base ? base + at : nullptr;
    at += (sizes[i] + 3) / 4 * 4;
  }
  return at;
}

// The tile's first sample and its rows [lo, hi) of sample s0 + part.
__device__ __forceinline__ void part_rows(int r0, int M, int Ta, int part, int* lo, int* hi) {
  const int s0 = r0 / Ta, s = s0 + part;
  *lo = max(0, s * Ta - r0);
  *hi = min(M, (s + 1) * Ta - r0);
}

// ---- shared memory of each kernel (mirrored by `fused_block.py::tc_smem_bytes`) ----

__host__ __device__ inline size_t rows_smem_bytes(const Params& p) {
  const int wide = p.Ds > p.Dv ? p.Ds : p.Dv;
  return 1024 + kBaseBytes + 4 * (size_t)kRows * (x_stride(wide) + 2 * x_stride(p.d));
}

__host__ __device__ inline size_t video_smem_bytes(const Params& p) {
  const int hd = round_up(p.H * p.T, 16);
  const int hid = p.prior_hidden > p.pool_hidden ? p.prior_hidden : p.pool_hidden;
  return 1024 + kBaseBytes + 4 * ((size_t)4 * kRows * x_stride(p.d) + (size_t)hd * x_stride(p.Ta) +
                           (size_t)hd * x_stride(p.d) + x_stride(2 * p.d) +
                           (size_t)kRows * x_stride(hid) + x_stride(p.prior_dim) + 3 * kRows);
}

__host__ __device__ inline size_t audio_smem_bytes(const Params& p) {
  return 1024 + kBaseBytes + 4 * ((size_t)6 * kRows * x_stride(p.d) + 2 * (size_t)p.T * 2 * p.d +
                           (size_t)kRows * p.H * p.T + 2 * p.T + 4 +
                           (size_t)kRows * x_stride(p.pool_hidden) + 2 * kRows);
}

__host__ __device__ inline size_t head_smem_bytes(const Params& p) {
  const int hid = p.head_hidden > p.d ? p.head_hidden : p.d;
  return 1024 + kBaseBytes + 4 * ((size_t)kRows * (x_stride(2 * p.d) + x_stride(hid) + x_stride(p.d)) +
                           kRows);
}

// ---- (1) audio and video rows ----------------------------------------------

// Rows [r0, r0 + M) of a [rows, width] tower output -> float32 X tile, in
// 16-byte pieces (the launcher checks the alignment).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* src, int width, int M, float* X, int ldx) {
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = width / kPer;
  for (int idx = threadIdx.x; idx < M * pieces; idx += kThreads) {
    const int r = idx / pieces, c = (idx - r * pieces) * kPer;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * width + c);
    const T* v = reinterpret_cast<const T*>(&raw);
    float* x = X + (size_t)r * ldx + c;
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[i] = to_f(v[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fb_rows_tc(const Params p, const Work w) {
  extern __shared__ __align__(16) uint8_t smem_rows[];
  uint8_t* base = aligned_base(smem_rows);
  const Smem sm = carve_base(base);
  const int d = p.d, ldd = x_stride(d);
  float* X = reinterpret_cast<float*>(base + kBaseBytes);
  float* Y1 = X + kRows * x_stride(p.Ds > p.Dv ? p.Ds : p.Dv);
  float* Y2 = Y1 + kRows * ldd;
  const bool prior = p.bias_mode == kBiasPrior;
  const int na = audio_tiles(p);

  if ((int)blockIdx.x < na) {  // audio rows
    const int r0 = blockIdx.x * kRows, M = min(kRows, p.B * p.Ta - r0);
    stage_rows(static_cast<const T*>(p.t[kAIn]) + (size_t)r0 * p.Ds, p.Ds, M, X, x_stride(p.Ds));
    tc_linear(sm, X, x_stride(p.Ds), M, p.Ds, p.m[kAseqW], d, 0, d, p.v[kAseqB], Y1, ldd);
    tc_linear(sm, Y1, ldd, M, d, p.m[kAinW], d, 0, d, p.v[kAinB], Y2, ldd);
    const size_t off = (size_t)r0 * d;
    float* a_g = static_cast<float*>(p.t[kATok]) + off;
    for (int idx = threadIdx.x; idx < M * d; idx += kThreads)
      a_g[idx] = Y2[(idx / d) * ldd + idx % d];
    // The v2a keys and values of a, one [rows, 2d] product; the a2v queries.
    tc_linear(sm, Y2, ldd, M, d, p.m[kV2aInW], 3 * d, d, 2 * d, p.v[kV2aInB] + d,
              static_cast<float*>(p.t[kKa]) + 2 * off, 2 * d);
    tc_linear(sm, Y2, ldd, M, d, p.m[kA2vInW], 3 * d, 0, d, p.v[kA2vInB],
              static_cast<float*>(p.t[kQa]) + off, d, kActNone, p.qscale);
    if (prior)  // the token parts of s_ak and s_aq: rows [0, d) of the packed score weights
      tc_linear(sm, Y2, ldd, M, d, p.m[kEpTokW], 4, 0, 2, nullptr, w.satok + 2 * r0, 2);
    if (prior) {  // column sums of a per sample of the tile, for the prior's mean
      for (int idx = threadIdx.x; idx < 2 * d; idx += kThreads) {
        const int part = idx / d, c = idx - part * d;
        int lo, hi;
        part_rows(r0, M, p.Ta, part, &lo, &hi);
        float s = 0.f;
        for (int r = lo; r < hi; ++r) s += Y2[r * ldd + c];
        w.apart[((size_t)blockIdx.x * 2 + part) * d + c] = s;
      }
    }
  } else {  // video rows
    const int r0 = (blockIdx.x - na) * kRows, M = min(kRows, p.B * p.T - r0);
    stage_rows(static_cast<const T*>(p.t[kVIn]) + (size_t)r0 * p.Dv, p.Dv, M, X, x_stride(p.Dv));
    tc_linear(sm, X, x_stride(p.Dv), M, p.Dv, p.m[kVinW], d, 0, d, p.v[kVinB], Y1, ldd);
    for (int idx = threadIdx.x; idx < M * d; idx += kThreads)
      w.v[(size_t)r0 * d + idx] = Y1[(idx / d) * ldd + idx % d];
    tc_linear(sm, Y1, ldd, M, d, p.m[kV2aInW], 3 * d, 0, d, p.v[kV2aInB],
              w.qv + (size_t)r0 * d, d, kActNone, p.qscale);
    if (prior)  // the token parts of s_vq and s_vk (from the pre-update v)
      tc_linear(sm, Y1, ldd, M, d, p.m[kEpTokW], 4, 2, 2, nullptr, w.svtok + 2 * r0, 2);
  }
}

// ---- (2) the video side, per sample ---------------------------------------

static __global__ void __launch_bounds__(kThreads, 1) fb_video_tc(const Params p, const Work w) {
  extern __shared__ __align__(16) uint8_t smem_video[];
  uint8_t* base = aligned_base(smem_video);
  const Smem sm = carve_base(base);
  const int T = p.T, Ta = p.Ta, d = p.d, H = p.H, dh = d / H, ldd = x_stride(d);
  const int hd = round_up(H * T, 16), ldp = x_stride(Ta);
  const int hid_n = p.prior_hidden > p.pool_hidden ? p.prior_hidden : p.pool_hidden;
  float* sv = reinterpret_cast<float*>(base + kBaseBytes);  // v
  float* sq = sv + kRows * ldd;        // v2a queries
  float* sctx = sq + kRows * ldd;      // v2a context
  float* so = sq;                      // out-projection (the queries are spent by then)
  float* sv2 = sctx + kRows * ldd;     // v'
  float* P = sv2 + kRows * ldd;        // [H*T, Ta] probabilities
  float* Yp = P + (size_t)hd * ldp;    // [H*T, d] P . V, all heads' columns
  float* pooled = Yp + (size_t)hd * ldd;  // [2d]
  float* hid = pooled + x_stride(2 * d);  // [rows, hidden] the prior's, then the pool's
  float* prior = hid + kRows * x_stride(hid_n);  // [prior_dim]
  float* misc = prior + x_stride(p.prior_dim);   // [4] constants, then scores [T], weights
  float* score = misc + kRows;
  const bool use_prior = p.bias_mode == kBiasPrior;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * p.samples_per_block;
  const int last = min(p.B, first + p.samples_per_block);

  for (int s = first; s < last; ++s) {
    __syncthreads();  // the previous sample's readers of shared memory
    for (int idx = threadIdx.x; idx < T * d; idx += kThreads) {
      const int i = idx / d, c = idx - i * d;
      sv[i * ldd + c] = w.v[((size_t)s * T + i) * d + c];
      sq[i * ldd + c] = w.qv[((size_t)s * T + i) * d + c];
    }
    float c_vq = 0.f, c_ak = 0.f, scale = 0.f;
    if (use_prior) {
      __syncthreads();
      // pooled = [mean_T v, mean_Ta a]: the tiles' column sums in tile order.
      const int t_first = s * Ta / kRows, t_last = ((s + 1) * Ta - 1) / kRows;
      for (int c = threadIdx.x; c < 2 * d; c += kThreads) {
        float acc = 0.f;
        if (c < d) {
          for (int i = 0; i < T; ++i) acc += sv[i * ldd + c];
          pooled[c] = acc / T;
        } else {
          #pragma unroll 4
          for (int t = t_first; t <= t_last; ++t) {
            const int part = (t * kRows) / Ta == s ? 0 : 1;
            acc += w.apart[((size_t)t * 2 + part) * d + (c - d)];
          }
          pooled[c] = acc / Ta;
        }
      }
      tc_linear(sm, pooled, x_stride(2 * d), 1, 2 * d, p.m[kEpP0W], p.prior_hidden, 0,
                p.prior_hidden, p.v[kEpP0B], hid, x_stride(hid_n), kActRelu);
      tc_linear(sm, hid, x_stride(hid_n), 1, p.prior_hidden, p.m[kEpP3W], p.prior_dim, 0,
                p.prior_dim, p.v[kEpP3B], prior, x_stride(p.prior_dim));
      // The four constants prior . w_x[d:] + b_x (depth prior_dim, CUDA cores).
      if (threadIdx.x < 4) {
        const Mat wx = p.m[kEpVqW + threadIdx.x];
        float c = p.v[kEpVqB + threadIdx.x][0];
        for (int k = 0; k < p.prior_dim; ++k) c = fmaf(prior[k], mat_at(wx, d + k, 0), c);
        misc[threadIdx.x] = c;
        w.pconst[(size_t)s * 4 + threadIdx.x] = c;
      }
      __syncthreads();
      c_vq = misc[0];
      c_ak = misc[1];
      scale = p.v[kEpScale][0];
    }
    __syncthreads();

    // v2a scores: thread per (head, key), the T queries' sums in registers
    // (T <= 8: an 8-wide loop, else kMaxT), keys and queries read as float4.
    const float* kva = static_cast<const float*>(p.t[kKa]) + (size_t)s * Ta * 2 * d;
    if (T <= 8) {
      for (int idx = threadIdx.x; idx < H * Ta; idx += kThreads) {
        const int h = idx / Ta, j = idx - h * Ta;
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        const float* kr = kva + (size_t)j * 2 * d + h * dh;
#pragma unroll 2
        for (int c = 0; c < dh; c += 4) {
          const float4 kv = __ldg(reinterpret_cast<const float4*>(kr + c));
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < T) {
              const float4 qv = *reinterpret_cast<const float4*>(sq + i * ldd + h * dh + c);
              acc[i] = fmaf(qv.x, kv.x, acc[i]);
              acc[i] = fmaf(qv.y, kv.y, acc[i]);
              acc[i] = fmaf(qv.z, kv.z, acc[i]);
              acc[i] = fmaf(qv.w, kv.w, acc[i]);
            }
          }
        }
        const float ak = use_prior ? w.satok[((size_t)s * Ta + j) * 2] + c_ak : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < T) {
            const float b =
                use_prior ? tanhf(w.svtok[((size_t)s * T + i) * 2] + c_vq + ak) * scale : 0.f;
            P[(size_t)(h * T + i) * ldp + j] = acc[i] + b;
          }
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < H * Ta; idx += kThreads) {
        const int h = idx / Ta, j = idx - h * Ta;
        float acc[kMaxT];
#pragma unroll
        for (int i = 0; i < kMaxT; ++i) acc[i] = 0.f;
        const float* kr = kva + (size_t)j * 2 * d + h * dh;
        for (int c = 0; c < dh; c += 4) {
          const float4 kv = __ldg(reinterpret_cast<const float4*>(kr + c));
#pragma unroll
          for (int i = 0; i < kMaxT; ++i) {
            if (i < T) {
              const float4 qv = *reinterpret_cast<const float4*>(sq + i * ldd + h * dh + c);
              acc[i] = fmaf(qv.x, kv.x, acc[i]);
              acc[i] = fmaf(qv.y, kv.y, acc[i]);
              acc[i] = fmaf(qv.z, kv.z, acc[i]);
              acc[i] = fmaf(qv.w, kv.w, acc[i]);
            }
          }
        }
        const float ak = use_prior ? w.satok[((size_t)s * Ta + j) * 2] + c_ak : 0.f;
#pragma unroll
        for (int i = 0; i < kMaxT; ++i) {
          if (i < T) {
            const float b =
                use_prior ? tanhf(w.svtok[((size_t)s * T + i) * 2] + c_vq + ak) * scale : 0.f;
            P[(size_t)(h * T + i) * ldp + j] = acc[i] + b;
          }
        }
      }
    }
    __syncthreads();
    for (int row = warp; row < H * T; row += kWarps) softmax_row(P + (size_t)row * ldp, Ta);
    // P . V on the tensor cores: every head's rows against all d columns of
    // V (the sample's v2a values: columns [d, 2d) of its [Ta, 2d] keys and
    // values); each row keeps its own head's columns.
    tc_product(sm, make_lin(Mat{kva, nullptr}, 2 * d, d, d, Ta, nullptr, Yp, ldd), P, ldp,
               H * T);
    for (int idx = threadIdx.x; idx < T * d; idx += kThreads) {
      const int i = idx / d, c = idx - i * d;
      sctx[i * ldd + c] = Yp[(size_t)((c / dh) * T + i) * ldd + c];
    }
    tc_linear(sm, sctx, ldd, T, d, p.m[kV2aOutW], d, 0, d, p.v[kV2aOutB], so, ldd);
    layer_norm_rows(sv, ldd, so, ldd, T, d, p.v[kVnS], p.v[kVnB], p.eps, sv2, ldd);
    float* kvv = w.kvv + (size_t)s * T * 2 * d;
    tc_linear(sm, sv2, ldd, T, d, p.m[kA2vInW], 3 * d, d, 2 * d, p.v[kA2vInB] + d, kvv, 2 * d);
    float* emb = w.vemb + (size_t)s * d;
    if (p.pooling == kPoolAttn) {
      layer_norm_rows(sv2, ldd, nullptr, 0, T, d, p.v[kVpLnS], p.v[kVpLnB], p.eps, so, ldd);
      tc_linear(sm, so, ldd, T, d, p.m[kVpW1], p.pool_hidden, 0, p.pool_hidden, p.v[kVpB1], hid,
                x_stride(hid_n), kActGelu);
      tc_linear(sm, hid, x_stride(hid_n), T, p.pool_hidden, p.m[kVpW2], 1, 0, 1, p.v[kVpB2],
                score, 1);
      if (threadIdx.x < 32) softmax_row(score, T);
      __syncthreads();
      for (int c = threadIdx.x; c < d; c += kThreads) {
        float acc = 0.f;
        for (int i = 0; i < T; ++i) acc = fmaf(sv2[i * ldd + c], score[i], acc);
        emb[c] = acc;
      }
    } else {
      for (int c = threadIdx.x; c < d; c += kThreads) {
        float acc = 0.f;
        for (int i = 0; i < T; ++i) acc += sv2[i * ldd + c];
        emb[c] = acc / T;
      }
    }
  }
}

// ---- (3) the audio update, per row tile -----------------------------------

static __global__ void __launch_bounds__(kThreads, 1) fb_audio_tc(const Params p, const Work w) {
  extern __shared__ __align__(16) uint8_t smem_audio[];
  uint8_t* base = aligned_base(smem_audio);
  const Smem sm = carve_base(base);
  const int T = p.T, Ta = p.Ta, d = p.d, H = p.H, dh = d / H, ldd = x_stride(d);
  const int r0 = blockIdx.x * kRows, M = min(kRows, p.B * Ta - r0);
  const int s0 = r0 / Ta, ns = (r0 + M - 1) / Ta - s0 + 1;  // one or two samples
  float* sq = reinterpret_cast<float*>(base + kBaseBytes);
  float* sa = sq + kRows * ldd;     // a
  float* sctx = sa + kRows * ldd;   // a2v context
  float* so = sctx + kRows * ldd;   // out-projection
  float* sa2 = so + kRows * ldd;    // a'
  float* st = sa2 + kRows * ldd;    // the pool's LayerNorm
  float* skv = st + kRows * ldd;    // [2][T][2d] keys and values of the tile's samples
  float* sp = skv + 2 * T * 2 * d;  // [rows][H][T] probabilities
  float* svk = sp + kRows * H * T;  // [2][T] s_vk with its constant; then [2] c_aq
  float* caq = svk + 2 * T;
  float* mid = caq + 4;                              // [rows, pool_hidden]
  float* score = mid + kRows * x_stride(p.pool_hidden);  // [rows]
  float* ew = score + kRows;                         // [rows]
  const bool use_prior = p.bias_mode == kBiasPrior;
  const float scale = use_prior ? p.v[kEpScale][0] : 0.f;

  const size_t off = (size_t)r0 * d;
  const float* qa = static_cast<const float*>(p.t[kQa]) + off;
  const float* at = static_cast<const float*>(p.t[kATok]) + off;
  for (int idx = threadIdx.x; idx < M * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    sq[r * ldd + c] = qa[idx];
    sa[r * ldd + c] = at[idx];
  }
  for (int idx = threadIdx.x; idx < ns * T * 2 * d; idx += kThreads)
    skv[idx] = w.kvv[(size_t)s0 * T * 2 * d + idx];
  if (use_prior && threadIdx.x < ns * T) {
    const int k = threadIdx.x / T, i = threadIdx.x - k * T;
    svk[threadIdx.x] = w.svtok[((size_t)(s0 + k) * T + i) * 2 + 1] +
                       w.pconst[(size_t)(s0 + k) * 4 + 3];
    if (i == 0) caq[k] = w.pconst[(size_t)(s0 + k) * 4 + 2];
  }
  __syncthreads();

  // a2v scores of each (row, head) over its sample's T keys, then softmax.
  for (int idx = threadIdx.x; idx < M * H * T; idx += kThreads) {
    const int r = idx / (H * T), h = (idx / T) % H, i = idx % T;
    const int k = (r0 + r) / Ta - s0;
    const float* qr = sq + r * ldd + h * dh;
    const float* kr = skv + ((size_t)k * T + i) * 2 * d + h * dh;
    float acc = 0.f;
    for (int c = 0; c < dh; ++c) acc = fmaf(qr[c], kr[c], acc);
    if (use_prior) acc += tanhf(w.satok[(r0 + r) * 2 + 1] + caq[k] + svk[k * T + i]) * scale;
    sp[idx] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * H; idx += kThreads) {
    float* pr = sp + (size_t)idx * T;
    float m = -3.402823466e38f, l = 0.f;
    for (int i = 0; i < T; ++i) m = fmaxf(m, pr[i]);
    for (int i = 0; i < T; ++i) {
      pr[i] = expf(pr[i] - m);
      l += pr[i];
    }
    for (int i = 0; i < T; ++i) pr[i] /= l;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int k = (r0 + r) / Ta - s0;
    const float* pr = sp + ((size_t)r * H + c / dh) * T;
    const float* vr = skv + (size_t)k * T * 2 * d + d + c;
    float acc = 0.f;
    for (int i = 0; i < T; ++i) acc = fmaf(pr[i], vr[(size_t)i * 2 * d], acc);
    sctx[r * ldd + c] = acc;
  }
  tc_linear(sm, sctx, ldd, M, d, p.m[kA2vOutW], d, 0, d, p.v[kA2vOutB], so, ldd);
  layer_norm_rows(so, ldd, sa, ldd, M, d, p.v[kAnS], p.v[kAnB], p.eps, sa2, ldd);

  __syncthreads();  // a' of every row
  float* part_g = w.ppart + (size_t)blockIdx.x * 2 * (2 + d);
  if (p.pooling == kPoolAttn) {
    layer_norm_rows(sa2, ldd, nullptr, 0, M, d, p.v[kApLnS], p.v[kApLnB], p.eps, st, ldd);
    tc_linear(sm, st, ldd, M, d, p.m[kApW1], p.pool_hidden, 0, p.pool_hidden, p.v[kApB1], mid,
              x_stride(p.pool_hidden), kActGelu);
    tc_linear(sm, mid, x_stride(p.pool_hidden), M, p.pool_hidden, p.m[kApW2], 1, 0, 1,
              p.v[kApB2], score, 1);
    // Per sample of the tile: its max, exp(score - max), their sum, and the
    // weighted column sums of a' (the head rescales the tiles to one max).
    if (threadIdx.x < ns) {
      int lo, hi;
      part_rows(r0, M, Ta, threadIdx.x, &lo, &hi);
      float m = -3.402823466e38f, l = 0.f;
      for (int r = lo; r < hi; ++r) m = fmaxf(m, score[r]);
      for (int r = lo; r < hi; ++r) {
        ew[r] = expf(score[r] - m);
        l += ew[r];
      }
      part_g[threadIdx.x * (2 + d)] = m;
      part_g[threadIdx.x * (2 + d) + 1] = l;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < ns * d; idx += kThreads) {
    const int part = idx / d, c = idx - part * d;
    int lo, hi;
    part_rows(r0, M, Ta, part, &lo, &hi);
    float acc = 0.f;
    if (p.pooling == kPoolAttn) {
      for (int r = lo; r < hi; ++r) acc = fmaf(ew[r], sa2[r * ldd + c], acc);
    } else {
      for (int r = lo; r < hi; ++r) acc += sa2[r * ldd + c];
    }
    part_g[part * (2 + d) + 2 + c] = acc;
  }
}

// ---- (4) the head, per group of samples -----------------------------------

static __global__ void __launch_bounds__(kThreads, 1) fb_head_tc(const Params p, const Work w) {
  extern __shared__ __align__(16) uint8_t smem_head[];
  uint8_t* base = aligned_base(smem_head);
  const Smem sm = carve_base(base);
  const int Ta = p.Ta, d = p.d, C = p.C;
  const int hid_n = p.head_hidden > d ? p.head_hidden : d;
  const int ldb = x_stride(2 * d), ldh = x_stride(hid_n), ldd = x_stride(d);
  float* both = reinterpret_cast<float*>(base + kBaseBytes);  // [rows, 2d]
  float* hid = both + kRows * ldb;   // [rows, hidden]
  float* fused = hid + kRows * ldh;  // [rows, d]
  float* gate = fused + kRows * ldd;  // [rows]
  const int first = blockIdx.x * p.samples_per_block;
  const int last = min(p.B, first + p.samples_per_block);
  float* out = static_cast<float*>(p.t[kOut]);

  for (int g0 = first; g0 < last; g0 += kRows) {
    const int G = min(kRows, last - g0);
    __syncthreads();  // the previous group's readers of shared memory
    for (int idx = threadIdx.x; idx < G * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d, s = g0 + r;
      const int t_first = s * Ta / kRows, t_last = ((s + 1) * Ta - 1) / kRows;
      both[r * ldb + c] = w.vemb[(size_t)s * d + c];
      float emb;
      if (p.pooling == kPoolAttn) {
        float m = -3.402823466e38f;
        #pragma unroll 4
        for (int t = t_first; t <= t_last; ++t) {
          const int part = (t * kRows) / Ta == s ? 0 : 1;
          m = fmaxf(m, w.ppart[((size_t)t * 2 + part) * (2 + d)]);
        }
        float l = 0.f, acc = 0.f;
        #pragma unroll 4
        for (int t = t_first; t <= t_last; ++t) {
          const int part = (t * kRows) / Ta == s ? 0 : 1;
          const float* pt = w.ppart + ((size_t)t * 2 + part) * (2 + d);
          const float e = expf(pt[0] - m);
          l = fmaf(pt[1], e, l);
          acc = fmaf(pt[2 + c], e, acc);
        }
        emb = acc / l;
      } else {
        float acc = 0.f;
        #pragma unroll 4
        for (int t = t_first; t <= t_last; ++t) {
          const int part = (t * kRows) / Ta == s ? 0 : 1;
          acc += w.ppart[((size_t)t * 2 + part) * (2 + d) + 2 + c];
        }
        emb = acc / Ta;
      }
      both[r * ldb + d + c] = emb;
    }
    float* logits = out + (size_t)g0 * C;
    if (p.head == kHeadConcat) {
      tc_linear(sm, both, ldb, G, 2 * d, p.m[kHW1], p.head_hidden, 0, p.head_hidden, p.v[kHB1],
                hid, ldh, kActRelu);
      tc_linear(sm, hid, ldh, G, p.head_hidden, p.m[kHW2], C, 0, C, p.v[kHB2], logits, C);
    } else {
      tc_linear(sm, both, ldb, G, 2 * d, p.m[kGW1], d, 0, d, p.v[kGB1], hid, ldh, kActRelu);
      tc_linear(sm, hid, ldh, G, d, p.m[kGW2], 1, 0, 1, p.v[kGB2], gate, 1);
      for (int idx = threadIdx.x; idx < G * d; idx += kThreads) {
        const int r = idx / d, c = idx - r * d;
        const float g = 1.f / (1.f + expf(-gate[r]));
        fused[r * ldd + c] = g * both[r * ldb + c] + (1.f - g) * both[r * ldb + d + c];
      }
      tc_linear(sm, fused, ldd, G, d, p.m[kCW], C, 0, C, p.v[kCB], logits, C);
    }
  }
}

// ---- the launcher ----------------------------------------------------------

// Shapes this route takes (the same rule as `fused_block.py::tensor_core_route`).
inline bool route_takes(const Params& p) {
  return p.T <= kMaxT && p.Ta >= kRows && p.d % 32 == 0 && p.d <= 128 &&
         (p.d / p.H) % 4 == 0 && p.Dv % 8 == 0 && p.Ds % 8 == 0 &&
         rows_smem_bytes(p) <= kMaxSmem && video_smem_bytes(p) <= kMaxSmem &&
         audio_smem_bytes(p) <= kMaxSmem && head_smem_bytes(p) <= kMaxSmem;
}

template <typename T>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  float* work = static_cast<float*>(p.t[kWork]);
  if (!route_takes(p) || p.bias_mode == kBiasExternal || work == nullptr)
    return cudaErrorInvalidValue;
  Work w;
  if (carve_work(p, work, &w) > (size_t)p.work_floats) return cudaErrorInvalidValue;
  // The tower outputs are read in 16-byte pieces; the workspace and the
  // scratch rows in float4.
  if ((reinterpret_cast<uintptr_t>(p.t[kVIn]) | reinterpret_cast<uintptr_t>(p.t[kAIn]) |
       reinterpret_cast<uintptr_t>(p.t[kKa]) | reinterpret_cast<uintptr_t>(work)) & 15)
    return cudaErrorMisalignedAddress;
  const size_t bytes[4] = {rows_smem_bytes(p), video_smem_bytes(p), audio_smem_bytes(p),
                           head_smem_bytes(p)};
  // Each kernel may take a block's whole shared memory: set once for the
  // device (four driver calls a launch cost the host as much as the
  // launches).
  static int configured_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != configured_device) {
    const void* fns[4] = {reinterpret_cast<const void*>(fb_rows_tc<T>),
                          reinterpret_cast<const void*>(fb_video_tc),
                          reinterpret_cast<const void*>(fb_audio_tc),
                          reinterpret_cast<const void*>(fb_head_tc)};
    for (int i = 0; i < 4; ++i) {
      err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
    }
    configured_device = device;
  }
  const int groups = (p.B + p.samples_per_block - 1) / p.samples_per_block;
  fb_rows_tc<T><<<audio_tiles(p) + video_tiles(p), kThreads, bytes[0], stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fb_video_tc<<<groups, kThreads, bytes[1], stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fb_audio_tc<<<audio_tiles(p), kThreads, bytes[2], stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fb_head_tc<<<groups, kThreads, bytes[3], stream>>>(p, w);
  return cudaGetLastError();
}

}  // namespace fusion_tc
}  // namespace emo
