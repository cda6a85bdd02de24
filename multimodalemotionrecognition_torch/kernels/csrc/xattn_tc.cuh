// K5 on the tensor cores: the bidirectional cross-attention core cut along
// its row independence into four grid-wide launches, every product with a
// weight (and the v2a P . V) in TF32 with split products (3xTF32) on wgmma
// through K4's `tc_product` (`tc_product.cuh`), at float32 accuracy.
// Included by `xattn.cu`, whose `emo_xattn_tc` takes this route when
// `kernels/xattn.py::tensor_core_route` says so (T <= 16 video tokens, d a
// multiple of 32 up to 128, at most 8 heads of a width that is a multiple of
// 4, shared memory within a block's); other shapes keep `xattn.cu`'s
// CUDA-core kernels.
//
// What it computes is `xattn.cu`'s: per sample, float32,
//   v' = LN(v + MHA(q = v, kv = a)  [+ bias v2a [T, Ta]])
//   a' = LN(a + MHA(q = a, kv = v') [+ bias a2v [Ta, T]])
//   v_emb = mean_T(v')      a_emb = mean_Ta(a')
//
// What bounds it on an H100: at B = 8 (T = 8, Ta = 149, d = 128, 4 heads)
// the core is 0.174 GFLOP over 1.2 MB: about a microsecond of either unit.
// The CUDA-core kernels run the chain of a sample on one block (B blocks),
// every product as float32 FMAs: 0.18 ms at B = 8 and at B = 1 (H100 80GB
// HBM3, 700 W).  Here the chain is cut where the data allow, so what is left
// is the latency of a few short chains of small products, each 32-deep chunk
// of a product waiting on its weight's trip from L2 (PERF.md has the times).
//
//  (1) xa_rows_tc: grid (audio tiles + 1, 3, B).  A block takes 16 audio
//      rows of one sample (a tile never holds two samples: a sample's rows
//      sit at the same places of its tiles at every B) and one of the three
//      products that do not depend on v' (the v2a keys, the v2a values, the
//      pre-scaled a2v queries); the last x index takes the sample's T video
//      rows and their pre-scaled v2a queries.  264 blocks at B = 8.
//  (2) xa_video_tc: grid (H, B) in clusters of H blocks, one cluster per
//      sample, one block per head.  Block h: the scores of the T queries of
//      head h over the Ta keys (CUDA cores, the external bias read in the
//      score loop), the softmax, ctx_h = P_h . V_h on the tensor cores; the
//      cluster's blocks read each other's ctx_h from distributed shared
//      memory, each computes d/H columns of the out-projection, they gather
//      those, and each takes v' = LN(v + .) (the same bits in every block)
//      and 2d/H columns of the a2v keys and values of v'.  Block 0 writes
//      v_emb.  H blocks a sample: 32 SMs at B = 8, 4 at B = 1.
//  (3) xa_audio_tc: grid (audio tiles, B): the a2v attention of each row
//      over its sample's T keys (CUDA cores), the out-projection on the
//      tensor cores, a' = LN(a + .), and the tile's column sums of a'.
//  (4) xa_pool: per sample, the tiles' column sums added in tile order.
//
// Launches (2) to (4) are programmatic dependents of the one before: each
// is scheduled as the one before completes and waits in the kernel
// (`griddepcontrol.wait`) only where it reads that kernel's output.  In (1)
// and (3) the product's first weight chunks are issued (`tc_prefetch`)
// before the loads that precede it, so that their L2 latency overlaps.
//
// Every sum runs in a fixed order and no atomics are used, and a sample's
// rows sit at the same places of the same tiles at every B: a sample's
// embeddings are the same bits at any B and from run to run (an output
// element of a product depends on its own row and column only).  The
// weights are read as they lie, float32: each chunk is split into TF32 hi
// and lo in registers as the product loads it (`chunk_products`), so no
// split pass runs per call and none is kept with the parameters.
#pragma once

#include <cooperative_groups.h>

#include "tc_product.cuh"

namespace emo {
namespace xattn_tc {

using namespace emo::fusion;
using namespace emo::fusion_tc;
namespace cg = cooperative_groups;

constexpr int kMaxHeads = 8;  // a sample's cluster: one block per head, the portable size

// The float32 intermediates in device memory.
struct Work {
  float* kva;   // [B*Ta, 2d]       v2a keys (columns [0, d)) and values ([d, 2d)) of a
  float* qa;    // [B*Ta, d]        a2v queries of a, pre-scaled
  float* qv;    // [B*T, d]         v2a queries of v, pre-scaled
  float* kvv;   // [B*T, 2d]        a2v keys and values of v'
  float* part;  // [B, tiles, d]    column sums of a' per audio tile
};

__host__ __device__ inline int audio_tiles(int Ta) { return (Ta + kRows - 1) / kRows; }

// Carves `base` (may be null: sizes only) -> floats used.  Each piece starts
// on a 16-byte boundary.  Mirrored by `xattn.py::tc_workspace_floats`.
__host__ __device__ inline size_t carve_work(const Params& p, float* base, Work* w) {
  const size_t ra = (size_t)p.B * p.Ta, rv = (size_t)p.B * p.T, d = p.d;
  const size_t sizes[5] = {ra * 2 * d, ra * d, rv * d, rv * 2 * d,
                           (size_t)p.B * audio_tiles(p.Ta) * d};
  float** slots[5] = {&w->kva, &w->qa, &w->qv, &w->kvv, &w->part};
  size_t at = 0;
  for (int i = 0; i < 5; ++i) {
    *slots[i] = base ? base + at : nullptr;
    at += (sizes[i] + 3) / 4 * 4;
  }
  return at;
}

// ---- shared memory of each kernel (mirrored by `xattn.py::tc_smem_bytes`) ----

__host__ __device__ inline size_t rows_smem_bytes(const Params& p) {
  return 1024 + kBaseBytes + 4 * (size_t)kRows * x_stride(p.d);
}

__host__ __device__ inline size_t video_smem_bytes(const Params& p) {
  const int dh = p.d / p.H;
  return 1024 + kBaseBytes +
         4 * (size_t)p.T * (3 * x_stride(dh) + x_stride(p.Ta) + 4 * x_stride(p.d));
}

__host__ __device__ inline size_t audio_smem_bytes(const Params& p) {
  return 1024 + kBaseBytes +
         4 * ((size_t)5 * kRows * x_stride(p.d) + (size_t)p.T * (2 * p.d + 4) +
              (size_t)kRows * p.H * p.T);
}

// Programmatic dependent launch: a kernel launched so is scheduled as the
// one before it completes, and `wait_for_previous` returns once that kernel
// has completed and its writes are visible.  (Letting the next kernel launch
// earlier, `griddepcontrol.launch_dependents` at each block's start, made
// the chain slower on an H100.)
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Rows [0, M) x columns [0, K) of a row-major float32 matrix (row stride
// lds) into X (row stride ldx, 16-byte aligned rows): float4 loads, all of
// a thread's in flight at once, when the source allows; else floats.
__device__ __forceinline__ void stage_f32(const float* src, int lds, int M, int K, float* X,
                                          int ldx) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && lds % 4 == 0 && K % 4 == 0) {
    constexpr int kPer = 4;  // float4 loads a thread issues before storing
    const int per_row = K / 4, total = M * per_row;
    for (int base = threadIdx.x; base < total; base += kThreads * kPer) {
      float4 v[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = base + u * kThreads, r = idx / per_row, c = (idx - r * per_row) * 4;
        if (idx < total) v[u] = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * lds + c));
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = base + u * kThreads, r = idx / per_row, c = (idx - r * per_row) * 4;
        if (idx < total) *reinterpret_cast<float4*>(X + r * ldx + c) = v[u];
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < M * K; idx += kThreads)
      X[(idx / K) * ldx + idx % K] = src[(size_t)(idx / K) * lds + idx % K];
  }
}

// ---- (1) the rows' products that do not depend on v' -----------------------

static __global__ void __launch_bounds__(kThreads, 1) xa_rows_tc(const Params p, const Work w) {
  extern __shared__ __align__(16) uint8_t smem_xa_rows[];
  uint8_t* base = aligned_base(smem_xa_rows);
  const Smem sm = carve_base(base);
  const int d = p.d, ldd = x_stride(d), which = blockIdx.y, s = blockIdx.z;
  const bool audio = (int)blockIdx.x < audio_tiles(p.Ta);
  if (!audio && which != 0) return;  // the video rows have one product
  const int r0 = audio ? blockIdx.x * kRows : 0;
  const int M = audio ? min(kRows, p.Ta - r0) : p.T;
  const size_t row0 = audio ? (size_t)s * p.Ta + r0 : (size_t)s * p.T;
  // The video rows' pre-scaled v2a queries; the audio rows' v2a keys (0) or
  // values (1), columns [(1 + which) d, ...) of W, or pre-scaled a2v queries.
  const int col0 = audio && which < 2 ? (1 + which) * d : 0;
  const Lin L = !audio ? make_lin(p.m[kV2aInW], 3 * d, 0, d, d, p.v[kV2aInB], w.qv + row0 * d,
                                  d, kActNone, p.qscale)
                : which < 2 ? make_lin(p.m[kV2aInW], 3 * d, col0, d, d, p.v[kV2aInB] + col0,
                                       w.kva + row0 * 2 * d + which * d, 2 * d)
                            : make_lin(p.m[kA2vInW], 3 * d, 0, d, d, p.v[kA2vInB],
                                       w.qa + row0 * d, d, kActNone, p.qscale);
  tc_prefetch(sm, L);  // the weight's first chunks fly while the rows load
  float* X = reinterpret_cast<float*>(base + kBaseBytes);
  stage_f32(static_cast<const float*>(p.t[audio ? kATok : kVIn]) + row0 * d, d, M, d, X, ldd);
  tc_product_prefetched(sm, L, X, ldd, M);
}

// ---- (2) the video side: a cluster per sample, a block per head -------------

// P[i][j] = q_i . k_j (+ bias[i][j]) for head h, a thread per key j, the
// kQ >= T queries' sums in registers, keys and queries read as float4.
template <int kQ>
__device__ __forceinline__ void v2a_scores(const Params& p, const float* kva_s, const float* sq,
                                           int ldq, const float* bias_s, float* P, int ldp,
                                           int h) {
  const int T = p.T, Ta = p.Ta, d = p.d, dh = d / p.H;
  for (int j = threadIdx.x; j < Ta; j += kThreads) {
    float acc[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) acc[i] = 0.f;
    const float* kr = kva_s + (size_t)j * 2 * d + h * dh;
#pragma unroll 2
    for (int c = 0; c < dh; c += 4) {
      const float4 kv = __ldg(reinterpret_cast<const float4*>(kr + c));
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        if (i < T) {
          const float4 qv = *reinterpret_cast<const float4*>(sq + i * ldq + c);
          acc[i] = fmaf(qv.x, kv.x, acc[i]);
          acc[i] = fmaf(qv.y, kv.y, acc[i]);
          acc[i] = fmaf(qv.z, kv.z, acc[i]);
          acc[i] = fmaf(qv.w, kv.w, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i)
      if (i < T) P[i * ldp + j] = bias_s ? acc[i] + bias_s[(size_t)i * Ta + j] : acc[i];
  }
}

static __global__ void __launch_bounds__(kThreads, 1) xa_video_tc(const Params p, const Work w) {
  extern __shared__ __align__(16) uint8_t smem_xa_video[];
  uint8_t* base = aligned_base(smem_xa_video);
  const Smem sm = carve_base(base);
  cg::cluster_group cluster = cg::this_cluster();
  const int T = p.T, Ta = p.Ta, d = p.d, H = p.H, dh = d / H, kc = 2 * d / H;
  const int h = (int)cluster.block_rank(), s = blockIdx.y;
  const int ldd = x_stride(d), ldh = x_stride(dh), ldp = x_stride(Ta);
  float* sq = reinterpret_cast<float*>(base + kBaseBytes);  // [T, dh] head h's v2a queries
  float* P = sq + T * ldh;         // [T, Ta] head h's probabilities
  float* cpart = P + T * ldp;      // [T, dh] ctx_h, read by the cluster
  float* opart = cpart + T * ldh;  // [T, d/H] this block's out-projection, read by the cluster
  float* sv = opart + T * ldh;     // [T, d] v
  float* sctx = sv + T * ldd;      // [T, d] the context, every head
  float* so = sctx + T * ldd;      // [T, d] the out-projection, every column
  float* sv2 = so + T * ldd;       // [T, d] v'
  const size_t vrow = (size_t)s * T;
  const float* kva_s = w.kva + (size_t)s * Ta * 2 * d;
  wait_for_previous();  // the rows' keys, values and queries
  stage_f32(static_cast<const float*>(p.t[kVIn]) + vrow * d, d, T, d, sv, ldd);
  stage_f32(w.qv + vrow * d + h * dh, d, T, dh, sq, ldh);
  const float* bias_s = p.bias_mode == kBiasExternal
                            ? static_cast<const float*>(p.t[kBiasV2a]) + vrow * Ta
                            : nullptr;
  __syncthreads();
  if (T <= 8)
    v2a_scores<8>(p, kva_s, sq, ldh, bias_s, P, ldp, h);
  else
    v2a_scores<kMaxT>(p, kva_s, sq, ldh, bias_s, P, ldp, h);
  __syncthreads();
  for (int row = threadIdx.x >> 5; row < T; row += kWarps) softmax_row(P + (size_t)row * ldp, Ta);
  // ctx_h = P_h . V_h: V_h is columns [d + h dh, d + (h + 1) dh) of the
  // sample's [Ta, 2d] keys and values, streamed as the product's weight.
  // (Issuing this kernel's products' first chunks ahead, with `tc_prefetch`,
  // or keeping all their chunks in flight in stages of their own width
  // made it slower on an H100.)
  tc_product(sm, make_lin(Mat{kva_s, nullptr}, 2 * d, d + h * dh, dh, Ta, nullptr, cpart, ldh),
             P, ldp, T);
  cluster.sync();  // every head's ctx_h
  for (int idx = threadIdx.x; idx < T * d; idx += kThreads) {
    const int i = idx / d, c = idx - i * d, hh = c / dh;
    const float* peer = cluster.map_shared_rank(cpart, hh);
    sctx[i * ldd + c] = peer[i * ldh + c - hh * dh];
  }
  // Columns [h d/H, (h + 1) d/H) of the out-projection (d/H = dh).
  tc_product(sm, make_lin(p.m[kV2aOutW], d, h * dh, dh, d, p.v[kV2aOutB] + h * dh, opart, ldh),
             sctx, ldd, T);
  cluster.sync();  // every block's columns
  for (int idx = threadIdx.x; idx < T * d; idx += kThreads) {
    const int i = idx / d, c = idx - i * d, hh = c / dh;
    const float* peer = cluster.map_shared_rank(opart, hh);
    so[i * ldd + c] = peer[i * ldh + c - hh * dh];
  }
  cluster.sync();  // no block reads another's shared memory after this: each may finish
  layer_norm_rows(sv, ldd, so, ldd, T, d, p.v[kVnS], p.v[kVnB], p.eps, sv2, ldd);
  // Columns [h 2d/H, (h + 1) 2d/H) of the a2v keys and values of v'.
  tc_product(sm, make_lin(p.m[kA2vInW], 3 * d, d + h * kc, kc, d, p.v[kA2vInB] + d + h * kc,
                          w.kvv + vrow * 2 * d + h * kc, 2 * d),
             sv2, ldd, T);
  if (h == 0) {
    float* emb = static_cast<float*>(p.t[kOutV]) + (size_t)s * d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < T; ++i) acc += sv2[i * ldd + c];
      emb[c] = acc / T;
    }
  }
}

// ---- (3) the audio update, per tile of one sample's rows -------------------

// sp[(r H + h) T + i] = softmax_i(q_r,h . k_i,h (+ bias[r][i])) for the M
// rows of a tile: a thread per (row, head, key) in groups of kG >= T lanes,
// the group's softmax by shuffles.  Within a quarter warp (one group of 8,
// or half of one of 16) the reads of Q are one broadcast and the reads of K
// fall in distinct banks (its rows `ldk` = 2d + 4 floats apart).
template <int kG>
__device__ __forceinline__ void a2v_probs(const Params& p, const float* sq, int ldq,
                                          const float* skv, int ldk, const float* bias_s,
                                          float* sp, int M) {
  const int T = p.T, H = p.H, dh = p.d / H, total = M * H * kG;
  for (int base = 0; base < total; base += kThreads) {  // uniform: every lane shuffles
    const int idx = base + threadIdx.x, i = idx % kG, rh = idx / kG, r = rh / H, h = rh % H;
    const bool ok = idx < total && i < T;
    float s = -INFINITY;
    if (ok) {
      const float* qr = sq + r * ldq + h * dh;
      const float* kr = skv + (size_t)i * ldk + h * dh;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < dh; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + c);
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
        acc = fmaf(qv.x, kv.x, acc);
        acc = fmaf(qv.y, kv.y, acc);
        acc = fmaf(qv.z, kv.z, acc);
        acc = fmaf(qv.w, kv.w, acc);
      }
      s = bias_s ? acc + bias_s[(size_t)r * T + i] : acc;
    }
    float m = s;
#pragma unroll
    for (int o = 1; o < kG; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = ok ? expf(s - m) : 0.f;
    float l = e;
#pragma unroll
    for (int o = 1; o < kG; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (ok) sp[(size_t)rh * T + i] = e / l;
  }
}

static __global__ void __launch_bounds__(kThreads, 1) xa_audio_tc(const Params p, const Work w) {
  extern __shared__ __align__(16) uint8_t smem_xa_audio[];
  uint8_t* base = aligned_base(smem_xa_audio);
  const Smem sm = carve_base(base);
  const int T = p.T, Ta = p.Ta, d = p.d, H = p.H, dh = d / H, ldd = x_stride(d);
  const int tile = blockIdx.x, s = blockIdx.y, r0 = tile * kRows, M = min(kRows, Ta - r0);
  float* sq = reinterpret_cast<float*>(base + kBaseBytes);
  float* sa = sq + kRows * ldd;     // a
  float* sctx = sa + kRows * ldd;   // a2v context
  float* so = sctx + kRows * ldd;   // out-projection
  float* sa2 = so + kRows * ldd;    // a'
  const int ldk = 2 * d + 4;
  float* skv = sa2 + kRows * ldd;   // [T][ldk] the sample's a2v keys and values
  float* sp = skv + T * ldk;        // [rows][H][T] probabilities
  const size_t arow = (size_t)s * Ta + r0;
  // The out-projection's first chunks fly under the loads and the attention.
  const Lin op = make_lin(p.m[kA2vOutW], d, 0, d, d, p.v[kA2vOutB], so, ldd);
  tc_prefetch(sm, op);
  wait_for_previous();  // the video side's keys and values of v' (and, before it, the rows')
  stage_f32(w.qa + arow * d, d, M, d, sq, ldd);
  stage_f32(static_cast<const float*>(p.t[kATok]) + arow * d, d, M, d, sa, ldd);
  stage_f32(w.kvv + (size_t)s * T * 2 * d, 2 * d, T, 2 * d, skv, ldk);
  const float* bias_s = p.bias_mode == kBiasExternal
                            ? static_cast<const float*>(p.t[kBiasA2v]) + arow * T
                            : nullptr;
  __syncthreads();

  // a2v probabilities of each (row, head) over its sample's T keys.
  if (T <= 8)
    a2v_probs<8>(p, sq, ldd, skv, ldk, bias_s, sp, M);
  else
    a2v_probs<kMaxT>(p, sq, ldd, skv, ldk, bias_s, sp, M);
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const float* pr = sp + ((size_t)r * H + c / dh) * T;
    const float* vr = skv + d + c;
    float acc = 0.f;
    for (int i = 0; i < T; ++i) acc = fmaf(pr[i], vr[(size_t)i * ldk], acc);
    sctx[r * ldd + c] = acc;
  }
  tc_product_prefetched(sm, op, sctx, ldd, M);
  layer_norm_rows(so, ldd, sa, ldd, M, d, p.v[kAnS], p.v[kAnB], p.eps, sa2, ldd);
  __syncthreads();  // a' of every row
  float* part = w.part + ((size_t)s * audio_tiles(Ta) + tile) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < M; ++r) acc += sa2[r * ldd + c];
    part[c] = acc;
  }
}

// ---- (4) the audio mean pool ------------------------------------------------

static __global__ void __launch_bounds__(128) xa_pool(const Params p, const Work w) {
  const int s = blockIdx.x, tiles = audio_tiles(p.Ta), d = p.d;
  float* emb = static_cast<float*>(p.t[kOutA]) + (size_t)s * d;
  wait_for_previous();  // every tile's column sums
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc += w.part[((size_t)s * tiles + t) * d + c];
    emb[c] = acc / p.Ta;
  }
}

// ---- the launcher ------------------------------------------------------------

// Shapes this route takes (the same rule as `xattn.py::tensor_core_route`).
inline bool route_takes(const Params& p) {
  return p.T <= kMaxT && p.d % 32 == 0 && p.d <= 128 && p.H <= kMaxHeads &&
         (p.d / p.H) % 4 == 0 && rows_smem_bytes(p) <= kMaxSmem &&
         video_smem_bytes(p) <= kMaxSmem && audio_smem_bytes(p) <= kMaxSmem;
}

inline cudaError_t launch(const Params& p, cudaStream_t stream) {
  float* work = static_cast<float*>(p.t[kWork]);
  if (!route_takes(p) || (p.bias_mode != kBiasNone && p.bias_mode != kBiasExternal) ||
      work == nullptr)
    return cudaErrorInvalidValue;
  Work w;
  if (carve_work(p, work, &w) > (size_t)p.work_floats) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(work) & 15) return cudaErrorMisalignedAddress;
  // Each kernel may take a block's whole shared memory: set once for the device.
  static int configured_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != configured_device) {
    const void* fns[3] = {reinterpret_cast<const void*>(xa_rows_tc),
                          reinterpret_cast<const void*>(xa_video_tc),
                          reinterpret_cast<const void*>(xa_audio_tc)};
    for (int i = 0; i < 3; ++i) {
      err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
    }
    configured_device = device;
  }
  const int tiles = audio_tiles(p.Ta);
  xa_rows_tc<<<dim3(tiles + 1, 3, p.B), kThreads, rows_smem_bytes(p), stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The other three launch as programmatic dependents of the one before;
  // the video side in clusters of H blocks, one cluster a sample.
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = p.H;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.blockDim = dim3(kThreads);

  cfg.gridDim = dim3(p.H, p.B);
  cfg.dynamicSmemBytes = video_smem_bytes(p);
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, xa_video_tc, p, w);
  if (err != cudaSuccess) return err;

  cfg.gridDim = dim3(tiles, p.B);
  cfg.dynamicSmemBytes = audio_smem_bytes(p);
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, xa_audio_tc, p, w);
  if (err != cudaSuccess) return err;

  cfg.gridDim = dim3(p.B);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, xa_pool, p, w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace xattn_tc
}  // namespace emo
