// K4: the whole cross-attention fusion block, from the two towers' outputs
// to the logits.
//
// Replaces the two TPU kernels of `multimodalemotionrecognition_tpu/ops/
// pallas_fused_block.py`: `_block_kernel` (one sample per program) and
// `_block_kernel_batched` (S samples per program), launched by
// `build_fused_block_fn`.  They compute the same function per sample, so one
// CUDA kernel with a samples-per-block parameter stands for both: a block
// walks over its samples one after the other.  Per sample, float32 whatever
// the towers' dtype (v_feat [T, Dv] and a_seq [Ta, Ds] are upcast on load):
//
//   v = v_feat W_vin + b                    a = (a_seq W_aseq + b) W_ain + b
//   optional emotion prior: prior = MLP([mean v, mean a]); per-token scores
//     s_x(tok) = tok . w_x[:d] + prior . w_x[d:] + b_x;
//     bias_v2a[i, j] = tanh(s_vq(v_i) + s_ak(a_j)) * scale, bias_a2v likewise
//   v' = LN(v + MHA(q = v, kv = a)),  a' = LN(a + MHA(q = a, kv = v'))
//   pool: mean over time, or softmax_t(Linear(GELU(Linear(LN(x))))) weights
//   head: MLP([v_emb, a_emb]), or g v_emb + (1 - g) a_emb -> Linear
//
// int8 matrices (weight-only, one float32 scale per output column) are
// dequantised where they are read (`fusion.cuh::linear`).
//
// What bounds it on an H100: ~60 MFLOP a sample (half of it a_seq W_aseq)
// and ~0.6 MB of float32 weights shared by all samples: under the ridge of
// both units at B <= 8, so it is bound by latency: a chain of ~20 dependent
// small products on few SMs.
//
// Design: two launches, no intermediate but the audio tokens and their three
// projections (4 x [B, Ta, d] float32, L2-resident) in device memory.
//  (a) fused_block_audio_tokens: one block per (16 audio rows, sample).  The
//      rows of a_seq (16 x 768 float32 = 48 KB) sit in shared memory; W_aseq
//      (393 KB, more than a block's shared memory) streams from L2 through
//      `linear`.  The block then applies W_ain and the three projections of
//      the audio tokens that do not depend on v' (v2a K and V, a2v Q).
//      10 x B blocks.
//  (b) fused_block_core: one block per `samples_per_block` samples.  Shared
//      memory holds v (8 rows), the score tiles, the a2v context and a'
//      ([Ta, d] each), the attention pool's hidden tile [Ta, d/2]: ~215 KB.
//      B <= 8 leaves >= 124 of 132 SMs idle in (b); accepted for now.

#include "fusion.cuh"

using namespace emo::fusion;

namespace {

using emo::to_f;

template <typename T>
__global__ void __launch_bounds__(kTileThreads) fused_block_audio_tokens(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int d = p.d, Ds = p.Ds, s = blockIdx.y, r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, p.Ta - r0);
  float* xs = smem;                  // [rows, Ds]
  float* h1 = xs + kTileRows * Ds;   // [rows, d]
  float* at = h1 + kTileRows * d;    // [rows, d]
  const T* x_g = static_cast<const T*>(p.t[kAIn]) + ((size_t)s * p.Ta + r0) * Ds;
  for (int idx = threadIdx.x; idx < rows * Ds; idx += blockDim.x) xs[idx] = to_f(x_g[idx]);
  __syncthreads();
  linear(xs, Ds, rows, Ds, p.m[kAseqW], d, 0, p.v[kAseqB], d, h1, d);
  __syncthreads();
  linear(h1, d, rows, d, p.m[kAinW], d, 0, p.v[kAinB], d, at, d);
  __syncthreads();
  const size_t off = ((size_t)s * p.Ta + r0) * d;
  float* a_g = static_cast<float*>(p.t[kATok]) + off;
  for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) a_g[idx] = at[idx];
  project_audio_rows(p, at, rows, static_cast<float*>(p.t[kKa]) + off,
                     static_cast<float*>(p.t[kVa]) + off,
                     static_cast<float*>(p.t[kQa]) + off);
}

// Small shared-memory vectors of the core kernel, after the Arena.
struct Scratch {
  float* mid;     // [Ta, pool_hidden]  attention pool's hidden tile
  float* both;    // [2d]  prior input [mean v, mean a]; later [v_emb, a_emb]
  float* hid;     // [max(prior_hidden, head_hidden, d)]
  float* fused;   // [d]   gated head's mix
  float* prior;   // [prior_dim]
  float* vq;      // [T]   prior token scores
  float* vk;      // [T]
  float* ak;      // [Ta]
  float* aq;      // [Ta]
  float* weight;  // [max(T, Ta)]  attention pool's softmax weights
  float* misc;    // [8]   the prior's four per-sample constants, the gate
};

__host__ __device__ inline int hid_floats(const Params& p) {
  int n = p.d;
  if (p.prior_hidden > n) n = p.prior_hidden;
  if (p.head_hidden > n) n = p.head_hidden;
  return (n + 3) / 4 * 4;
}

inline size_t core_floats(const Params& p) {
  const int longest = p.Ta > p.T ? p.Ta : p.T;
  return arena_floats(p) + (size_t)p.Ta * p.pool_hidden + 2 * p.d + hid_floats(p) +
         p.d + p.prior_dim + 2 * p.T + 2 * p.Ta + longest + 8;
}

__device__ __forceinline__ void carve_scratch(float* at, const Params& p, Scratch* sc) {
  sc->mid = at;
  sc->both = sc->mid + (size_t)p.Ta * p.pool_hidden;
  sc->hid = sc->both + 2 * p.d;
  sc->fused = sc->hid + hid_floats(p);
  sc->prior = sc->fused + p.d;
  sc->vq = sc->prior + p.prior_dim;
  sc->vk = sc->vq + p.T;
  sc->ak = sc->vk + p.T;
  sc->aq = sc->ak + p.Ta;
  sc->weight = sc->aq + p.Ta;
  sc->misc = sc->weight + (p.Ta > p.T ? p.Ta : p.T);
}

// EmotionPriorBiasAdapter: per-token query and key scores of both streams.
__device__ void prior_scores(const Params& p, const Arena& ar, const Scratch& sc,
                             const float* a_g) {
  const int T = p.T, Ta = p.Ta, d = p.d;
  mean_rows(ar.vtok, d, T, d, sc.both);
  mean_rows(a_g, d, Ta, d, sc.both + d);
  __syncthreads();
  linear(sc.both, 2 * d, 1, 2 * d, p.m[kEpP0W], p.prior_hidden, 0, p.v[kEpP0B],
         p.prior_hidden, sc.hid, p.prior_hidden, kActRelu);
  __syncthreads();
  linear(sc.hid, p.prior_hidden, 1, p.prior_hidden, p.m[kEpP3W], p.prior_dim, 0,
         p.v[kEpP3B], p.prior_dim, sc.prior, p.prior_dim);
  __syncthreads();
  // The score weights are [d + prior_dim, 1]: a token part and, from rows d
  // on, a part that is one constant per sample.
  if (threadIdx.x < 4) {
    const Mat w = p.m[kEpVqW + threadIdx.x];
    float c = p.v[kEpVqB + threadIdx.x][0];
    for (int k = 0; k < p.prior_dim; ++k) c = fmaf(sc.prior[k], mat_at(w, d + k, 0), c);
    sc.misc[threadIdx.x] = c;
  }
  __syncthreads();
  row_dots(ar.vtok, d, T, d, p.m[kEpVqW], sc.misc[0], sc.vq);
  row_dots(a_g, d, Ta, d, p.m[kEpAkW], sc.misc[1], sc.ak);
  row_dots(a_g, d, Ta, d, p.m[kEpAqW], sc.misc[2], sc.aq);
  row_dots(ar.vtok, d, T, d, p.m[kEpVkW], sc.misc[3], sc.vk);
  __syncthreads();
}

// TemporalAttentionPooling of x [rows, d] -> emb [d]; `tmp` [rows, d] holds
// the LayerNorm's output.
__device__ void attn_pool(const Params& p, const Scratch& sc, const float* x, int rows,
                          float* tmp, int ln_s, int ln_b, int w1, int b1, int w2,
                          int b2, float* emb) {
  const int d = p.d, ph = p.pool_hidden;
  layer_norm_rows(x, d, nullptr, 0, rows, d, p.v[ln_s], p.v[ln_b], p.eps, tmp, d);
  __syncthreads();
  linear(tmp, d, rows, d, p.m[w1], ph, 0, p.v[b1], ph, sc.mid, ph, kActGelu);
  __syncthreads();
  row_dots(sc.mid, ph, rows, ph, p.m[w2], p.v[b2][0], sc.weight);
  __syncthreads();
  if (threadIdx.x < 32) softmax_row(sc.weight, rows);
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s = fmaf(x[(size_t)r * d + c], sc.weight[r], s);
    emb[c] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kCoreThreads) fused_block_core(const Params p) {
  extern __shared__ __align__(16) float smem[];
  Arena ar;
  Scratch sc;
  carve_scratch(carve_arena(smem, p, &ar), p, &sc);
  const int Tv = p.T, Ta = p.Ta, d = p.d, Dv = p.Dv;
  const int first = blockIdx.x * p.samples_per_block;
  const int last = min(p.B, first + p.samples_per_block);
  for (int s = first; s < last; ++s) {
    const float* a_g = static_cast<const float*>(p.t[kATok]) + (size_t)s * Ta * d;

    // Video tokens: v_feat (staged in big0, upcast) times W_vin.
    const T* vf = static_cast<const T*>(p.t[kVIn]) + (size_t)s * Tv * Dv;
    for (int idx = threadIdx.x; idx < Tv * Dv; idx += blockDim.x) ar.big0[idx] = to_f(vf[idx]);
    __syncthreads();
    linear(ar.big0, Dv, Tv, Dv, p.m[kVinW], d, 0, p.v[kVinB], d, ar.vtok, d);
    __syncthreads();

    AttnBias bias = {};
    bias.mode = p.bias_mode;
    if (p.bias_mode == kBiasPrior) {
      prior_scores(p, ar, sc, a_g);
      bias.vq = sc.vq; bias.ak = sc.ak; bias.aq = sc.aq; bias.vk = sc.vk;
      bias.scale = p.v[kEpScale][0];
    }
    bidirectional_attention(p, ar, bias, s);  // v' in vtok, a' in big1

    if (p.pooling == kPoolAttn) {
      attn_pool(p, sc, ar.vtok, Tv, ar.vt1, kVpLnS, kVpLnB, kVpW1, kVpB1, kVpW2, kVpB2,
                sc.both);
      attn_pool(p, sc, ar.big1, Ta, ar.big0, kApLnS, kApLnB, kApW1, kApB1, kApW2, kApB2,
                sc.both + d);
    } else {
      mean_rows(ar.vtok, d, Tv, d, sc.both);
      mean_rows(ar.big1, d, Ta, d, sc.both + d);
      __syncthreads();
    }

    float* logits = static_cast<float*>(p.t[kOut]) + (size_t)s * p.C;
    if (p.head == kHeadConcat) {
      linear(sc.both, 2 * d, 1, 2 * d, p.m[kHW1], p.head_hidden, 0, p.v[kHB1],
             p.head_hidden, sc.hid, p.head_hidden, kActRelu);
      __syncthreads();
      linear(sc.hid, p.head_hidden, 1, p.head_hidden, p.m[kHW2], p.C, 0, p.v[kHB2], p.C,
             logits, p.C);
    } else {
      linear(sc.both, 2 * d, 1, 2 * d, p.m[kGW1], d, 0, p.v[kGB1], d, sc.hid, d, kActRelu);
      __syncthreads();
      row_dots(sc.hid, d, 1, d, p.m[kGW2], p.v[kGB2][0], sc.misc + 4);
      __syncthreads();
      const float g = 1.f / (1.f + expf(-sc.misc[4]));
      for (int c = threadIdx.x; c < d; c += blockDim.x)
        sc.fused[c] = g * sc.both[c] + (1.f - g) * sc.both[d + c];
      __syncthreads();
      linear(sc.fused, d, 1, d, p.m[kCW], p.C, 0, p.v[kCB], p.C, logits, p.C);
    }
    __syncthreads();  // shared memory is rewritten for the block's next sample
  }
}

template <typename T>
int launch(const void* const* ptrs, int n_ptrs, const int* ints, int n_ints, float eps,
           float qscale, void* stream_ptr) {
  Params p;
  if (!unpack(ptrs, n_ptrs, ints, n_ints, eps, qscale, &p) ||
      p.bias_mode == kBiasExternal || p.Dv < 1 || p.Ds < 1 || p.C < 1 ||
      (size_t)p.T * p.Dv > (size_t)p.Ta * p.d)  // v_feat is staged in big0
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const size_t smem_a = sizeof(float) * kTileRows * ((size_t)p.Ds + 2 * p.d);
  const size_t smem_b = sizeof(float) * core_floats(p);
  if (smem_a > kMaxSmem || smem_b > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_audio_tokens<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_block_core<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;

  dim3 grid_a((p.Ta + kTileRows - 1) / kTileRows, p.B);
  fused_block_audio_tokens<T><<<grid_a, kTileThreads, smem_a, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (p.B + p.samples_per_block - 1) / p.samples_per_block;
  fused_block_core<T><<<blocks, kCoreThreads, smem_b, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int emo_fused_block_f32(const void* const* ptrs, int n_ptrs, const int* ints,
                                   int n_ints, float eps, float qscale, void* stream) {
  return launch<float>(ptrs, n_ptrs, ints, n_ints, eps, qscale, stream);
}

extern "C" int emo_fused_block_bf16(const void* const* ptrs, int n_ptrs, const int* ints,
                                    int n_ints, float eps, float qscale, void* stream) {
  return launch<__nv_bfloat16>(ptrs, n_ptrs, ints, n_ints, eps, qscale, stream);
}
