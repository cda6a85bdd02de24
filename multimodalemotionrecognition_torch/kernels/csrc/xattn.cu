// K5: the bidirectional cross-attention core of the fusion block.
//
// Replaces the TPU kernel `multimodalemotionrecognition_tpu/ops/
// pallas_xattn.py::_fused_kernel` (launched by `fused_bidirectional_xattn`).
// Per batch element, from video tokens v [T, d] and audio tokens a [Ta, d]
// (T = 8, Ta = 149, d = 128, 4 heads at the serving shapes), float32:
//
//   v' = LN(v + MHA(q = v, kv = a)  [+ bias v2a [T, Ta]])
//   a' = LN(a + MHA(q = a, kv = v') [+ bias a2v [Ta, T]])
//   v_emb = mean_T(v')      a_emb = mean_Ta(a')
//
// What bounds it on an H100: ~21 MFLOP and ~0.1 MB a sample, far under the
// ridge of either unit, so it is bound by latency: the chain of dependent
// small products, and how many SMs work at all at B <= 8.
//
// Design (`fusion.cuh` has the shared device functions): two launches.
//  (a) xattn_audio_proj: one block per (16 audio rows, sample) projects the
//      audio tokens to the v2a keys and values and the a2v queries, the three
//      products that do not depend on v'; 10 x B blocks instead of B.
//  (b) xattn_core: one block per sample keeps v, the score tiles, the a2v
//      context and a' in shared memory (~170 KB) and runs the rest of the
//      chain; weights are read from L2 as they lie.  B <= 8 leaves >= 124 of
//      132 SMs idle in (b); accepted for now.

#include "fusion.cuh"

using namespace emo::fusion;

namespace {

__global__ void __launch_bounds__(kTileThreads) xattn_audio_proj(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int d = p.d, s = blockIdx.y, r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, p.Ta - r0);
  const size_t off = ((size_t)s * p.Ta + r0) * d;
  const float* a_g = static_cast<const float*>(p.t[kATok]) + off;
  for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) smem[idx] = a_g[idx];
  __syncthreads();
  project_audio_rows(p, smem, rows, static_cast<float*>(p.t[kKa]) + off,
                     static_cast<float*>(p.t[kVa]) + off,
                     static_cast<float*>(p.t[kQa]) + off);
}

__global__ void __launch_bounds__(kCoreThreads) xattn_core(const Params p) {
  extern __shared__ __align__(16) float smem[];
  Arena ar;
  carve_arena(smem, p, &ar);
  const int T = p.T, Ta = p.Ta, d = p.d, s = blockIdx.x;
  const float* v_g = static_cast<const float*>(p.t[kVIn]) + (size_t)s * T * d;
  for (int idx = threadIdx.x; idx < T * d; idx += blockDim.x) ar.vtok[idx] = v_g[idx];
  AttnBias bias = {};
  bias.mode = p.bias_mode;
  if (p.bias_mode == kBiasExternal) {
    bias.v2a = static_cast<const float*>(p.t[kBiasV2a]) + (size_t)s * T * Ta;
    bias.a2v = static_cast<const float*>(p.t[kBiasA2v]) + (size_t)s * Ta * T;
  }
  __syncthreads();
  bidirectional_attention(p, ar, bias, s);
  mean_rows(ar.vtok, d, T, d, static_cast<float*>(p.t[kOutV]) + (size_t)s * d);
  mean_rows(ar.big1, d, Ta, d, static_cast<float*>(p.t[kOutA]) + (size_t)s * d);
}

}  // namespace

extern "C" int emo_xattn(const void* const* ptrs, int n_ptrs, const int* ints,
                         int n_ints, float eps, float qscale, void* stream_ptr) {
  Params p;
  if (!unpack(ptrs, n_ptrs, ints, n_ints, eps, qscale, &p) ||
      (p.bias_mode != kBiasNone && p.bias_mode != kBiasExternal))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  const size_t smem_a = sizeof(float) * kTileRows * p.d;
  const size_t smem_b = sizeof(float) * arena_floats(p);
  if (smem_a > kMaxSmem || smem_b > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xattn_audio_proj, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(xattn_core, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;

  dim3 grid_a((p.Ta + kTileRows - 1) / kTileRows, p.B);
  xattn_audio_proj<<<grid_a, kTileThreads, smem_a, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xattn_core<<<p.B, kCoreThreads, smem_b, stream>>>(p);
  return cudaGetLastError();
}
