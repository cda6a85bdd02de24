// Device code shared by the two forward kernels of the WavLM attention
// sublayer: K1 (`wavlm_attn.cu`, one block per batch element, head and query
// tile) and K6 (`wavlm_attn_tiled.cu`, one block per G batch elements).  Both
// run a query row through `attn_row`, the out-projection's 64 x 64 tile
// through `out_proj_stage_ctx` / `out_proj_slice`, and a pre-LayerNorm row
// through `wavlm_attn_ln`, so on the same operands they agree bit for bit.
#pragma once

#include "common.cuh"

namespace emo {

constexpr int kAttnWarps = 8;
constexpr int kAttnRows = 32;      // query rows per tile (4 per warp)
constexpr int kLnWarps = 8;        // rows per block of the LayerNorm pass
constexpr int kLnMaxPerLane = 32;  // E <= 1024
constexpr int kMaxSmem = 227 * 1024;
// The out-projection's tile: 64 x 64 outputs a block of 256 threads (each
// 4 x 4), the reduction in slices of 16.
constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

__device__ __forceinline__ bool row_valid(int row, int M, int Tp, int seq_len) {
  return row < M && (row % Tp) < seq_len;
}

// One query row of one head, by one warp.  K_h ([seq_len][ks_stride]) and V_h
// ([seq_len][dh]) are float32 in shared memory; `qs` ([dh]) and `ps`
// ([seq_len]) are the warp's own shared rows; `brow` is the head's bias row
// (device or shared memory).  s[j] = q . k_j + g * brow[j] over j < seq_len,
// float32 softmax, optional dropout from the stateless hash, p rounded to T,
// ctx = p . V written in T.
template <typename T>
__device__ __forceinline__ void attn_row(
    const T* __restrict__ q_row, T* __restrict__ ctx_row, const float* Ks,
    const float* Vs, float* qs, float* ps, const float* brow, float g,
    int seq_len, int dh, int ks_stride, int lane, unsigned stream,
    unsigned index0, unsigned attn_thr, float attn_inv) {
  for (int d = lane; d < dh; d += 32) qs[d] = to_f(q_row[d]);
  __syncwarp();

  float m = -3.402823466e38f;  // -FLT_MAX
  for (int j = lane; j < seq_len; j += 32) {
    const float* kr = Ks + j * ks_stride;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(qs[d], kr[d], s);
    s += g * brow[j];
    ps[j] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < seq_len; j += 32) {
    const float p = expf(ps[j] - m);
    ps[j] = p;
    l += p;
  }
  l = warp_sum(l);
  const float inv = 1.f / l;
  for (int j = lane; j < seq_len; j += 32) {
    float p = ps[j] * inv;
    if (attn_thr)
      p = hash_keep(stream, index0 + (unsigned)j, attn_thr) ? p * attn_inv : 0.f;
    ps[j] = round_to<T>(p);
  }
  __syncwarp();

  for (int d = lane; d < dh; d += 32) {
    float acc = 0.f;
    for (int j = 0; j < seq_len; ++j) acc = fmaf(ps[j], Vs[j * dh + d], acc);
    ctx_row[d] = from_f<T>(acc);
  }
  __syncwarp();  // qs / ps are rewritten for the warp's next row
}

// One slice of the out-projection's A operand: ctx[m0 .. m0 + kBM) x
// [k0 .. k0 + kBK) into As, transposed, zeros where `valid(row)` is false.
template <typename T, typename Valid>
__device__ __forceinline__ void out_proj_stage_ctx(
    float (*As)[kBM + 4], const T* __restrict__ ctx, int m0, int k0, int E,
    int tid, Valid valid) {
#pragma unroll
  for (int l = 0; l < (kBM * kBK) / kGemmThreads; ++l) {
    const int idx = tid + l * kGemmThreads;
    const int r = idx / kBK, c = idx % kBK;
    const int row = m0 + r, kk = k0 + c;
    As[c][r] = (kk < E && valid(row)) ? to_f(ctx[(size_t)row * E + kk]) : 0.f;
  }
}

// acc += As . Bs over one slice: `Bs` is the slice's kBK rows of the block's
// kBN columns of W_o, float32 in shared memory; thread (tx, ty) of 16 x 16
// owns outputs [ty*4, ty*4 + 4) x [tx*4, tx*4 + 4).
__device__ __forceinline__ void out_proj_slice(
    float (&acc)[4][4], float (*As)[kBM + 4], const float* Bs, int tx,
    int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * kBN + tx * 4 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// LayerNorm of the float32 pre-norm rows, one warp per row from registers,
// one write in T.  Rows at or past seq_len are skipped.
template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
wavlm_attn_ln(const float* __restrict__ proj, const float* __restrict__ lns,
              const float* __restrict__ lnb, T* __restrict__ out, int M, int Tp,
              int seq_len, int E, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (!row_valid(row, M, Tp, seq_len)) return;
  const float* x = proj + (size_t)row * E;
  float v[kLnMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < E ? x[c] : 0.f;
    s += v[i];
  }
  const float mean = warp_sum(s) / E;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < E) q += (v[i] - mean) * (v[i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / E + eps);
#pragma unroll
  for (int i = 0; i < kLnMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < E) out[(size_t)row * E + c] = from_f<T>((v[i] - mean) * rstd * lns[c] + lnb[c]);
  }
}

}  // namespace emo
