// K4 on the tensor cores: the whole cross-attention fusion block cut along
// its row independence into four grid-wide launches, every Linear layer in
// TF32 with split products (3xTF32) on wgmma, at float32 accuracy.
// Included by `fused_block.cu`, which takes this route when
// `kernels/fused_block.py::tensor_core_route` says so (the shapes alone
// decide: T <= 16 video tokens, Ta >= 16 audio tokens, d a multiple of 32
// up to 128, head width a multiple of 4, tower widths multiples of 8,
// shared memory within a block's); the CUDA-core kernels of
// `fused_block.cu` keep every other shape.  K5 (`xattn.cu`) keeps
// `fusion.cuh`'s CUDA-core device code.
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
// Every Linear layer goes through `tc_product`, transposed: Y^T = W^T X^T,
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

namespace emo {
namespace fusion_tc {

using namespace emo::fusion;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;          // rows of a row tile
constexpr int kMaxCols = 128;      // columns of one product: two warpgroups of 64
constexpr int kChunk = 32;         // weight rows a chunk: one 128-byte column block of X
constexpr int kRingStages = 3;     // weight chunks in flight: the cp.async ring
constexpr int kRingBytes = kChunk * (kMaxCols * 4 + 16);  // one stage: 16,896
constexpr int kXRows = 32;         // rows of X a pass: wgmma's N
constexpr int kXBlockBytes = kXRows * 128;  // X's chunk block, hi or lo

// Shared memory every kernel starts with: X's double-buffered hi and lo
// chunk blocks, the ring of raw weight chunks.
constexpr int kBaseBytes = 4 * kXBlockBytes + kRingStages * kRingBytes;  // 67,072

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Row stride of an X tile of width k: conflict-free A fragments (4 mod 32).
__host__ __device__ constexpr int x_stride(int k) { return round_up(k, 32) + 4; }

// One product: Y[r * ldy + j] = act(X . W[:, col0 + j] + bias[j]) * mul for
// j < N, over the depth K, with W a [K', ldw] row-major weight (float32, or
// int8 with a float32 scale per column of the whole weight).  `bias` points
// at column col0 (or is null).
struct Lin {
  const void* w;
  const float* scale;
  const float* bias;
  float* y;
  int ldw, col0, N, K, ldy, act;
  float mul;
};

__host__ __device__ inline Lin make_lin(const Mat& m, int ldw, int col0, int N, int K,
                                        const float* bias, float* y, int ldy,
                                        int act = kActNone, float mul = 1.f) {
  Lin l;
  l.w = m.w;
  l.scale = m.scale;
  l.bias = bias;
  l.y = y;
  l.ldw = ldw;
  l.col0 = col0;
  l.N = N;
  l.K = K;
  l.ldy = ldy;
  l.act = act;
  l.mul = mul;
  return l;
}

// x = hi + lo, both TF32 (low 13 bits zero), each rounded to nearest with
// ties away from zero: the value `sm90::split_tf32` (cvt.rna) gives for
// every finite x, in two integer operations a part (the kernels split every
// operand in their inner loops).
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

struct Smem {  // the product machinery's shared memory
  uint8_t* ring;  // [kRingStages][kRingBytes] raw weight chunks, as they lie
  uint8_t* xs;    // [2 buffers][hi, lo][kXRows rows x 128 bytes] X's 32 columns of a chunk
};

// The dynamic shared memory rounded up to the swizzle's 1024-byte atoms
// (each kernel asks for 1 KB more than it carves).
__device__ __forceinline__ uint8_t* aligned_base(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ Smem carve_base(uint8_t* smem) {
  Smem s;
  s.xs = smem;  // 1024-byte aligned first: the swizzle's atoms
  s.ring = smem + 4 * kXBlockBytes;
  return s;
}

// How a product's weight is staged: chunks of kChunk rows (one 32-column
// block of X), each weight row as pieces of pb bytes (16, 8 or 4, copied by
// cp.async when the weight's rows and columns allow; else single int8
// bytes, copied by the thread) in a ring row of rs bytes (16 bytes of
// padding: conflict-free A fragments).
struct Plan {
  int elem, rs, pb, ppr, chunks;
};

__device__ inline Plan plan_for(const Lin& L) {
  Plan pl;
  pl.elem = L.scale ? 1 : 4;
  pl.rs = round_up(L.N * pl.elem, 16) + 16;
  const uintptr_t base = reinterpret_cast<uintptr_t>(L.w);
  pl.pb = pl.elem;
  for (int cand = 16; cand >= 4; cand /= 2) {
    if ((L.col0 * pl.elem) % cand == 0 && (L.ldw * pl.elem) % cand == 0 &&
        (L.N * pl.elem) % cand == 0 && base % cand == 0) {
      pl.pb = cand;
      break;
    }
  }
  pl.ppr = L.N * pl.elem / pl.pb;
  pl.chunks = round_up((L.K + kChunk - 1) / kChunk, 2);  // even: the loop takes two a turn
  return pl;
}

// Chunk c of the weight (rows at or past K as zeros) into ring stage
// c % kRingStages, in pieces of 8 or 4 bytes (`issue` takes 16-byte pieces);
// the caller commits the group.  The loop has a fixed trip count, so the
// copies issue back to back.
template <int PB>
__device__ __forceinline__ void issue_pieces(uint8_t* stage, const Plan& pl, const Lin& L, int c) {
  const uint8_t* w = static_cast<const uint8_t*>(L.w);
  const int pieces = kChunk * pl.ppr;
#pragma unroll
  for (int it = 0; it < (kChunk * kMaxCols * 4 / PB + kThreads - 1) / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (idx < pieces) {
      const int kk = idx / pl.ppr, j = idx - kk * pl.ppr, k = c * kChunk + kk;
      const bool ok = k < L.K;
      uint8_t* dst = stage + kk * pl.rs + j * PB;
      const uint8_t* src = w + ((size_t)(ok ? k : 0) * L.ldw + L.col0) * pl.elem + j * PB;
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(sm90::smem_u32(dst)),
                   "l"(src), "n"(PB), "r"(ok ? PB : 0)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void issue_chunk(const Smem& sm, const Plan& pl, const Lin& L, int c) {
  uint8_t* stage = sm.ring + (c % kRingStages) * kRingBytes;
  if (pl.pb == 8) {
    issue_pieces<8>(stage, pl, L, c);
  } else if (pl.pb == 4) {
    issue_pieces<4>(stage, pl, L, c);
  } else {  // an int8 weight whose rows are not 4-byte aligned: byte by byte
    const uint8_t* w = static_cast<const uint8_t*>(L.w);
    for (int idx = threadIdx.x; idx < kChunk * pl.ppr; idx += kThreads) {
      const int kk = idx / pl.ppr, j = idx - kk * pl.ppr, k = c * kChunk + kk;
      stage[kk * pl.rs + j] = k < L.K ? w[(size_t)k * L.ldw + L.col0 + j] : 0;
    }
  }
}

// This thread's 16-byte pieces of every chunk (at most four: a chunk of a
// float32 weight is 32 rows of at most 512 bytes), found once a product:
// byte offsets from the chunk's first weight row and in a ring stage, and
// the piece's row in the chunk (-1: no piece).
struct Pieces {
  int src[4], dst[4], kk[4];
};

__device__ __forceinline__ Pieces pieces_for(const Plan& pl, const Lin& L) {
  Pieces p;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int kk = idx / pl.ppr, j = idx - kk * pl.ppr;
    const bool ok = pl.pb == 16 && idx < kChunk * pl.ppr;
    p.kk[it] = ok ? kk : -1;
    p.src[it] = (kk * L.ldw + L.col0) * pl.elem + j * 16;
    p.dst[it] = kk * pl.rs + j * 16;
  }
  return p;
}

// Chunk c into ring stage c % kRingStages: 16-byte pieces from `pc`, else
// issue_chunk's general path.
__device__ __forceinline__ void issue(const Smem& sm, const Plan& pl, const Lin& L,
                                     const Pieces& pc, int c) {
  if (pl.pb != 16) {
    issue_chunk(sm, pl, L, c);
    return;
  }
  uint8_t* stage = sm.ring + (c % kRingStages) * kRingBytes;
  const uint8_t* w = static_cast<const uint8_t*>(L.w) + (size_t)c * kChunk * L.ldw * pl.elem;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    if (pc.kk[it] >= 0) {
      const bool ok = c * kChunk + pc.kk[it] < L.K;
      sm90::cp_async_16(stage + pc.dst[it], ok ? w + pc.src[it] : L.w, ok);
    }
  }
}

// Columns [32c, 32c + 32) of rows [r0, r0 + NR) of X (plain, row stride
// ldx) -> TF32 hi and lo in X buffer c % 2, K-major with the 128-byte
// swizzle wgmma reads (16-byte piece p of row r at p ^ (r % 8)); rows past
// M and columns past K as zeros.
template <int NR>
__device__ __forceinline__ void build_x(const Smem& sm, const float* X, int ldx, int M, int K,
                                        int r0, int c) {
  uint8_t* hi = sm.xs + (c & 1) * 2 * kXBlockBytes;
  uint8_t* lo = hi + kXBlockBytes;
  for (int idx = threadIdx.x; idx < NR * 8; idx += kThreads) {
    const int r = idx >> 3, p = idx & 7, k0 = c * kChunk + p * 4;
    const float* x = X + (size_t)(r0 + r) * ldx + k0;
    const bool row_ok = r0 + r < M;
    float4 h, l;
    split(row_ok && k0 < K ? x[0] : 0.f, h.x, l.x);
    split(row_ok && k0 + 1 < K ? x[1] : 0.f, h.y, l.y);
    split(row_ok && k0 + 2 < K ? x[2] : 0.f, h.z, l.z);
    split(row_ok && k0 + 3 < K ? x[3] : 0.f, h.w, l.w);
    const int at = r * 128 + ((p ^ (r & 7)) << 4);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// wgmma.m64n{16,32}k8 with A (64 x 8, TF32) from registers, as mma.sync's A
// fragment per warp: a = {(g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)};
// B (8 x NR) from shared memory.
template <int NR>
__device__ __forceinline__ void wgmma_ra(float (&d)[NR / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ra<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ra<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The state of one pass of a warpgroup over the chunks.
template <int NR>
struct Pass {
  int n_a, n_b;           // this thread's two output columns
  float sc_a, sc_b;       // their int8 scales
  uint64_t desc[2][2];    // X buffer b's hi and lo blocks, at column 0
  float total[NR / 2];    // the float32 total, folded every chunk
};

// One chunk's products for this warpgroup: A (the weight, 64 output
// columns x 32 of depth) from the ring into registers, split; then lo.hi,
// hi.lo, hi.hi for each of the four 8-deep steps into `acc` (scale-d off at
// the chunk's first: a chunk is 32 of depth, folded into the total later).
template <int NR>
__device__ __forceinline__ void chunk_products(const Smem& sm, const Plan& pl, const Lin& L,
                                               int c, const Pass<NR>& ps, uint32_t (&ah)[4][4],
                                               uint32_t (&al)[4][4], float (&acc)[NR / 2]) {
  const int q = threadIdx.x & 3;
  const uint8_t* stage = sm.ring + (c % kRingStages) * kRingBytes;
  const bool ok_a = ps.n_a < L.N, ok_b = ps.n_b < L.N;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k0 = ks * 8 + q, k1 = k0 + 4;
    float w[4];
    if (pl.elem == 4) {
      const float* r0f = reinterpret_cast<const float*>(stage + k0 * pl.rs);
      const float* r1f = reinterpret_cast<const float*>(stage + k1 * pl.rs);
      w[0] = ok_a ? r0f[ps.n_a] : 0.f;
      w[1] = ok_b ? r0f[ps.n_b] : 0.f;
      w[2] = ok_a ? r1f[ps.n_a] : 0.f;
      w[3] = ok_b ? r1f[ps.n_b] : 0.f;
    } else {  // int8, dequantised with the column's scale
      const int8_t* r0b = reinterpret_cast<const int8_t*>(stage + k0 * pl.rs);
      const int8_t* r1b = reinterpret_cast<const int8_t*>(stage + k1 * pl.rs);
      w[0] = ok_a ? static_cast<float>(r0b[ps.n_a]) * ps.sc_a : 0.f;
      w[1] = ok_b ? static_cast<float>(r0b[ps.n_b]) * ps.sc_b : 0.f;
      w[2] = ok_a ? static_cast<float>(r1b[ps.n_a]) * ps.sc_a : 0.f;
      w[3] = ok_b ? static_cast<float>(r1b[ps.n_b]) * ps.sc_b : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      split(w[i], h, l);
      ah[ks][i] = __float_as_uint(h);
      al[ks][i] = __float_as_uint(l);
    }
  }
  // The A registers are final before the fence: else the compiler inserts
  // its own fences, in branches, and serializes every wgmma.
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(ah[ks][i]), "+r"(al[ks][i])::"memory");
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
  const uint64_t xh = ps.desc[c & 1][0], xl = ps.desc[c & 1][1];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {  // a step is 32 bytes further: 2 in the descriptor's units
    wgmma_ra<NR>(acc, al[ks], xh + 2 * ks, ks > 0);  // W_lo . X_hi
    wgmma_ra<NR>(acc, ah[ks], xl + 2 * ks, 1);       // W_hi . X_lo
    wgmma_ra<NR>(acc, ah[ks], xh + 2 * ks, 1);       // W_hi . X_hi
  }
  sm90::wgmma_commit();
}

// Chunk c's turn: its weight and X's block c landed and visible, the ring
// refilled two chunks ahead, its products issued; then the previous chunk's
// products waited for and folded into the total.
template <int NR>
__device__ __forceinline__ void chunk_turn(const Smem& sm, const Plan& pl, const Lin& L,
                                           const Pieces& pc, const float* X, int ldx, int M,
                                           int r0, int c, Pass<NR>& ps, uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4], float (&acc)[NR / 2],
                                           float (&prev)[NR / 2]) {
  build_x<NR>(sm, X, ldx, M, L.K, r0, c);
  sm90::cp_async_wait<kRingStages - 2>();
  sm90::fence_proxy_async();
  __syncthreads();  // chunk c and X's block c for all; ring stage (c - 1) is free
  if (c + kRingStages - 1 < pl.chunks) issue(sm, pl, L, pc, c + kRingStages - 1);
  sm90::cp_async_commit();
  chunk_products<NR>(sm, pl, L, c, ps, ah, al, acc);
  sm90::wgmma_wait<1>();  // chunk c - 1's products are done (zeros before chunk 0)
  sm90::fence_regs(prev);
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) ps.total[i] += prev[i];  // 32 of depth: a float32 total
}

// The products of rows [r0, r0 + NR) of X with this warpgroup's 64 weight
// columns, chunk by chunk, and the epilogue.  Transposed: the weight is
// wgmma's A (64 output columns x 8 of depth, from registers: TF32 wgmma
// reads shared memory only K-major, and W lies [K, N]), X is B (K-major as
// it lies: a row of X is a column of B; m64n{16,32}k8, rows past M as
// zeros).  Chunk c + 1's weight loads and X block overlap chunk c's
// products: two register sets for A and for the accumulators, the chunk
// loop unrolled by 2 over an even count (no wgmma under a branch).
template <int NR>
__device__ __forceinline__ void product_rows(const Smem& sm, const Plan& pl, const Lin& L,
                                             const Pieces& pc, const float* X, int ldx, int M,
                                             int r0) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  Pass<NR> ps;
  ps.n_a = wg * 64 + warp * 16 + g;
  ps.n_b = ps.n_a + 8;
  // The columns' int8 scales and the epilogue's biases, loaded now: their
  // latency hides under the chunks.
  ps.sc_a = L.scale && ps.n_a < L.N ? L.scale[L.col0 + ps.n_a] : 1.f;
  ps.sc_b = L.scale && ps.n_b < L.N ? L.scale[L.col0 + ps.n_b] : 1.f;
  const float bias_a = L.bias && ps.n_a < L.N ? L.bias[ps.n_a] : 0.f;
  const float bias_b = L.bias && ps.n_b < L.N ? L.bias[ps.n_b] : 0.f;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ps.desc[b][h] = sm90::wgmma_desc(sm.xs + (2 * b + h) * kXBlockBytes, 16, 1024);
  float acc0[NR / 2], acc1[NR / 2];
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) acc0[i] = acc1[i] = ps.total[i] = 0.f;

  for (int c = 0; c < kRingStages - 1; ++c) {
    if (c < pl.chunks) issue(sm, pl, L, pc, c);
    sm90::cp_async_commit();
  }
  for (int c = 0; c < pl.chunks; c += 2) {
    chunk_turn<NR>(sm, pl, L, pc, X, ldx, M, r0, c, ps, ah0, al0, acc0, acc1);
    chunk_turn<NR>(sm, pl, L, pc, X, ldx, M, r0, c + 1, ps, ah1, al1, acc1, acc0);
  }
  sm90::wgmma_wait<0>();  // the last chunk's products
  sm90::fence_regs(acc1);
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) ps.total[i] += acc1[i];
  sm90::cp_async_wait<0>();
  if (wg * 64 < L.N) {
    // total[4j + e]: output column n_a (e < 2) or n_b, X row 8j + 2q + (e & 1).
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) {
      const int n = (i & 2) ? ps.n_b : ps.n_a, r = r0 + 8 * (i >> 2) + 2 * q + (i & 1);
      if (r < M && n < L.N) {
        const float y = ps.total[i] + ((i & 2) ? bias_b : bias_a);
        L.y[(size_t)r * L.ldy + n] = activate(y, L.act) * L.mul;
      }
    }
  }
}

// Y = act(X . W + bias) * mul: X [M, K] float32 in shared memory (row stride
// ldx; rows past M and columns past K are not read), N <= kMaxCols.  Every
// thread of the block calls it; it starts and ends with a barrier, so X and
// Y may be shared memory the caller just wrote or reads next.  The weight
// streams through the ring kRingStages - 1 chunks ahead of the products;
// up to 16 rows of X in one pass (wgmma's N = 16), more in passes of 32.
// Not inlined: each kernel holds one copy of the product machinery.
__device__ __noinline__ void tc_product(const Smem& sm, const Lin L, const float* X, int ldx,
                                        int M) {
  const Plan pl = plan_for(L);
  const Pieces pc = pieces_for(pl, L);
  __syncthreads();  // the caller's writes of X; the previous product's readers of sm
  if (M <= 16) {
    product_rows<16>(sm, pl, L, pc, X, ldx, M, 0);
    __syncthreads();  // the ring and X's blocks, for the next product
    return;
  }
  for (int r0 = 0; r0 < M; r0 += kXRows) {
    product_rows<32>(sm, pl, L, pc, X, ldx, M, r0);
    __syncthreads();  // the ring and X's blocks, for the next rows or product
  }
}

// One Linear layer: Y[:, :N] = act(X . W[:, col0 : col0 + N] + bias) * mul,
// in products of at most kMaxCols columns.
__device__ inline void tc_linear(const Smem& sm, const float* X, int ldx, int M, int K,
                                 const Mat& W, int ldw, int col0, int N, const float* bias,
                                 float* Y, int ldy, int act = kActNone, float mul = 1.f) {
  for (int n0 = 0; n0 < N; n0 += kMaxCols)
    tc_product(sm, make_lin(W, ldw, col0 + n0, min(kMaxCols, N - n0), K,
                            bias ? bias + n0 : nullptr, Y + n0, ldy, act, mul),
               X, ldx, M);
}

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
