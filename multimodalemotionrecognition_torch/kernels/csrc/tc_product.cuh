// The tensor-core product of the cross-attention fusion kernels: one Linear
// layer Y = act(X . W + bias) * mul on a block's few rows of X, in TF32 with
// split products (3xTF32) on wgmma, at float32 accuracy.  Used by K4's
// tensor-core route (`fused_block_tc.cuh`) and K5's (`xattn_tc.cuh`); the
// design note is `fused_block_tc.cuh`'s.  Every function is inline, a
// template or static: the header is included by more than one source.
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
template <int NR, bool kPrefetched = false>
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

  if constexpr (!kPrefetched) {  // else `tc_prefetch` issued them
    for (int c = 0; c < kRingStages - 1; ++c) {
      if (c < pl.chunks) issue(sm, pl, L, pc, c);
      sm90::cp_async_commit();
    }
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
static __device__ __noinline__ void tc_product(const Smem& sm, const Lin L, const float* X, int ldx,
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

// The first kRingStages - 1 chunks of L's weight into the ring, as a
// product's first pass issues them, ahead of `tc_product_prefetched` with the
// same L: the weight's first loads then overlap the caller's work in
// between, which must leave the ring alone.  Every thread of the block calls
// it, after the previous product has returned.
__device__ __forceinline__ void tc_prefetch(const Smem& sm, const Lin& L) {
  const Plan pl = plan_for(L);
  const Pieces pc = pieces_for(pl, L);
  for (int c = 0; c < kRingStages - 1; ++c) {
    if (c < pl.chunks) issue(sm, pl, L, pc, c);
    sm90::cp_async_commit();
  }
}

// `tc_product` of M <= 16 rows (N <= kMaxCols) whose weight's first chunks
// `tc_prefetch(sm, L)` issued.
static __device__ __noinline__ void tc_product_prefetched(const Smem& sm, const Lin L,
                                                          const float* X, int ldx, int M) {
  const Plan pl = plan_for(L);
  const Pieces pc = pieces_for(pl, L);
  __syncthreads();  // the caller's writes of X
  product_rows<16, true>(sm, pl, L, pc, X, ldx, M, 0);
  __syncthreads();  // the ring and X's blocks, for the next product
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

}  // namespace fusion_tc
}  // namespace emo
