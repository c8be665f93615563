// Tensor-core flash-attention tile for NVIDIA Hopper (sm_90a), shared by
// the bf16 prefill kernels of residual_attention.cu (#7),
// paged_residual_attention.cu (#6, #3) and paged_residual_disagg.cu (#5),
// and by #2's split-K decode there: the MMA and softmax steps, the
// rebuild of K = K_b + RoPE(K_r . B_k) on the tensor cores (#7, #5; its
// MMA part for #2), the int8 pages' dequantization to bf16 (#6, #3,
// #5, #2), and head rows narrower than their tile (``Cols``: head_dim 120
// in D 128's tile, #7 and #8, the paged tiles of #6, #3, #5 and #1, and
// #2's group tile).
//
// A CTA holds kRows = 128 query rows, 16 per warp of its 8: on the H100
// both kernels ran faster so than with 4 warps (64 rows), which load (and
// for #7 rebuild) each key block twice as often
// (scripts/mma_tile_variants.py, PERF.md §6).  Every product runs on the
// tensor cores as mma.sync.m16n8k16 with bf16 operands and f32
// accumulators; operands come from shared memory through ldmatrix, whose
// rows are padded by kPad elements so the eight row addresses of one 8x8
// matrix fall in distinct banks.  The softmax state stays in
// registers: in the m16n8 accumulator layout a thread holds rows
// lane/4 and lane/4 + 8 of its warp's 16 and columns 2*(lane%4) + {0,1}
// of every 8-wide n-tile, so a row's max and sum take two quad shuffles.
//
// Rounding points (held on the CPU by tests/test_torch_mma_rounding.py):
// scores and both accumulators are f32; P is rounded to bf16 where it
// becomes an A operand (scores -> P . V, acc_r -> acc_r . B_v); the row
// sum l is taken over the f32 P.
#pragma once

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;     // query rows per CTA
constexpr int kPad = 8;                // bf16 elements of padding per row
constexpr int kMaxRank = 64;           // LoRA rank of the largest RP instance
constexpr float kNegInit = -1e30f;     // running max before any key
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; ``valid`` false zero-fills the 16 bytes
// and reads nothing (``src`` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a . b for one m16n8k16 tile: a row-major 16x16, b column-major
// 16x8, both bf16; c f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q . K^T for one warp: q points at the warp's 16 rows (stride ``qs``
// elements), k at BK key rows (stride ``ks``), both D wide.
template <int D, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const bf16* q,
                                       int qs, const bf16* k, int ks,
                                       int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, q + (lane & 15) * qs + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n2 = 0; n2 < BK / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4(b, k + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ks +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * n2], a, b[0], b[1]);
      mma(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// The warp's 16 rows of Q (stride ``qs``) as A fragments, one per 16
// columns, for ``scores`` to keep in registers across key blocks.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4],
                                       const bf16* q, int qs, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], q + (lane & 15) * qs + kk * 16 + (lane >> 4) * 8);
}

// S = Q . K^T as ``scores`` above, with Q's fragments in registers.
template <int D, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const uint32_t (&qf)[D / 16][4],
                                       const bf16* k, int ks, int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < BK / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4(b, k + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ks +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * n2], qf[kk], b[0], b[1]);
      mma(s[2 * n2 + 1], qf[kk], b[2], b[3]);
    }
}

// c += A . B for one warp, with A (16 x K) given as f32 accumulator
// fragments (K/8 n-tiles), rounded here to bf16 A fragments, and B
// (K x N) row-major in shared memory with row stride ``bs`` (read
// transposed by ldmatrix; N a multiple of 8: an odd last n-tile, as at
// #8's D 32 quarter of 8 columns, takes an x2 load).
template <int K, int N>
__device__ __forceinline__ void product(float (&c)[N / 8][4],
                                        const float (&a)[K / 8][4],
                                        const bf16* b, int bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t af[4] = {
        pack_bf16(a[2 * kk][0], a[2 * kk][1]),
        pack_bf16(a[2 * kk][2], a[2 * kk][3]),
        pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
        pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
    const bf16* row =
        b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * bs +
        (lane >> 4) * 8;
#pragma unroll
    for (int n2 = 0; n2 < N / 16; ++n2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, row + n2 * 16);
      mma(c[2 * n2], af, bf[0], bf[1]);
      mma(c[2 * n2 + 1], af, bf[2], bf[3]);
    }
    if constexpr (N % 16 == 8) {
      uint32_t bf[2];
      ldmatrix_x2_trans(
          bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * bs + N - 8);
      mma(c[N / 8 - 1], af, bf[0], bf[1]);
    }
  }
}

// Masks the scores of key block j0 for the thread's two rows (positions
// pos[0], pos[1]): key kpos is seen iff kpos < klimit, kpos <= pos when
// ``causal``, and kpos > pos - window when ``window`` > 0.
template <int BK>
__device__ __forceinline__ void mask(float (&s)[BK / 8][4], int j0,
                                     const int (&pos)[2], int klimit,
                                     bool causal, int window, int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = j0 + n * 8 + 2 * (lane & 3) + (i & 1);
      const int qp = pos[i >> 1];
      bool seen = kpos < klimit;
      if (causal) seen = seen && kpos <= qp;
      if (window > 0) seen = seen && kpos > qp - window;
      if (!seen) s[n][i] = -CUDART_INF_F;
    }
}

// The online-softmax step for one key block: turns s (raw scores) into
// P = exp(scale * s - m) in f32, updates the running max m (kept in the
// exp2 domain, scale * log2(e) folded in) and the thread's partial row
// sum l, and returns in alpha = exp(m_old - m_new) the factor by which
// the accumulators are to be rescaled (``rescale``).
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             float scale_log2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * scale_log2);
    alpha[h] = exp2f(m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(s[n][2 * h + e], scale_log2, -m_new));
        s[n][2 * h + e] = p;
        sum += p;
      }
    l[h] = l[h] * alpha[h] + sum;
    m[h] = m_new;
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// Sums the quad's partial row sums.
__device__ __forceinline__ void finish_rowsum(float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// x * c + y * s with each product rounded on its own (no FMA): the plain
// version's f32 operations in RoPE
__device__ __forceinline__ float rot(float x, float c, float y, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

// K_r . B_k for 16 keys and the n-tile pair (j, j + D/16): in the m16n8
// accumulator layout x1 holds columns 8 j + 2 (lane % 4) + {0, 1} of keys
// lane / 4 and lane / 4 + 8, and x2 the same columns + D/2, so RoPE
// rotates in registers.  kr: the 16 keys' rows (stride ``rs``, RP columns,
// zero from R on); bk: B_k's RP rows (stride ``bks``).
template <int D, int RP>
__device__ __forceinline__ void lora_pair(float (&x1)[4], float (&x2)[4],
                                          const bf16* kr, int rs,
                                          const bf16* bk, int bks, int j,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x1[i] = x2[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < RP / 16; ++kk) {
    uint32_t af[4], bf[2];
    ldmatrix_x4(af, kr + (lane & 15) * rs + kk * 16 + (lane >> 4) * 8);
    const bf16* brow =
        bk + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * bks + 8 * j;
    ldmatrix_x2_trans(bf, brow);
    mma(x1, af, bf[0], bf[1]);
    ldmatrix_x2_trans(bf, brow + D / 2);
    mma(x2, af, bf[0], bf[1]);
  }
}

// K = K_b + RoPE(K_r . B_k) in place for BK keys: k holds the keys' K_b
// rows (stride ``ks``) on entry, kr their K_r rows, sn/cs their sin/cos
// rows (stride ``hs``).  Items of 16 keys x an n-tile pair (``lora_pair``)
// are spread over the CTA's warps; K_b is added in f32 and the sum
// rounded once to bf16, where the plain version rounds.
template <int D, int BK, int RP>
__device__ __forceinline__ void rebuild_k(bf16* k, int ks, const bf16* kr,
                                          int rs, const bf16* bk, int bks,
                                          const bf16* sn, const bf16* cs,
                                          int hs, int warp, int lane) {
  for (int item = warp; item < (BK / 16) * (D / 16); item += kWarps) {
    const int mt = item / (D / 16), j = item % (D / 16);
    float x1[4], x2[4];
    lora_pair<D, RP>(x1, x2, kr + mt * 16 * rs, rs, bk, bks, j, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = mt * 16 + (lane >> 2) + 8 * hh;
      const int i = 8 * j + 2 * (lane & 3);
      const float2 s = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sn + t * hs + i));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(cs + t * hs + i));
      __nv_bfloat162* k1 = reinterpret_cast<__nv_bfloat162*>(k + t * ks + i);
      __nv_bfloat162* k2 =
          reinterpret_cast<__nv_bfloat162*>(k + t * ks + i + D / 2);
      const float2 b1 = __bfloat1622float2(*k1);
      const float2 b2 = __bfloat1622float2(*k2);
      // the plain version's f32 operations, uncontracted: k_b + (x1 cos -
      // x2 sin) and k_b + (x2 cos + x1 sin), each product rounded
      *k1 = __floats2bfloat162_rn(
          b1.x + rot(x1[2 * hh], c.x, x2[2 * hh], -s.x),
          b1.y + rot(x1[2 * hh + 1], c.y, x2[2 * hh + 1], -s.y));
      *k2 = __floats2bfloat162_rn(
          b2.x + rot(x2[2 * hh], c.x, x1[2 * hh], s.x),
          b2.y + rot(x2[2 * hh + 1], c.y, x1[2 * hh + 1], s.y));
    }
  }
}

// int8 pages: bf16(code * scale) of ``rows`` rows of D int8 codes
// (contiguous) with one f32 scale per row, into bf16 rows of stride
// ``ds``, where the plain version rounds (its gather: (kb.f32 *
// ks).to(q.dtype)); thread ``tid`` of ``nthreads`` takes every nthreads-th
// group of 8 codes.
template <int D>
__device__ __forceinline__ void dequantize_rows(const unsigned char* codes,
                                                const float* scales,
                                                bf16* dst, int ds, int rows,
                                                int tid, int nthreads) {
  for (int e = tid; e < rows * (D / 8); e += nthreads) {
    const int t = e / (D / 8), c = e % (D / 8);
    const uint2 raw = *reinterpret_cast<const uint2*>(codes + t * D + c * 8);
    const float sc = scales[t];
    // bytes 2i and 2i + 1 of the eight codes -> one bf16 pair
    auto pair = [&](uint32_t word, int shift) {
      return pack_bf16(__fmul_rn((float)(int8_t)(word >> shift), sc),
                       __fmul_rn((float)(int8_t)(word >> (shift + 8)), sc));
    };
    *reinterpret_cast<uint4*>(dst + t * ds + c * 8) =
        make_uint4(pair(raw.x, 0), pair(raw.x, 16), pair(raw.y, 0),
                   pair(raw.y, 16));
  }
}

// Head rows of DR elements in a tile D columns wide (#7 and #8; the paged
// tiles #6, #3, #5, #1 and #2's group tile).  DR == D: the row as it is,
// in 16-byte copies.  DR < D (head_dim 120 in D 128's tile): the
// split-half layout.  RoPE pairs column c with c + DR/2 and the tile's code
// pairs c with c + D/2, so the real columns [0, DR/2) go to [0, DR/2) and
// [DR/2, DR) to [D/2, D/2 + DR/2); the kGap columns after each half hold
// zeros (``zero_gaps``), add nothing to Q . K^T and are never stored
// (``store_cols``).  A half of 60 elements starts at byte 120 of its row,
// which a 16-byte copy cannot address, so at DR < D every copy is 8 bytes.
// sin/cos rows of DR/2 elements fill the first DR/2 of the tile's D/2
// columns.  int8 pages: a head row is DR codes, copied as they are into a
// staging row D bytes wide (16-byte copies; 8-byte at DR < D, since a row
// starts at a multiple of 120 bytes), and dequantized into the tile by
// ``dequantize_cols``.
template <int D, int DR>
struct Cols {
  static_assert(DR == D || (DR < D && (DR / 2) % 4 == 0 && (D - DR) % 4 == 0),
                "split halves of whole 8-byte copies");
  static constexpr int kVec = DR == D ? 8 : 4;     // elements per copy
  static constexpr int kRow = DR / kVec;           // copies per head row
  static constexpr int kHalf = DR / 2 / kVec;      // copies per sin/cos row
  static constexpr int kGap = (D - DR) / 2;        // zero columns per half
  static constexpr int kCodeVec = DR == D ? 16 : 8;  // int8 codes per copy
  static constexpr int kCodeRow = DR / kCodeVec;     // copies per code row

  // the tile column of a head row's element e
  __device__ static __forceinline__ int col(int e) {
    return e < DR / 2 ? e : e + kGap;
  }
  // is tile column c one of the gap columns?
  __device__ static __forceinline__ bool gap(int c) {
    return kGap > 0 && ((c >= DR / 2 && c < D / 2) || c >= D / 2 + DR / 2);
  }
  // the head row's element at tile column c; -1 for a gap column
  __device__ static __forceinline__ int elem(int c) {
    return gap(c) ? -1 : c < D / 2 ? c : c - kGap;
  }
  // copy i (of kCodeRow) of a row of DR int8 codes at src into the
  // staging row at dst
  __device__ static __forceinline__ void codes(unsigned char* dst,
                                               const int8_t* src, int i,
                                               bool ok) {
    if constexpr (kCodeVec == 16)
      cp_async16(dst + i * 16, src + i * 16, ok);
    else
      cp_async8(dst + i * 8, src + i * 8, ok);
  }
  __device__ static __forceinline__ void copy(bf16* dst, const bf16* src,
                                              bool ok) {
    if constexpr (kVec == 8)
      cp_async16(dst, src, ok);
    else
      cp_async8(dst, src, ok);
  }
  // copy i (of kRow) of the head row at src into the tile row at dst
  __device__ static __forceinline__ void row(bf16* dst, const bf16* src,
                                             int i, bool ok) {
    copy(dst + col(i * kVec), src + i * kVec, ok);
  }
  // copy i (of kHalf) of the sin/cos row at src into the tile row at dst
  __device__ static __forceinline__ void half(bf16* dst, const bf16* src,
                                              int i, bool ok) {
    copy(dst + i * kVec, src + i * kVec, ok);
  }
  // zero the gap columns of ``rows`` head rows (stride ``stride``), and
  // of ``rows`` sin/cos rows (columns DR/2..D/2-1, stride ``hs``); thread
  // ``tid`` of ``n``
  __device__ static void zero_gaps(bf16* base, int rows, int stride, int tid,
                                   int n) {
    if constexpr (kGap > 0)
      for (int e = tid; e < rows * 2 * kGap; e += n) {
        const int r = e / (2 * kGap), j = e % (2 * kGap);
        base[r * stride +
             (j < kGap ? DR / 2 + j : D / 2 + DR / 2 + j - kGap)] =
            __float2bfloat16(0.f);
      }
  }
  __device__ static void zero_table_gaps(bf16* base, int rows, int hs,
                                         int tid, int n) {
    if constexpr (kGap > 0)
      for (int e = tid; e < rows * kGap; e += n)
        base[(e / kGap) * hs + DR / 2 + e % kGap] = __float2bfloat16(0.f);
  }
};

// ``dequantize_rows`` for staging rows of DR codes (stride D bytes) into
// tile rows D wide (``Cols``).  DR == D: groups of 8 codes, as there.  DR
// < D: the second half starts at code DR/2 (60: only 4-byte aligned), so
// the codes go in groups of 4 (one 4-byte load, two bf16 pairs), which
// never straddle a half; each lands at its tile column (``Cols::col``).
// The gap columns are not written: the caller zeroes them once.
template <int D, int DR>
__device__ __forceinline__ void dequantize_cols(const unsigned char* codes,
                                                const float* scales,
                                                bf16* dst, int ds, int rows,
                                                int tid, int nthreads) {
  if constexpr (DR == D) {
    dequantize_rows<D>(codes, scales, dst, ds, rows, tid, nthreads);
  } else {
    for (int e = tid; e < rows * (DR / 4); e += nthreads) {
      const int t = e / (DR / 4), u = 4 * (e % (DR / 4));
      const uint32_t raw =
          *reinterpret_cast<const uint32_t*>(codes + t * D + u);
      const float sc = scales[t];
      *reinterpret_cast<uint2*>(dst + t * ds + Cols<D, DR>::col(u)) =
          make_uint2(
              pack_bf16(__fmul_rn((float)(int8_t)raw, sc),
                        __fmul_rn((float)(int8_t)(raw >> 8), sc)),
              pack_bf16(__fmul_rn((float)(int8_t)(raw >> 16), sc),
                        __fmul_rn((float)(int8_t)(raw >> 24), sc)));
    }
  }
}

// ``store_rows`` for the tile columns [c0, c0 + N) of head rows of DR
// elements in a tile D wide (``Cols``): dst[h] points at the row's element
// 0 (null for a padding row); gap columns are skipped.
template <int N, int D, int DR>
__device__ __forceinline__ void store_cols(const float (&o)[N / 8][4],
                                           const float (&l)[2],
                                           bf16* const (&dst)[2], int c0,
                                           int lane) {
  using C = Cols<D, DR>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (dst[h] == nullptr) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-20f);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      // a column pair never straddles a gap: DR/2 and D/2 are even
      const int c = c0 + n * 8 + 2 * (lane & 3);
      if (C::gap(c)) continue;
      *reinterpret_cast<uint32_t*>(dst[h] + (c < D / 2 ? c : c - C::kGap)) =
          pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
  }
}

// Writes the warp's rows o / max(l, 1e-20) in bf16; row r (0..15 of the
// warp) goes to dst[r] unless dst[r] is null (a padding row).
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4],
                                           const float (&l)[2],
                                           bf16* const (&dst)[2], int lane) {
  store_cols<D, D, D>(o, l, dst, 0, lane);
}

}  // namespace flash
