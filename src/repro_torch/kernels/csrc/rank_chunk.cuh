// LoRA ranks above kRankChunk (64) in the bf16 residual kernels for NVIDIA
// Hopper (sm_90a): the key-block rebuild shared by the chunked instances of
// #5 and #1 (paged_prefill_res_chunk_kernel) and #2
// (paged_decode_res_chunk_kernel) in paged_residual_disagg.cu, and of #7
// (residual_attention_chunk_kernel) and #8
// (residual_attention_decode_chunk_kernel) in residual_attention.cu.  Ranks
// up to 64 keep their RP 16/32/64 instances, which hold B_k and B_v of RP
// rows on chip and a second accumulator O_r = P V_r of RP columns; neither
// scales to any rank.  Here no buffer and no accumulator grows with R:
//   * a key block's K and V tiles are rebuilt on chip, rank chunk by
//     chunk: only one chunk's K_r (or V_r) columns, BK x 64, and B_k (or
//     B_v) rows, 64 x D, are in shared memory at a time;
//   * K_r . B_k is linear in the rank, so the MMA chain runs on over the
//     chunks through f32 sums X (BK x D) in shared memory: each thread
//     reloads its own accumulator elements from X, adds the chunk's
//     products, and stores them back (the same elements every chunk, so
//     the chain is the one a single instance of RP = R would run); after
//     the last chunk K = bf16(K_b + RoPE(X)), as rebuild_k rounds;
//   * V is rebuilt the same way, V = bf16(V_b + V_r . B_v) (the plain
//     version's reconstruct rounds there too), so P . V needs no O_r and
//     the split-K decodes' partials and combines carry no rank columns.
// Bound: each key block costs 4 BK R D MMA flops of rebuild per query
// tile against 4 BK rows D for QK and PV, and rereads B_k and B_v (2 R D
// bf16) per block, from L2 after the first tile; the rank's columns of
// K_r and V_r are read once per block.  A simple kernel first: one stage,
// every chunk waited for, no copy overlapped with the MMAs.
#pragma once

#include "flash_tile.cuh"

namespace flash {

// Shared memory of a key block of BK keys, from its base: bf16 K and V
// tiles (BK x DS each, V right after K), sin and cos rows (BK x HS), one
// chunk of K_r or V_r (BK x RS), one chunk of B_k or B_v rows (64 x DS);
// then the f32 sums X (BK x D) and, for int8 pages, the block's K and V
// codes (2 BK x D bytes) and their scales (2 BK f32).
template <int D, int BK, bool INT8>
struct ChunkBlock {
  static constexpr int DS = D + kPad, RS = kRankChunk + kPad,
                       HS = D / 2 + kPad;
  static constexpr int kK = 0, kV = BK * DS, kSin = 2 * BK * DS,
                       kCos = kSin + BK * HS, kR = kCos + BK * HS,
                       kB = kR + BK * RS, kElems = kB + kRankChunk * DS;
  static constexpr int kX = 2 * kElems, kCodes = kX + 4 * BK * D,
                       kScales = kCodes + 2 * BK * D,
                       kBytes = INT8 ? kScales + 8 * BK : kCodes;
  static_assert(BK % 16 == 0, "whole m16 tiles of keys");
};

// Where a key block's rows come from.  The kernel's index maps give, for a
// key position, the row of its head in the base pools (``tok``: rows of DR
// elements, and the row of its int8 scales), its residual row (``res``:
// rows of R) and its RoPE row (``rope``: rows of DR / 2).
struct ChunkSrc {
  const void* kb;
  const void* vb;
  const float* kb_s;     // int8 pages only
  const float* vb_s;
  const bf16* kr;
  const bf16* vr;
  const bf16* bk;        // B_k / B_v of the row and kv head: rank row rr at
  const bf16* bv;        // rr * hd
  long hd;
  const bf16* sin;
  const bf16* cos;
  int R;
};

// The gap columns of the split-half layout (DR < D) in the block's K/V
// tiles, B chunk and sin/cos rows: zero once, never written by a copy.
template <int D, int DR, int BK, bool INT8>
__device__ __forceinline__ void chunk_zero_gaps(unsigned char* base, int tid,
                                                int n) {
  using L = ChunkBlock<D, BK, INT8>;
  using C = Cols<D, DR>;
  bf16* sm = reinterpret_cast<bf16*>(base);
  C::zero_gaps(sm + L::kK, 2 * BK, L::DS, tid, n);
  C::zero_gaps(sm + L::kB, kRankChunk, L::DS, tid, n);
  C::zero_table_gaps(sm + L::kSin, BK, L::HS, tid, n);
  C::zero_table_gaps(sm + L::kCos, BK, L::HS, tid, n);
}

// cp.async of key block [j0, j0 + BK): K_b and V_b rows (int8: codes and
// scales), sin and cos rows; keys outside [klo, khi) are zero-filled.
template <int D, int DR, int BK, int NT, bool INT8, class Tok, class Rope>
__device__ __forceinline__ void chunk_issue_block(unsigned char* base,
                                                  const ChunkSrc& s, int j0,
                                                  int klo, int khi, Tok tok,
                                                  Rope rope, int tid) {
  using L = ChunkBlock<D, BK, INT8>;
  using C = Cols<D, DR>;
  bf16* sm = reinterpret_cast<bf16*>(base);
  if constexpr (!INT8) {
    const bf16* kb = static_cast<const bf16*>(s.kb);
    const bf16* vb = static_cast<const bf16*>(s.vb);
    for (int e = tid; e < BK * C::kRow; e += NT) {
      const int t = e / C::kRow, i = e % C::kRow, kpos = j0 + t;
      const bool ok = kpos >= klo && kpos < khi;
      const long src = ok ? tok(kpos) * DR : 0;
      C::row(sm + L::kK + t * L::DS, kb + src, i, ok);
      C::row(sm + L::kV + t * L::DS, vb + src, i, ok);
    }
  } else {
    const int8_t* kb = static_cast<const int8_t*>(s.kb);
    const int8_t* vb = static_cast<const int8_t*>(s.vb);
    unsigned char* codes = base + L::kCodes;
    float* scales = reinterpret_cast<float*>(base + L::kScales);
    for (int e = tid; e < BK * C::kCodeRow; e += NT) {
      const int t = e / C::kCodeRow, i = e % C::kCodeRow, kpos = j0 + t;
      const bool ok = kpos >= klo && kpos < khi;
      const long src = ok ? tok(kpos) * DR : 0;
      C::codes(codes + t * D, kb + src, i, ok);
      C::codes(codes + (BK + t) * D, vb + src, i, ok);
    }
    for (int t = tid; t < BK; t += NT) {
      const int kpos = j0 + t;
      const bool ok = kpos >= klo && kpos < khi;
      const long src = ok ? tok(kpos) : 0;
      cp_async4(scales + t, s.kb_s + src, ok);
      cp_async4(scales + BK + t, s.vb_s + src, ok);
    }
  }
  for (int e = tid; e < BK * C::kHalf; e += NT) {
    const int t = e / C::kHalf, i = e % C::kHalf, kpos = j0 + t;
    const bool ok = kpos >= klo && kpos < khi;
    const long src = ok ? rope(kpos) * (DR / 2) : 0;
    C::half(sm + L::kSin + t * L::HS, s.sin + src, i, ok);
    C::half(sm + L::kCos + t * L::HS, s.cos + src, i, ok);
  }
}

// cp.async of rank chunk c of the block: columns 64 c.. of the keys' K_r
// (V_r when V) and rows 64 c.. of B_k (B_v); columns and rows at or past
// R are zero-filled, as are keys outside [klo, khi).
template <int D, int DR, int BK, int NT, bool V, class Res>
__device__ __forceinline__ void chunk_issue_rank(unsigned char* base,
                                                 const ChunkSrc& s, int j0,
                                                 int klo, int khi, int c,
                                                 Res res, int tid) {
  using L = ChunkBlock<D, BK, false>;
  using C = Cols<D, DR>;
  bf16* sm = reinterpret_cast<bf16*>(base);
  const bf16* r = V ? s.vr : s.kr;
  const bf16* b = V ? s.bv : s.bk;
  const int r0 = c * kRankChunk, R = s.R;
  for (int e = tid; e < kRankChunk * C::kRow; e += NT) {
    const int rr = e / C::kRow, i = e % C::kRow;
    const bool ok = r0 + rr < R;
    const long src = ok ? (long)(r0 + rr) * s.hd : 0;
    C::row(sm + L::kB + rr * L::DS, b + src, i, ok);
  }
  if (R % 8 == 0) {
    for (int e = tid; e < BK * (kRankChunk / 8); e += NT) {
      const int t = e / (kRankChunk / 8), g = e % (kRankChunk / 8);
      const int kpos = j0 + t;
      const bool ok = kpos >= klo && kpos < khi && r0 + g * 8 < R;
      const long src = ok ? res(kpos) * R + r0 + g * 8 : 0;
      cp_async16(sm + L::kR + t * L::RS + g * 8, r + src, ok);
    }
  } else {              // rows of R elements are not 16-byte aligned
    for (int e = tid; e < BK * kRankChunk; e += NT) {
      const int t = e / kRankChunk, cc = e % kRankChunk, kpos = j0 + t;
      const bool ok = kpos >= klo && kpos < khi && r0 + cc < R;
      sm[L::kR + t * L::RS + cc] =
          ok ? r[res(kpos) * R + r0 + cc] : __float2bfloat16(0.f);
    }
  }
}

// One rank chunk of the rebuild of the block's K (ROPE) or V tile on the
// tensor cores.  Items of 16 keys x an n-tile pair (j, j + D/16) go to the
// NW warps as in rebuild_k; a thread's accumulators hold columns c and c +
// D/2 of its two keys, start from X (0 at the first chunk), run the
// chunk's 4 k-steps, and go back to X, or after the last chunk become
// K = bf16(K_b + RoPE(X)) (V = bf16(V_b + X)) in place of K_b (V_b).
template <int D, int BK, int NW, bool ROPE>
__device__ __forceinline__ void chunk_rebuild(unsigned char* base, bool first,
                                              bool last, int warp, int lane) {
  using L = ChunkBlock<D, BK, false>;
  constexpr int DS = L::DS, RS = L::RS, HS = L::HS;
  bf16* sm = reinterpret_cast<bf16*>(base);
  float* X = reinterpret_cast<float*>(base + L::kX);
  bf16* tile = sm + (ROPE ? L::kK : L::kV);
  const bf16* rch = sm + L::kR;
  const bf16* bch = sm + L::kB;
  for (int item = warp; item < (BK / 16) * (D / 16); item += NW) {
    const int mt = item / (D / 16), j = item % (D / 16);
    const int i = 8 * j + 2 * (lane & 3);
    float x1[4], x2[4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = mt * 16 + (lane >> 2) + 8 * hh;
      const float2 a1 = first ? make_float2(0.f, 0.f)
                              : *reinterpret_cast<const float2*>(X + t * D + i);
      const float2 a2 =
          first ? make_float2(0.f, 0.f)
                : *reinterpret_cast<const float2*>(X + t * D + i + D / 2);
      x1[2 * hh] = a1.x;
      x1[2 * hh + 1] = a1.y;
      x2[2 * hh] = a2.x;
      x2[2 * hh + 1] = a2.y;
    }
#pragma unroll
    for (int kk = 0; kk < kRankChunk / 16; ++kk) {
      uint32_t af[4], bf[2];
      ldmatrix_x4(af, rch + (mt * 16 + (lane & 15)) * RS + kk * 16 +
                          (lane >> 4) * 8);
      const bf16* brow =
          bch + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS + 8 * j;
      ldmatrix_x2_trans(bf, brow);
      mma(x1, af, bf[0], bf[1]);
      ldmatrix_x2_trans(bf, brow + D / 2);
      mma(x2, af, bf[0], bf[1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = mt * 16 + (lane >> 2) + 8 * hh;
      if (!last) {
        *reinterpret_cast<float2*>(X + t * D + i) =
            make_float2(x1[2 * hh], x1[2 * hh + 1]);
        *reinterpret_cast<float2*>(X + t * D + i + D / 2) =
            make_float2(x2[2 * hh], x2[2 * hh + 1]);
        continue;
      }
      __nv_bfloat162* k1 = reinterpret_cast<__nv_bfloat162*>(tile + t * DS + i);
      __nv_bfloat162* k2 =
          reinterpret_cast<__nv_bfloat162*>(tile + t * DS + i + D / 2);
      const float2 b1 = __bfloat1622float2(*k1);
      const float2 b2 = __bfloat1622float2(*k2);
      if constexpr (ROPE) {
        const float2 sn = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm + L::kSin + t * HS +
                                                     i));
        const float2 cs = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm + L::kCos + t * HS +
                                                     i));
        // rebuild_k's f32 operations, uncontracted
        *k1 = __floats2bfloat162_rn(
            b1.x + rot(x1[2 * hh], cs.x, x2[2 * hh], -sn.x),
            b1.y + rot(x1[2 * hh + 1], cs.y, x2[2 * hh + 1], -sn.y));
        *k2 = __floats2bfloat162_rn(
            b2.x + rot(x2[2 * hh], cs.x, x1[2 * hh], sn.x),
            b2.y + rot(x2[2 * hh + 1], cs.y, x1[2 * hh + 1], sn.y));
      } else {
        *k1 = __floats2bfloat162_rn(__fadd_rn(b1.x, x1[2 * hh]),
                                    __fadd_rn(b1.y, x1[2 * hh + 1]));
        *k2 = __floats2bfloat162_rn(__fadd_rn(b2.x, x2[2 * hh]),
                                    __fadd_rn(b2.y, x2[2 * hh + 1]));
      }
    }
  }
}

// Key block [j0, j0 + BK) into the K and V tiles of ``base``, K = K_b +
// RoPE(K_r . B_k) and V = V_b + V_r . B_v, the rank in chunks of 64: all
// NW warps load and rebuild; returns after a barrier, the tiles ready.
// The caller syncs the CTA before its next call (which refills them).
template <int D, int DR, int BK, int NW, bool INT8, class Tok, class Res,
          class Rope>
__device__ void chunk_block(unsigned char* base, const ChunkSrc& s, int j0,
                            int klo, int khi, Tok tok, Res res, Rope rope,
                            int tid, int warp, int lane) {
  using L = ChunkBlock<D, BK, INT8>;
  constexpr int NT = 32 * NW;
  const int nch = (s.R + kRankChunk - 1) / kRankChunk;
  chunk_issue_block<D, DR, BK, NT, INT8>(base, s, j0, klo, khi, tok, rope,
                                         tid);
  for (int pass = 0; pass < 2; ++pass)
    for (int c = 0; c < nch; ++c) {
      if (pass == 0)
        chunk_issue_rank<D, DR, BK, NT, false>(base, s, j0, klo, khi, c, res,
                                               tid);
      else
        chunk_issue_rank<D, DR, BK, NT, true>(base, s, j0, klo, khi, c, res,
                                              tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (INT8) {
        if (pass == 0 && c == 0) {     // the codes into the K and V tiles
          dequantize_cols<D, DR>(
              base + L::kCodes,
              reinterpret_cast<const float*>(base + L::kScales),
              reinterpret_cast<bf16*>(base) + L::kK, L::DS, 2 * BK, tid, NT);
          __syncthreads();
        }
      }
      if (pass == 0)
        chunk_rebuild<D, BK, NW, true>(base, c == 0, c == nch - 1, warp, lane);
      else
        chunk_rebuild<D, BK, NW, false>(base, c == 0, c == nch - 1, warp,
                                        lane);
      __syncthreads();
    }
}

}  // namespace flash
