// LoRA ranks above kRankChunk (64) in the bf16 residual kernels for NVIDIA
// Hopper (sm_90a).  Ranks up to 64 keep their RP 16/32/64 instances, which
// hold B_k and B_v of RP rows on chip and a second accumulator O_r = P V_r
// of RP columns; neither scales to any rank.  Three forms:
//   * ``chunk_block``: a key block's K and V tiles rebuilt on chip rank
//     chunk by chunk, K = bf16(K_b + RoPE(sum_c K_r,c . B_k,c)) and V =
//     bf16(V_b + sum_c V_r,c . B_v,c) with the sums in f32 (rebuild_k's
//     rounding; the plain version's reconstruct rounds V there too), so P
//     . V needs no O_r.  One chunk of K_r (V_r) columns, BK x 64, and of
//     B_k (B_v) rows, 64 x D, in shared memory at a time; the f32 sums X
//     (BK x D) in shared memory between chunks; one stage, every chunk
//     waited for.  It serves the split-K decodes' chunked instances only
//     above kDecodeRankMax, as #2's paged_decode_res_rebuild_kernel
//     (paged_residual_disagg.cu) and #8's
//     residual_attention_decode_rebuild_kernel (residual_attention.cu),
//     whose combines take no rank.
//   * ``ChunkPipe``: the prefill tile of #7's residual_attention_chunk_
//     kernel and of #5's and #1's paged_prefill_res_chunk_kernel (below).
//   * ``DecodePipe``: the decodes' rank route up to kDecodeRankMax, #2's
//     paged_decode_res_chunk_kernel and #8's
//     residual_attention_decode_chunk_kernel (at the end): only K is
//     rebuilt, acc_r carries V's rank columns to the combine.
// Bound: a prefill's key block costs 4 BK R D MMA flops of rebuild against
// 4 BK rows D for QK and PV per query tile; a decode's block 2 BK R D of
// K's rebuild against 2 BK 16 (2 D + R) for QK, P V_b and P V_r of the 16
// head rows.  B_k (and in chunk_block B_v) is read per block, from L2
// after the first; the rank's columns of K_r and V_r once per block.
#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "flash_tile.cuh"

namespace flash {

// ``chunk_block``'s shared memory of a key block of BK keys, from its
// base: bf16 K and V tiles (BK x DS each, V right after K), sin and cos
// rows (BK x HS), one chunk of K_r or V_r (BK x RS), one chunk of B_k or
// B_v rows (64 x DS); then the f32 sums X (BK x D) and, for int8 pages,
// the block's K and V codes (2 BK x D bytes) and their scales (2 BK f32).
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

// ---------------------------------------------------------------------
// The chunked prefill tile: #7's residual_attention_chunk_kernel and #5's
// and #1's paged_prefill_res_chunk_kernel.  A CTA holds 128 query rows (tq
// positions x G heads), as the RP instances' tiles; what changes is who
// rebuilds a key block and how its rank chunks flow:
//   * the q tiles of one (row, kv head) run as a thread block cluster of NC
//     CTAs, the latest tiles first (``chunk_cluster_tile``), and the
//     cluster rebuilds each key block once, not once per CTA.  It walks
//     the union of its tiles' key ranges; a CTA takes the scores only of
//     blocks in its own range (a padding CTA, past the first tile, has
//     none) but always its share of the rebuild;
//   * the share: in a cluster the first NC/2 CTAs rebuild K and the others
//     V, each P = (D/16) / (NC/2) of the tile's n-tile pairs (columns 8 j..
//     and 8 j + D/2.., which RoPE pairs), and load only what that needs:
//     the K_r (V_r) chunk, their columns of the B_k (B_v) rows, of K_b
//     (V_b; int8 pages: every code of the rows and the scales) and of
//     sin/cos.  A CTA alone (NC 1) rebuilds K, then V;
//   * the rebuild runs as m16n8k16 MMAs whose f32 sums stay in registers
//     across the rank chunks, in the order of ``chunk_block``'s chain, so
//     each key's K and V are the same bits at every cluster size and
//     chunk width;
//   * S stages of cp.async carry (block, chunk) steps of W rank columns
//     (128 where a CTA owns at most 64 tile columns, else 64): chunk
//     c + S - 1, of this key block or the next, loads while chunk c
//     multiplies; a pass's last chunk also brings the block's base
//     columns and sin/cos; a thread takes the same key rows and columns
//     in every copy, so each index map runs once per row and step;
//   * after its last chunk a CTA writes its bf16 columns of K (V) into its
//     own tile and sends them, 16 bytes at a time, to the same place of
//     every other CTA of the cluster with st.async, each store completing
//     its bytes on the receiver's ``full`` mbarrier of the buffer; a CTA
//     takes a block's scores once that barrier completes, then tells
//     every CTA's ``empty`` mbarrier of the buffer, which a CTA waits on
//     before it writes the buffer's next block.  No CTA waits for the
//     whole cluster per block.  With three tile buffers (two, and Q's tile
//     once Q's fragments are in registers: D <= 128) a CTA rebuilds and
//     sends block j + 1 before it takes block j's scores, which cover the
//     stores' flight; at D 256 (Q read per block) two buffers, in turn.
// Shared memory: the caller's head (Q, positions), two K/V tile pairs,
// the stages, as many as fit up to kChunkStages
// (``ChunkPrefill::stages``), and the mbarriers.
constexpr int kClusterCtas = 4;       // CTAs of a cluster: 1, 2 or 4
constexpr int kChunkStages = 3;       // the most stages of the chunk ring
constexpr int kPipeChunk = 128;       // rank columns per stage (``W``)
constexpr int kSmemPerCta = 232448;   // a CTA's shared memory on the H100

// The cluster size of a tile D wide: a D 256 CTA alone or in pairs has no
// room for two stages of full-width B rows, base rows and sin/cos.
constexpr int cluster_ctas(int d) {
  return d > 128 ? 4 : kClusterCtas;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// mbarriers (shared-memory addresses): init to ``count`` arrivals; this
// thread's arrival with ``bytes`` of transactions expected; a wait for the
// phase of ``parity`` to complete (acquire at cluster scope: st.async
// writes of other CTAs are visible after it); an arrival on the barrier at
// the same address of the cluster's CTA ``rank`` (release at cluster
// scope)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// a wait that cannot complete (a fault in the pipe) ends the kernel with
// an error after ~10 s at the card's clock instead of holding the card
constexpr long long kWaitCycles = 1ll << 34;

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// ``bytes`` (a multiple of 16) of this CTA's shared memory from ``addr``
// to the same address of the cluster's CTA ``rank`` by the copy engine,
// completing them on that CTA's mbarrier at ``bar``
__device__ __forceinline__ void bulk_to(uint32_t addr, uint32_t bar,
                                        uint32_t rank, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b32 ra, rb;\n"
      "mapa.shared::cluster.u32 ra, %0, %2;\n"
      "mapa.shared::cluster.u32 rb, %1, %2;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [ra], [%0], %3, [rb];\n"
      "}\n" ::"r"(addr),
      "r"(bar), "r"(rank), "r"(bytes)
      : "memory");
}

// S = Q . K^T (``scores``) and c += P . V (``product``) over group-major
// K/V tiles: column group g (8 columns) of key t at element 8 (g BK + t),
// so the 8 keys of an ldmatrix row set are 128 contiguous bytes (no bank
// conflict without padding) and a CTA's columns are whole runs of groups.
template <int D, int BK>
__device__ __forceinline__ void gm_scores(float (&s)[BK / 8][4],
                                          const uint32_t (&qf)[D / 16][4],
                                          const bf16* k, int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < BK / 16; ++n2) {
      uint32_t b[4];
      const int t = n2 * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(b, k + 8 * ((2 * kk + ((lane >> 3) & 1)) * BK + t));
      mma(s[2 * n2], qf[kk], b[0], b[1]);
      mma(s[2 * n2 + 1], qf[kk], b[2], b[3]);
    }
}

// the same with Q's rows in shared memory (stride ``qs``), read per block
template <int D, int BK>
__device__ __forceinline__ void gm_scores(float (&s)[BK / 8][4],
                                          const bf16* q, int qs,
                                          const bf16* k, int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, q + (lane & 15) * qs + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n2 = 0; n2 < BK / 16; ++n2) {
      uint32_t b[4];
      const int t = n2 * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(b, k + 8 * ((2 * kk + ((lane >> 3) & 1)) * BK + t));
      mma(s[2 * n2], a, b[0], b[1]);
      mma(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

template <int BK, int D>
__device__ __forceinline__ void gm_product(float (&c)[D / 8][4],
                                           const float (&a)[BK / 8][4],
                                           const bf16* v, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t af[4] = {
        pack_bf16(a[2 * kk][0], a[2 * kk][1]),
        pack_bf16(a[2 * kk][2], a[2 * kk][3]),
        pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
        pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
    const int t = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, v + 8 * ((2 * n2 + (lane >> 4)) * BK + t));
      mma(c[2 * n2], af, bf[0], bf[1]);
      mma(c[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// 4 bytes to shared-memory address ``addr`` of this CTA
__device__ __forceinline__ void st_local(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The q tile of CTA ``rank`` of cluster ``slot`` of a (row, kv head):
// slot 0 holds the latest (heaviest) tiles; < 0 is a padding CTA
__host__ __device__ __forceinline__ int chunk_cluster_tile(int ntiles,
                                                           int nc, int slot,
                                                           int rank) {
  return ntiles - 1 - (slot * nc + rank);
}

// Bytes of the tiles and of a stage of the chunk ring (BK keys at tile
// width D); the column share P and the items (m16 key tile x n-tile pair)
// of a CTA's pass.
template <int D, int BK, int NC, bool INT8>
struct ChunkPrefill {
  static_assert(NC == 1 || NC == 2 || NC == 4, "clusters of 1, 2 or 4");
  static_assert(BK % 32 == 0, "key rows tid / 8 + 32 k of whole m16 tiles");
  static constexpr int kPasses = NC == 1 ? 2 : 1;     // K, V in turn alone
  static constexpr int kPerKind = NC == 1 ? 1 : NC / 2;
  static constexpr int P = D / 16 / kPerKind;         // n-tile pairs
  static_assert(P * kPerKind == D / 16, "whole n-tile pairs per CTA");
  static constexpr int DS = D + kPad;                 // K/V tile rows
  // rank columns per stage: kPipeChunk up to 4 own pairs (64 columns),
  // else kRankChunk (a stage's B rows grow with W x own columns: two
  // stages of 128 rows of 128 columns do not fit)
  static constexpr int W = P <= 4 ? kPipeChunk : kRankChunk;
  static_assert(W % 64 == 0, "whole 8-column groups for 8 threads");
  static constexpr int RS = W + kPad;                 // K_r / V_r chunk
  static constexpr int CS = 16 * P + kPad;            // own columns
  static constexpr int TS = 8 * P + kPad;             // own sin/cos
  static constexpr int kItems = BK / 16 * P;
  static constexpr int kPerWarp = (kItems + kWarps - 1) / kWarps;
  // a stage, bytes: the chunk's K_r (V_r) rows, B rows, then (a pass's
  // last chunk) the base columns (int8: code rows D wide, then scales)
  // and the sin and cos columns
  static constexpr int kR = 0, kB = kR + 2 * BK * RS,
                       kBase = kB + 2 * W * CS,
                       kSin = kBase + (INT8 ? BK * D + 4 * BK : 2 * BK * CS),
                       kCos = kSin + 2 * BK * TS, kStage = kCos + 2 * BK * TS;
  // K, then V, group-major (``gm_scores``): no padding
  static constexpr int kTile = 2 * 2 * BK * D;
  static constexpr int kTiles = (NC == 1 ? 1 : 2) * kTile;
  static constexpr int kBars = 64;     // a cluster's mbarriers, after all
  static_assert(kStage % 16 == 0 && kTile % 16 == 0, "16-byte rows");
  // stages that fit beside ``head`` bytes (at least 2)
  static constexpr int stages(int head) {
    int s = kChunkStages;
    while (s > 2 && head + kTiles + s * kStage + kBars > kSmemPerCta) --s;
    return s;
  }
  static constexpr int bytes(int head) {
    return head + kTiles + stages(head) * kStage + kBars;
  }
};

// A cluster launch of NC CTAs along x; a launch the card refuses (no SM
// group can hold a cluster) returns its error, as any other.
template <class Kernel, class... Args>
int launch_cluster(Kernel kernel, int nc, long blocks, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(flash::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The ring and the rebuild of one CTA over its cluster's key blocks
// [jb0, jb0 + nblocks), keys at or past ``klimit`` zero; ``tok``, ``res``
// and ``rope`` as for chunk_block.  The caller zeroes the stages first
// where DR < D (the gap columns are never copied), then calls ``start``
// after committing its own copies (Q), then ``run``.
template <int D, int DR, int BK, int NC, int S, bool INT8, bool QBUF,
          class Tok, class Res, class Rope>
struct ChunkPipe {
  using L = ChunkPrefill<D, BK, NC, INT8>;
  using C = Cols<D, DR>;
  static constexpr int P = L::P;
  // a cluster's third tile buffer: the caller's Q tile (QBUF: its bytes,
  // kRows x DS bf16, hold a K/V tile pair, free once Q is in registers)
  static constexpr bool kAhead = NC > 1 && QBUF;
  static constexpr int NB = kAhead ? 3 : 2;          // tile buffers (NC > 1)
  // transaction bytes a CTA receives per block: every other CTA's columns
  static constexpr uint32_t kPushBytes = (NC - 1) * BK * 2 * P * 16;
  static_assert(!QBUF || kRows * (D + kPad) * 2 >= L::kTile,
                "Q's tile holds a K/V tile pair");
  unsigned char* tiles;
  unsigned char* stages;
  unsigned char* qbuf;
  ChunkSrc s;
  int rank, jb0, nblocks, klimit, nch, steps, p0, tid, warp, lane;
  bool vkind;                   // in a cluster: this CTA rebuilds V
  Tok tok;
  Res res;
  Rope rope;

  __device__ ChunkPipe(unsigned char* tiles_, unsigned char* stages_,
                       unsigned char* qbuf_, const ChunkSrc& s_, int rank_,
                       int jb0_, int nblocks_, int klimit_, Tok tok_,
                       Res res_, Rope rope_)
      : tiles(tiles_), stages(stages_), qbuf(qbuf_), s(s_), rank(rank_),
        jb0(jb0_), nblocks(nblocks_), klimit(klimit_), tok(tok_),
        res(res_), rope(rope_) {
    nch = (s.R + L::W - 1) / L::W;
    steps = nblocks * L::kPasses * nch;
    vkind = NC > 1 && rank >= NC / 2;
    p0 = NC == 1 ? 0 : (rank % (NC / 2)) * P;
    if (vkind) {        // a cluster's V CTA reads the V sources as ``k``
      s.kb = s.vb;
      s.kb_s = s.vb_s;
      s.kr = s.vr;
      s.bk = s.bv;
    }
    tid = threadIdx.x;
    warp = tid >> 5;
    lane = tid & 31;
  }

  // the K/V tile pair of block ``blk``: one alone; two in a cluster, or
  // three with the Q tile (kAhead)
  __device__ __forceinline__ unsigned char* tile_of(int blk) const {
    if constexpr (NC == 1) {
      return tiles;
    } else if constexpr (kAhead) {
      const int i = blk % 3;
      return i == 0 ? qbuf : tiles + (i - 1) * L::kTile;
    } else {
      return tiles + (blk & 1) * L::kTile;
    }
  }

  // buffer b's mbarriers: ``full`` completes when every other CTA's
  // columns of the buffer's block have landed (one local arrival with
  // kPushBytes expected); ``empty`` when every CTA of the cluster has
  // taken the block's scores (NC arrivals)
  __device__ __forceinline__ uint32_t full(int blk) const {
    return smem_addr(stages + S * L::kStage) + 8 * (blk % NB);
  }
  __device__ __forceinline__ uint32_t empty(int blk) const {
    return full(blk) + 8 * NB;
  }

  // Copies of a step.  Thread tid takes the key rows tid / 8 + 32 k (k <
  // BK / 32) and, in each, the 8-column group or own-column slots tid % 8,
  // + 8, ...: the index maps run once per row and step.  A slot is kVec
  // tile columns of the CTA's own groups (2 P of 8 columns: P in each
  // half), at compact column 8 u + kVec sub.
  static constexpr int kSub = 8 / C::kVec;            // slots per group
  static constexpr int kSlots = 2 * P * kSub;         // per head row
  static constexpr int kHalfSlots = P * kSub;         // per sin/cos row
  __device__ __forceinline__ int slot_col(int sl) const {  // tile column
    const int u = sl / kSub;
    return 8 * ((u < P ? 0 : D / 16) + p0 + u % P) + sl % kSub * C::kVec;
  }
  __device__ __forceinline__ int slot_cc(int sl) const {   // compact
    return 8 * (sl / kSub) + sl % kSub * C::kVec;
  }

  __device__ void issue(int step) const {
    const int per = L::kPasses * nch, blk = step / per;
    const int pass = step % per / nch, c = step % nch;
    const bool v = NC == 1 ? pass == 1 : vkind;
    const bool vsrc = NC == 1 && v;      // else the ``k`` sources hold V's
    const bool last = c == nch - 1;
    unsigned char* st = stages + (step % S) * L::kStage;
    bf16* rch = reinterpret_cast<bf16*>(st + L::kR);
    bf16* bch = reinterpret_cast<bf16*>(st + L::kB);
    const int j0 = (jb0 + blk) * BK, r0 = c * L::W, R = s.R;
    const int slot = tid & 7;
    const bf16* r = vsrc ? s.vr : s.kr;
    const bf16* b = vsrc ? s.bv : s.bk;
    // rank rows r0 + tid / 8 + 32 k of B_k (B_v), own slots as above
#pragma unroll 1
    for (int sl = slot; sl < kSlots; sl += 8) {
      const int el = C::elem(slot_col(sl)), cc = slot_cc(sl);
      if (el < 0) continue;
#pragma unroll
      for (int k = 0; k < L::W / 32; ++k) {
        const int rr = (tid >> 3) + 32 * k;
        const bool ok = r0 + rr < R;
        C::copy(bch + rr * L::CS + cc,
                b + (ok ? (long)(r0 + rr) * s.hd + el : 0), ok);
      }
    }
#pragma unroll
    for (int k = 0; k < BK / 32; ++k) {
      const int t = (tid >> 3) + 32 * k, kpos = j0 + t;
      const bool ok = kpos < klimit;
      // columns r0 + 8 g of the key's K_r (V_r) row, g = slot, + 8, ...
      const long row = ok ? res(kpos) * R : 0;
#pragma unroll
      for (int g = slot; g < L::W / 8; g += 8) {
        if (R % 8 == 0) {
          const bool okr = ok && r0 + 8 * g < R;
          cp_async16(rch + t * L::RS + 8 * g, r + (okr ? row + r0 + 8 * g : 0),
                     okr);
        } else {        // rows of R elements are not 16-byte aligned
#pragma unroll
          for (int cc = 8 * g; cc < 8 * g + 8; ++cc)
            rch[t * L::RS + cc] = ok && r0 + cc < R ? r[row + r0 + cc]
                                                    : __float2bfloat16(0.f);
        }
      }
      if (!last) continue;
      // the pass's last chunk: the key's base columns and sin/cos
      unsigned char* base = st + L::kBase;
      const long tk = ok ? tok(kpos) : 0;
      if constexpr (!INT8) {
        const bf16* kb = static_cast<const bf16*>(vsrc ? s.vb : s.kb);
        bf16* dst = reinterpret_cast<bf16*>(base) + t * L::CS;
        for (int sl = slot; sl < kSlots; sl += 8) {
          const int el = C::elem(slot_col(sl));
          if (el < 0) continue;
          C::copy(dst + slot_cc(sl), kb + (ok ? tk * DR + el : 0), ok);
        }
      } else {
        const int8_t* kb = static_cast<const int8_t*>(vsrc ? s.vb : s.kb);
        for (int i = slot; i < C::kCodeRow; i += 8)
          C::codes(base + t * D, kb + tk * DR, i, ok);
        if (slot == 0)
          cp_async4(reinterpret_cast<float*>(base + BK * D) + t,
                    (vsrc ? s.vb_s : s.kb_s) + tk, ok);
      }
      if (v) continue;
      const long rp = ok ? rope(kpos) * (DR / 2) : 0;
      bf16* sn = reinterpret_cast<bf16*>(st + L::kSin) + t * L::TS;
      bf16* cs = reinterpret_cast<bf16*>(st + L::kCos) + t * L::TS;
      for (int sl = slot; sl < kHalfSlots; sl += 8) {
        const int col = slot_col(sl);               // first half
        if (col >= DR / 2) continue;                // a gap column
        C::copy(sn + slot_cc(sl), s.sin + rp + col, ok);
        C::copy(cs + slot_cc(sl), s.cos + rp + col, ok);
      }
    }
  }

  // the mbarriers; the S - 1 first steps; the caller's earlier copies (Q)
  // landed, then ``ready`` (Q's fragments into registers); then the
  // cluster's CTAs all running, their mbarriers ready and done with Q,
  // before any writes to a peer
  template <class Ready>
  __device__ void start(Ready ready) const {
    if (NC > 1 && tid == 0) {
      for (int b = 0; b < NB; ++b) {
        mbar_init(full(b), 1);
        mbar_init(empty(b), NC);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < steps) issue(i);
      cp_async_commit();
    }
    cp_async_wait<S - 1>();
    __syncthreads();
    ready();
    if constexpr (NC > 1) cluster_sync();
  }

  // chunk ``step``'s MMAs into the sums of the warp's items
  __device__ __forceinline__ void multiply(
      int step, float (&acc)[L::kPerWarp][2][4]) const {
    const unsigned char* st = stages + (step % S) * L::kStage;
    const bf16* rch = reinterpret_cast<const bf16*>(st + L::kR);
    const bf16* bch = reinterpret_cast<const bf16*>(st + L::kB);
#pragma unroll
    for (int u = 0; u < L::kPerWarp; ++u) {
      const int item = warp + kWarps * u;
      if (item >= L::kItems) break;
      const int mt = item / P, jj = item % P;
#pragma unroll
      for (int kk = 0; kk < L::W / 16; ++kk) {
        uint32_t af[4], bf[2];
        ldmatrix_x4(af, rch + (mt * 16 + (lane & 15)) * L::RS + kk * 16 +
                            (lane >> 4) * 8);
        const bf16* brow =
            bch + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::CS +
            8 * jj;
        ldmatrix_x2_trans(bf, brow);
        mma(acc[u][0], af, bf[0], bf[1]);
        ldmatrix_x2_trans(bf, brow + 8 * P);
        mma(acc[u][1], af, bf[0], bf[1]);
      }
    }
  }

  // K = bf16(K_b + RoPE(sums)) (V = bf16(V_b + sums)) of the warp's items
  // into this CTA's K (V) tile of block ``blk``
  __device__ __forceinline__ void finish(int step, int blk, bool v,
                                         const float (&acc)[L::kPerWarp][2]
                                                           [4]) const {
    const unsigned char* st = stages + (step % S) * L::kStage;
    const unsigned char* base = st + L::kBase;
    const bf16* sn = reinterpret_cast<const bf16*>(st + L::kSin);
    const bf16* cs = reinterpret_cast<const bf16*>(st + L::kCos);
    const uint32_t tile = smem_addr(tile_of(blk)) + (v ? 2 * BK * D : 0);
#pragma unroll
    for (int u = 0; u < L::kPerWarp; ++u) {
      const int item = warp + kWarps * u;
      if (item >= L::kItems) break;
      const int mt = item / P, jj = item % P;
      const int ci = 8 * jj + 2 * (lane & 3);         // compact column
      const int i = 8 * (p0 + jj) + 2 * (lane & 3);  // tile column
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = mt * 16 + (lane >> 2) + 8 * hh;
        float2 b1, b2;
        if constexpr (!INT8) {
          const bf16* row = reinterpret_cast<const bf16*>(base) + t * L::CS;
          b1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + ci));
          b2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + 8 * P + ci));
        } else {         // bf16(code * scale), as dequantize_cols rounds
          const unsigned char* codes = base + t * D;
          const float sc = reinterpret_cast<const float*>(base + BK * D)[t];
          auto deq = [&](int c) {
            const int e = C::elem(c);
            if (e < 0) return make_float2(0.f, 0.f);
            return __bfloat1622float2(__floats2bfloat162_rn(
                __fmul_rn((float)(int8_t)codes[e], sc),
                __fmul_rn((float)(int8_t)codes[e + 1], sc)));
          };
          b1 = deq(i);
          b2 = deq(i + D / 2);
        }
        const float x1a = acc[u][0][2 * hh], x1b = acc[u][0][2 * hh + 1];
        const float x2a = acc[u][1][2 * hh], x2b = acc[u][1][2 * hh + 1];
        uint32_t k1, k2;
        if (!v) {
          const float2 s2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sn + t * L::TS + ci));
          const float2 c2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(cs + t * L::TS + ci));
          // rebuild_k's f32 operations, uncontracted
          k1 = pack_bf16(b1.x + rot(x1a, c2.x, x2a, -s2.x),
                         b1.y + rot(x1b, c2.y, x2b, -s2.y));
          k2 = pack_bf16(b2.x + rot(x2a, c2.x, x1a, s2.x),
                         b2.y + rot(x2b, c2.y, x1b, s2.y));
        } else {
          k1 = pack_bf16(__fadd_rn(b1.x, x1a), __fadd_rn(b1.y, x1b));
          k2 = pack_bf16(__fadd_rn(b2.x, x2a), __fadd_rn(b2.y, x2b));
        }
        // group-major: column i of key t at 16 (i / 8 BK + t) + 2 (i % 8)
        const uint32_t a1 = tile + 16 * ((i >> 3) * BK + t) + 2 * (i & 7);
        st_local(a1, k1);
        st_local(a1 + 2 * BK * D / 2, k2);            // column i + D/2
      }
    }
  }

  // This CTA's columns of block ``blk``'s K (V) tile into the same place
  // of every other CTA of the cluster: its groups are two runs of P BK
  // 16-byte rows in the group-major tile, each one bulk copy per peer,
  // completing its bytes on the peer's ``full`` barrier (after a CTA
  // barrier over ``finish``'s writes, made visible to the copy engine)
  __device__ __forceinline__ void push(int blk) const {
    if (tid != 0) return;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t tile = smem_addr(tile_of(blk)) + (vkind ? 2 * BK * D : 0);
#pragma unroll
    for (int k = 1; k < NC; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bulk_to(tile + 16 * BK * (h * D / 16 + p0), full(blk),
                (rank + k) % NC, 16 * BK * P);
  }

  // Block ``blk``'s steps from step ``t``: per step wait for its chunk,
  // issue step + S - 1 into the stage the previous step left, multiply;
  // after a pass's last chunk write this CTA's tile columns.  The sums
  // live through one pass, so never across attend.  Returns the next step.
  __device__ int rebuild(int blk, int t) const {
    for (int pass = 0; pass < L::kPasses; ++pass) {
      float acc[L::kPerWarp][2][4];
#pragma unroll
      for (int u = 0; u < L::kPerWarp; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          acc[u][h][0] = acc[u][h][1] = acc[u][h][2] = acc[u][h][3] = 0.f;
      for (int c = 0; c < nch; ++c, ++t) {
        cp_async_wait<S - 2>();
        __syncthreads();
        if (t + S - 1 < steps) issue(t + S - 1);
        cp_async_commit();
        multiply(t, acc);
      }
      // in a cluster the buffer is free once every CTA has taken the
      // scores of its block before (NB back)
      if (NC > 1 && blk >= NB) mbar_wait(empty(blk), (blk / NB - 1) & 1);
      finish(t - 1, blk, NC == 1 ? pass == 1 : vkind, acc);
    }
    return t;
  }

  // Every block: rebuild, make its tiles whole, attend(blk, K tile, V
  // tile).  Alone: a CTA barrier between.  In a cluster: this CTA's
  // columns written and pushed, block blk's scores once its ``full``
  // barrier completes, then every CTA's ``empty`` barrier of the buffer
  // told.  With kAhead, block blk + 1 is rebuilt and pushed before block
  // blk's scores, so the pushes' flight is covered by them.
  template <class Attend>
  __device__ void run(Attend attend) const {
    auto scores = [&](int blk) {
      if constexpr (NC > 1) mbar_wait(full(blk), (blk / NB) & 1);
      const bf16* k = reinterpret_cast<const bf16*>(tile_of(blk));
      attend(blk, k, k + BK * D);
      if constexpr (NC > 1) {
        __syncthreads();                     // every warp's reads done
        if (tid < NC && blk + NB < nblocks) mbar_arrive_at(empty(blk), tid);
      }
    };
    auto whole = [&](int blk, int t) {
      t = rebuild(blk, t);
      __syncthreads();
      if constexpr (NC > 1) {
        if (tid == 0) mbar_expect(full(blk), kPushBytes);
        push(blk);
      }
      return t;
    };
    int t = 0;
    if constexpr (kAhead) {
      if (nblocks > 0) t = whole(0, t);
      for (int blk = 0; blk < nblocks; ++blk) {
        if (blk + 1 < nblocks) t = whole(blk + 1, t);
        scores(blk);
      }
    } else {
      for (int blk = 0; blk < nblocks; ++blk) {
        t = whole(blk, t);
        scores(blk);
      }
    }
    cp_async_wait<0>();
    // no CTA leaves while a peer may still write to it
    if constexpr (NC > 1) cluster_sync();
  }
};

// ---------------------------------------------------------------------
// The chunked split-K decodes' rank route: #2's paged_decode_res_chunk_
// kernel and #8's residual_attention_decode_chunk_kernel, ranks from
// kRankChunk + 1 to kDecodeRankMax.  A decode has one query row per head,
// so V is never rebuilt: O += P V_b and acc_r += P V_r (R columns), and
// the combine (or #8's one-range epilogue) applies B_v once per row, as
// the RP instances do.  A CTA is 4 warps over 16 query heads of one kv
// head and walks its keys in blocks of 64:
//   * K = bf16(K_b + RoPE(sum_c K_r,c . B_k,c)) is rebuilt by keys: warp w
//     owns keys 16 w .. 16 w + 15 of the block, their f32 sums of all D
//     columns in registers across the rank chunks (``chunk_block``'s
//     chain: the same bits), and after the last chunk the rebuilt K pairs
//     are the B fragments of S = Q K^T at once (the RP kernels' trick);
//   * the warps' row maxima meet in shared memory, each warp writes its
//     P (bf16) there, and O and acc_r are split by columns: warp w owns
//     columns [w D/4, (w + 1) D/4) of O and columns 64 c + 16 w .. + 15 of
//     acc_r for every rank chunk c, so no accumulator grows with R beyond
//     R/8 registers a thread;
//   * a cp.async ring of S stages carries (block, step) steps: a block's
//     K steps bring a K_r chunk (BK x 64) and, streamed, the B_k chunk (64
//     x D; HOLD: all of B_k stays on chip for the CTA's range), then its V
//     steps one V_r chunk each; the block's K_b, sin and cos (``kbuf``)
//     ride with its first K step and its V_b (``vbuf``) with its first V
//     step, so each lands behind the steps before it.  Each thread copies
//     the same key row (tid / 2) in every copy: the index maps run once
//     per row and step.
// The copies, not the MMAs, set the time (scripts/rank_chunk_variants.py
// decode: issuing them is 44-53% of a CTA's cycles, K's MMAs 16-22%), so
// each family takes what moves fewest bytes for its rows: #2 (ragged
// rows, whose longest set the time through the splits per row) keeps two
// CTAs per SM and holds B_k where they still fit (kPagedTwoPerSm), else
// streams it, with 2 stages; #8 (even rows: the bytes per key set the
// time) holds B_k with 3 stages wherever a CTA fits, else streams it with
// 2 (``decode_chunk_plan`` in residual_attention.py mirrors both).
// Shared memory: Q, P, the warps' maxima, the ring, kbuf, vbuf; held B_k
// (whole chunks of rows) last.
constexpr int kDecodeRankMax = 256;    // the largest rank of the route
constexpr int kDecodeStages = 0;       // 0: each family's; else at most
constexpr bool kDecodeHoldBk = true;   // B_k held where the family's rule
                                       // lets it
// a paged CTA's budget for two per SM: half an SM's 233,472 bytes, less
// the card's 1 KB per CTA and the plan's 2 KB of block-table slices
constexpr int kPagedTwoPerSm = 233472 / 2 - 1024 - 2048;

template <int D, bool INT8, bool HOLD, int S_>
struct DecodeChunk {
  static constexpr int S = S_;                   // ring stages
  static constexpr bool kHold = HOLD;           // B_k held on chip
  static constexpr int BK = 64;                  // keys per block
  static constexpr int kHeads = 16;              // query heads per CTA
  static constexpr int NW = 4;                   // warps
  static constexpr int kNch = kDecodeRankMax / kRankChunk;
  static constexpr int DS = D + kPad, RS = kRankChunk + kPad,
                       HS = D / 2 + kPad, PS = BK + kPad;
  static constexpr int QD = D / NW;              // O columns per warp
  // bytes
  static constexpr int kQ = 0, kP = kQ + 2 * kHeads * DS,
                       kMx = kP + 2 * kHeads * PS,
                       kRing = kMx + 4 * NW * kHeads;
  static constexpr int kStageB = 2 * BK * RS;    // a stage's B_k chunk
  static constexpr int kStage = kStageB + (HOLD ? 0 : 2 * kRankChunk * DS);
  // kbuf: the K_b tile (int8: codes, then scales), sin, cos; vbuf: the
  // V_b tile (int8: codes, scales, then the bf16 tile they make)
  static constexpr int kKb = INT8 ? BK * D + 4 * BK : 2 * BK * DS;
  static constexpr int kTab = 2 * BK * HS;
  static constexpr int kVb = INT8 ? BK * D + 4 * BK + 2 * BK * DS
                                  : 2 * BK * DS;
  static constexpr int bytes_at(int s) {
    return kRing + s * kStage + kKb + 2 * kTab + kVb;
  }
  // at most ``want`` stages (kDecodeStages where set), as many as fit
  static constexpr int stages(int want) {
    int s = kDecodeStages ? kDecodeStages : want;
    while (s > 1 && bytes_at(s) > kSmemPerCta) --s;
    return s;
  }
  static constexpr int kKbuf = kRing + S * kStage, kSin = kKbuf + kKb,
                       kCos = kSin + kTab, kVbuf = kCos + kTab,
                       kVtile = kVbuf + (INT8 ? BK * D + 4 * BK : 0),
                       kBytes = kVbuf + kVb;
  // #8's one-range epilogue: acc_r in bf16 (16 x AS) over the ring, one
  // B_v chunk (64 x DS) over kbuf
  static constexpr int AS = kDecodeRankMax + kPad;
  static_assert(S >= 1 && S <= 3, "a K step's kbuf lands behind S - 1 "
                "steps of the block before (nch >= 2)");
  static_assert(kBytes <= kSmemPerCta, "a CTA's shared memory");
  static_assert(2 * kHeads * AS <= S * kStage, "acc_r over the ring");
  static_assert(2 * kRankChunk * DS <= kKb + 2 * kTab, "B_v over kbuf");
  static_assert(kKbuf % 16 == 0 && kVbuf % 16 == 0 && kVtile % 16 == 0 &&
                    kBytes % 16 == 0,
                "16-byte rows");
  // the held B_k's bytes at rank R (rows padded to whole chunks)
  static constexpr long held(int R) {
    return HOLD ? 2l * ((R + kRankChunk - 1) / kRankChunk) * kRankChunk * DS
                : 0;
  }
};

// the instance with at most WANT stages (kDecodeStages where set), as many
// as fit a CTA
template <int D, bool INT8, bool HOLD, int WANT>
using DecodeChunkFor =
    DecodeChunk<D, INT8, HOLD, DecodeChunk<D, INT8, HOLD, 1>::stages(WANT)>;

// c += A . B for one warp with A (16 x K) given as bf16 A fragments, B (K
// x N) row-major in shared memory (``flash::product``'s B side)
template <int K, int N>
__device__ __forceinline__ void product_a(float (&c)[N / 8][4],
                                          const uint32_t (&a)[K / 16][4],
                                          const bf16* b, int bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const bf16* row =
        b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * bs;
#pragma unroll
    for (int n2 = 0; n2 < N / 16; ++n2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, row + (lane >> 4) * 8 + n2 * 16);
      mma(c[2 * n2], a[kk], bf[0], bf[1]);
      mma(c[2 * n2 + 1], a[kk], bf[2], bf[3]);
    }
    if constexpr (N % 16 == 8) {
      uint32_t bf[2];
      ldmatrix_x2_trans(bf, row + N - 8);
      mma(c[N / 8 - 1], a[kk], bf[0], bf[1]);
    }
  }
}

// the A fragments of a 16 x K bf16 tile in shared memory (stride ``as``)
template <int K>
__device__ __forceinline__ void load_a(uint32_t (&a)[K / 16][4],
                                       const bf16* t, int as, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    ldmatrix_x4(a[kk], t + (lane & 15) * as + kk * 16 + (lane >> 4) * 8);
}

// One CTA's walk over its keys [lo, hi) of one (row, kv head); ``tok``,
// ``res`` and ``rope`` as for chunk_block.  The caller commits its own
// copies (Q, held B_k) first, zeroes the gap columns (``zero_gaps``),
// then calls ``start`` and ``run``.
template <int D, int DR, bool INT8, bool HOLD, int S_, class Tok, class Res,
          class Rope>
struct DecodePipe {
  using L = DecodeChunk<D, INT8, HOLD, S_>;
  using C = Cols<D, DR>;
  static constexpr int S = L::S, BK = L::BK, DS = L::DS, RS = L::RS,
                       HS = L::HS, PS = L::PS, QD = L::QD, kNch = L::kNch;
  unsigned char* sm;
  ChunkSrc s;
  int lo, hi, nblocks, nch, steps, tid, warp, lane;
  Tok tok;
  Res res;
  Rope rope;

  __device__ DecodePipe(unsigned char* sm_, const ChunkSrc& s_, int lo_,
                        int hi_, Tok tok_, Res res_, Rope rope_)
      : sm(sm_), s(s_), lo(lo_), hi(hi_), tok(tok_), res(res_),
        rope(rope_) {
    nch = (s.R + kRankChunk - 1) / kRankChunk;
    nblocks = lo < hi ? (hi - lo + BK - 1) / BK : 0;
    steps = nblocks * 2 * nch;
    tid = threadIdx.x;
    warp = tid >> 5;
    lane = tid & 31;
  }

  __device__ __forceinline__ bf16* held() const {
    return reinterpret_cast<bf16*>(sm + L::kBytes);
  }

  // B_k's rows (HOLD), zero from R to the whole chunk
  __device__ void issue_held() const {
    if constexpr (HOLD) {
      bf16* bk = held();
      for (int e = tid; e < nch * kRankChunk * C::kRow; e += 32 * L::NW) {
        const int rr = e / C::kRow, i = e % C::kRow;
        const bool ok = rr < s.R;
        C::row(bk + rr * DS, s.bk + (ok ? (long)rr * s.hd : 0), i, ok);
      }
    }
  }

  // the gap columns (DR < D) of every tile a copy never fills
  __device__ void zero_gaps() const {
    constexpr int NT = 32 * L::NW;
    if constexpr (!HOLD)
      for (int st = 0; st < S; ++st)
        C::zero_gaps(reinterpret_cast<bf16*>(sm + L::kRing + st * L::kStage +
                                             L::kStageB),
                     kRankChunk, DS, tid, NT);
    else
      C::zero_gaps(held(), nch * kRankChunk, DS, tid, NT);
    if constexpr (!INT8)
      C::zero_gaps(reinterpret_cast<bf16*>(sm + L::kKbuf), BK, DS, tid, NT);
    C::zero_gaps(reinterpret_cast<bf16*>(sm + L::kVtile), BK, DS, tid, NT);
    C::zero_table_gaps(reinterpret_cast<bf16*>(sm + L::kSin), BK, HS, tid,
                       NT);
    C::zero_table_gaps(reinterpret_cast<bf16*>(sm + L::kCos), BK, HS, tid,
                       NT);
  }

  // K_b (V_b when V) rows of key row t of block j0 into its buffer
  template <bool V>
  __device__ __forceinline__ void issue_base(int t, int kpos, bool ok,
                                             int half) const {
    unsigned char* buf = sm + (V ? L::kVbuf : L::kKbuf);
    const long tk = ok ? tok(kpos) : 0;
    if constexpr (!INT8) {
      const bf16* kb = static_cast<const bf16*>(V ? s.vb : s.kb);
      bf16* dst = reinterpret_cast<bf16*>(buf) + t * DS;
      for (int i = half; i < C::kRow; i += 2)
        C::row(dst, kb + tk * DR, i, ok);
    } else {
      const int8_t* kb = static_cast<const int8_t*>(V ? s.vb : s.kb);
      for (int i = half; i < C::kCodeRow; i += 2)
        C::codes(buf + t * D, kb + tk * DR, i, ok);
      if (half == 0)
        cp_async4(reinterpret_cast<float*>(buf + BK * D) + t,
                  (V ? s.vb_s : s.kb_s) + tk, ok);
    }
  }

  // Copies of step ``step``: block step / (2 nch), then K step c < nch or
  // V step c - nch.  Thread tid takes key row tid / 2 (and B row tid / 2)
  // and every other copy of it.
  __device__ void issue(int step) const {
    const int per = 2 * nch, blk = step / per, k = step % per;
    const bool v = k >= nch;
    const int c = v ? k - nch : k;
    const int j0 = lo + blk * BK, r0 = c * kRankChunk, R = s.R;
    unsigned char* st = sm + L::kRing + (step % S) * L::kStage;
    bf16* rch = reinterpret_cast<bf16*>(st);
    const int t = tid >> 1, half = tid & 1, kpos = j0 + t;
    const bool ok = kpos < hi;
    const bf16* r = v ? s.vr : s.kr;
    const long row = ok ? res(kpos) * R : 0;
    if (R % 8 == 0) {
#pragma unroll
      for (int g = half; g < kRankChunk / 8; g += 2) {
        const bool okr = ok && r0 + 8 * g < R;
        cp_async16(rch + t * RS + 8 * g, r + (okr ? row + r0 + 8 * g : 0),
                   okr);
      }
    } else {            // rows of R elements are not 16-byte aligned
      for (int cc = half * 32; cc < half * 32 + 32; ++cc)
        rch[t * RS + cc] = ok && r0 + cc < R ? r[row + r0 + cc]
                                             : __float2bfloat16(0.f);
    }
    if (!HOLD && !v) {  // rows r0 + t of B_k
      bf16* bch = reinterpret_cast<bf16*>(st + L::kStageB) + t * DS;
      const bool okb = r0 + t < R;
      const bf16* src = s.bk + (okb ? (long)(r0 + t) * s.hd : 0);
      for (int i = half; i < C::kRow; i += 2) C::row(bch, src, i, okb);
    }
    if (k == 0) {       // the block's K_b, sin and cos
      issue_base<false>(t, kpos, ok, half);
      const long rp = ok ? rope(kpos) * (DR / 2) : 0;
      bf16* sn = reinterpret_cast<bf16*>(sm + L::kSin) + t * HS;
      bf16* cs = reinterpret_cast<bf16*>(sm + L::kCos) + t * HS;
      for (int i = half; i < C::kHalf; i += 2) {
        C::half(sn, s.sin + rp, i, ok);
        C::half(cs, s.cos + rp, i, ok);
      }
    }
    if (k == nch) issue_base<true>(t, kpos, ok, half);
  }

  // the S - 1 first steps
  __device__ void start() const {
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < steps) issue(i);
      cp_async_commit();
    }
  }

  // step ``t``'s copies landed and the stage the step before read free;
  // step t + S - 1 issued into it
  __device__ __forceinline__ void advance(int t) const {
    if constexpr (S == 1) {
      __syncthreads();
      issue(t);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      cp_async_wait<S - 2>();
      __syncthreads();
      if (t + S - 1 < steps) issue(t + S - 1);
      cp_async_commit();
    }
  }

  // K step ``t`` (chunk c): the warp's 16 keys' sums of n-tile pairs (j, j
  // + D/16) += K_r,c . B_k,c, the rank in order (chunk_block's chain)
  __device__ __forceinline__ void multiply(int t, int c,
                                           float (&x1)[D / 16][4],
                                           float (&x2)[D / 16][4]) const {
    const unsigned char* st = sm + L::kRing + (t % S) * L::kStage;
    const bf16* rch = reinterpret_cast<const bf16*>(st) + 16 * warp * RS;
    const bf16* bch =
        HOLD ? held() + c * kRankChunk * DS
             : reinterpret_cast<const bf16*>(st + L::kStageB);
#pragma unroll
    for (int kk = 0; kk < kRankChunk / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, rch + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
      const bf16* row =
          bch + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
          (lane >> 4) * 8;
#pragma unroll
      for (int n2 = 0; n2 < D / 32; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, row + 16 * n2);
        mma(x1[2 * n2], af, b[0], b[1]);
        mma(x1[2 * n2 + 1], af, b[2], b[3]);
        ldmatrix_x4_trans(b, row + D / 2 + 16 * n2);
        mma(x2[2 * n2], af, b[0], b[1]);
        mma(x2[2 * n2 + 1], af, b[2], b[3]);
      }
    }
  }

  // K = bf16(K_b + RoPE(sums)) of the warp's keys as the B fragments of S
  // = Q K^T (16 heads x 16 keys), 4 n-tiles at a time
  template <class QFrag>
  __device__ __forceinline__ void scores(float (&sc)[2][4],
                                         const float (&x1)[D / 16][4],
                                         const float (&x2)[D / 16][4],
                                         QFrag qfrag) const {
    const bf16* sn = reinterpret_cast<const bf16*>(sm + L::kSin);
    const bf16* cs = reinterpret_cast<const bf16*>(sm + L::kCos);
    const unsigned char* kb = sm + L::kKbuf;
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      uint32_t kf[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * i + jj;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = 16 * warp + (lane >> 2) + 8 * hh;
          const int col = 8 * j + 2 * (lane & 3);
          const float2 s2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sn + t * HS + col));
          const float2 c2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(cs + t * HS + col));
          float2 b1, b2;
          if constexpr (INT8) {
            const unsigned char* codes = kb + t * D;
            const float scl = reinterpret_cast<const float*>(kb + BK * D)[t];
            // bf16(code * scale), as dequantize_cols rounds; zero in a gap
            auto deq = [&](int cc) {
              const int e = C::elem(cc);
              if (e < 0) return make_float2(0.f, 0.f);
              return __bfloat1622float2(__floats2bfloat162_rn(
                  __fmul_rn((float)(int8_t)codes[e], scl),
                  __fmul_rn((float)(int8_t)codes[e + 1], scl)));
            };
            b1 = deq(col);
            b2 = deq(col + D / 2);
          } else {
            const bf16* row = reinterpret_cast<const bf16*>(kb) + t * DS;
            b1 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(row + col));
            b2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(row + col + D / 2));
          }
          // rebuild_k's f32 operations, uncontracted
          kf[jj][hh] = pack_bf16(
              b1.x + rot(x1[j][2 * hh], c2.x, x2[j][2 * hh], -s2.x),
              b1.y + rot(x1[j][2 * hh + 1], c2.y, x2[j][2 * hh + 1], -s2.y));
          kf[2 + jj][hh] = pack_bf16(
              b2.x + rot(x2[j][2 * hh], c2.x, x1[j][2 * hh], s2.x),
              b2.y + rot(x2[j][2 * hh + 1], c2.y, x1[j][2 * hh + 1], s2.y));
        }
      }
      uint32_t qa[4];
      qfrag(i, qa);
      mma(sc[0], qa, kf[0][0], kf[1][0]);
      mma(sc[1], qa, kf[0][1], kf[1][1]);
      qfrag(i + D / 32, qa);
      mma(sc[0], qa, kf[2][0], kf[3][0]);
      mma(sc[1], qa, kf[2][1], kf[3][1]);
    }
  }

  // The whole range: O (the warp's QD columns), acc_r (the warp's 16
  // columns of each rank chunk), the running max m (the same in every
  // warp) and the thread's partial row sums l (over the warp's keys).
  template <class QFrag>
  __device__ void run(float (&o)[QD / 8][4], float (&accr)[2 * kNch][4],
                      float (&m)[2], float (&l)[2], float scale_log2,
                      QFrag qfrag) const {
#pragma unroll
    for (int n = 0; n < QD / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * kNch; ++n)
      accr[n][0] = accr[n][1] = accr[n][2] = accr[n][3] = 0.f;
    m[0] = m[1] = kNegInit;
    l[0] = l[1] = 0.f;
    float* mxs = reinterpret_cast<float*>(sm + L::kMx);
    bf16* ps = reinterpret_cast<bf16*>(sm + L::kP);
    const int c0 = warp * QD;
    int t = 0;
    for (int blk = 0; blk < nblocks; ++blk) {
      float x1[D / 16][4], x2[D / 16][4];
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x1[j][e] = x2[j][e] = 0.f;
      for (int c = 0; c < nch; ++c, ++t) {
        advance(t);
        multiply(t, c, x1, x2);
      }
      float sc[2][4];
      scores(sc, x1, x2, qfrag);
      const int k0 = lo + blk * BK + 16 * warp;
      if (k0 + 16 > hi) {
        const int pos[2] = {0, 0};              // not read: no causal mask
        mask<16>(sc, k0, pos, hi, false, 0, lane);
      }
      // the block's row maxima over the 4 warps, then softmax_step's
      // arithmetic with them
      float mx[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mx[h] = fmaxf(mx[h], fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if ((lane & 3) == 0) mxs[warp * 16 + (lane >> 2) + 8 * h] = mx[h];
      }
      __syncthreads();
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (lane >> 2) + 8 * h;
        float bm = -CUDART_INF_F;
#pragma unroll
        for (int w = 0; w < L::NW; ++w) bm = fmaxf(bm, mxs[w * 16 + r]);
        const float m_new = fmaxf(m[h], bm * scale_log2);
        alpha[h] = exp2f(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(sc[n][2 * h + e], scale_log2, -m_new));
            sc[n][2 * h + e] = p;
            sum += p;
          }
        l[h] = l[h] * alpha[h] + sum;
        m[h] = m_new;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<uint32_t*>(ps + r * PS + 16 * warp + 8 * n +
                                       2 * (lane & 3)) =
              pack_bf16(sc[n][2 * h], sc[n][2 * h + 1]);
      }
      rescale<QD / 8>(o, alpha);
      rescale<2 * kNch>(accr, alpha);
      // V steps: O += P V_b at the first, acc_r += P V_r,c at each
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int c = 0; c < kNch; ++c) {
        if (c >= nch) break;
        advance(t);
        if (c == 0) {
          if constexpr (INT8) {     // bf16(code * scale) into the V tile
            dequantize_cols<D, DR>(
                sm + L::kVbuf,
                reinterpret_cast<const float*>(sm + L::kVbuf + BK * D),
                reinterpret_cast<bf16*>(sm + L::kVtile), DS, BK, tid,
                32 * L::NW);
            __syncthreads();
          }
          load_a<BK>(pa, ps, PS, lane);
          product_a<BK, QD>(o, pa,
                            reinterpret_cast<const bf16*>(sm + L::kVtile) +
                                c0,
                            DS, lane);
        }
        const bf16* vr = reinterpret_cast<const bf16*>(
                             sm + L::kRing + (t % S) * L::kStage) +
                         16 * warp;
        float pr[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pr[0][e] = accr[2 * c][e];
          pr[1][e] = accr[2 * c + 1][e];
        }
        product_a<BK, 16>(pr, pa, vr, RS, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          accr[2 * c][e] = pr[0][e];
          accr[2 * c + 1][e] = pr[1][e];
        }
        ++t;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // sum_w l_w of the thread's two rows (after ``run``; uses the maxima's
  // buffer)
  __device__ void row_sums(float (&l)[2], float (&lsum)[2]) const {
    float* buf = reinterpret_cast<float*>(sm + L::kMx);
    finish_rowsum(l);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if ((lane & 3) == 0) buf[warp * 16 + (lane >> 2) + 8 * h] = l[h];
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] = 0.f;
#pragma unroll
      for (int w = 0; w < L::NW; ++w)
        lsum[h] += buf[w * 16 + (lane >> 2) + 8 * h];
    }
  }

  // The partial of head row r of this CTA into the workspace row ``row``:
  // m, l (from lane % 4 == 0 of warp 0), the warp's DR-real O columns and
  // its acc_r columns below R
  __device__ void store_partial(const float (&o)[QD / 8][4],
                                const float (&accr)[2 * kNch][4],
                                const float (&m)[2], const float (&lsum)[2],
                                int hh, long row, float* ws_m, float* ws_l,
                                float* ws_acc, float* ws_accr) const {
    if (warp == 0 && (lane & 3) == 0) {
      ws_m[row] = m[hh];
      ws_l[row] = lsum[hh];
    }
#pragma unroll
    for (int n = 0; n < QD / 8; ++n) {
      // a pair never straddles a gap
      const int e = C::elem(warp * QD + 8 * n + 2 * (lane & 3));
      if (e >= 0)
        *reinterpret_cast<float2*>(ws_acc + row * DR + e) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
#pragma unroll
    for (int c = 0; c < kNch; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * kRankChunk + 16 * warp + 8 * n +
                          2 * (lane & 3) + e;
          if (col < s.R) ws_accr[row * s.R + col] = accr[2 * c + n][2 * hh + e];
        }
  }

  // #8's one range: O + bf16(acc_r) . B_v over the warp's QD columns, the
  // rank in chunks of 64 (B_v rows through kbuf), as the MMA's f32 sums
  __device__ void apply_bv(float (&o)[QD / 8][4],
                           const float (&accr)[2 * kNch][4]) const {
    bf16* ar = reinterpret_cast<bf16*>(sm + L::kRing);
    bf16* bv = reinterpret_cast<bf16*>(sm + L::kKbuf);
#pragma unroll
    for (int c = 0; c < kNch; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(
              ar + ((lane >> 2) + 8 * hh) * L::AS + c * kRankChunk +
              16 * warp + 8 * n + 2 * (lane & 3)) =
              pack_bf16(accr[2 * c + n][2 * hh], accr[2 * c + n][2 * hh + 1]);
    C::zero_gaps(bv, kRankChunk, DS, tid, 32 * L::NW);
    for (int c = 0; c < nch; ++c) {
      __syncthreads();                  // the chunk before read
      const int t = tid >> 1, half = tid & 1, rr = c * kRankChunk + t;
      const bool ok = rr < s.R;
      const bf16* src = s.bv + (ok ? (long)rr * s.hd : 0);
      for (int i = half; i < C::kRow; i += 2)
        C::row(bv + t * DS, src, i, ok);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      uint32_t af[kRankChunk / 16][4];
      load_a<kRankChunk>(af, ar + c * kRankChunk, L::AS, lane);
      product_a<kRankChunk, QD>(o, af, bv + warp * QD, DS, lane);
    }
  }
};

}  // namespace flash
