// The disaggregated kernels for NVIDIA Hopper (sm_90a): the redesigned
// kernels of three Pallas entries of
// repro/kernels/paged_residual_attention.py, each with its int8 branch,
//   paged_residual_attention_prefill (#5, _kernel_prefill; int8 :516)
//   paged_residual_attention_mixed   (#1, _kernel_mixed;   int8 :787)
//   paged_residual_attention_decode  (#2, _kernel;         int8 :231)
// apart from paged_residual_attention.cu so that the two sources build in
// parallel.  A bf16 launch of #5 or #1 runs the tensor-core tile
// paged_prefill_res_mma_kernel (bound by operations for long prefill rows;
// #1 gives each row's q_len, #5 derives it); an f32 launch the scalar
// template (paged_template.cuh).  Every launch of #2 runs a split-K
// decode, in bf16 paged_decode_res_split_kernel (bound by bytes), in f32
// the template share by share, then paged_decode_res_combine_kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "flash_tile.cuh"
#include "paged_template.cuh"
#include "rank_chunk.cuh"

namespace {

// ---------------------------------------------------------------------
// bf16 disaggregated chunked prefill and mixed grid on the tensor cores:
// paged_residual_attention_prefill (#5) and paged_residual_attention_mixed
// (#1), each with its int8 branch, q in bf16.
//
// #6's tile (paged_residual_attention.cu) with the rebuild of the dense
// prefill's tile (residual_attention_mma_kernel, residual_attention.cu):
// 128 query rows of 8 warps per CTA, 64-key blocks, cp.async into the
// other of two stages of
//   * K_b/V_b rows gathered through bt_b[kpos / page] (int8: codes and
//     scales into a staging stage, then bf16(code * scale) in one bf16
//     K/V tile, where the plain version rounds);
//   * K_r/V_r rows gathered through bt_r (the residual pools are
//     (Pr, page, R): a key's row is R elements; ranks not a multiple of 8
//     are copied element by element, columns R..RP-1 stay zero);
//   * the block's rows of the RoPE tables, sin and cos of each position
//     rounded to q's type as the plain version rounds them (built once by
//     the wrapper; a row per position, so a block is contiguous).
// Keys at or past min(kv_len, W * page) are zero-filled, never read.
// K = K_b + RoPE(K_r . B_k): K_r (64 x RP, RP = 16, 32 or 64; the
// smallest that holds R) . B_k (RP x D)
// as MMAs whose accumulator holds columns c and c + D/2 in one thread, so
// RoPE rotates in registers; K_b is added in f32 and the sum rounded once
// to bf16 into the K tile.  Then #6's S = Q K^T, masks on blocks that
// straddle an edge, online softmax in registers, O += P V_b and O_r +=
// P V_r (P in bf16), and at the end O += O_r . B_v (O_r in bf16), O /
// max(l, 1e-20).  q_len is derived from kv_len - start unless given (#1's
// ragged rows: prefill rows, decode rows of q_len 1, q_len 0 padding), as
// #6's tile takes #3's rows: the rows at or past q_len are zeroed and a
// tile with none below it returns after the zeroing, so a mixed launch
// costs its valid rows plus the zero stores of its padding (B * Sq * Hq *
// D * 2 bytes in all).  Each q tile of a row repeats the rebuild of the blocks
// it reads: 2 R D MMA flops per key against 4 * 128 * D for its QK and PV,
// ~6% more tensor work at R 16; the rebuilt K never leaves the chip.
// Head rows of DR < D (head_dim 120) run in D 128's tile in the split-half
// layout of flash::Cols, as the dense prefill (#7) runs them: RoPE's
// c <-> c + 60 becomes the tile's c <-> c + 64; Q, B_k, B_v, the K/V tiles
// and the sin/cos rows keep zero gap columns, so the rebuilt K is zero
// there; q, the pages and the tables are read as they are.
template <int D, int RP, bool INT8>
struct PagedResMmaLayout {
  static constexpr int BK = 64;
  static constexpr int DS = D + flash::kPad;       // Q, K, V, B_k, B_v rows
  static constexpr int RS = RP + flash::kPad;      // K_r, V_r rows
  static constexpr int HS = D / 2 + flash::kPad;   // sin, cos rows
  static constexpr int kTile = 2 * BK * DS;        // a K and a V tile
  // bf16 elements of a stage: the K/V tile (bf16 pages; int8 pages share
  // one converted tile), K_r, V_r, sin, cos
  static constexpr int kKr = INT8 ? 0 : kTile, kVr = kKr + BK * RS,
                       kSin = kVr + BK * RS, kCos = kSin + BK * HS,
                       kStage = kCos + BK * HS;
  // Q, B_k, B_v, (int8) the converted K/V tile, two stages; then, int8
  // only, bytes of two stages of codes (K, V: BK x D) and scales
  static constexpr int kQ = 0, kBk = kQ + flash::kRows * DS,
                       kBv = kBk + RP * DS, kKV8 = kBv + RP * DS,
                       kStages = kKV8 + (INT8 ? kTile : 0),
                       kElems = kStages + 2 * kStage;
  static constexpr int kStage8 = 2 * BK * D + 2 * BK * (int)sizeof(float);
  static constexpr size_t kBytes =
      (size_t)kElems * sizeof(__nv_bfloat16) + (INT8 ? 2 * kStage8 : 0);
};

template <int D, int DR, int RP, bool INT8>
__global__ void __launch_bounds__(flash::kThreads, 1)
paged_prefill_res_mma_kernel(Args a, int bsz) {
  using flash::bf16;
  using L = PagedResMmaLayout<D, RP, INT8>;
  using C = flash::Cols<D, DR>;           // head rows of DR in D columns
  constexpr int BK = L::BK, DS = L::DS, RS = L::RS, HS = L::HS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = sm + L::kQ;
  bf16* Bks = sm + L::kBk;
  bf16* Bvs = sm + L::kBv;
  unsigned char* staging = smem_raw + L::kElems * sizeof(bf16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.hq / a.hkv, page = a.page, R = a.r;
  const int ntiles = (a.sq + a.tq - 1) / a.tq;
  const int per_tile = a.hkv * bsz;
  const int tile = ntiles - 1 - (int)(blockIdx.x / per_tile);
  const int h = (int)(blockIdx.x % per_tile) % a.hkv;
  const int b = (int)(blockIdx.x % per_tile) / a.hkv;

  const int kvlen = a.kv_len[b];
  const int start = a.start[b];
  // the mixed grid (#1) gives each row's q_len; the chunked prefill (#5)
  // derives it
  const int qlen = a.q_len ? a.q_len[b] : max(0, min(a.sq, kvlen - start));
  const int q0 = tile * a.tq;
  const int npos = min(a.tq, a.sq - q0);
  const int nq = max(0, min(npos, qlen - q0));
  bf16* out = static_cast<bf16*>(a.out);
  const long out_tile = ((long)b * a.sq + q0) * a.hq + (long)h * G;

  // rows at or past q_len: exact zeros
  for (int e = tid; e < (npos - nq) * G * (DR / 8); e += flash::kThreads) {
    const int qi = nq + e / (G * (DR / 8)), rest = e % (G * (DR / 8));
    *reinterpret_cast<uint4*>(out + (out_tile + (long)qi * a.hq) * DR +
                              rest * 8) = make_uint4(0, 0, 0, 0);
  }
  if (nq == 0) return;
  const int nrows = nq * G;                         // row = qi * G + g
  const long hd = (long)a.hkv * DR;

  // Q rows (zero past nrows), B_k and B_v rows (zero from R to RP)
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* bk = static_cast<const bf16*>(a.bk);
  const bf16* bv = static_cast<const bf16*>(a.bv);
  for (int e = tid; e < flash::kRows * C::kRow; e += flash::kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < nrows;
    const bf16* src =
        ok ? q + (out_tile + (long)(r / G) * a.hq + r % G) * DR : q;
    C::row(Qs + r * DS, src, i, ok);
  }
  for (int e = tid; e < RP * C::kRow; e += flash::kThreads) {
    const int rr = e / C::kRow, i = e % C::kRow;
    const bool ok = rr < R;
    const long src = ok ? ((long)b * R + rr) * hd + (long)h * DR : 0;
    C::row(Bks + rr * DS, bk + src, i, ok);
    C::row(Bvs + rr * DS, bv + src, i, ok);
  }
  flash::cp_async_commit();
  // the split-half layout's gap columns (DR < D) stay zero in Q, B_k, B_v,
  // the K/V tiles and the sin/cos rows of both stages (int8 pages: the one
  // converted tile), as do K_r / V_r columns R..RP-1
  C::zero_gaps(Qs, flash::kRows, DS, tid, flash::kThreads);
  C::zero_gaps(Bks, RP, DS, tid, flash::kThreads);
  C::zero_gaps(Bvs, RP, DS, tid, flash::kThreads);
  if constexpr (INT8)
    C::zero_gaps(sm + L::kKV8, 2 * BK, DS, tid, flash::kThreads);
  for (int st = 0; st < 2; ++st) {
    bf16* base = sm + L::kStages + st * L::kStage;
    for (int e = tid; e < BK * (RP - R); e += flash::kThreads) {
      const int t = e / (RP - R), rr = R + e % (RP - R);
      base[L::kKr + t * RS + rr] = __float2bfloat16(0.f);
      base[L::kVr + t * RS + rr] = __float2bfloat16(0.f);
    }
    if constexpr (!INT8) C::zero_gaps(base, 2 * BK, DS, tid, flash::kThreads);
    C::zero_table_gaps(base + L::kSin, BK, HS, tid, flash::kThreads);
    C::zero_table_gaps(base + L::kCos, BK, HS, tid, flash::kThreads);
  }

  const int klimit = min(kvlen, a.w * page);
  const int qpos_lo = start + q0, qpos_hi = start + q0 + nq - 1;
  const int last_k = min(klimit - 1, qpos_hi);
  const int first_k = a.window > 0 ? max(qpos_lo - (a.window - 1), 0) : 0;
  const int jb0 = first_k / BK;
  const int nblocks = last_k >= 0 ? max(0, last_k / BK - jb0 + 1) : 0;
  const int* bt = a.bt_b + (long)b * a.w;
  const int* btr = a.bt_r + (long)b * a.w;
  const bool vec_res = (R % 8) == 0;
  const bf16* kr = static_cast<const bf16*>(a.kr);
  const bf16* vr = static_cast<const bf16*>(a.vr);
  const bf16* sin_tab = static_cast<const bf16*>(a.sin);
  const bf16* cos_tab = static_cast<const bf16*>(a.cos);

  // element offset of (key kpos, head h, column 0) in the base pools (and
  // the scale offset of (kpos, h)); of (key kpos, column 0) in the
  // residual pools
  auto token = [&](int kpos) {
    const long pb = bt[kpos / page];
    return (pb * page + kpos % page) * a.hkv + h;
  };
  auto res_token = [&](int kpos) {
    return ((long)btr[kpos / page] * page + kpos % page) * R;
  };
  auto load_block = [&](int blk, int st) {
    const int j0 = blk * BK;
    bf16* base = sm + L::kStages + st * L::kStage;
    if constexpr (!INT8) {
      const bf16* kb = static_cast<const bf16*>(a.kb);
      const bf16* vb = static_cast<const bf16*>(a.vb);
      for (int e = tid; e < BK * C::kRow; e += flash::kThreads) {
        const int t = e / C::kRow, i = e % C::kRow;
        const bool ok = j0 + t < klimit;
        const long src = ok ? token(j0 + t) * DR : 0;
        C::row(base + t * DS, kb + src, i, ok);
        C::row(base + BK * DS + t * DS, vb + src, i, ok);
      }
    } else {
      const int8_t* kb = static_cast<const int8_t*>(a.kb);
      const int8_t* vb = static_cast<const int8_t*>(a.vb);
      unsigned char* s8 = staging + st * L::kStage8;
      float* ksc = reinterpret_cast<float*>(s8 + 2 * BK * D);
      for (int e = tid; e < BK * C::kCodeRow; e += flash::kThreads) {
        const int t = e / C::kCodeRow, i = e % C::kCodeRow;
        const bool ok = j0 + t < klimit;
        const long src = ok ? token(j0 + t) * DR : 0;
        C::codes(s8 + t * D, kb + src, i, ok);
        C::codes(s8 + BK * D + t * D, vb + src, i, ok);
      }
      for (int t = tid; t < BK; t += flash::kThreads) {
        const bool ok = j0 + t < klimit;
        const long src = ok ? token(j0 + t) : 0;
        flash::cp_async4(ksc + t, a.kb_s + src, ok);
        flash::cp_async4(ksc + BK + t, a.vb_s + src, ok);
      }
    }
    for (int e = tid; e < BK * C::kHalf; e += flash::kThreads) {
      const int t = e / C::kHalf, i = e % C::kHalf;
      const bool ok = j0 + t < klimit;
      const long src = ok ? (long)(j0 + t) * (DR / 2) : 0;
      C::half(base + L::kSin + t * HS, sin_tab + src, i, ok);
      C::half(base + L::kCos + t * HS, cos_tab + src, i, ok);
    }
    if (vec_res) {
      for (int e = tid; e < BK * (R / 8); e += flash::kThreads) {
        const int t = e / (R / 8), c = e % (R / 8);
        const bool ok = j0 + t < klimit;
        const long src = ok ? res_token(j0 + t) + c * 8 : 0;
        flash::cp_async16(base + L::kKr + t * RS + c * 8, kr + src, ok);
        flash::cp_async16(base + L::kVr + t * RS + c * 8, vr + src, ok);
      }
    } else {            // rows of R elements are not 16-byte aligned
      for (int e = tid; e < BK * R; e += flash::kThreads) {
        const int t = e / R, rr = e % R;
        const bool ok = j0 + t < klimit;
        const long src = ok ? res_token(j0 + t) + rr : 0;
        base[L::kKr + t * RS + rr] = ok ? kr[src] : __float2bfloat16(0.f);
        base[L::kVr + t * RS + rr] = ok ? vr[src] : __float2bfloat16(0.f);
      }
    }
  };

  float o[D / 8][4], orr[RP / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < RP / 8; ++n)
    orr[n][0] = orr[n][1] = orr[n][2] = orr[n][3] = 0.f;
  m[0] = m[1] = flash::kNegInit;
  l[0] = l[1] = 0.f;
  const float scale_log2 = a.scale * flash::kLog2e;
  int pos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    pos[hh] = qpos_lo + min(warp * 16 + (lane >> 2) + 8 * hh, nrows - 1) / G;

  if (nblocks > 0) load_block(jb0, 0);
  flash::cp_async_commit();
  flash::cp_async_wait<1>();                        // Q, B_k, B_v
  __syncthreads();
  uint32_t qf[D / 16][4];                           // Q's A fragments
  flash::load_q<D>(qf, Qs + warp * 16 * DS, DS, lane);
  for (int it = 0; it < nblocks; ++it) {
    const int st = it & 1;
    if (it + 1 < nblocks) load_block(jb0 + it + 1, st ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();
    const bf16* base = sm + L::kStages + st * L::kStage;
    bf16* Ks = INT8 ? sm + L::kKV8 : sm + L::kStages + st * L::kStage;
    if constexpr (INT8) {      // stage st's codes into the one bf16 tile
      const unsigned char* s8 = staging + st * L::kStage8;
      flash::dequantize_cols<D, DR>(
          s8, reinterpret_cast<const float*>(s8 + 2 * BK * D), Ks, DS,
          2 * BK, tid, flash::kThreads);
      __syncthreads();
    }
    const bf16* Krs = base + L::kKr;
    const bf16* Sn = base + L::kSin;
    const bf16* Cs = base + L::kCos;

    // K = K_b + RoPE(K_r . B_k) in place of K_b
    flash::rebuild_k<D, BK, RP>(Ks, DS, Krs, RS, Bks, DS, Sn, Cs, HS, warp,
                                lane);
    __syncthreads();

    const int j0 = (jb0 + it) * BK;
    float s[BK / 8][4], alpha[2];
    flash::scores<D, BK>(s, qf, Ks, DS, lane);
    const bool full = j0 + BK <= klimit && j0 + BK - 1 <= qpos_lo &&
                      (a.window <= 0 || j0 > qpos_hi - a.window);
    if (!full) flash::mask<BK>(s, j0, pos, klimit, true, a.window, lane);
    flash::softmax_step<BK>(s, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::rescale<RP / 8>(orr, alpha);
    flash::product<BK, D>(o, s, Ks + BK * DS, DS, lane);
    flash::product<BK, RP>(orr, s, base + L::kVr, RS, lane);
    __syncthreads();
  }
  flash::cp_async_wait<0>();

  // epilogue: (O + O_r . B_v) / max(l, 1e-20)
  flash::product<RP, D>(o, orr, Bvs, DS, lane);
  flash::finish_rowsum(l);
  bf16* dst[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + (lane >> 2) + 8 * hh;
    dst[hh] = r < nrows ? out + (out_tile + (long)(r / G) * a.hq + r % G) * DR
                        : nullptr;
  }
  flash::store_cols<D, D, DR>(o, l, dst, 0, lane);
}

template <int D, int DR, int RP, bool INT8>
int launch_prefill_res_mma(const Args& a, int bsz, cudaStream_t stream) {
  using L = PagedResMmaLayout<D, RP, INT8>;
  auto kernel = paged_prefill_res_mma_kernel<D, DR, RP, INT8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((a.sq + a.tq - 1) / a.tq) * a.hkv * bsz;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, flash::kThreads, L::kBytes, stream>>>(a, bsz);
  return (int)cudaGetLastError();
}

// The chunked instance of #5's tile (#1 shares it): ranks above
// kRankChunk (rank_chunk.cuh).  The same CTAs, rows, masks and zeroed rows
// past q_len as paged_prefill_res_mma_kernel, one stage, and per 64-key
// block K and V rebuilt rank chunk by chunk on chip (flash::chunk_block),
// so the key loop is O += P V with no O_r and no B_v epilogue.
template <int D, int DR, bool INT8>
__global__ void __launch_bounds__(flash::kThreads, 1)
paged_prefill_res_chunk_kernel(Args a, int bsz) {
  using flash::bf16;
  constexpr int BK = 64;
  using L = flash::ChunkBlock<D, BK, INT8>;
  using C = flash::Cols<D, DR>;
  constexpr int DS = L::DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* blk = smem_raw + flash::kRows * DS * sizeof(bf16);
  const bf16* Ks = reinterpret_cast<const bf16*>(blk) + L::kK;
  const bf16* Vs = reinterpret_cast<const bf16*>(blk) + L::kV;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.hq / a.hkv, page = a.page, R = a.r;
  const int ntiles = (a.sq + a.tq - 1) / a.tq;
  const int per_tile = a.hkv * bsz;
  const int tile = ntiles - 1 - (int)(blockIdx.x / per_tile);
  const int h = (int)(blockIdx.x % per_tile) % a.hkv;
  const int b = (int)(blockIdx.x % per_tile) / a.hkv;

  const int kvlen = a.kv_len[b];
  const int start = a.start[b];
  const int qlen = a.q_len ? a.q_len[b] : max(0, min(a.sq, kvlen - start));
  const int q0 = tile * a.tq;
  const int npos = min(a.tq, a.sq - q0);
  const int nq = max(0, min(npos, qlen - q0));
  bf16* out = static_cast<bf16*>(a.out);
  const long out_tile = ((long)b * a.sq + q0) * a.hq + (long)h * G;

  // rows at or past q_len: exact zeros
  for (int e = tid; e < (npos - nq) * G * (DR / 8); e += flash::kThreads) {
    const int qi = nq + e / (G * (DR / 8)), rest = e % (G * (DR / 8));
    *reinterpret_cast<uint4*>(out + (out_tile + (long)qi * a.hq) * DR +
                              rest * 8) = make_uint4(0, 0, 0, 0);
  }
  if (nq == 0) return;
  const int nrows = nq * G;                         // row = qi * G + g
  const long hd = (long)a.hkv * DR;

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < flash::kRows * C::kRow; e += flash::kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < nrows;
    const bf16* src =
        ok ? q + (out_tile + (long)(r / G) * a.hq + r % G) * DR : q;
    C::row(Qs + r * DS, src, i, ok);
  }
  flash::cp_async_commit();
  C::zero_gaps(Qs, flash::kRows, DS, tid, flash::kThreads);
  flash::chunk_zero_gaps<D, DR, BK, INT8>(blk, tid, flash::kThreads);

  const int klimit = min(kvlen, a.w * page);
  const int qpos_lo = start + q0, qpos_hi = start + q0 + nq - 1;
  const int last_k = min(klimit - 1, qpos_hi);
  const int first_k = a.window > 0 ? max(qpos_lo - (a.window - 1), 0) : 0;
  const int jb0 = first_k / BK;
  const int nblocks = last_k >= 0 ? max(0, last_k / BK - jb0 + 1) : 0;
  const int* bt = a.bt_b + (long)b * a.w;
  const int* btr = a.bt_r + (long)b * a.w;
  const long b0 = (long)b * R * hd + (long)h * DR;
  const flash::ChunkSrc src{
      a.kb, a.vb, a.kb_s, a.vb_s, static_cast<const bf16*>(a.kr),
      static_cast<const bf16*>(a.vr), static_cast<const bf16*>(a.bk) + b0,
      static_cast<const bf16*>(a.bv) + b0, hd,
      static_cast<const bf16*>(a.sin), static_cast<const bf16*>(a.cos), R};
  auto tok = [&](int kpos) {
    return ((long)bt[kpos / page] * page + kpos % page) * a.hkv + h;
  };
  auto res = [&](int kpos) {
    return (long)btr[kpos / page] * page + kpos % page;
  };
  auto rope = [&](int kpos) { return (long)kpos; };

  float o[D / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  m[0] = m[1] = flash::kNegInit;
  l[0] = l[1] = 0.f;
  const float scale_log2 = a.scale * flash::kLog2e;
  int pos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    pos[hh] = qpos_lo + min(warp * 16 + (lane >> 2) + 8 * hh, nrows - 1) / G;

  flash::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];                           // Q's A fragments
  flash::load_q<D>(qf, Qs + warp * 16 * DS, DS, lane);
  for (int it = 0; it < nblocks; ++it) {
    const int j0 = (jb0 + it) * BK;
    flash::chunk_block<D, DR, BK, flash::kWarps, INT8>(
        blk, src, j0, 0, klimit, tok, res, rope, tid, warp, lane);
    float s[BK / 8][4], alpha[2];
    flash::scores<D, BK>(s, qf, Ks, DS, lane);
    const bool full = j0 + BK <= klimit && j0 + BK - 1 <= qpos_lo &&
                      (a.window <= 0 || j0 > qpos_hi - a.window);
    if (!full) flash::mask<BK>(s, j0, pos, klimit, true, a.window, lane);
    flash::softmax_step<BK>(s, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::product<BK, D>(o, s, Vs, DS, lane);
    __syncthreads();                  // the tiles are refilled next block
  }

  flash::finish_rowsum(l);
  bf16* dst[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + (lane >> 2) + 8 * hh;
    dst[hh] = r < nrows ? out + (out_tile + (long)(r / G) * a.hq + r % G) * DR
                        : nullptr;
  }
  flash::store_cols<D, D, DR>(o, l, dst, 0, lane);
}

template <int D, int DR, bool INT8>
int launch_prefill_res_chunk(const Args& a, int bsz, cudaStream_t stream) {
  constexpr size_t smem = (size_t)flash::kRows * (D + flash::kPad) * 2 +
                          flash::ChunkBlock<D, 64, INT8>::kBytes;
  auto kernel = paged_prefill_res_chunk_kernel<D, DR, INT8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((a.sq + a.tq - 1) / a.tq) * a.hkv * bsz;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, flash::kThreads, smem, stream>>>(a, bsz);
  return (int)cudaGetLastError();
}

// RP: the smallest instance (16, 32, 64) that holds the rank; above 64 the
// chunked instance
template <int D, int DR = D>
int launch_prefill_res_rank(const Args& a, int bsz, cudaStream_t s) {
  const bool int8 = a.kb_s != nullptr;
  if (a.r > flash::kRankChunk)
    return int8 ? launch_prefill_res_chunk<D, DR, true>(a, bsz, s)
                : launch_prefill_res_chunk<D, DR, false>(a, bsz, s);
  if (a.r <= 16)
    return int8 ? launch_prefill_res_mma<D, DR, 16, true>(a, bsz, s)
                : launch_prefill_res_mma<D, DR, 16, false>(a, bsz, s);
  if (a.r <= 32)
    return int8 ? launch_prefill_res_mma<D, DR, 32, true>(a, bsz, s)
                : launch_prefill_res_mma<D, DR, 32, false>(a, bsz, s);
  return int8 ? launch_prefill_res_mma<D, DR, 64, true>(a, bsz, s)
              : launch_prefill_res_mma<D, DR, 64, false>(a, bsz, s);
}

// The bf16 disaggregated chunked prefill (q_len null) and mixed grid (q_len
// given): D 32/64/128, and 120 in D 128's tile (split halves,
// ``flash::Cols``); any R >= 1 (above 64 the chunked instance), tq * G <=
// 128 rows, page 1..32, bf16 or int8 pages, RoPE tables given.
int dispatch_prefill_res_mma(const Args& a, int bsz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a.kb_s == nullptr) != (a.vb_s == nullptr) || a.tq < 1 ||
      a.tq * (a.hq / a.hkv) > flash::kRows || a.page < 1 || a.page > 32 ||
      a.r < 1 || a.sin == nullptr || a.cos == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a.d == 32) return launch_prefill_res_rank<32>(a, bsz, s);
  if (a.d == 64) return launch_prefill_res_rank<64>(a, bsz, s);
  if (a.d == 128) return launch_prefill_res_rank<128>(a, bsz, s);
  if (a.d == 120) return launch_prefill_res_rank<128, 120>(a, bsz, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// Split-K paged decode with the residual stream: paged_residual_attention_
// decode (#2) and its int8 branch.
//
// #4's plan (paged_residual_attention.cu: a row's live keys cut into n_split equal shares, f32
// partials in a workspace, a combine launched programmatically) with two
// things added: each share keeps a second accumulator acc_r = sum p V_r of
// R columns per head, and the combine applies B_v after the reduction:
//   out = (sum_s w_s acc_s + (sum_s w_s acc_r,s) . B_v) / max(sum_s w_s l_s,
//   1e-20),  w_s = 2^(m_s - max m),
// over the shares that saw a key, so a row with none comes out exactly 0.
// The rebuild K = K_b + RoPE(K_r . B_k) costs R D FMAs per key and kv
// head, 4x the G D of the scores at R 16 and G 4, so in bf16 every product
// runs on the tensor cores as mma.sync m16n8k16:
//   * a CTA is 4 warps over 16 query heads of one kv head (one m16 tile:
//     G <= 16 heads, rows past G are zero; a larger group takes several
//     CTAs); each warp takes a share of its own, in steps of 16 keys, so
//     shares are multiples of 16 keys and warps never meet after the
//     start;
//   * per step, cp.async brings into the other of the warp's two stages
//     the K_b/V_b rows through bt_b (int8: codes and scales), the K_r/V_r
//     rows through bt_r and the step's rows of the RoPE tables (as #5);
//   * K_r (16 keys x RP) . B_k (RP x D, in shared memory once per CTA)
//     runs with keys as M, so the accumulator of n-tiles j and j + D/16
//     holds columns c and c + D/2 of one key: RoPE rotates in registers,
//     K_b is added (int8: bf16(code * scale) first, as the plain version
//     rounds) and the sum rounded once to bf16, and these accumulators are
//     exactly the B fragments of S = Q . K^T with the keys as N, so the
//     rebuilt K never leaves the registers;
//   * S (16 heads x 16 keys), the online softmax in registers (base 2),
//     O += P V_b and O_r += P V_r with P in bf16 (V_b from shared memory;
//     int8 pages dequantized to a bf16 tile of the warp first);
//   * the warp writes m, l, acc (D) and acc_r (R) of its share.
// Shared memory per warp is two stages of K, V, K_r, V_r and the two table
// rows (~30 KB at D 128, R 16, bf16 pages), so one CTA of 4 warps fits per
// SM at D 128 with bf16 pages (two with int8 pages, three at D 64); the
// wrapper's ``res_split_plan`` sizes n_split to fill those slots in one
// pass.  (One buffer of table rows per warp, refilled once the rebuild has
// read it, fits two CTAs at D 128: 15% faster on ragged rows, 5% slower at
// the serves' heaviest launch, scripts/res_decode_variants.py.)
// Head rows of DR < D (head_dim 120) run in D 128's group tile, whose
// MMAs take k = 16, in the split-half layout of flash::Cols: B_k, the K/V
// rows and the sin/cos rows of each stage (int8 pages: the warp's V tile)
// keep zero gap columns, Q's fragments read zeros there, the int8 K codes
// are dequantized from the real columns only, and the partials carry the
// DR real columns.
// f32 launches run the template share by share (one CTA per share,
// IEEE f32 FMAs, RoPE from the f32 tables) into the same workspace, and
// the same combine.
// the template's arguments, layout and block size, as the f32 path of the
// namespace below launches it
using TemplateArgs = Args;
using TemplateLayout = Layout;
constexpr int kTemplateThreads = kThreads;

namespace splitk_res {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = kResSplitKeys;   // keys per warp step
constexpr int kHeads = 16;             // query heads per CTA (one m16 tile)

struct Args {
  const void* q;        // (B, Hq, D)
  const void* kb;       // (P, page, Hkv, D)  bf16, or int8 with scales
  const void* vb;
  const float* kb_s;    // (P, page, Hkv) f32  int8 pages only, else null
  const float* vb_s;
  const void* kr;       // (Pr, page, R)
  const void* vr;
  const void* bk;       // (B, R, Hkv*D)
  const void* bv;
  const void* sin;      // (N >= W * page, D/2) in q's type
  const void* cos;
  const int* bt_b;      // (B, W)
  const int* bt_r;      // (B, W)
  const int* kv_len;    // (B,)
  float* ws_m;          // (B, Hq, n_split)
  float* ws_l;          // (B, Hq, n_split)
  float* ws_acc;        // (B, Hq, n_split, D)
  float* ws_accr;       // (B, Hq, n_split, R)
  void* out;            // (B, Hq, D)
  int bsz, hq, hkv, d, r, page, page_shift, w, n_split, window, bt_slice;
  float scale, rope_theta;
  int use_rope;
};

// Bytes: B_k (RP x DS bf16) once per CTA, then per warp two stages of K,
// V (bf16 16 x DS; int8 16 x D codes and 16 + 16 scales), K_r, V_r (16 x
// RS) and sin, cos (16 x HS), and for int8 pages a bf16 V tile (16 x DS);
// then the CTA's two block-table slices (bt_slice ints each).
template <int D, int RP, bool INT8>
struct Layout {
  static constexpr int DS = D + flash::kPad;
  static constexpr int RS = RP + flash::kPad;
  static constexpr int HS = D / 2 + flash::kPad;
  static constexpr int kRowB = INT8 ? D : 2 * DS;   // bytes of a K/V row
  static constexpr int kK = 0, kV = kK + kKeys * kRowB,
                       kScale = kV + kKeys * kRowB,
                       kKr = kScale + (INT8 ? 2 * kKeys * 4 : 0),
                       kVr = kKr + kKeys * RS * 2, kSin = kVr + kKeys * RS * 2,
                       kCos = kSin + kKeys * HS * 2,
                       kStage = kCos + kKeys * HS * 2;
  static constexpr int kVt = 2 * kStage;            // int8: the V tile
  static constexpr int kWarp = kVt + (INT8 ? kKeys * DS * 2 : 0);
  static constexpr int kBk = RP * DS * 2;
  static constexpr int kBytes = kBk + kWarps * kWarp;
};

template <int D, int DR, int RP, bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_res_split_kernel(Args a) {
  using flash::bf16;
  using L = Layout<D, RP, INT8>;
  using C = flash::Cols<D, DR>;           // head rows of DR in D columns
  constexpr int DS = L::DS, RS = L::RS, HS = L::HS, HALF = D / 2;
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* Bks = reinterpret_cast<bf16*>(dyn);
  int* bts = reinterpret_cast<int*>(dyn + L::kBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, G = a.hq / a.hkv, R = a.r, page = a.page;
  const int nht = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / nht;
  const int g0 = (blockIdx.y % nht) * kHeads;
  const int ng = min(kHeads, G - g0);               // heads of this CTA
  const long head0 = (long)b * a.hq + (long)h * G + g0;
  const long hd = (long)a.hkv * DR;

  // this warp's share, and the CTA's keys (its kWarps shares)
  const int kvlen = a.kv_len[b];
  const int first_share = (int)blockIdx.x * kWarps;
  const int share = first_share + warp;
  const Share sh(kvlen, a.w, page, a.window, a.n_split, share);
  const int k_lo = sh.lo, k_hi = sh.hi;
  const Share cta(kvlen, a.w, page, a.window, a.n_split, first_share);
  const int c_hi = min(cta.lo + kWarps * cta.per, min(kvlen, a.w * page));
  auto page_of = [&](int kpos) {
    return a.page_shift >= 0 ? kpos >> a.page_shift : kpos / page;
  };
  auto slot_of = [&](int kpos) {
    return a.page_shift >= 0 ? kpos & (page - 1) : kpos % page;
  };
  // the block-table entries of the CTA's keys: bt_b's, then bt_r's
  const int j_lo = page_of(cta.lo);
  const int nbt = cta.lo < c_hi ? page_of(c_hi - 1) - j_lo + 1 : 0;
  for (int i = tid; i < nbt; i += kThreads) {
    bts[i] = a.bt_b[(long)b * a.w + j_lo + i];
    bts[a.bt_slice + i] = a.bt_r[(long)b * a.w + j_lo + i];
  }
  // B_k of kv head h (rows R..RP-1 zero)
  const bf16* bk = static_cast<const bf16*>(a.bk);
  for (int e = tid; e < RP * C::kRow; e += kThreads) {
    const int rr = e / C::kRow, i = e % C::kRow;
    const bool ok = rr < R;
    const long src = ok ? ((long)b * R + rr) * hd + (long)h * DR : 0;
    C::row(Bks + rr * DS, bk + src, i, ok);
  }
  flash::cp_async_commit();
  C::zero_gaps(Bks, RP, DS, tid, kThreads);
  // K_r / V_r columns R..RP-1 stay zero in both of the warp's stages, as
  // do the split-half layout's gap columns (DR < D) of its K/V and sin/cos
  // rows (int8 pages: of its V tile)
  unsigned char* mine = dyn + L::kBk + warp * L::kWarp;
  for (int st = 0; st < 2; ++st) {
    unsigned char* sb = mine + st * L::kStage;
    bf16* kr_s = reinterpret_cast<bf16*>(sb + L::kKr);
    bf16* vr_s = reinterpret_cast<bf16*>(sb + L::kVr);
    for (int e = lane; e < kKeys * (RP - R); e += 32) {
      const int t = e / (RP - R), rr = R + e % (RP - R);
      kr_s[t * RS + rr] = __float2bfloat16(0.f);
      vr_s[t * RS + rr] = __float2bfloat16(0.f);
    }
    if constexpr (!INT8) {
      C::zero_gaps(reinterpret_cast<bf16*>(sb + L::kK), kKeys, DS, lane, 32);
      C::zero_gaps(reinterpret_cast<bf16*>(sb + L::kV), kKeys, DS, lane, 32);
    }
    C::zero_table_gaps(reinterpret_cast<bf16*>(sb + L::kSin), kKeys, HS,
                       lane, 32);
    C::zero_table_gaps(reinterpret_cast<bf16*>(sb + L::kCos), kKeys, HS,
                       lane, 32);
  }
  if constexpr (INT8)
    C::zero_gaps(reinterpret_cast<bf16*>(mine + L::kVt), kKeys, DS, lane, 32);
  flash::cp_async_wait<0>();
  __syncthreads();                  // the last CTA-wide barrier

  if (k_lo >= k_hi) {               // an empty share: weight 0
    if (lane < ng) {
      a.ws_m[(head0 + lane) * a.n_split + share] = flash::kNegInit;
      a.ws_l[(head0 + lane) * a.n_split + share] = 0.f;
    }
    return;
  }

  // Q's A fragments: rows = the CTA's heads (zero past ng and in the gap
  // columns)
  const bf16* q = static_cast<const bf16*>(a.q);
  uint32_t qf[D / 16][4];
  {
    const int r0 = lane >> 2, c0 = 2 * (lane & 3);
    auto ld = [&](int r, int c) {      // tile columns c, c + 1
      const int e = C::elem(c);
      return r < ng && e >= 0 ? *reinterpret_cast<const uint32_t*>(
                                    q + (head0 + r) * DR + e)
                              : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = ld(r0, kk * 16 + c0);
      qf[kk][1] = ld(r0 + 8, kk * 16 + c0);
      qf[kk][2] = ld(r0, kk * 16 + 8 + c0);
      qf[kk][3] = ld(r0 + 8, kk * 16 + 8 + c0);
    }
  }

  const bf16* sin_tab = static_cast<const bf16*>(a.sin);
  const bf16* cos_tab = static_cast<const bf16*>(a.cos);
  const bf16* kr = static_cast<const bf16*>(a.kr);
  const bf16* vr = static_cast<const bf16*>(a.vr);
  const int* bts_b = bts - j_lo;
  const int* bts_r = bts + a.bt_slice - j_lo;
  const bool vec_res = (R % 8) == 0;
  const int nsteps = (k_hi - k_lo + kKeys - 1) / kKeys;

  // one step's loads into stage (it & 1); keys past the share zero-filled
  auto issue = [&](int it) {
    if (it < nsteps) {
      unsigned char* s = mine + (it & 1) * L::kStage;
      const int k0 = k_lo + it * kKeys;
      auto tok = [&](int kp) {          // (key, head h) in the base pools
        return ((long)bts_b[page_of(kp)] * page + slot_of(kp)) * a.hkv + h;
      };
      auto rtok = [&](int kp) {         // a key's row in the residual pools
        return ((long)bts_r[page_of(kp)] * page + slot_of(kp)) * R;
      };
      if constexpr (!INT8) {
        const bf16* kb = static_cast<const bf16*>(a.kb);
        const bf16* vb = static_cast<const bf16*>(a.vb);
        bf16* ks_ = reinterpret_cast<bf16*>(s + L::kK);
        bf16* vs_ = reinterpret_cast<bf16*>(s + L::kV);
        for (int e = lane; e < kKeys * C::kRow; e += 32) {
          const int t = e / C::kRow, i = e % C::kRow;
          const bool ok = k0 + t < k_hi;
          const long src = ok ? tok(k0 + t) * DR : 0;
          C::row(ks_ + t * DS, kb + src, i, ok);
          C::row(vs_ + t * DS, vb + src, i, ok);
        }
      } else {
        const int8_t* kb = static_cast<const int8_t*>(a.kb);
        const int8_t* vb = static_cast<const int8_t*>(a.vb);
        for (int e = lane; e < kKeys * C::kCodeRow; e += 32) {
          const int t = e / C::kCodeRow, i = e % C::kCodeRow;
          const bool ok = k0 + t < k_hi;
          const long src = ok ? tok(k0 + t) * DR : 0;
          C::codes(s + L::kK + t * D, kb + src, i, ok);
          C::codes(s + L::kV + t * D, vb + src, i, ok);
        }
        {                               // lanes 0-15 K's scales, 16-31 V's
          const int t = lane & (kKeys - 1);
          const bool ok = k0 + t < k_hi;
          const long src = ok ? tok(k0 + t) : 0;
          flash::cp_async4(s + L::kScale + lane * 4,
                           (lane < kKeys ? a.kb_s : a.vb_s) + src, ok);
        }
      }
      if (vec_res) {
        for (int e = lane; e < kKeys * (R / 8); e += 32) {
          const int t = e / (R / 8), c = e % (R / 8);
          const bool ok = k0 + t < k_hi;
          const long src = ok ? rtok(k0 + t) + c * 8 : 0;
          flash::cp_async16(s + L::kKr + (t * RS + c * 8) * 2, kr + src, ok);
          flash::cp_async16(s + L::kVr + (t * RS + c * 8) * 2, vr + src, ok);
        }
      } else {          // rows of R elements are not 16-byte aligned
        bf16* kr_s = reinterpret_cast<bf16*>(s + L::kKr);
        bf16* vr_s = reinterpret_cast<bf16*>(s + L::kVr);
        for (int e = lane; e < kKeys * R; e += 32) {
          const int t = e / R, rr = e % R;
          const bool ok = k0 + t < k_hi;
          const long src = ok ? rtok(k0 + t) + rr : 0;
          kr_s[t * RS + rr] = ok ? kr[src] : __float2bfloat16(0.f);
          vr_s[t * RS + rr] = ok ? vr[src] : __float2bfloat16(0.f);
        }
      }
      bf16* sn_ = reinterpret_cast<bf16*>(s + L::kSin);
      bf16* cs_ = reinterpret_cast<bf16*>(s + L::kCos);
      for (int e = lane; e < kKeys * C::kHalf; e += 32) {
        const int t = e / C::kHalf, i = e % C::kHalf;
        const bool ok = k0 + t < k_hi;
        const long src = ok ? (long)(k0 + t) * (DR / 2) : 0;
        C::half(sn_ + t * HS, sin_tab + src, i, ok);
        C::half(cs_ + t * HS, cos_tab + src, i, ok);
      }
    }
    flash::cp_async_commit();
  };

  float o[D / 8][4], orr[RP / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < RP / 8; ++n)
    orr[n][0] = orr[n][1] = orr[n][2] = orr[n][3] = 0.f;
  m[0] = m[1] = flash::kNegInit;
  l[0] = l[1] = 0.f;
  const float scale_log2 = a.scale * flash::kLog2e;

  issue(0);
  for (int it = 0; it < nsteps; ++it) {
    issue(it + 1);
    flash::cp_async_wait<1>();
    __syncwarp();
    const unsigned char* s = mine + (it & 1) * L::kStage;
    const bf16* Vs;
    if constexpr (INT8) {
      // the warp's V tile: bf16(code * scale), as the plain version rounds
      bf16* Vt = reinterpret_cast<bf16*>(mine + L::kVt);
      flash::dequantize_cols<D, DR>(
          s + L::kV, reinterpret_cast<const float*>(s + L::kScale) + kKeys,
          Vt, DS, kKeys, lane, 32);
      __syncwarp();
      Vs = Vt;
    } else {
      Vs = reinterpret_cast<const bf16*>(s + L::kV);
    }
    const bf16* Krs = reinterpret_cast<const bf16*>(s + L::kKr);
    const bf16* Sn = reinterpret_cast<const bf16*>(s + L::kSin);
    const bf16* Cs = reinterpret_cast<const bf16*>(s + L::kCos);

    // K = K_b + RoPE(K_r . B_k) for the step's 16 keys, kept as the B
    // fragments of S = Q K^T: kf[n][hh] holds key (lane / 4) + 8 hh,
    // columns 8 n + 2 (lane % 4) + {0, 1}
    uint32_t kf[D / 8][2];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      float x1[4], x2[4];
      flash::lora_pair<D, RP>(x1, x2, Krs, RS, Bks, DS, j, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = (lane >> 2) + 8 * hh;
        const int i = 8 * j + 2 * (lane & 3);
        const float2 sn = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Sn + t * HS + i));
        const float2 cs = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Cs + t * HS + i));
        float2 b1, b2;
        if constexpr (INT8) {
          const float sc = reinterpret_cast<const float*>(s + L::kScale)[t];
          const unsigned char* row = s + L::kK + t * D;
          // bf16(code * scale) of the pair at tile columns c, c + 1 (zero
          // in a gap: the codes are the DR real columns)
          auto deq = [&](int c) {
            const int e = C::elem(c);
            if (e < 0) return make_float2(0.f, 0.f);
            const uint16_t w2 = *reinterpret_cast<const uint16_t*>(row + e);
            return __bfloat1622float2(__floats2bfloat162_rn(
                __fmul_rn((float)(int8_t)(w2 & 0xff), sc),
                __fmul_rn((float)(int8_t)(w2 >> 8), sc)));
          };
          b1 = deq(i);
          b2 = deq(i + HALF);
        } else {
          const bf16* row = reinterpret_cast<const bf16*>(s + L::kK) + t * DS;
          b1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + i));
          b2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(row + i + HALF));
        }
        kf[j][hh] = flash::pack_bf16(
            b1.x + flash::rot(x1[2 * hh], cs.x, x2[2 * hh], -sn.x),
            b1.y + flash::rot(x1[2 * hh + 1], cs.y, x2[2 * hh + 1], -sn.y));
        kf[j + D / 16][hh] = flash::pack_bf16(
            b2.x + flash::rot(x2[2 * hh], cs.x, x1[2 * hh], sn.x),
            b2.y + flash::rot(x2[2 * hh + 1], cs.y, x1[2 * hh + 1], sn.y));
      }
    }

    // S = Q K^T: 16 heads x the 16 keys (two n-tiles of 8)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      flash::mma(sc[0], qf[kk], kf[2 * kk][0], kf[2 * kk + 1][0]);
      flash::mma(sc[1], qf[kk], kf[2 * kk][1], kf[2 * kk + 1][1]);
    }
    const int k0 = k_lo + it * kKeys;
    if (k0 + kKeys > k_hi) {
      const int pos[2] = {0, 0};              // not read: no causal mask
      flash::mask<kKeys>(sc, k0, pos, k_hi, false, 0, lane);
    }
    float alpha[2];
    flash::softmax_step<kKeys>(sc, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::rescale<RP / 8>(orr, alpha);
    flash::product<kKeys, D>(o, sc, Vs, DS, lane);
    flash::product<kKeys, RP>(
        orr, sc, reinterpret_cast<const bf16*>(s + L::kVr), RS, lane);
    __syncwarp();                   // the stage is refilled next step
  }
  flash::cp_async_wait<0>();

  // the combine may launch now; it still waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  flash::finish_rowsum(l);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = (lane >> 2) + 8 * hh;
    if (r >= ng) continue;
    const long row = (head0 + r) * a.n_split + share;
    if ((lane & 3) == 0) {
      a.ws_m[row] = m[hh];
      a.ws_l[row] = l[hh];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      // the DR real columns; a pair never straddles a gap
      const int e = C::elem(8 * n + 2 * (lane & 3));
      if (e >= 0)
        *reinterpret_cast<float2*>(a.ws_acc + row * DR + e) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
#pragma unroll
    for (int n = 0; n < RP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * (lane & 3) + e;
        if (col < R) a.ws_accr[row * R + col] = orr[n][2 * hh + e];
      }
  }
}

// The chunked instance of the split-K decode (#2): ranks above kRankChunk
// (rank_chunk.cuh).  The grid, shares and workspace of the split kernel
// above, but the CTA's 4 warps walk the union of their shares in 64-key
// blocks together: per block all 128 threads rebuild K and V rank chunk by
// chunk (flash::chunk_block; the warps share each B_k and B_v chunk, which
// warps on shares of their own could not), then warp w takes keys 16 w ..
// 16 w + 15 of the block: S = Q K^T for the 16 heads, the online softmax,
// O += P V.  A warp's partial covers its keys of every block rather than
// its own share; the combine needs only that the partials split the row's
// keys, and V is rebuilt, so they carry no acc_r and the combine runs
// with no rank (B_v is in V already).
template <int D, int DR, bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_res_chunk_kernel(Args a) {
  using flash::bf16;
  constexpr int BK = kWarps * kKeys;
  using L = flash::ChunkBlock<D, BK, INT8>;
  using C = flash::Cols<D, DR>;
  constexpr int DS = L::DS;
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* Qs = reinterpret_cast<bf16*>(dyn);
  unsigned char* blk = dyn + kHeads * DS * sizeof(bf16);
  const bf16* Ks = reinterpret_cast<const bf16*>(blk) + L::kK;
  const bf16* Vs = reinterpret_cast<const bf16*>(blk) + L::kV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, G = a.hq / a.hkv, R = a.r, page = a.page;
  const int nht = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / nht;
  const int g0 = (blockIdx.y % nht) * kHeads;
  const int ng = min(kHeads, G - g0);
  const long head0 = (long)b * a.hq + (long)h * G + g0;
  const long hd = (long)a.hkv * DR;
  const int kvlen = a.kv_len[b];
  const int first_share = (int)blockIdx.x * kWarps;
  const Share cta(kvlen, a.w, page, a.window, a.n_split, first_share);
  const int c_lo = cta.lo;
  const int c_hi = min(cta.lo + kWarps * cta.per, min(kvlen, a.w * page));

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < kHeads * C::kRow; e += kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < ng;
    C::row(Qs + r * DS, ok ? q + (head0 + r) * DR : q, i, ok);
  }
  flash::cp_async_commit();
  C::zero_gaps(Qs, kHeads, DS, tid, kThreads);
  flash::chunk_zero_gaps<D, DR, BK, INT8>(blk, tid, kThreads);

  const int* bt = a.bt_b + (long)b * a.w;
  const int* btr = a.bt_r + (long)b * a.w;
  const long b0 = (long)b * R * hd + (long)h * DR;
  const flash::ChunkSrc src{
      a.kb, a.vb, a.kb_s, a.vb_s, static_cast<const bf16*>(a.kr),
      static_cast<const bf16*>(a.vr), static_cast<const bf16*>(a.bk) + b0,
      static_cast<const bf16*>(a.bv) + b0, hd,
      static_cast<const bf16*>(a.sin), static_cast<const bf16*>(a.cos), R};
  auto tok = [&](int kpos) {
    return ((long)bt[kpos / page] * page + kpos % page) * a.hkv + h;
  };
  auto res = [&](int kpos) {
    return (long)btr[kpos / page] * page + kpos % page;
  };
  auto rope = [&](int kpos) { return (long)kpos; };

  float o[D / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  m[0] = m[1] = flash::kNegInit;
  l[0] = l[1] = 0.f;
  const float scale_log2 = a.scale * flash::kLog2e;

  flash::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];           // the CTA's 16 heads, for every warp
  flash::load_q<D>(qf, Qs, DS, lane);
  const int nblocks = c_lo < c_hi ? (c_hi - c_lo + BK - 1) / BK : 0;
  for (int it = 0; it < nblocks; ++it) {
    const int j0 = c_lo + it * BK;
    flash::chunk_block<D, DR, BK, kWarps, INT8>(
        blk, src, j0, c_lo, c_hi, tok, res, rope, tid, warp, lane);
    float sc[2][4], alpha[2];
    flash::scores<D, kKeys>(sc, qf, Ks + warp * kKeys * DS, DS, lane);
    const int k0 = j0 + warp * kKeys;
    if (k0 + kKeys > c_hi) {
      const int pos[2] = {0, 0};              // not read: no causal mask
      flash::mask<kKeys>(sc, k0, pos, c_hi, false, 0, lane);
    }
    flash::softmax_step<kKeys>(sc, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::product<kKeys, D>(o, sc, Vs + warp * kKeys * DS, DS, lane);
    __syncthreads();                  // the tiles are refilled next block
  }

  // the combine may launch now; it still waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  flash::finish_rowsum(l);
  const int share = first_share + warp;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = (lane >> 2) + 8 * hh;
    if (r >= ng) continue;
    const long row = (head0 + r) * a.n_split + share;
    if ((lane & 3) == 0) {
      a.ws_m[row] = m[hh];
      a.ws_l[row] = l[hh];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int e = C::elem(8 * n + 2 * (lane & 3));
      if (e >= 0)
        *reinterpret_cast<float2*>(a.ws_acc + row * DR + e) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
  }
}

// out[b, head] = (sum_s w_s acc_s + (sum_s w_s acc_r,s) . B_v[b, :, head's
// kv head]) / max(sum_s w_s l_s, 1e-20), w_s = 2^(m_s - M) over the shares
// with l_s > 0: one CTA per (row, head), threads over R, then over D.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_res_combine_kernel(Args a) {
  // wait for the split kernel's grid and its writes
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // a.r <= kRankChunk: the chunked instances launch it with no rank
  __shared__ float accr[flash::kRankChunk];
  const long row = blockIdx.x;                  // b * Hq + head
  const int b = (int)(row / a.hq), head = (int)(row % a.hq);
  const int h = head / (a.hq / a.hkv);
  const float* m = a.ws_m + row * a.n_split;
  const float* l = a.ws_l + row * a.n_split;
  float mx = flash::kNegInit;
  for (int s = 0; s < a.n_split; ++s)
    if (l[s] > 0.f) mx = fmaxf(mx, m[s]);
  float lsum = 0.f;
  for (int s = 0; s < a.n_split; ++s)
    if (l[s] > 0.f) lsum = fmaf(exp2f(m[s] - mx), l[s], lsum);
  for (int rr = threadIdx.x; rr < a.r; rr += kThreads) {
    float o = 0.f;
    for (int s = 0; s < a.n_split; ++s)
      if (l[s] > 0.f)
        o = fmaf(exp2f(m[s] - mx),
                 a.ws_accr[(row * a.n_split + s) * a.r + rr], o);
    accr[rr] = o;
  }
  __syncthreads();
  const T* bv = static_cast<const T*>(a.bv) + (long)b * a.r * a.hkv * a.d +
                (long)h * a.d;
  for (int col = threadIdx.x; col < a.d; col += kThreads) {
    float o = 0.f;
    for (int s = 0; s < a.n_split; ++s)
      if (l[s] > 0.f)
        o = fmaf(exp2f(m[s] - mx),
                 a.ws_acc[(row * a.n_split + s) * a.d + col], o);
    for (int rr = 0; rr < a.r; ++rr)
      o = fmaf(accr[rr], to_f32(bv[(long)rr * a.hkv * a.d + col]), o);
    static_cast<T*>(a.out)[row * a.d + col] =
        from_f32<T>(o / fmaxf(lsum, 1e-20f));
  }
}

// The combine, launched programmatically after the split kernel on the
// same stream: its launch overlaps the split kernel's tail, and it waits
// for the whole grid before it reads.
template <typename T>
int launch_combine(const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long)a.bsz * a.hq));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, paged_decode_res_combine_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D, int DR, int RP, bool INT8>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<D, RP, INT8>;
  auto kernel = paged_decode_res_split_kernel<D, DR, RP, INT8>;
  const size_t smem = (size_t)L::kBytes + 2 * (size_t)a.bt_slice * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = a.hq / a.hkv;
  const dim3 grid(a.n_split / kWarps, a.hkv * ((G + kHeads - 1) / kHeads),
                  a.bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<__nv_bfloat16>(a, stream);
}

// the chunked instance and the combine with no rank (V carries B_v)
template <int D, int DR, bool INT8>
int launch_chunk(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = (size_t)kHeads * (D + flash::kPad) * 2 +
                          flash::ChunkBlock<D, kWarps * kKeys, INT8>::kBytes;
  auto kernel = paged_decode_res_chunk_kernel<D, DR, INT8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = a.hq / a.hkv;
  const dim3 grid(a.n_split / kWarps, a.hkv * ((G + kHeads - 1) / kHeads),
                  a.bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args c = a;
  c.r = 0;
  return launch_combine<__nv_bfloat16>(c, stream);
}

// RP: the smallest instance (16, 32, 64) that holds the rank; above 64 the
// chunked instance
template <int D, int DR = D>
int launch_rank(const Args& a, cudaStream_t s) {
  const bool int8 = a.kb_s != nullptr;
  if (a.r > flash::kRankChunk)
    return int8 ? launch_chunk<D, DR, true>(a, s)
                : launch_chunk<D, DR, false>(a, s);
  if (a.r <= 16)
    return int8 ? launch<D, DR, 16, true>(a, s)
                : launch<D, DR, 16, false>(a, s);
  if (a.r <= 32)
    return int8 ? launch<D, DR, 32, true>(a, s)
                : launch<D, DR, 32, false>(a, s);
  return int8 ? launch<D, DR, 64, true>(a, s) : launch<D, DR, 64, false>(a, s);
}

// f32: the template (HAS_RES) one CTA per share into the same workspace,
// then the combine
template <typename TB>
int launch_f32(const Args& r, cudaStream_t stream) {
  TemplateArgs a{r.q, r.kb, r.vb, r.kb_s, r.vb_s, r.kr, r.vr, r.bk, r.bv,
           r.bt_b, r.bt_r, nullptr, nullptr, r.kv_len, r.out,
           1, r.hq, r.hkv, r.d, r.r, r.page, r.w, 1, r.scale, r.window,
           r.rope_theta, r.use_rope};
  a.sin = r.sin;
  a.cos = r.cos;
  a.n_split = r.n_split;
  a.ws_m = r.ws_m;
  a.ws_l = r.ws_l;
  a.ws_acc = r.ws_acc;
  a.ws_accr = r.ws_accr;
  const int G = a.hq / a.hkv;
  // above kRankChunk the template's chunked instance: V rebuilt, no acc_r
  const bool chunk = a.r > flash::kRankChunk;
  const TemplateLayout L(G, a.d, a.r, a.page, true, chunk);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kernel = chunk ? paged_attention_kernel<float, TB, true, true, true>
                      : paged_attention_kernel<float, TB, true, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.n_split, a.hkv, r.bsz), kTemplateThreads, smem,
                                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args c = r;
  if (chunk) c.r = 0;
  return launch_combine<float>(c, stream);
}

// ints of each block table one CTA reads: its kWarps shares span at most
// kWarps * per / page + 2 pages, never more than the table's W
inline int bt_entries(const Args& a) {
  const long keys = (long)a.w * a.page;
  const long per = ((keys + a.n_split - 1) / a.n_split + kKeys - 1) / kKeys *
                   kKeys;
  return (int)std::min<long>(a.w, kWarps * per / a.page + 2);
}

// dtype: q's type (0 f32, 1 bf16); int8 pages exactly when scales given.
// D 32/64/128 and 120 (bf16: in D 128's tile; f32: the template takes any
// even D), any R >= 1 (above 64 the chunked instances), page 1..32,
// n_split a multiple of kWarps.
int dispatch(int dtype, Args a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a.kb_s == nullptr) != (a.vb_s == nullptr) || a.n_split < kWarps ||
      a.n_split % kWarps != 0 || a.page < 1 || a.page > 32 || a.r < 1 ||
      a.hkv < 1 || a.hq % a.hkv != 0 ||
      a.bsz > 65535 ||
      (long)a.hkv * ((a.hq / a.hkv + kHeads - 1) / kHeads) > 65535 ||
      (long)a.bsz * a.hq > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (a.sin == nullptr || a.cos == nullptr) return (int)cudaErrorInvalidValue;
  const bool int8 = a.kb_s != nullptr;
  if (dtype == 0)
    return int8 ? launch_f32<int8_t>(a, s) : launch_f32<float>(a, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  a.bt_slice = bt_entries(a);
  if (a.d == 32) return launch_rank<32>(a, s);
  if (a.d == 64) return launch_rank<64>(a, s);
  if (a.d == 128) return launch_rank<128>(a, s);
  if (a.d == 120) return launch_rank<128, 120>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace splitk_res

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, residual pools, B_k/B_v).
// kb_s/vb_s: both null (kb/vb in q's type) or both the f32 scale pools of
// int8 kb/vb.  Each launcher returns cudaGetLastError() after the launch (0
// = success), or cudaErrorInvalidValue for a geometry its kernel does not
// take.
// The split-K decode with the residual stream (splitk_res above), every
// type: sin/cos are the RoPE tables (N >= W * page rows, q's type);
// ws_m/ws_l (B, Hq, n_split), ws_acc (B, Hq,
// n_split, D) and ws_accr (B, Hq, n_split, R) the caller's f32 workspace;
// n_split a multiple of 4 (the bf16 kernel's warps per CTA).
extern "C" int paged_residual_attention_decode(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* kb_s, const void* vb_s, const void* kr, const void* vr,
    const void* bk, const void* bv, const void* sin, const void* cos,
    const void* bt_b, const void* bt_r, const void* kv_len, void* ws_m,
    void* ws_l, void* ws_acc, void* ws_accr, void* out, int bsz, int hq,
    int hkv, int d, int r, int page, int w, int n_split, float scale,
    int window, float rope_theta, int use_rope, void* stream) {
  int shift = -1;
  for (int i = 0; i < 6; ++i)
    if (page == (1 << i)) shift = i;
  const splitk_res::Args a{
      q, kb, vb, static_cast<const float*>(kb_s),
      static_cast<const float*>(vb_s), kr, vr, bk, bv, sin, cos,
      static_cast<const int*>(bt_b), static_cast<const int*>(bt_r),
      static_cast<const int*>(kv_len), static_cast<float*>(ws_m),
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_accr), out,
      bsz, hq, hkv, d, r, page, shift, w, n_split, window, 0,
      scale, rope_theta, use_rope};
  return splitk_res::dispatch(dtype, a, stream);
}

// The chunked prefill (#5) and the mixed grid (#1): bf16 runs the
// tensor-core tile (sin/cos: the RoPE tables, N >= W * page rows), f32
// (IEEE, no TF32) the template, which computes RoPE itself (sin/cos null).
extern "C" int paged_residual_attention_prefill(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* kb_s, const void* vb_s, const void* kr, const void* vr,
    const void* bk, const void* bv, const void* sin, const void* cos,
    const void* bt_b, const void* bt_r, const void* start,
    const void* kv_len, void* out, int bsz, int sq, int hq, int hkv, int d,
    int r, int page, int w, int tq, float scale, int window,
    float rope_theta, int use_rope, void* stream) {
  Args a{q, kb, vb, static_cast<const float*>(kb_s),
         static_cast<const float*>(vb_s), kr, vr, bk, bv,
         static_cast<const int*>(bt_b), static_cast<const int*>(bt_r),
         static_cast<const int*>(start), nullptr,
         static_cast<const int*>(kv_len), out,
         sq, hq, hkv, d, r, page, w, tq, scale, window, rope_theta,
         use_rope};
  a.sin = sin;
  a.cos = cos;
  if (dtype == 1) return dispatch_prefill_res_mma(a, bsz, stream);
  return dispatch<true>(dtype, a, bsz, stream);
}

extern "C" int paged_residual_attention_mixed(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* kb_s, const void* vb_s, const void* kr, const void* vr,
    const void* bk, const void* bv, const void* sin, const void* cos,
    const void* bt_b, const void* bt_r, const void* start,
    const void* q_len, const void* kv_len, void* out, int bsz, int sq,
    int hq, int hkv, int d, int r, int page, int w, int tq, float scale,
    int window, float rope_theta, int use_rope, void* stream) {
  Args a{q, kb, vb, static_cast<const float*>(kb_s),
         static_cast<const float*>(vb_s), kr, vr, bk, bv,
         static_cast<const int*>(bt_b), static_cast<const int*>(bt_r),
         static_cast<const int*>(start), static_cast<const int*>(q_len),
         static_cast<const int*>(kv_len), out,
         sq, hq, hkv, d, r, page, w, tq, scale, window, rope_theta,
         use_rope};
  a.sin = sin;
  a.cos = cos;
  if (dtype == 1) return dispatch_prefill_res_mma(a, bsz, stream);
  return dispatch<true>(dtype, a, bsz, stream);
}
