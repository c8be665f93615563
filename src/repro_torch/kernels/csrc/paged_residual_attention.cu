// Paged ResidualAttention for NVIDIA Hopper (sm_90a).
//
// Hand-written CUDA port of the six paged Pallas kernels in
// repro/kernels/paged_residual_attention.py:
//   paged_residual_attention_mixed   (_kernel_mixed,        disaggregated)
//   paged_residual_attention_decode  (_kernel,              disaggregated)
//   paged_residual_attention_prefill (_kernel_prefill,      disaggregated)
//   paged_attention_mixed_base       (_kernel_mixed_base,   base only)
//   paged_attention_decode_base      (_kernel_base,         base only)
//   paged_attention_prefill_base     (_kernel_prefill_base, base only)
//
// This source holds the entries of #3, #4 and #6 and their redesigned
// kernels; paged_residual_disagg.cu holds #5's, #1's and #2's, so the two
// build in parallel.  The scalar template both use is paged_template.cuh.
//
// Which kernel each entry runs, and what bounds it on the H100:
//   * #6 paged_attention_prefill_base and #3 paged_attention_mixed_base in
//     bf16 (bf16 or int8 pages): the tensor-core flash tile
//     paged_prefill_base_mma_kernel (below, on flash_tile.cuh); bound by
//     operations at long chunks;
//   * #5 paged_residual_attention_prefill and #1
//     paged_residual_attention_mixed in bf16 (bf16 or int8 pages): the
//     same tile with K rebuilt per key block on the tensor cores,
//     paged_prefill_res_mma_kernel (paged_residual_disagg.cu; #1 with each
//     row's q_len given); bound by operations for long prefill rows, bytes
//     for decode rows;
//   * #4 paged_attention_decode_base, every type: the split-K decode
//     paged_decode_split_kernel and its combine paged_decode_combine_kernel;
//     bound by bytes;
//   * #2 paged_residual_attention_decode, every type: in bf16 the split-K
//     decode paged_decode_res_split_kernel (K rebuilt on the tensor cores,
//     a residual partial per share), in f32 the template share by share;
//     then paged_decode_res_combine_kernel, which applies B_v
//     (paged_residual_disagg.cu); bound by bytes;
//   * f32 launches of #1, #3, #5 and #6: the template (IEEE f32, TF32
//     off).
//
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "flash_tile.cuh"
#include "paged_template.cuh"

namespace {

// ---------------------------------------------------------------------
// bf16 base-only chunked prefill and mixed grid on the tensor cores
// (flash_tile.cuh): paged_attention_prefill_base (#6) and
// paged_attention_mixed_base (#3), each with its int8 branch, q in bf16.
// They differ only in q_len: #3 reads it per row, #6 derives it.
//
// The flash tile of residual_attention.cu without the rebuild: 128 query
// rows (tq positions x G heads, tq = 128 / G) of 8 warps per CTA, key
// blocks of 64 keys gathered key row by key row through
// bt_b[kpos / page], so every page size works, with cp.async into the
// other of two shared-memory stages while this one is used.  Keys at or
// past min(kv_len, W * page) are zero-filled, never read.  q_len, the
// zeroed rows and tiles past it, and the key-loop bounds are those of the
// scalar template above.
//
// int8 pages dequantize the tile to bf16: the int8 codes and
// their f32 (token, head) scales land in a staging stage, and each element
// becomes bf16(code * scale) in the bf16 K/V tile, which is where the
// plain version rounds (ref.py's gather: (kb.f32 * ks).to(q.dtype)).  So
// the kernel's K and V equal the plain version's bit for bit, and the only
// rounding the tensor cores add is P's.  (Scaling S's and P's columns
// instead would need the scales in registers per key column and round P
// after the V scale, a point the plain version does not have.)
//
// Head rows of DR elements run in a tile D wide (flash::Cols): DR == D at
// head_dim 32, 64 and 128; head_dim 120 (h2o-danube-3-4b) in D 128's tile
// in the split-half layout, q, the pages and out read and written as they
// are (8-byte copies, int8 codes in groups of 4), the gap columns of Q and
// of the K/V tiles zeroed once on chip.
template <int D, bool INT8>
struct PagedMmaLayout {
  static constexpr int BK = 64;
  static constexpr int DS = D + flash::kPad;
  // bf16 elements: Q, then the K/V tiles (two stages of bf16 pages, one
  // converted tile for int8 pages); then, int8 only, bytes of two stages
  // of codes (K, V: BK x D) and scales (K, V: BK floats)
  static constexpr int kQ = 0, kKV = kQ + flash::kRows * DS,
                       kTile = 2 * BK * DS,
                       kElems = kKV + (INT8 ? 1 : 2) * kTile;
  static constexpr int kStage8 = 2 * BK * D + 2 * BK * (int)sizeof(float);
  static constexpr size_t kBytes =
      (size_t)kElems * sizeof(__nv_bfloat16) + (INT8 ? 2 * kStage8 : 0);
};

template <int D, int DR, bool INT8>
__global__ void __launch_bounds__(flash::kThreads, 1)
paged_prefill_base_mma_kernel(Args a, int bsz) {
  using flash::bf16;
  using L = PagedMmaLayout<D, INT8>;
  using C = flash::Cols<D, DR>;           // head rows of DR in D columns
  constexpr int BK = L::BK, DS = L::DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = sm + L::kQ;
  unsigned char* staging = smem_raw + L::kElems * sizeof(bf16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.hq / a.hkv, page = a.page;
  const int ntiles = (a.sq + a.tq - 1) / a.tq;
  const int per_tile = a.hkv * bsz;
  const int tile = ntiles - 1 - (int)(blockIdx.x / per_tile);
  const int h = (int)(blockIdx.x % per_tile) % a.hkv;
  const int b = (int)(blockIdx.x % per_tile) / a.hkv;

  const int kvlen = a.kv_len[b];
  const int start = a.start[b];
  // the mixed grid (#3) gives each row's q_len; the chunked prefill (#6)
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

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < flash::kRows * C::kRow; e += flash::kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < nrows;
    const bf16* src =
        ok ? q + (out_tile + (long)(r / G) * a.hq + r % G) * DR : q;
    C::row(Qs + r * DS, src, i, ok);
  }
  flash::cp_async_commit();
  // the split-half layout's gap columns (DR < D) stay zero in Q and in
  // the K/V tiles (both stages; int8 pages: the one converted tile)
  C::zero_gaps(Qs, flash::kRows, DS, tid, flash::kThreads);
  C::zero_gaps(sm + L::kKV, (INT8 ? 2 : 4) * BK, DS, tid, flash::kThreads);

  const int klimit = min(kvlen, a.w * page);
  const int qpos_lo = start + q0, qpos_hi = start + q0 + nq - 1;
  const int last_k = min(klimit - 1, qpos_hi);
  const int first_k = a.window > 0 ? max(qpos_lo - (a.window - 1), 0) : 0;
  const int jb0 = first_k / BK;
  const int nblocks = last_k >= 0 ? max(0, last_k / BK - jb0 + 1) : 0;
  const int* bt = a.bt_b + (long)b * a.w;

  // element offset of (key kpos, head h, column 0) in the pools, and the
  // scale offset of (kpos, h)
  auto token = [&](int kpos) {
    const long pb = bt[kpos / page];
    return (pb * page + kpos % page) * a.hkv + h;
  };
  auto load_block = [&](int blk, int st) {
    const int j0 = blk * BK;
    if constexpr (!INT8) {
      const bf16* kb = static_cast<const bf16*>(a.kb);
      const bf16* vb = static_cast<const bf16*>(a.vb);
      bf16* Kd = sm + L::kKV + st * L::kTile;
      bf16* Vd = Kd + BK * DS;
      for (int e = tid; e < BK * C::kRow; e += flash::kThreads) {
        const int t = e / C::kRow, i = e % C::kRow;
        const bool ok = j0 + t < klimit;
        const long src = ok ? token(j0 + t) * DR : 0;
        C::row(Kd + t * DS, kb + src, i, ok);
        C::row(Vd + t * DS, vb + src, i, ok);
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
  };

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

  if (nblocks > 0) load_block(jb0, 0);
  flash::cp_async_commit();
  flash::cp_async_wait<1>();                        // Q
  __syncthreads();
  uint32_t qf[D / 16][4];                           // Q's A fragments
  flash::load_q<D>(qf, Qs + warp * 16 * DS, DS, lane);
  for (int it = 0; it < nblocks; ++it) {
    const int st = it & 1;
    if (it + 1 < nblocks) load_block(jb0 + it + 1, st ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = sm + L::kKV + (INT8 ? 0 : st * L::kTile);
    if constexpr (INT8) {      // stage st's codes into the one bf16 tile
      const unsigned char* s8 = staging + st * L::kStage8;
      flash::dequantize_cols<D, DR>(
          s8, reinterpret_cast<const float*>(s8 + 2 * BK * D), sm + L::kKV,
          DS, 2 * BK, tid, flash::kThreads);
      __syncthreads();
    }
    const int j0 = (jb0 + it) * BK;
    float s[BK / 8][4], alpha[2];
    flash::scores<D, BK>(s, qf, Ks, DS, lane);
    const bool full = j0 + BK <= klimit && j0 + BK - 1 <= qpos_lo &&
                      (a.window <= 0 || j0 > qpos_hi - a.window);
    if (!full) flash::mask<BK>(s, j0, pos, klimit, true, a.window, lane);
    flash::softmax_step<BK>(s, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::product<BK, D>(o, s, Ks + BK * DS, DS, lane);
    __syncthreads();
  }
  flash::cp_async_wait<0>();

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

template <int D, bool INT8, int DR = D>
int launch_prefill_mma(const Args& a, int bsz, cudaStream_t stream) {
  using L = PagedMmaLayout<D, INT8>;
  auto kernel = paged_prefill_base_mma_kernel<D, DR, INT8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((a.sq + a.tq - 1) / a.tq) * a.hkv * bsz;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, flash::kThreads, L::kBytes, stream>>>(a, bsz);
  return (int)cudaGetLastError();
}

// The bf16 base-only chunked prefill and mixed grid: D 32/64/128, and 120
// in D 128's tile (split halves, ``flash::Cols``); tq * G <= 128 rows,
// page 1..32, bf16 or int8 pages.
int dispatch_prefill_mma(const Args& a, int bsz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a.kb_s == nullptr) != (a.vb_s == nullptr) || a.tq < 1 ||
      a.tq * (a.hq / a.hkv) > flash::kRows || a.page < 1 || a.page > 32)
    return (int)cudaErrorInvalidValue;
  const bool int8 = a.kb_s != nullptr;
  if (a.d == 32)
    return int8 ? launch_prefill_mma<32, true>(a, bsz, s)
                : launch_prefill_mma<32, false>(a, bsz, s);
  if (a.d == 64)
    return int8 ? launch_prefill_mma<64, true>(a, bsz, s)
                : launch_prefill_mma<64, false>(a, bsz, s);
  if (a.d == 128)
    return int8 ? launch_prefill_mma<128, true>(a, bsz, s)
                : launch_prefill_mma<128, false>(a, bsz, s);
  if (a.d == 120)
    return int8 ? launch_prefill_mma<128, true, 120>(a, bsz, s)
                : launch_prefill_mma<128, false, 120>(a, bsz, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// Split-K paged decode, base only: paged_attention_decode_base (#4) and
// its int8 branch, q in f32 or bf16 (f32 stays f32: every product is an
// f32 FMA on the CUDA cores).
//
// One query row per request, so the work is G heads x the row's live keys
// per (row, kv head): a few FMAs per byte read, bound by bytes.  The
// template ran one CTA per (row, kv head) down every page in turn, which
// leaves most SMs idle at decode's small batches.  Here a row's live key
// range [kv_len - window, kv_len) clipped to [0, min(kv_len, W * page)),
// the keys the Pallas kernel reads, is cut into n_split equal shares of
// whole 64-key multiples, one CTA each, so B x Hkv x n_split CTAs stream
// the pages at once (the wrapper's n_split fills the card's resident CTA
// slots, min_blocks(GT) per SM, in one pass).
//
// Grid (n_split, Hkv * ceil(G / GT), B); a CTA takes GT <= 8 query heads of
// one kv head, whose q rows (scaled by scale * log2(e)) and accumulators
// stay in registers.  Each lane holds 8 columns of one key (16 bytes of
// bf16 K, 32 of f32, 8 of int8 codes), so D / 8 lanes read one key's row
// and a warp takes 32 / (D / 8) whole keys per step (8 at D 32, 4 at D
// 64, 2 at D 128).  Head rows of DR < D columns (head_dim 120) take D
// 128's lane map with the columns in order: 15 lanes of a key hold its
// 120 columns and the 16th holds none (it copies nothing, and its zero q
// and K/V add nothing to the key's sums); no RoPE pairs columns here, and
// every lane's 8 columns start at a 16-byte (bf16, f32) or 8-byte (int8)
// boundary of its row, since a row of 120 starts at one.  Per step a lane copies the K and V columns of U keys
// (up to 128 bytes; a key past the
// split copies the split's last key, whose score is masked, so no copy
// branches) into its own slots of the warp's two shared-memory stages by
// cp.async, so the next step's bytes fly while this one is computed
// without holding registers; 4 resident CTAs per SM (<= 128 registers, 2
// at GT 8) keep up to ~128 KB in flight per SM.  The dot products for the
// GT heads are reduced over the key's lanes with __shfl_xor; every key
// group runs its own online softmax (base 2, one MUFU ex2 per exponent)
// with P . V in registers, and the groups merge first within the warp by
// shuffles, then across the 4 warps through shared memory.  int8 codes
// become floats by a byte permute into 2^23 + code + 128 and an exact
// subtraction, not by I2F, whose issue rate is a quarter of an FMA's.
// Every lane of a key's group repeats the scores' reduction and softmax,
// and the QK and PV FMAs run on the CUDA cores, so at decode's heaviest
// launch the kernel is bound by instruction issue about as much as by
// bytes (int8 pages, half the bytes, take about as long as bf16 pages).
//
// Partials (f32, the wrapper's workspace): m and l of shape
// (B, Hq, n_split), acc of shape (B, Hq, n_split, D), m in base-2 units.
// A split with no key writes m = -1e30 and l = 0 and leaves its acc
// unwritten; the combine gives such a split weight 0 and reads nothing
// else of it.  paged_decode_combine_kernel reduces them on the same
// stream, launched programmatically (griddepcontrol) so its launch
// overlaps the split kernel's tail: M = max m_s, out = sum 2^(m_s - M)
// acc_s / max(sum 2^(m_s - M) l_s, 1e-20) in q's type, so a row with no
// visible key comes out exactly 0.  (The disaggregated decode #2,
// splitk_res in paged_residual_disagg.cu, takes the same layout with an
// acc_r of R columns per share and applies B_v in its combine.)
//
// Rounding: int8 elements are dequantized as the plain version's gather
// rounds, (code * scale) in f32 then rounded to q's type; bf16 and f32
// elements are used as they are; all sums are f32.
namespace splitk {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;               // columns of one key per lane
constexpr int kSplitKeys = 64;         // a split's share: multiples of this
constexpr int kStepBytes = 128;        // K and V bytes per lane per step
constexpr int kStages = 2;             // steps in flight per warp (cp.async)

struct Args {
  const void* q;        // (B, Hq, D)
  const void* kb;       // (P, page, Hkv, D)  T, or int8 with scales
  const void* vb;
  const float* kb_s;    // (P, page, Hkv) f32  int8 pages only, else null
  const float* vb_s;
  const int* bt_b;      // (B, W)
  const int* kv_len;    // (B,)
  float* ws_m;          // (B, Hq, n_split)
  float* ws_l;          // (B, Hq, n_split)
  float* ws_acc;        // (B, Hq, n_split, D)
  void* out;            // (B, Hq, D)
  int bsz, hq, hkv, d, page, page_shift, w, n_split, window;
  float scale_log2;
};

// The 8 elements of TB at one lane's columns of one key row, as loaded.
template <typename TB>
struct Cols;
template <>
struct Cols<float> {
  uint4 w[2];
};
template <>
struct Cols<__nv_bfloat16> {
  uint4 w[1];
};
template <>
struct Cols<int8_t> {
  uint2 w[1];
};

template <typename TB>
__device__ __forceinline__ void load_cols(Cols<TB>& c, const TB* p) {
  if constexpr (std::is_same<TB, int8_t>::value) {
    c.w[0] = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(c.w) / sizeof(uint4)); ++i)
      c.w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
}

template <typename TB>
__device__ __forceinline__ void zero_cols(Cols<TB>& c) {
  if constexpr (std::is_same<TB, int8_t>::value) {
    c.w[0] = make_uint2(0, 0);
  } else {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(c.w) / sizeof(uint4)); ++i)
      c.w[i] = make_uint4(0, 0, 0, 0);
  }
}

// Word i of a 16-byte load (i a compile-time constant after unrolling, so
// the load stays in registers).
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 2^x in one MUFU instruction (x = -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 8 elements in f32; ``sc`` is the (token, head) scale of int8 pages.
template <typename T, typename TB>
__device__ __forceinline__ void cols_f32(float (&x)[kCols],
                                         const Cols<TB>& c, float sc) {
  if constexpr (std::is_same<TB, float>::value) {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      x[e] = __uint_as_float(word(c.w[e / 4], e % 4));
  } else if constexpr (std::is_same<TB, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) {
      const uint32_t u = word(c.w[0], i);
      x[2 * i] = __uint_as_float(u << 16);
      x[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
    }
  } else {
    // code + 128 as the low byte of the f32 2^23 + code + 128 (a byte
    // permute and an exact subtraction instead of the slower I2F)
    const uint32_t u[2] = {c.w[0].x ^ 0x80808080u, c.w[0].y ^ 0x80808080u};
#pragma unroll
    for (int e = 0; e < kCols; e += 2) {
      float x2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float code =
            __uint_as_float(__byte_perm(u[(e + i) / 4], 0x4B000000u,
                                        0x7650 + (e + i) % 4)) -
            8388736.f;
        x2[i] = __fmul_rn(code, sc);
      }
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        // both rounded to bf16 by one packed conversion
        const __nv_bfloat162 r = __floats2bfloat162_rn(x2[0], x2[1]);
        const uint32_t w = *reinterpret_cast<const uint32_t*>(&r);
        x[e] = __uint_as_float(w << 16);
        x[e + 1] = __uint_as_float(w & 0xffff0000u);
      } else {
        x[e] = x2[0];
        x[e + 1] = x2[1];
      }
    }
  }
}

// Keys per lane per step: about 128 bytes of K and V loads in flight per
// lane, and at most 16 scores (U x GT) in registers.
template <typename TB, int GT>
__host__ __device__ constexpr int keys_per_step() {
  constexpr int by_bytes = kStepBytes / (2 * kCols * (int)sizeof(TB));
  return by_bytes < 16 / GT ? by_bytes : 16 / GT;
}

// Resident CTAs per SM the registers must allow (the wrapper's
// SPLIT_CTAS_PER_SM): 4 (<= 128 registers a thread), 2 at 8 heads per
// CTA, whose q rows and accumulators alone take 128.
__host__ __device__ constexpr int min_blocks(int gt) {
  return gt >= 8 ? 2 : 4;
}

template <typename TB, int U>
struct Step {
  Cols<TB> k[U], v[U];
  float ks[U], vs[U];
  bool ok[U];
};

// Shared-memory bytes of one warp's cp.async stages: per stage and key of
// the step, each lane's K and V columns and (int8) their two scales.
template <typename TB, int U>
__host__ __device__ constexpr int stage_bytes() {
  return U * 32 * (2 * (int)sizeof(Cols<TB>) +
                   (std::is_same<TB, int8_t>::value ? 8 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                 "r"(flash::smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::
                 "r"(flash::smem_addr(dst)), "l"(src), "n"(N));
}

// K/V columns of one key (and int8 scales) copied to shared memory
template <typename TB>
__device__ __forceinline__ void copy_cols(Cols<TB>* dst, const TB* src) {
  if constexpr (std::is_same<TB, int8_t>::value) {
    cp_async<8>(dst, src);
  } else {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Cols<TB>) / 16); ++i)
      cp_async<16>(reinterpret_cast<uint4*>(dst) + i,
                   reinterpret_cast<const uint4*>(src) + i);
  }
}

template <typename T, typename TB, int D, int DR, int GT>
__global__ void __launch_bounds__(kThreads, min_blocks(GT))
paged_decode_split_kernel(Args a) {
  constexpr int LPK = D / kCols;         // lanes per key
  constexpr int KPW = 32 / LPK;          // keys per warp step
  constexpr int NG = kWarps * KPW;       // key groups per CTA
  constexpr int U = keys_per_step<TB, GT>();
  constexpr bool INT8 = std::is_same<TB, int8_t>::value;
  constexpr int SB = stage_bytes<TB, U>();
  // each warp's cp.async stages, then the split's block-table slice
  extern __shared__ __align__(16) unsigned char dyn[];
  int* bt_s = reinterpret_cast<int*>(dyn + kWarps * kStages * SB);
  __shared__ float cm[kWarps][GT], cl[kWarps][GT];
  __shared__ float cacc[kWarps][GT][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.z;
  const int G = a.hq / a.hkv, nhb = (G + GT - 1) / GT;
  const int h = blockIdx.y / nhb;
  const int g0 = (blockIdx.y % nhb) * GT;
  const int ng = min(GT, G - g0);        // heads of this CTA
  const long head0 = (long)b * a.hq + (long)h * G + g0;

  // this split's share of the row's live keys
  const int kvlen = a.kv_len[b];
  const int k_end = min(kvlen, a.w * a.page);
  const int k_first = a.window > 0 ? max(0, kvlen - a.window) : 0;
  const int n = max(0, k_end - k_first);
  const int per = ((n + a.n_split - 1) / a.n_split + kSplitKeys - 1) /
                  kSplitKeys * kSplitKeys;
  const int k_lo = k_first + split * per;
  const int k_hi = min(k_end, k_lo + per);
  if (k_lo >= k_hi) {
    if (tid < ng) {
      a.ws_m[(head0 + tid) * a.n_split + split] = flash::kNegInit;
      a.ws_l[(head0 + tid) * a.n_split + split] = 0.f;
    }
    return;
  }

  auto page_of = [&](int kpos) {
    return a.page_shift >= 0 ? kpos >> a.page_shift : kpos / a.page;
  };
  auto slot_of = [&](int kpos) {
    return a.page_shift >= 0 ? kpos & (a.page - 1) : kpos % a.page;
  };
  const int j_lo = page_of(k_lo);
  const int* bt = a.bt_b + (long)b * a.w;
  for (int i = tid; i <= page_of(k_hi - 1) - j_lo; i += kThreads)
    bt_s[i] = bt[j_lo + i];
  const int grp = warp * KPW + lane / LPK;   // key group
  const int c0 = (lane % LPK) * kCols;       // first column of the lane
  const bool live = c0 < DR;                 // the lane holds columns

  // q rows of the CTA's heads, columns c0..c0+7, in f32
  float qf[GT][kCols];
  const T* q = static_cast<const T*>(a.q);
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    Cols<T> qc;
    if (g < ng && live)
      load_cols(qc, q + (head0 + g) * DR + c0);
    else
      zero_cols(qc);
    cols_f32<T, T>(qf[g], qc, 0.f);
#pragma unroll
    for (int e = 0; e < kCols; ++e) qf[g][e] *= a.scale_log2;
  }
  float m[GT], l[GT], acc[GT][kCols];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = flash::kNegInit;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();

  const TB* kb = static_cast<const TB*>(a.kb);
  const TB* vb = static_cast<const TB*>(a.vb);
  const int nsteps = (k_hi - k_lo + NG * U - 1) / (NG * U);

  // one online-softmax step of the key group over its U keys
  auto compute = [&](const Step<TB, U>& f) {
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[kCols];
      cols_f32<T, TB>(kx, f.k[u], f.ks[u]);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) dot = fmaf(qf[g][e], kx[e], dot);
        s[u][g] = dot;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!f.ok[u]) s[u][g] = -CUDART_INF_F;
        mx = fmaxf(mx, s[u][g]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = ex2(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ex2(s[u][g] - m_new);
        s[u][g] = p;
        l[g] += p;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[kCols];
      cols_f32<T, TB>(vx, f.v[u], f.vs[u]);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[g][e] = fmaf(s[u][g], vx[e], acc[g][e]);
    }
  };

  // cp.async: the next kStages - 1 steps' loads fly while this one is
  // computed; each lane reads back only what it copied itself, so a
  // wait_group is the only synchronisation
  unsigned char* mine = dyn + warp * kStages * SB;
  auto slot_k = [&](int st, int u) {
    return reinterpret_cast<Cols<TB>*>(mine + st * SB) + u * 32 + lane;
  };
  auto slot_v = [&](int st, int u) { return slot_k(st, u) + U * 32; };
  auto slot_s = [&](int st, int u) {
    return reinterpret_cast<float*>(mine + st * SB +
                                    2 * U * 32 * sizeof(Cols<TB>)) +
           (u * 32 + lane) * 2;
  };
  auto issue = [&](int it) {
    if (it < nsteps) {
      const int st = it % kStages;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kp = min(k_lo + (it * U + u) * NG + grp, k_hi - 1);
        const long tok =
            ((long)bt_s[page_of(kp) - j_lo] * a.page + slot_of(kp)) *
                a.hkv + h;
        if (live) {
          copy_cols(slot_k(st, u), kb + tok * DR + c0);
          copy_cols(slot_v(st, u), vb + tok * DR + c0);
        }
        if constexpr (INT8) {
          cp_async<4>(slot_s(st, u), a.kb_s + tok);
          cp_async<4>(slot_s(st, u) + 1, a.vb_s + tok);
        }
      }
    }
    flash::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int it = 0; it < nsteps; ++it) {
    issue(it + kStages - 1);
    flash::cp_async_wait<kStages - 1>();
    const int st = it % kStages;
    Step<TB, U> f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      f.ok[u] = k_lo + (it * U + u) * NG + grp < k_hi;
      if (live) {
        f.k[u] = *slot_k(st, u);
        f.v[u] = *slot_v(st, u);
      } else {
        zero_cols(f.k[u]);
        zero_cols(f.v[u]);
      }
      if constexpr (INT8) {
        f.ks[u] = slot_s(st, u)[0];
        f.vs[u] = slot_s(st, u)[1];
      } else {
        f.ks[u] = f.vs[u] = 0.f;
      }
    }
    compute(f);
  }
  flash::cp_async_wait<0>();

  // the combine may launch now; it still waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // merge the warp's key groups (lanes LPK apart hold the same columns)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a0 = exp2f(m[g] - mn), a1 = exp2f(mo - mn);
      l[g] = l[g] * a0 + lo * a1;
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        acc[g][e] = acc[g][e] * a0 +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], off) * a1;
      m[g] = mn;
    }
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        cm[warp][g] = m[g];
        cl[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < kCols; ++e) cacc[warp][g][c0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps and write the split's partials (the DR real columns)
  for (int e = tid; e < ng * DR; e += kThreads) {
    const int g = e / DR, col = e % DR;
    float mx = cm[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, cm[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(cm[w][g] - mx);
      lsum = fmaf(wt, cl[w][g], lsum);
      o = fmaf(wt, cacc[w][g][col], o);
    }
    const long row = (head0 + g) * a.n_split + split;
    a.ws_acc[row * DR + col] = o;
    if (col == 0) {
      a.ws_m[row] = mx;
      a.ws_l[row] = lsum;
    }
  }
}

// out[b, head] = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s,
// 1e-20) over the splits with l_s > 0; one thread per output element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(Args a) {
  // wait for the split kernel's grid and its writes
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long)a.bsz * a.hq * a.d) return;
  const long row = i / a.d;
  const int col = (int)(i % a.d);
  const float* m = a.ws_m + row * a.n_split;
  const float* l = a.ws_l + row * a.n_split;
  float mx = flash::kNegInit;
  for (int s = 0; s < a.n_split; ++s)
    if (l[s] > 0.f) mx = fmaxf(mx, m[s]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    if (!(l[s] > 0.f)) continue;
    const float wt = exp2f(m[s] - mx);
    lsum = fmaf(wt, l[s], lsum);
    o = fmaf(wt, a.ws_acc[(row * a.n_split + s) * a.d + col], o);
  }
  static_cast<T*>(a.out)[i] = from_f32<T>(o / fmaxf(lsum, 1e-20f));
}

// ints of block table one split reads: its share spans at most
// per / page + 2 pages, never more than the table's W
inline int bt_entries(const Args& a) {
  const long keys = (long)a.w * a.page;
  const long share = ((keys + a.n_split - 1) / a.n_split + kSplitKeys - 1) /
                     kSplitKeys * kSplitKeys;
  return (int)std::min<long>(a.w, share / a.page + 2);
}

template <typename T, typename TB, int D, int DR, int GT>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<T, TB, D, DR, GT>;
  constexpr int U = keys_per_step<TB, GT>();
  const size_t smem = (size_t)kWarps * kStages * stage_bytes<TB, U>() +
                      (size_t)bt_entries(a) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = a.hq / a.hkv;
  const dim3 grid(a.n_split, a.hkv * ((G + GT - 1) / GT), a.bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long total = (long)a.bsz * a.hq * a.d;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  // a programmatic launch: the combine's launch overlaps the split
  // kernel's tail, and it waits for the whole grid before it reads
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename TB, int D, int DR = D>
int launch_heads(const Args& a, cudaStream_t s) {
  const int G = a.hq / a.hkv;
  if (G <= 1) return launch<T, TB, D, DR, 1>(a, s);
  if (G <= 2) return launch<T, TB, D, DR, 2>(a, s);
  if (G <= 4) return launch<T, TB, D, DR, 4>(a, s);
  return launch<T, TB, D, DR, 8>(a, s);
}

template <typename T, typename TB>
int launch_dims(const Args& a, cudaStream_t s) {
  if (a.d == 32) return launch_heads<T, TB, 32>(a, s);
  if (a.d == 64) return launch_heads<T, TB, 64>(a, s);
  if (a.d == 128) return launch_heads<T, TB, 128>(a, s);
  if (a.d == 120) return launch_heads<T, TB, 128, 120>(a, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: q's type (0 f32, 1 bf16); int8 pages exactly when scales given.
// D 32/64/128 and 120 (in D 128's lane map), any G, page 1..32,
// n_split >= 1.
int dispatch(int dtype, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a.kb_s == nullptr) != (a.vb_s == nullptr) || a.n_split < 1 ||
      a.page < 1 || a.page > 32 || a.hkv < 1 || a.hq % a.hkv != 0 ||
      a.bsz > 65535 || (long)a.hkv * ((a.hq / a.hkv + 7) / 8) > 65535)
    return (int)cudaErrorInvalidValue;
  const bool int8 = a.kb_s != nullptr;
  if (dtype == 0)
    return int8 ? launch_dims<float, int8_t>(a, s)
                : launch_dims<float, float>(a, s);
  if (dtype == 1)
    return int8 ? launch_dims<__nv_bfloat16, int8_t>(a, s)
                : launch_dims<__nv_bfloat16, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace splitk

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, residual pools, B_k/B_v).
// kb_s/vb_s: both null (kb/vb in q's type) or both the f32 scale pools of
// int8 kb/vb.  paged_attention_prefill_base and paged_attention_mixed_base
// with bf16 q run the tensor-core kernel (tq * G <= 128 rows),
// paged_attention_decode_base the split-K decode in every type; their f32
// launches the template.
// Each launcher returns cudaGetLastError() after the launch (0 = success),
// or cudaErrorInvalidValue for a geometry its kernel does not take.
extern "C" int paged_attention_mixed_base(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* kb_s, const void* vb_s, const void* bt_b, const void* start,
    const void* q_len, const void* kv_len, void* out, int bsz, int sq,
    int hq, int hkv, int d, int page, int w, int tq, float scale,
    int window, void* stream) {
  const Args a{q, kb, vb, static_cast<const float*>(kb_s),
               static_cast<const float*>(vb_s), nullptr, nullptr, nullptr,
               nullptr, static_cast<const int*>(bt_b), nullptr,
               static_cast<const int*>(start), static_cast<const int*>(q_len),
               static_cast<const int*>(kv_len), out,
               sq, hq, hkv, d, 0, page, w, tq, scale, window, 0.f, 0};
  // bf16 takes the tensor-core kernel, f32 (IEEE, no TF32) the template
  if (dtype == 1) return dispatch_prefill_mma(a, bsz, stream);
  return dispatch<false>(dtype, a, bsz, stream);
}

// The split-K decode (splitk above), every type: ws_m/ws_l (B, Hq,
// n_split) and ws_acc (B, Hq, n_split, D) are the caller's f32 workspace.
extern "C" int paged_attention_decode_base(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* kb_s, const void* vb_s, const void* bt_b,
    const void* kv_len, void* ws_m, void* ws_l, void* ws_acc, void* out,
    int bsz, int hq, int hkv, int d, int page, int w, int n_split,
    float scale, int window, void* stream) {
  int shift = -1;
  for (int i = 0; i < 6; ++i)
    if (page == (1 << i)) shift = i;
  const splitk::Args a{q, kb, vb, static_cast<const float*>(kb_s),
                       static_cast<const float*>(vb_s),
                       static_cast<const int*>(bt_b),
                       static_cast<const int*>(kv_len),
                       static_cast<float*>(ws_m), static_cast<float*>(ws_l),
                       static_cast<float*>(ws_acc), out,
                       bsz, hq, hkv, d, page, shift, w, n_split, window,
                       scale * flash::kLog2e};
  return splitk::dispatch(dtype, a, stream);
}

extern "C" int paged_attention_prefill_base(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* kb_s, const void* vb_s, const void* bt_b, const void* start,
    const void* kv_len, void* out, int bsz, int sq, int hq, int hkv, int d,
    int page, int w, int tq, float scale, int window, void* stream) {
  const Args a{q, kb, vb, static_cast<const float*>(kb_s),
               static_cast<const float*>(vb_s), nullptr, nullptr, nullptr,
               nullptr, static_cast<const int*>(bt_b), nullptr,
               static_cast<const int*>(start), nullptr,
               static_cast<const int*>(kv_len), out,
               sq, hq, hkv, d, 0, page, w, tq, scale, window, 0.f, 0};
  // bf16 takes the tensor-core kernel, f32 (IEEE, no TF32) the template
  if (dtype == 1) return dispatch_prefill_mma(a, bsz, stream);
  return dispatch<false>(dtype, a, bsz, stream);
}
