// The scalar template of the paged ResidualAttention kernels for NVIDIA
// Hopper (sm_90a), shared by paged_residual_attention.cu (#3, #4, #6) and
// paged_residual_disagg.cu (#5, #1, #2): its arguments, the shares of a
// split decode, the kernel and its launchers.  Only f32 launches run it:
// those of #1, #3, #5 and #6, and those of #2 share by share (SPLIT);
// every bf16 launch runs the redesigned kernels of the two sources, so
// the template is instantiated for f32 q alone.
//
// One kernel template covers all six entries.  Decode is the mixed kernel
// with Sq = 1, start = kv_len - 1 and q_len = 1 (null start / q_len
// pointers).  The phase-separated chunked prefill is the mixed kernel
// with a null q_len pointer: each row's query length is
// clamp(kv_len - start, 0, Sq), so rows at or past it (the padding the
// caller ignores) come back as zeros and their tiles cost nothing.  The
// base-only twins drop the residual stream at compile time
// (HAS_RES = false).
//
// The int8 variant of all six (the ``quant = kb_scale is not None`` branch
// of each Pallas entry: :231, :363, :516, :645, :787, :922) is the same
// template with the bCache element type TB = int8_t: kb/vb pages are int8
// with f32 scale pools (P, page, Hkv), and each page element is multiplied
// by its per-(token, head) scale in f32 as it is loaded, before the
// residual term is added to K (Pallas: k_b * ks_ref, then + K_r B_k) and
// before V enters the softmax update.  The residual pools and B_k/B_v stay
// in q's type.  The launchers take the two scale pointers, null for
// full-precision pages.
//
// What it computes, per request row b and kv head h (G = Hq / Hkv query
// heads share that kv head):
//   K = K_b + RoPE(K_r . B_k)   rebuilt per page in f32 in shared memory,
//                               RoPE from the logical position j*page + t
//   S = scale . Q K^T           masked: causal, sliding window, row < q_len
//   online softmax with two accumulators, acc = P . V_b and acc_r = P . V_r
//   out = (acc + acc_r . B_v) / max(l, 1e-20); rows at or past q_len = 0.
//
// Template design (simple first; speed is later work):
//   * one CTA per (q tile, kv head, row).  A q tile is `tq` query positions
//     times the G heads of the group (tq*G <= 64 rows), so every page of
//     K/V is read once for all G heads, and a long prefill row is split
//     across CTAs instead of holding the whole G*Sq block on chip;
//   * B_k and B_v for head h (R x D) are loaded into shared memory once;
//   * the page loop has plain bounds: from the first page inside the
//     window of the tile's earliest row to the last page that is live and
//     causal for its latest row (replacing the Pallas index-map clamps);
//   * all arithmetic is f32 FMAs on the CUDA cores; inputs are f32 or bf16,
//     bCache pages f32, bf16 or int8 (one byte-wide load per element).
//   * a tile whose rows all lie at or past q_len writes zeros and returns.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "flash_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// One bCache element in f32.  An int8 element is multiplied by the scale
// of its (token, head), rounded on its own (no FMA with what is added
// next), as the Pallas kernel dequantizes the tile before the residual.
template <typename TB>
__device__ __forceinline__ float base_elem(const TB* pool, const float* s,
                                           long i, long si) {
  if constexpr (std::is_same<TB, int8_t>::value)
    return __fmul_rn(to_f32(pool[i]), s[si]);
  else
    return to_f32(pool[i]);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;       // (B, Sq, Hq, D)
  const void* kb;      // (P, page, Hkv, D)      T, or int8 with scales
  const void* vb;
  const float* kb_s;   // (P, page, Hkv) f32     int8 pages only, else null
  const float* vb_s;
  const void* kr;      // (Pr, page, R)       HAS_RES only
  const void* vr;
  const void* bk;      // (B, R, Hkv*D)       HAS_RES only
  const void* bv;
  const int* bt_b;     // (B, W)
  const int* bt_r;     // (B, W)              HAS_RES only
  const int* start;    // (B,) or null: decode, start = kv_len - 1
  const int* q_len;    // (B,) or null: decode, q_len = 1; prefill (start
                       // given), q_len = clamp(kv_len - start, 0, Sq)
  const int* kv_len;   // (B,)
  void* out;           // (B, Sq, Hq, D)
  int sq, hq, hkv, d, r, page, w, tq;
  float scale;
  int window;
  float rope_theta;
  int use_rope;
  // RoPE tables (N, D/2) in q's type, rows by position: the tensor-core
  // #5 tile and the template's SPLIT instances read them; the others
  // compute sin/cos themselves
  const void* sin = nullptr;
  const void* cos = nullptr;
  // decode by shares (#2 in f32): n_split shares of the row's live keys,
  // one CTA each, f32 partials m (base 2), l (B, Hq, n_split), acc (...,
  // D) and acc_r (..., R) instead of out; null for every other launch
  int n_split = 0;
  float* ws_m = nullptr;
  float* ws_l = nullptr;
  float* ws_acc = nullptr;
  float* ws_accr = nullptr;
};

// Keys per share of a split decode with the residual stream (#2): shares
// are whole multiples of it (the tensor-core split kernel's warp step).
constexpr int kResSplitKeys = 16;

// [lo, hi) of share ``s`` of n_split equal shares of kResSplitKeys
// multiples over a decode row's live keys, [kv_len - window, kv_len)
// clipped to [0, min(kv_len, W * page)).
struct Share {
  int lo, hi, per, first;
  __device__ Share(int kvlen, int w, int page, int window, int n_split,
                   int s) {
    const int end = min(kvlen, w * page);
    first = window > 0 ? max(0, kvlen - window) : 0;
    const int n = max(0, end - first);
    per = ((n + n_split - 1) / n_split + kResSplitKeys - 1) / kResSplitKeys *
          kResSplitKeys;
    lo = first + s * per;
    hi = min(end, lo + per);
  }
};

// Shared-memory layout, in floats.  Rows of Q and of the rebuilt K are
// padded by one float so the score loop (threads spread over rows of K)
// hits distinct banks.
struct Layout {
  int rows, dp, sp;
  int q, acc, s, m, l, alpha, k, v, inv_freq, accr, kr, vr, bk, bv, total;
  __host__ __device__ Layout(int rows_, int d, int r, int page,
                             bool has_res) {
    rows = rows_;
    dp = d + 1;
    sp = page + 1;
    int o = 0;
    q = o;        o += rows * dp;
    acc = o;      o += rows * d;
    s = o;        o += rows * sp;
    m = o;        o += rows;
    l = o;        o += rows;
    alpha = o;    o += rows;
    k = o;        o += page * dp;
    v = o;        o += page * d;
    inv_freq = o; o += d / 2;
    accr = kr = vr = bk = bv = o;
    if (has_res) {
      accr = o;   o += rows * r;
      kr = o;     o += page * r;
      vr = o;     o += page * r;
      bk = o;     o += r * d;
      bv = o;     o += r * d;
    }
    total = o;
  }
};

// SPLIT: a decode by shares (#2 in f32): share blockIdx.x of its row (one
// q tile), its partials into the workspace, sin/cos from the RoPE tables.
template <typename T, typename TB, bool HAS_RES, bool SPLIT = false>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int tile = SPLIT ? 0 : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int D = a.d, R = a.r, page = a.page, half = D / 2;
  const int G = a.hq / a.hkv;

  const int kvlen = a.kv_len[b];
  const int start = a.start ? a.start[b] : kvlen - 1;
  const int qlen = a.q_len   ? a.q_len[b]
                   : a.start ? max(0, min(a.sq, kvlen - start))
                             : 1;
  const int q0 = tile * a.tq;                       // first position
  const int npos = min(a.tq, a.sq - q0);            // positions in tile
  const int nq = max(0, min(npos, qlen - q0));      // valid positions
  T* out = static_cast<T*>(a.out);
  const long out_tile = ((long)b * a.sq + q0) * a.hq + (long)h * G;

  // rows at or past q_len: exact zeros
  for (int e = tid; e < (npos - nq) * G * D; e += kThreads) {
    const int qi = nq + e / (G * D);
    const int rest = e % (G * D);
    out[(out_tile + (long)qi * a.hq) * D + rest] = from_f32<T>(0.f);
  }
  if (nq == 0) return;

  const int rows = nq * G;                          // row = qi * G + g
  const Layout L(a.tq * G, D, R, page, HAS_RES);
  float* Qs = smem + L.q;
  float* acc = smem + L.acc;
  float* S = smem + L.s;
  float* m = smem + L.m;
  float* l = smem + L.l;
  float* alpha = smem + L.alpha;
  float* Ks = smem + L.k;
  float* Vs = smem + L.v;
  float* inv_freq = smem + L.inv_freq;
  float* accr = smem + L.accr;
  float* Kr = smem + L.kr;
  float* Vr = smem + L.vr;
  float* Bk = smem + L.bk;
  float* Bv = smem + L.bv;

  const T* q = static_cast<const T*>(a.q);
  for (int e = tid; e < rows * D; e += kThreads) {
    const int row = e / D, dd = e % D;
    Qs[row * L.dp + dd] = to_f32(q[(out_tile + (long)(row / G) * a.hq +
                                    row % G) * D + dd]);
    acc[e] = 0.f;
  }
  for (int row = tid; row < rows; row += kThreads) {
    m[row] = kNegInit;
    l[row] = 0.f;
  }
  if (HAS_RES) {
    const T* bk = static_cast<const T*>(a.bk);
    const T* bv = static_cast<const T*>(a.bv);
    const long hd = (long)a.hkv * D;
    for (int e = tid; e < R * D; e += kThreads) {
      const int rr = e / D, dd = e % D;
      const long src = ((long)b * R + rr) * hd + (long)h * D + dd;
      Bk[e] = to_f32(bk[src]);
      Bv[e] = to_f32(bv[src]);
    }
    for (int e = tid; e < rows * R; e += kThreads) accr[e] = 0.f;
    for (int i = tid; i < half; i += kThreads)
      inv_freq[i] = 1.0f / powf(a.rope_theta, (float)i / (float)half);
  }

  // plain page-loop bounds (the Pallas kernels clamp their index maps)
  const int qpos_lo = start + q0;
  const int qpos_hi = start + q0 + nq - 1;
  const int last_k = min(kvlen - 1, qpos_hi);
  int j_lo = a.window > 0 ? max(qpos_lo - (a.window - 1), 0) / page : 0;
  int j_hi = last_k >= 0 ? min(last_k / page, a.w - 1) : -1;
  // a share's keys only (an empty share: no page)
  int k_lo = 0, k_hi = INT_MAX;
  if constexpr (SPLIT) {
    const Share sh(kvlen, a.w, page, a.window, a.n_split, blockIdx.x);
    k_lo = sh.lo;
    k_hi = sh.hi;
    j_lo = max(j_lo, k_lo / page);
    j_hi = k_lo < k_hi ? min(j_hi, (k_hi - 1) / page) : -1;
  }

  const TB* kb = static_cast<const TB*>(a.kb);
  const TB* vb = static_cast<const TB*>(a.vb);
  const T* kr = static_cast<const T*>(a.kr);
  const T* vr = static_cast<const T*>(a.vr);
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const long pb = a.bt_b[(long)b * a.w + j];
    // base page tile (page, D) of head h sits at stride Hkv*D
    const long kv_base = (pb * page * a.hkv + h) * D;
    const long kv_row = (long)a.hkv * D;
    // scale of (page pb, token t, head h) at (pb * page + t) * Hkv + h
    const long s_base = pb * page * a.hkv + h;
    for (int e = tid; e < page * D; e += kThreads) {
      const int t = e / D, dd = e % D;
      Vs[e] = base_elem(vb, a.vb_s, kv_base + t * kv_row + dd,
                        s_base + (long)t * a.hkv);
    }
    if (HAS_RES) {
      const long pr = a.bt_r[(long)b * a.w + j];
      for (int e = tid; e < page * R; e += kThreads) {
        Kr[e] = to_f32(kr[pr * page * R + e]);
        Vr[e] = to_f32(vr[pr * page * R + e]);
      }
      __syncthreads();
      // K = K_b + RoPE(K_r . B_k), one (t, i) rotation pair per step
      for (int e = tid; e < page * half; e += kThreads) {
        const int t = e / half, i = e % half;
        float x1 = 0.f, x2 = 0.f;
        for (int rr = 0; rr < R; ++rr) {
          const float kv = Kr[t * R + rr];
          x1 = fmaf(kv, Bk[rr * D + i], x1);
          x2 = fmaf(kv, Bk[rr * D + i + half], x2);
        }
        float k1 = x1, k2 = x2;
        if (a.use_rope) {
          float sn, cs;
          if constexpr (SPLIT) {
            const long at = (long)(j * page + t) * half + i;
            sn = to_f32(static_cast<const T*>(a.sin)[at]);
            cs = to_f32(static_cast<const T*>(a.cos)[at]);
          } else {
            sincosf((float)(j * page + t) * inv_freq[i], &sn, &cs);
          }
          k1 = x1 * cs - x2 * sn;
          k2 = x2 * cs + x1 * sn;
        }
        const long st = s_base + (long)t * a.hkv;
        Ks[t * L.dp + i] = base_elem(kb, a.kb_s, kv_base + t * kv_row + i,
                                     st) + k1;
        Ks[t * L.dp + i + half] =
            base_elem(kb, a.kb_s, kv_base + t * kv_row + i + half, st) + k2;
      }
    } else {
      for (int e = tid; e < page * D; e += kThreads) {
        const int t = e / D, dd = e % D;
        Ks[t * L.dp + dd] = base_elem(kb, a.kb_s, kv_base + t * kv_row + dd,
                                      s_base + (long)t * a.hkv);
      }
    }
    __syncthreads();

    // masked scores; -inf marks a masked (row, t)
    for (int e = tid; e < rows * page; e += kThreads) {
      const int row = e / page, t = e % page;
      const int qpos = qpos_lo + row / G;
      const int kpos = j * page + t;
      bool valid = kpos < kvlen && kpos <= qpos;
      if (a.window > 0) valid = valid && kpos > qpos - a.window;
      if (SPLIT) valid = valid && kpos >= k_lo && kpos < k_hi;
      float sc = -CUDART_INF_F;
      if (valid) {
        float dot = 0.f;
        const float* qr = Qs + row * L.dp;
        const float* kt = Ks + t * L.dp;
        for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kt[dd], dot);
        sc = dot * a.scale;
      }
      S[row * L.sp + t] = sc;
    }
    __syncthreads();

    // online softmax, one thread per row
    for (int row = tid; row < rows; row += kThreads) {
      float* sr = S + row * L.sp;
      const float m_old = m[row];
      float mx = m_old;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sr[t]);
      const float al = expf(m_old - mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = sr[t] == -CUDART_INF_F ? 0.f : expf(sr[t] - mx);
        sr[t] = p;
        sum += p;
      }
      m[row] = mx;
      l[row] = l[row] * al + sum;
      alpha[row] = al;
    }
    __syncthreads();

    for (int e = tid; e < rows * D; e += kThreads) {
      const int row = e / D, dd = e % D;
      const float* pr = S + row * L.sp;
      float o = acc[e] * alpha[row];
      for (int t = 0; t < page; ++t) o = fmaf(pr[t], Vs[t * D + dd], o);
      acc[e] = o;
    }
    if (HAS_RES) {
      for (int e = tid; e < rows * R; e += kThreads) {
        const int row = e / R, rr = e % R;
        const float* pr = S + row * L.sp;
        float o = accr[e] * alpha[row];
        for (int t = 0; t < page; ++t) o = fmaf(pr[t], Vr[t * R + rr], o);
        accr[e] = o;
      }
    }
    __syncthreads();
  }

  if constexpr (SPLIT) {
    // the share's partials (decode: row = query head g of kv head h); m
    // in base 2, as the combine weighs them
    for (int row = tid; row < rows; row += kThreads) {
      const long p = (out_tile + row) * a.n_split + blockIdx.x;
      a.ws_m[p] = m[row] * flash::kLog2e;
      a.ws_l[p] = l[row];
    }
    for (int e = tid; e < rows * D; e += kThreads)
      a.ws_acc[((out_tile + e / D) * a.n_split + blockIdx.x) * D + e % D] =
          acc[e];
    for (int e = tid; e < rows * R; e += kThreads)
      a.ws_accr[((out_tile + e / R) * a.n_split + blockIdx.x) * R + e % R] =
          accr[e];
    return;
  }

  // epilogue: (acc + acc_r . B_v) / max(l, 1e-20)
  for (int e = tid; e < rows * D; e += kThreads) {
    const int row = e / D, dd = e % D;
    float o = acc[e];
    if (HAS_RES) {
      for (int rr = 0; rr < R; ++rr)
        o = fmaf(accr[row * R + rr], Bv[rr * D + dd], o);
    }
    o /= fmaxf(l[row], 1e-20f);
    out[(out_tile + (long)(row / G) * a.hq + row % G) * D + dd] =
        from_f32<T>(o);
  }
}

template <typename T, typename TB, bool HAS_RES>
int launch(const Args& a, int bsz, cudaStream_t stream) {
  const int G = a.hq / a.hkv;
  const Layout L(a.tq * G, a.d, a.r, a.page, HAS_RES);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kernel = paged_attention_kernel<T, TB, HAS_RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + a.tq - 1) / a.tq, a.hkv, bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dtype: q's type, float32 only (every bf16 launch of the six entries
// runs a redesigned kernel); the pages are int8 exactly when the scales
// are given.
template <bool HAS_RES>
int dispatch(int dtype, const Args& a, int bsz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a.kb_s == nullptr) != (a.vb_s == nullptr) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return a.kb_s != nullptr ? launch<float, int8_t, HAS_RES>(a, bsz, s)
                           : launch<float, float, HAS_RES>(a, bsz, s);
}

}  // namespace
