// Paged ResidualAttention for NVIDIA Hopper (sm_90a).
//
// Hand-written CUDA port of the four Pallas kernels of the unified
// prefill/decode grid in repro/kernels/paged_residual_attention.py:
//   paged_residual_attention_mixed   (_kernel_mixed,      disaggregated)
//   paged_residual_attention_decode  (_kernel,            disaggregated)
//   paged_attention_mixed_base       (_kernel_mixed_base, base only)
//   paged_attention_decode_base      (_kernel_base,       base only)
//
// One kernel template covers all four.  Decode is the mixed kernel with
// Sq = 1, start = kv_len - 1 and q_len = 1 (the launchers pass null start /
// q_len pointers), and the base-only twins drop the residual stream at
// compile time (HAS_RES = false).
//
// What it computes, per request row b and kv head h (G = Hq / Hkv query
// heads share that kv head):
//   K = K_b + RoPE(K_r . B_k)   rebuilt per page in f32 in shared memory,
//                               RoPE from the logical position j*page + t
//   S = scale . Q K^T           masked: causal, sliding window, row < q_len
//   online softmax with two accumulators, acc = P . V_b and acc_r = P . V_r
//   out = (acc + acc_r . B_v) / max(l, 1e-20); rows at or past q_len = 0.
//
// Design (simple first; speed is later work):
//   * one CTA per (q tile, kv head, row).  A q tile is `tq` query positions
//     times the G heads of the group (tq*G <= 64 rows), so every page of
//     K/V is read once for all G heads, and a long prefill row is split
//     across CTAs instead of holding the whole G*Sq block on chip;
//   * B_k and B_v for head h (R x D) are loaded into shared memory once;
//   * the page loop has plain bounds: from the first page inside the
//     window of the tile's earliest row to the last page that is live and
//     causal for its latest row (replacing the Pallas index-map clamps);
//   * all arithmetic is f32 FMAs on the CUDA cores; inputs are f32 or bf16.
//   * a tile whose rows all lie at or past q_len writes zeros and returns.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
  const void* kb;      // (P, page, Hkv, D)
  const void* vb;
  const void* kr;      // (Pr, page, R)       HAS_RES only
  const void* vr;
  const void* bk;      // (B, R, Hkv*D)       HAS_RES only
  const void* bv;
  const int* bt_b;     // (B, W)
  const int* bt_r;     // (B, W)              HAS_RES only
  const int* start;    // (B,) or null: decode, start = kv_len - 1
  const int* q_len;    // (B,) or null: decode, q_len = 1
  const int* kv_len;   // (B,)
  void* out;           // (B, Sq, Hq, D)
  int sq, hq, hkv, d, r, page, w, tq;
  float scale;
  int window;
  float rope_theta;
  int use_rope;
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

template <typename T, bool HAS_RES>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int D = a.d, R = a.r, page = a.page, half = D / 2;
  const int G = a.hq / a.hkv;

  const int kvlen = a.kv_len[b];
  const int start = a.start ? a.start[b] : kvlen - 1;
  const int qlen = a.q_len ? a.q_len[b] : 1;
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
  const int j_lo = a.window > 0 ? max(qpos_lo - (a.window - 1), 0) / page
                                : 0;
  const int j_hi = last_k >= 0 ? min(last_k / page, a.w - 1) : -1;

  const T* kb = static_cast<const T*>(a.kb);
  const T* vb = static_cast<const T*>(a.vb);
  const T* kr = static_cast<const T*>(a.kr);
  const T* vr = static_cast<const T*>(a.vr);
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const long pb = a.bt_b[(long)b * a.w + j];
    // base page tile (page, D) of head h sits at stride Hkv*D
    const long kv_base = (pb * page * a.hkv + h) * D;
    const long kv_row = (long)a.hkv * D;
    for (int e = tid; e < page * D; e += kThreads) {
      const int t = e / D, dd = e % D;
      Vs[e] = to_f32(vb[kv_base + t * kv_row + dd]);
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
          sincosf((float)(j * page + t) * inv_freq[i], &sn, &cs);
          k1 = x1 * cs - x2 * sn;
          k2 = x2 * cs + x1 * sn;
        }
        Ks[t * L.dp + i] = to_f32(kb[kv_base + t * kv_row + i]) + k1;
        Ks[t * L.dp + i + half] =
            to_f32(kb[kv_base + t * kv_row + i + half]) + k2;
      }
    } else {
      for (int e = tid; e < page * D; e += kThreads) {
        const int t = e / D, dd = e % D;
        Ks[t * L.dp + dd] = to_f32(kb[kv_base + t * kv_row + dd]);
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

template <typename T, bool HAS_RES>
int launch(const Args& a, int bsz, cudaStream_t stream) {
  const int G = a.hq / a.hkv;
  const Layout L(a.tq * G, a.d, a.r, a.page, HAS_RES);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kernel = paged_attention_kernel<T, HAS_RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + a.tq - 1) / a.tq, a.hkv, bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, bool has_res, const Args& a, int bsz,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return has_res ? launch<float, true>(a, bsz, s)
                   : launch<float, false>(a, bsz, s);
  if (dtype == 1)
    return has_res ? launch<__nv_bfloat16, true>(a, bsz, s)
                   : launch<__nv_bfloat16, false>(a, bsz, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each launcher returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int paged_residual_attention_mixed(
    int dtype, const void* q, const void* kb, const void* vb, const void* kr,
    const void* vr, const void* bk, const void* bv, const void* bt_b,
    const void* bt_r, const void* start, const void* q_len,
    const void* kv_len, void* out, int bsz, int sq, int hq, int hkv, int d,
    int r, int page, int w, int tq, float scale, int window,
    float rope_theta, int use_rope, void* stream) {
  const Args a{q, kb, vb, kr, vr, bk, bv,
               static_cast<const int*>(bt_b), static_cast<const int*>(bt_r),
               static_cast<const int*>(start), static_cast<const int*>(q_len),
               static_cast<const int*>(kv_len), out,
               sq, hq, hkv, d, r, page, w, tq, scale, window, rope_theta,
               use_rope};
  return dispatch(dtype, true, a, bsz, stream);
}

extern "C" int paged_residual_attention_decode(
    int dtype, const void* q, const void* kb, const void* vb, const void* kr,
    const void* vr, const void* bk, const void* bv, const void* bt_b,
    const void* bt_r, const void* kv_len, void* out, int bsz, int hq,
    int hkv, int d, int r, int page, int w, float scale, int window,
    float rope_theta, int use_rope, void* stream) {
  const Args a{q, kb, vb, kr, vr, bk, bv,
               static_cast<const int*>(bt_b), static_cast<const int*>(bt_r),
               nullptr, nullptr, static_cast<const int*>(kv_len), out,
               1, hq, hkv, d, r, page, w, 1, scale, window, rope_theta,
               use_rope};
  return dispatch(dtype, true, a, bsz, stream);
}

extern "C" int paged_attention_mixed_base(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* bt_b, const void* start, const void* q_len,
    const void* kv_len, void* out, int bsz, int sq, int hq, int hkv, int d,
    int page, int w, int tq, float scale, int window, void* stream) {
  const Args a{q, kb, vb, nullptr, nullptr, nullptr, nullptr,
               static_cast<const int*>(bt_b), nullptr,
               static_cast<const int*>(start), static_cast<const int*>(q_len),
               static_cast<const int*>(kv_len), out,
               sq, hq, hkv, d, 0, page, w, tq, scale, window, 0.f, 0};
  return dispatch(dtype, false, a, bsz, stream);
}

extern "C" int paged_attention_decode_base(
    int dtype, const void* q, const void* kb, const void* vb,
    const void* bt_b, const void* kv_len, void* out, int bsz, int hq,
    int hkv, int d, int page, int w, float scale, int window,
    void* stream) {
  const Args a{q, kb, vb, nullptr, nullptr, nullptr, nullptr,
               static_cast<const int*>(bt_b), nullptr, nullptr, nullptr,
               static_cast<const int*>(kv_len), out,
               1, hq, hkv, d, 0, page, w, 1, scale, window, 0.f, 0};
  return dispatch(dtype, false, a, bsz, stream);
}
