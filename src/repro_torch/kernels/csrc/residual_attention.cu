// Dense ResidualAttention for NVIDIA Hopper (sm_90a).
//
// Hand-written CUDA port of the two dense Pallas kernels in
// repro/kernels/residual_attention.py:
//   residual_attention_prefill (_prefill_kernel, entry :111)
//   residual_attention_decode  (_decode_kernel,  entry :267)
//
// They compute attention over a disaggregated KV cache laid out
// contiguously per request (the model's forward pass and contiguous
// caches), not paged.  Per request row b and kv head h (G = Hq / Hkv query
// heads share that kv head):
//   K = K_b + RoPE(K_r . B_k)   rebuilt per key block in f32 in shared
//                               memory, with sin/cos READ from the tables
//                               passed in (as in Pallas; the paged kernels
//                               compute them from the position instead)
//   S = scale . Q K^T           masked: kpos < kv_len, causal kpos <= qpos,
//                               window kpos > qpos - window
//   online softmax with two accumulators, acc = P . V_b and acc_r = P . V_r
//   out = (acc + acc_r . B_v) / max(l, 1e-20)
// A query row that sees no key comes out 0, as in Pallas (the plain version
// averages V there; no caller produces such a row).
//
// Decode is the prefill kernel with Sq = 1 and the query at kv_len - 1
// (the launcher passes a null qpos pointer).  A null kv_len pointer means
// all Sk keys are valid.
//
// Design (simple first; speed is later work):
//   * one CTA per (query tile, kv head, request row).  A query tile is `tq`
//     query positions times the G heads of the group, so each key block of
//     K/V is read once for all G heads, and a long prefill spreads over
//     CTAs.  The wrapper sets tq from a row budget per head dim (tq*G <= 64
//     rows at D <= 128, <= 32 at D 256) so that the shared-memory Layout
//     below fits the 227 KB a CTA may use: at D 256, G 16 and R 16 a tile
//     is 2 positions and needs 51,906 words (~203 KB); 64 rows would need
//     ~280 KB.  Any D that is even works in the code itself;
//   * B_k and B_v for head h (R x D) are loaded into shared memory once;
//   * the key loop runs over blocks of 32 keys, from the first block inside
//     the window of the tile's earliest query to the last block that is
//     valid and (causal) not after the tile's latest query.  Any Sq and Sk
//     are taken as they are: no padding copies (the Pallas prefill pads
//     both to multiples of its 128 blocks);
//   * all arithmetic is f32 FMAs on the CUDA cores; inputs are f32 or bf16.
//
// Bound on an H100: a long causal prefill does ~4 G D flops per (query,
// key) pair and kv head and reads each key once per query tile, so it is
// bound by operations (989 TFLOP/s bf16 on tensor cores); this design runs
// f32 FMAs (67 TFLOP/s peak) and stays well above that bound.  Decode reads
// Sk*(Hkv*D*2 + 2R + D) values per row and does a few flops per byte: bound
// by bytes (3.35 TB/s).
#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;          // keys per step of the key loop
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
  const void* kb;      // (B, Sk, Hkv, D)
  const void* vb;
  const void* kr;      // (B, Sk, R)
  const void* vr;
  const void* bk;      // (B, R, Hkv*D)
  const void* bv;
  const void* sin;     // (B, Sk, D/2)
  const void* cos;
  const int* qpos;     // (B, Sq) or null: decode, the query at kv_len - 1
  const int* kv_len;   // (B,) or null: all Sk keys valid
  void* out;           // (B, Sq, Hq, D)
  int sq, sk, hq, hkv, d, r, tq;
  float scale;
  int causal, window;
};

// Shared-memory layout, in 4-byte words; launch() asks for Layout.total
// words and returns the error if that is more than a CTA may have.  Rows
// of Q and of the rebuilt K are padded by one float so the score loop
// (threads spread over rows of K) hits distinct banks.
struct Layout {
  int dp, sp;
  int q, acc, s, m, l, alpha, k, v, sn, cs, accr, kr, vr, bk, bv, qpos,
      total;
  __host__ __device__ Layout(int rows, int tq, int d, int r) {
    dp = d + 1;
    sp = kBlockK + 1;
    int o = 0;
    q = o;     o += rows * dp;
    acc = o;   o += rows * d;
    s = o;     o += rows * sp;
    m = o;     o += rows;
    l = o;     o += rows;
    alpha = o; o += rows;
    k = o;     o += kBlockK * dp;
    v = o;     o += kBlockK * d;
    sn = o;    o += kBlockK * (d / 2);
    cs = o;    o += kBlockK * (d / 2);
    accr = o;  o += rows * r;
    kr = o;    o += kBlockK * r;
    vr = o;    o += kBlockK * r;
    bk = o;    o += r * d;
    bv = o;    o += r * d;
    qpos = o;  o += tq;                 // ints
    total = o;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int D = a.d, R = a.r, half = D / 2;
  const int G = a.hq / a.hkv;
  const long sk = a.sk;

  const int kvlen = a.kv_len ? min(max(a.kv_len[b], 0), a.sk) : a.sk;
  const int q0 = tile * a.tq;                       // first query position
  const int nq = min(a.tq, a.sq - q0);              // positions in the tile
  const int rows = nq * G;                          // row = qi * G + g
  const Layout L(a.tq * G, a.tq, D, R);
  float* Qs = smem + L.q;
  float* acc = smem + L.acc;
  float* S = smem + L.s;
  float* m = smem + L.m;
  float* l = smem + L.l;
  float* alpha = smem + L.alpha;
  float* Ks = smem + L.k;
  float* Vs = smem + L.v;
  float* Sn = smem + L.sn;
  float* Cs = smem + L.cs;
  float* accr = smem + L.accr;
  float* Kr = smem + L.kr;
  float* Vr = smem + L.vr;
  float* Bk = smem + L.bk;
  float* Bv = smem + L.bv;
  int* qp = reinterpret_cast<int*>(smem + L.qpos);

  T* out = static_cast<T*>(a.out);
  const long out_tile = ((long)b * a.sq + q0) * a.hq + (long)h * G;
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
  for (int i = tid; i < nq; i += kThreads)
    qp[i] = a.qpos ? a.qpos[(long)b * a.sq + q0 + i] : kvlen - 1;
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
  __syncthreads();

  // key-loop bounds from the tile's earliest and latest query position
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    qlo = min(qlo, qp[i]);
    qhi = max(qhi, qp[i]);
  }
  const int last_k = a.causal ? min(kvlen - 1, qhi) : kvlen - 1;
  const int first_k = a.window > 0 ? max(qlo - (a.window - 1), 0) : 0;

  const T* kb = static_cast<const T*>(a.kb);
  const T* vb = static_cast<const T*>(a.vb);
  const T* kr = static_cast<const T*>(a.kr);
  const T* vr = static_cast<const T*>(a.vr);
  const T* sin_tab = static_cast<const T*>(a.sin);
  const T* cos_tab = static_cast<const T*>(a.cos);

  for (int j0 = first_k / kBlockK * kBlockK; j0 <= last_k; j0 += kBlockK) {
    const int nk = min(kBlockK, a.sk - j0);         // keys in this block
    const long tok0 = (long)b * sk + j0;            // first token's index
    // base tile (nk, D) of head h sits at stride Hkv*D
    const long kv_base = (tok0 * a.hkv + h) * D;
    for (int e = tid; e < nk * D; e += kThreads) {
      const int t = e / D, dd = e % D;
      Vs[e] = to_f32(vb[kv_base + t * hd + dd]);
    }
    for (int e = tid; e < nk * R; e += kThreads) {
      Kr[e] = to_f32(kr[tok0 * R + e]);
      Vr[e] = to_f32(vr[tok0 * R + e]);
    }
    for (int e = tid; e < nk * half; e += kThreads) {
      Sn[e] = to_f32(sin_tab[tok0 * half + e]);
      Cs[e] = to_f32(cos_tab[tok0 * half + e]);
    }
    __syncthreads();
    // K = K_b + RoPE(K_r . B_k), one (t, i) rotation pair per step
    for (int e = tid; e < nk * half; e += kThreads) {
      const int t = e / half, i = e % half;
      float x1 = 0.f, x2 = 0.f;
      for (int rr = 0; rr < R; ++rr) {
        const float kv = Kr[t * R + rr];
        x1 = fmaf(kv, Bk[rr * D + i], x1);
        x2 = fmaf(kv, Bk[rr * D + i + half], x2);
      }
      const float sn = Sn[e], cs = Cs[e];
      Ks[t * L.dp + i] =
          to_f32(kb[kv_base + t * hd + i]) + (x1 * cs - x2 * sn);
      Ks[t * L.dp + i + half] =
          to_f32(kb[kv_base + t * hd + i + half]) + (x2 * cs + x1 * sn);
    }
    __syncthreads();

    // masked scores; -inf marks a masked (row, t)
    for (int e = tid; e < rows * nk; e += kThreads) {
      const int row = e / nk, t = e % nk;
      const int qpos = qp[row / G];
      const int kpos = j0 + t;
      bool valid = kpos < kvlen;
      if (a.causal) valid = valid && kpos <= qpos;
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
      for (int t = 0; t < nk; ++t) mx = fmaxf(mx, sr[t]);
      const float al = expf(m_old - mx);
      float sum = 0.f;
      for (int t = 0; t < nk; ++t) {
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
      for (int t = 0; t < nk; ++t) o = fmaf(pr[t], Vs[t * D + dd], o);
      acc[e] = o;
    }
    for (int e = tid; e < rows * R; e += kThreads) {
      const int row = e / R, rr = e % R;
      const float* pr = S + row * L.sp;
      float o = accr[e] * alpha[row];
      for (int t = 0; t < nk; ++t) o = fmaf(pr[t], Vr[t * R + rr], o);
      accr[e] = o;
    }
    __syncthreads();
  }

  // epilogue: (acc + acc_r . B_v) / max(l, 1e-20)
  for (int e = tid; e < rows * D; e += kThreads) {
    const int row = e / D, dd = e % D;
    float o = acc[e];
    for (int rr = 0; rr < R; ++rr)
      o = fmaf(accr[row * R + rr], Bv[rr * D + dd], o);
    o /= fmaxf(l[row], 1e-20f);
    out[(out_tile + (long)(row / G) * a.hq + row % G) * D + dd] =
        from_f32<T>(o);
  }
}

template <typename T>
int launch(const Args& a, int bsz, cudaStream_t stream) {
  const int G = a.hq / a.hkv;
  const Layout L(a.tq * G, a.tq, a.d, a.r);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kernel = residual_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + a.tq - 1) / a.tq, a.hkv, bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const Args& a, int bsz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, bsz, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, bsz, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each launcher returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int residual_attention_prefill(
    int dtype, const void* q, const void* kb, const void* vb, const void* kr,
    const void* vr, const void* bk, const void* bv, const void* sin,
    const void* cos, const void* qpos, const void* kv_len, void* out,
    int bsz, int sq, int sk, int hq, int hkv, int d, int r, int tq,
    float scale, int causal, int window, void* stream) {
  const Args a{q, kb, vb, kr, vr, bk, bv, sin, cos,
               static_cast<const int*>(qpos),
               static_cast<const int*>(kv_len), out,
               sq, sk, hq, hkv, d, r, tq, scale, causal, window};
  return dispatch(dtype, a, bsz, stream);
}

extern "C" int residual_attention_decode(
    int dtype, const void* q, const void* kb, const void* vb, const void* kr,
    const void* vr, const void* bk, const void* bv, const void* sin,
    const void* cos, const void* kv_len, void* out, int bsz, int sk, int hq,
    int hkv, int d, int r, float scale, int window, void* stream) {
  const Args a{q, kb, vb, kr, vr, bk, bv, sin, cos, nullptr,
               static_cast<const int*>(kv_len), out,
               1, sk, hq, hkv, d, r, 1, scale, 1, window};
  return dispatch(dtype, a, bsz, stream);
}
