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
// Two kernels, chosen by q's type in the prefill launcher: a bf16 prefill
// runs the tensor-core flash tile (residual_attention_mma_kernel, below,
// on flash_tile.cuh); an f32 prefill and every decode run the scalar
// kernel described next (IEEE f32: the tensor cores have no such mode).
//
// Scalar design (simple first; speed is later work):
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
// bound by operations (989 TFLOP/s bf16 on tensor cores); the scalar
// design runs f32 FMAs (67 TFLOP/s peak) and stays well above that bound,
// the bf16 one runs mma.sync on the tensor cores (wgmma, TMA and warp
// specialisation are later work).  Decode reads
// Sk*(Hkv*D*2 + 2R + D) values per row and does a few flops per byte: bound
// by bytes (3.35 TB/s).
#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "flash_tile.cuh"

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

// ---------------------------------------------------------------------
// bf16 prefill on the tensor cores (flash_tile.cuh).
//
// One CTA per (query tile, kv head, request row) as above, but 128 rows
// (tq positions x G heads, tq = 128 / G) of 8 warps, and every product an
// m16n8k16 MMA.  Per key block of BK keys (64; 32 at D 256, where the
// accumulator alone takes 128 registers a thread):
//   * cp.async brings K_b, V_b, sin, cos and (R a multiple of 8) K_r, V_r
//     into the other of two shared-memory stages while this one is used;
//     keys at or past kv_len are zero-filled, never read;
//   * K_r (BK x R, zero-padded to RP = 16 or 32) . B_k (RP x D) runs as
//     MMAs whose accumulator holds columns c and c + D/2 in one thread
//     (n-tiles j and j + D/16), so RoPE rotates in registers with sin/cos
//     read from the tables; K_b is added in f32 and the sum rounded once
//     to bf16 in place of K_b (the plain version's rounding point);
//   * S = Q K^T, the mask (only on blocks that straddle kv_len, the
//     causal edge or the window), the online softmax in registers,
//     O += P V_b and O_r += P V_r, P rounded to bf16;
// then O += O_r . B_v (O_r rounded to bf16) and O / max(l, 1e-20).
// The latest query tiles, the heaviest under a causal mask, launch first.

template <int D, int BK, int RP>
struct MmaLayout {
  static constexpr int DS = D + flash::kPad;       // Q, K, V, B_k, B_v rows
  static constexpr int RS = RP + flash::kPad;      // K_r, V_r rows
  static constexpr int HS = D / 2 + flash::kPad;   // sin, cos rows
  static constexpr int kK = 0, kV = kK + BK * DS, kKr = kV + BK * DS,
                       kVr = kKr + BK * RS, kSin = kVr + BK * RS,
                       kCos = kSin + BK * HS, kStage = kCos + BK * HS;
  static constexpr int kQ = 0, kBk = kQ + flash::kRows * DS,
                       kBv = kBk + RP * DS, kStages = kBv + RP * DS,
                       kElems = kStages + 2 * kStage;
  // rowpos (flash::kRows ints) first, then kElems bf16
  static constexpr size_t kBytes =
      flash::kRows * sizeof(int) + (size_t)kElems * sizeof(__nv_bfloat16);
};

template <int D, int BK, int RP>
__global__ void __launch_bounds__(flash::kThreads, 1)
residual_attention_mma_kernel(Args a, int bsz) {
  using flash::bf16;
  using L = MmaLayout<D, BK, RP>;
  constexpr int DS = L::DS, RS = L::RS, HS = L::HS, HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* rowpos = reinterpret_cast<int*>(smem_raw);
  bf16* sm = reinterpret_cast<bf16*>(smem_raw + flash::kRows * sizeof(int));
  bf16* Qs = sm + L::kQ;
  bf16* Bks = sm + L::kBk;
  bf16* Bvs = sm + L::kBv;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.hq / a.hkv, R = a.r;
  const int ntiles = (a.sq + a.tq - 1) / a.tq;
  const int per_tile = a.hkv * bsz;
  const int tile = ntiles - 1 - (int)(blockIdx.x / per_tile);
  const int h = (int)(blockIdx.x % per_tile) % a.hkv;
  const int b = (int)(blockIdx.x % per_tile) / a.hkv;
  const long sk = a.sk;
  const int kvlen = a.kv_len ? min(max(a.kv_len[b], 0), a.sk) : a.sk;
  const int q0 = tile * a.tq;
  const int nq = min(a.tq, a.sq - q0);
  const int nrows = nq * G;                         // row = qi * G + g
  const long out_tile = ((long)b * a.sq + q0) * a.hq + (long)h * G;
  const long hd = (long)a.hkv * D;

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kb = static_cast<const bf16*>(a.kb);
  const bf16* vb = static_cast<const bf16*>(a.vb);
  const bf16* kr = static_cast<const bf16*>(a.kr);
  const bf16* vr = static_cast<const bf16*>(a.vr);
  const bf16* bk = static_cast<const bf16*>(a.bk);
  const bf16* bv = static_cast<const bf16*>(a.bv);
  const bf16* sin_tab = static_cast<const bf16*>(a.sin);
  const bf16* cos_tab = static_cast<const bf16*>(a.cos);

  // Q rows (zero past nrows), B_k and B_v rows (zero from R to RP)
  for (int e = tid; e < flash::kRows * (D / 8); e += flash::kThreads) {
    const int r = e / (D / 8), c = e % (D / 8);
    const bool ok = r < nrows;
    const bf16* src =
        ok ? q + (out_tile + (long)(r / G) * a.hq + r % G) * D + c * 8 : q;
    flash::cp_async16(Qs + r * DS + c * 8, src, ok);
  }
  for (int e = tid; e < RP * (D / 8); e += flash::kThreads) {
    const int rr = e / (D / 8), c = e % (D / 8);
    const bool ok = rr < R;
    const long src = ok ? ((long)b * R + rr) * hd + (long)h * D + c * 8 : 0;
    flash::cp_async16(Bks + rr * DS + c * 8, bk + src, ok);
    flash::cp_async16(Bvs + rr * DS + c * 8, bv + src, ok);
  }
  flash::cp_async_commit();
  // K_r / V_r columns R..RP-1 stay zero in both stages
  for (int st = 0; st < 2; ++st) {
    bf16* base = sm + L::kStages + st * L::kStage;
    for (int e = tid; e < BK * (RP - R); e += flash::kThreads) {
      const int t = e / (RP - R), rr = R + e % (RP - R);
      base[L::kKr + t * RS + rr] = __float2bfloat16(0.f);
      base[L::kVr + t * RS + rr] = __float2bfloat16(0.f);
    }
  }
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    const int p = a.qpos ? a.qpos[(long)b * a.sq + q0 + i] : kvlen - 1;
    qlo = min(qlo, p);
    qhi = max(qhi, p);
  }
  for (int r = tid; r < flash::kRows; r += flash::kThreads) {
    const int i = min(r, nrows - 1) / G;
    rowpos[r] = a.qpos ? a.qpos[(long)b * a.sq + q0 + i] : kvlen - 1;
  }

  const int last_k = a.causal ? min(kvlen - 1, qhi) : kvlen - 1;
  const int first_k = a.window > 0 ? max(qlo - (a.window - 1), 0) : 0;
  const int jb0 = first_k / BK;
  const int nblocks = last_k >= 0 ? max(0, last_k / BK - jb0 + 1) : 0;
  const bool vec_res = (R % 8) == 0;

  auto load_block = [&](int blk, int st) {
    bf16* base = sm + L::kStages + st * L::kStage;
    const int j0 = blk * BK;
    for (int e = tid; e < BK * (D / 8); e += flash::kThreads) {
      const int t = e / (D / 8), c = e % (D / 8);
      const int kpos = j0 + t;
      const bool ok = kpos < kvlen;
      const long src = ok ? (((long)b * sk + kpos) * a.hkv + h) * D + c * 8
                          : 0;
      flash::cp_async16(base + L::kK + t * DS + c * 8, kb + src, ok);
      flash::cp_async16(base + L::kV + t * DS + c * 8, vb + src, ok);
    }
    for (int e = tid; e < BK * (HALF / 8); e += flash::kThreads) {
      const int t = e / (HALF / 8), c = e % (HALF / 8);
      const int kpos = j0 + t;
      const bool ok = kpos < kvlen;
      const long src = ok ? ((long)b * sk + kpos) * HALF + c * 8 : 0;
      flash::cp_async16(base + L::kSin + t * HS + c * 8, sin_tab + src, ok);
      flash::cp_async16(base + L::kCos + t * HS + c * 8, cos_tab + src, ok);
    }
    if (vec_res) {
      for (int e = tid; e < BK * (R / 8); e += flash::kThreads) {
        const int t = e / (R / 8), c = e % (R / 8);
        const int kpos = j0 + t;
        const bool ok = kpos < kvlen;
        const long src = ok ? ((long)b * sk + kpos) * R + c * 8 : 0;
        flash::cp_async16(base + L::kKr + t * RS + c * 8, kr + src, ok);
        flash::cp_async16(base + L::kVr + t * RS + c * 8, vr + src, ok);
      }
    } else {            // rows of R elements are not 16-byte aligned
      for (int e = tid; e < BK * R; e += flash::kThreads) {
        const int t = e / R, rr = e % R;
        const int kpos = j0 + t;
        const bool ok = kpos < kvlen;
        const long src = ((long)b * sk + kpos) * R + rr;
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

  if (nblocks > 0) load_block(jb0, 0);
  flash::cp_async_commit();
  flash::cp_async_wait<1>();                        // Q, B_k, B_v
  __syncthreads();                                  // and rowpos
  const int pos[2] = {rowpos[warp * 16 + (lane >> 2)],
                      rowpos[warp * 16 + (lane >> 2) + 8]};
  const bf16* Qw = Qs + warp * 16 * DS;
  // Q's A fragments stay in registers up to D 128; at D 256 the
  // accumulator takes 128 registers and Q is read again per key block
  constexpr bool kQInRegisters = D <= 128;
  uint32_t qf[kQInRegisters ? D / 16 : 1][4];
  if constexpr (kQInRegisters) flash::load_q<D>(qf, Qw, DS, lane);

  for (int it = 0; it < nblocks; ++it) {
    const int st = it & 1;
    if (it + 1 < nblocks) load_block(jb0 + it + 1, st ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();
    bf16* base = sm + L::kStages + st * L::kStage;
    bf16* Ks = base + L::kK;
    const bf16* Krs = base + L::kKr;
    const bf16* Sn = base + L::kSin;
    const bf16* Cs = base + L::kCos;

    // K = K_b + RoPE(K_r . B_k) in place of K_b
    flash::rebuild_k<D, BK, RP>(Ks, DS, Krs, RS, Bks, DS, Sn, Cs, HS, warp,
                                lane);
    __syncthreads();

    const int j0 = (jb0 + it) * BK;
    float s[BK / 8][4];
    if constexpr (kQInRegisters)
      flash::scores<D, BK>(s, qf, Ks, DS, lane);
    else
      flash::scores<D, BK>(s, Qw, DS, Ks, DS, lane);
    const bool full = j0 + BK <= kvlen && (!a.causal || j0 + BK - 1 <= qlo) &&
                      (a.window <= 0 || j0 > qhi - a.window);
    if (!full)
      flash::mask<BK>(s, j0, pos, kvlen, a.causal != 0, a.window, lane);
    float alpha[2];
    flash::softmax_step<BK>(s, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::rescale<RP / 8>(orr, alpha);
    flash::product<BK, D>(o, s, base + L::kV, DS, lane);
    flash::product<BK, RP>(orr, s, base + L::kVr, RS, lane);
    __syncthreads();
  }
  flash::cp_async_wait<0>();

  // epilogue: (O + O_r . B_v) / max(l, 1e-20)
  flash::product<RP, D>(o, orr, Bvs, DS, lane);
  flash::finish_rowsum(l);
  bf16* out = static_cast<bf16*>(a.out);
  bf16* dst[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + (lane >> 2) + 8 * hh;
    dst[hh] = r < nrows ? out + (out_tile + (long)(r / G) * a.hq + r % G) * D
                        : nullptr;
  }
  flash::store_rows<D>(o, l, dst, lane);
}

template <int D, int BK, int RP>
int launch_mma(const Args& a, int bsz, cudaStream_t stream) {
  using L = MmaLayout<D, BK, RP>;
  auto kernel = residual_attention_mma_kernel<D, BK, RP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((a.sq + a.tq - 1) / a.tq) * a.hkv * bsz;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, flash::kThreads, L::kBytes, stream>>>(a, bsz);
  return (int)cudaGetLastError();
}

// The bf16 prefill: D 64/128/256, R 1..32, tq * G <= 128 rows.
int dispatch_mma(const Args& a, int bsz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.r < 1 || a.r > 32 || a.tq < 1 || a.tq * (a.hq / a.hkv) > flash::kRows)
    return (int)cudaErrorInvalidValue;
  const bool r16 = a.r <= 16;
  switch (a.d) {
    case 64:
      return r16 ? launch_mma<64, 64, 16>(a, bsz, s)
                 : launch_mma<64, 64, 32>(a, bsz, s);
    case 128:
      return r16 ? launch_mma<128, 64, 16>(a, bsz, s)
                 : launch_mma<128, 64, 32>(a, bsz, s);
    case 256:
      return r16 ? launch_mma<256, 32, 16>(a, bsz, s)
                 : launch_mma<256, 32, 32>(a, bsz, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The bf16 prefill runs the
// tensor-core kernel (tq * G <= 128 rows), everything else the scalar one.
// Each launcher returns cudaGetLastError() after the launch (0 = success),
// or cudaErrorInvalidValue for a geometry its kernel does not take.
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
  // bf16 takes the tensor-core kernel, f32 (IEEE, no TF32) the scalar one
  if (dtype == 1) return dispatch_mma(a, bsz, stream);
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
