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
// Decode has the query at kv_len - 1; a null kv_len pointer means all Sk
// keys are valid.
//
// Head dims: the scalar kernel takes any even D as it is; the bf16 kernels
// have instances at D 32, 64, 128 and 256, and run head_dim 120
// (h2o-danube-3-4b) in D 128's tile in the split-half layout of
// flash::Cols: RoPE pairs column c with c + 60, which is no multiple of an
// 8-column n-tile, so the halves go to tile columns 0..59 and 64..123 and
// the tile's own pairing c <-> c + 64 holds; columns 60..63 and 124..127
// are zero on chip (in Q, K_b, V_b, B_k, B_v, and sin/cos 60..63), add
// nothing to Q K^T and are never stored.  q and the cache are read as they
// are, with 8-byte cp.async (a half starts at byte 120 of its row); no
// copy is padded on the host.
//
// Three kernels, chosen by q's type: a bf16 prefill runs the tensor-core
// flash tile (residual_attention_mma_kernel, below, on flash_tile.cuh), a
// bf16 decode the split-K decode (residual_attention_decode_split_kernel,
// below); every f32 launch runs the scalar kernel described next, a
// decode as the prefill with Sq = 1 and a null qpos pointer (IEEE f32: the
// tensor cores have no such mode).
//
// Scalar design (simple first; speed is later work):
//   * one CTA per (query tile, kv head, request row).  A query tile is `tq`
//     query positions times the G heads of the group, so each key block of
//     K/V is read once for all G heads, and a long prefill spreads over
//     CTAs.  The wrapper sets tq from a row budget (tq*G <= 64 rows at
//     D <= 128; at D 256 32 rows, or 16 where the rank leaves no room for
//     32: ``scalar_rows`` in residual_attention.py repeats the Layout
//     below) so that the shared-memory Layout fits the 227 KB a CTA may
//     use: at D 256, G 16 and R 64 a tile is 1 position and needs 54,897
//     words (~214 KB).  Any D that is even works in the code itself;
//   * B_k for head h (R x D) is loaded into shared memory once, B_v after
//     the key loop, over the key block's buffers;
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
#include <atomic>
#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "flash_tile.cuh"
#include "rank_chunk.cuh"

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
// ``chunk`` (ranks above kRankChunk, or a group whose rows the layout at
// rank R cannot hold): no acc_r, and one rank chunk (kScalarRankChunk) of
// K_r or V_r (kr) and of B_k or B_v (bk) at a time.
struct Layout {
  int dp, sp;
  int q, acc, s, m, l, alpha, k, v, sn, cs, accr, kr, vr, bk, bv, qpos,
      total;
  __host__ __device__ Layout(int rows, int tq, int d, int r,
                             bool chunk = false) {
    if (chunk) r = 0;
    const int rc = chunk ? flash::kScalarRankChunk : 0;
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
    kr = chunk ? o : kr;  o += kBlockK * rc;
    bk = chunk ? o : bk;  o += rc * d;
    qpos = o;  o += tq;                 // ints
    total = o;
    // B_v (r x d) is read only after the key loop: it is loaded then over
    // the key block's k, v, sn and cs (kBlockK (3 d + 1) words, room for
    // r up to 96), which keeps rank 64 inside the 227 KB at D 256
    bv = k;
  }
};

// CHUNK: K = K_b + RoPE(K_r . B_k) summed in f32 in the K rows and V =
// V_b + V_r . B_v in the V rows, one rank chunk at a time (K_r and B_k,
// then V_r and B_v), as the plain version reconstructs them; then no acc_r
// and no B_v epilogue.
template <typename T, bool CHUNK = false>
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
  const Layout L(a.tq * G, a.tq, D, R, CHUNK);
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
  if (!CHUNK) {
    for (int e = tid; e < R * D; e += kThreads) {
      const int rr = e / D, dd = e % D;
      Bk[e] = to_f32(bk[((long)b * R + rr) * hd + (long)h * D + dd]);
    }
    for (int e = tid; e < rows * R; e += kThreads) accr[e] = 0.f;
  }
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
    if (!CHUNK)
      for (int e = tid; e < nk * R; e += kThreads) {
        Kr[e] = to_f32(kr[tok0 * R + e]);
        Vr[e] = to_f32(vr[tok0 * R + e]);
      }
    for (int e = tid; e < nk * half; e += kThreads) {
      Sn[e] = to_f32(sin_tab[tok0 * half + e]);
      Cs[e] = to_f32(cos_tab[tok0 * half + e]);
    }
    if constexpr (CHUNK) {
      constexpr int RC = flash::kScalarRankChunk;
      // the f32 sums of K_r . B_k in the K rows (RoPE after the last one)
      for (int e = tid; e < nk * D; e += kThreads)
        Ks[(e / D) * L.dp + e % D] = 0.f;
      for (int pass = 0; pass < 2; ++pass)
        for (int r0 = 0; r0 < R; r0 += RC) {
          __syncthreads();          // the chunk buffers are free
          const T* rp = pass ? vr : kr;
          const T* bp = pass ? bv : bk;
          for (int e = tid; e < nk * RC; e += kThreads) {
            const int t = e / RC, rr = r0 + e % RC;
            Kr[e] = rr < R ? to_f32(rp[(tok0 + t) * R + rr]) : 0.f;
          }
          for (int e = tid; e < RC * D; e += kThreads) {
            const int rr = r0 + e / D, dd = e % D;
            Bk[e] = rr < R ? to_f32(bp[((long)b * R + rr) * hd +
                                       (long)h * D + dd])
                           : 0.f;
          }
          __syncthreads();
          for (int e = tid; e < nk * D; e += kThreads) {
            const int t = e / D, dd = e % D;
            float x = 0.f;
            for (int c = 0; c < RC; ++c)
              x = fmaf(Kr[t * RC + c], Bk[c * D + dd], x);
            if (pass)
              Vs[e] += x;
            else
              Ks[t * L.dp + dd] += x;
          }
        }
      __syncthreads();
      for (int e = tid; e < nk * half; e += kThreads) {
        const int t = e / half, i = e % half;
        const float x1 = Ks[t * L.dp + i], x2 = Ks[t * L.dp + i + half];
        const float sn = Sn[e], cs = Cs[e];
        Ks[t * L.dp + i] =
            to_f32(kb[kv_base + t * hd + i]) + (x1 * cs - x2 * sn);
        Ks[t * L.dp + i + half] =
            to_f32(kb[kv_base + t * hd + i + half]) + (x2 * cs + x1 * sn);
      }
    }
    __syncthreads();
    // K = K_b + RoPE(K_r . B_k), one (t, i) rotation pair per step
    for (int e = tid; e < nk * half && !CHUNK; e += kThreads) {
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
    for (int e = tid; e < rows * R && !CHUNK; e += kThreads) {
      const int row = e / R, rr = e % R;
      const float* pr = S + row * L.sp;
      float o = accr[e] * alpha[row];
      for (int t = 0; t < nk; ++t) o = fmaf(pr[t], Vr[t * R + rr], o);
      accr[e] = o;
    }
    __syncthreads();
  }

  // B_v over the last key block (the loop ended on a barrier)
  if (!CHUNK) {
    for (int e = tid; e < R * D; e += kThreads) {
      const int rr = e / D, dd = e % D;
      Bv[e] = to_f32(bv[((long)b * R + rr) * hd + (long)h * D + dd]);
    }
    __syncthreads();
  }
  // epilogue: (acc + acc_r . B_v) / max(l, 1e-20)
  for (int e = tid; e < rows * D; e += kThreads) {
    const int row = e / D, dd = e % D;
    float o = acc[e];
    for (int rr = 0; rr < R && !CHUNK; ++rr)
      o = fmaf(accr[row * R + rr], Bv[rr * D + dd], o);
    o /= fmaxf(l[row], 1e-20f);
    out[(out_tile + (long)(row / G) * a.hq + row % G) * D + dd] =
        from_f32<T>(o);
  }
}

// the shared memory a CTA may have on the H100
constexpr int kSmemPerCta = 232448;

template <typename T>
int launch(const Args& a, int bsz, cudaStream_t stream) {
  const int G = a.hq / a.hkv;
  // the chunked instance above kRankChunk, or where the layout at rank R
  // does not fit (a group of 32 heads at D 256 and rank 64);
  // residual_attention.scalar_chunked repeats the choice
  const bool chunk =
      a.r > flash::kRankChunk ||
      (size_t)Layout(a.tq * G, a.tq, a.d, a.r).total * sizeof(float) >
          (size_t)kSmemPerCta;
  const Layout L(a.tq * G, a.tq, a.d, a.r, chunk);
  const size_t smem = (size_t)L.total * sizeof(float);
  auto kernel = chunk ? residual_attention_kernel<T, true>
                      : residual_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + a.tq - 1) / a.tq, a.hkv, bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// f32 only: every bf16 launch runs a tensor-core kernel.  Any R >= 1.
int dispatch(int dtype, const Args& a, int bsz, void* stream) {
  if (dtype != 0 || a.r < 1) return (int)cudaErrorInvalidValue;
  return launch<float>(a, bsz, static_cast<cudaStream_t>(stream));
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
//   * K_r (BK x R, zero-padded to RP = 16, 32 or 64) . B_k (RP x D) runs as
//     MMAs whose accumulator holds columns c and c + D/2 in one thread
//     (n-tiles j and j + D/16), so RoPE rotates in registers with sin/cos
//     read from the tables; K_b is added in f32 and the sum rounded once
//     to bf16 in place of K_b (the plain version's rounding point);
//   * S = Q K^T, the mask (only on blocks that straddle kv_len, the
//     causal edge or the window), the online softmax in registers,
//     O += P V_b and O_r += P V_r, P rounded to bf16;
// then O += O_r . B_v (O_r rounded to bf16) and O / max(l, 1e-20).
// The latest query tiles, the heaviest under a causal mask, launch first.
// ROWS query rows per CTA: 128 (all 8 warps), except at D 256 with RP 64,
// where B_k and B_v of 64 rows and the two stages leave no room for a Q
// tile of 128 rows in the 227 KB (250.5 KB); there the CTA holds 64 rows
// (217.3 KB), warps 4..7 load and rebuild the key blocks with the others
// and take no query rows.

template <int D, int BK, int RP, int ROWS = flash::kRows>
struct MmaLayout {
  static constexpr int DS = D + flash::kPad;       // Q, K, V, B_k, B_v rows
  static constexpr int RS = RP + flash::kPad;      // K_r, V_r rows
  static constexpr int HS = D / 2 + flash::kPad;   // sin, cos rows
  static constexpr int kK = 0, kV = kK + BK * DS, kKr = kV + BK * DS,
                       kVr = kKr + BK * RS, kSin = kVr + BK * RS,
                       kCos = kSin + BK * HS, kStage = kCos + BK * HS;
  static constexpr int kQ = 0, kBk = kQ + ROWS * DS,
                       kBv = kBk + RP * DS, kStages = kBv + RP * DS,
                       kElems = kStages + 2 * kStage;
  // rowpos (ROWS ints) first, then kElems bf16
  static constexpr size_t kBytes =
      ROWS * sizeof(int) + (size_t)kElems * sizeof(__nv_bfloat16);
  static_assert(ROWS % 16 == 0 && ROWS <= flash::kRows, "whole warps");
  static_assert(kBytes <= 232448, "a CTA's shared memory on the H100");
};

template <int D, int BK, int RP, int DR, int ROWS>
__global__ void __launch_bounds__(flash::kThreads, 1)
residual_attention_mma_kernel(Args a, int bsz) {
  using flash::bf16;
  using L = MmaLayout<D, BK, RP, ROWS>;
  using C = flash::Cols<D, DR>;           // head rows of DR in D columns
  constexpr int DS = L::DS, RS = L::RS, HS = L::HS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* rowpos = reinterpret_cast<int*>(smem_raw);
  bf16* sm = reinterpret_cast<bf16*>(smem_raw + ROWS * sizeof(int));
  bf16* Qs = sm + L::kQ;
  bf16* Bks = sm + L::kBk;
  bf16* Bvs = sm + L::kBv;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp with query rows (all of them unless ROWS < kRows)
  const bool rows_warp = warp * 16 < ROWS;
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
  const long hd = (long)a.hkv * DR;

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
  for (int e = tid; e < ROWS * C::kRow; e += flash::kThreads) {
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
  // the split-half layout's gap columns (DR < D) stay zero in Q, B_k, B_v
  // and both stages, as do K_r / V_r columns R..RP-1
  C::zero_gaps(Qs, ROWS, DS, tid, flash::kThreads);
  C::zero_gaps(Bks, RP, DS, tid, flash::kThreads);
  C::zero_gaps(Bvs, RP, DS, tid, flash::kThreads);
  for (int st = 0; st < 2; ++st) {
    bf16* base = sm + L::kStages + st * L::kStage;
    for (int e = tid; e < BK * (RP - R); e += flash::kThreads) {
      const int t = e / (RP - R), rr = R + e % (RP - R);
      base[L::kKr + t * RS + rr] = __float2bfloat16(0.f);
      base[L::kVr + t * RS + rr] = __float2bfloat16(0.f);
    }
    C::zero_gaps(base + L::kK, BK, DS, tid, flash::kThreads);
    C::zero_gaps(base + L::kV, BK, DS, tid, flash::kThreads);
    C::zero_table_gaps(base + L::kSin, BK, HS, tid, flash::kThreads);
    C::zero_table_gaps(base + L::kCos, BK, HS, tid, flash::kThreads);
  }
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    const int p = a.qpos ? a.qpos[(long)b * a.sq + q0 + i] : kvlen - 1;
    qlo = min(qlo, p);
    qhi = max(qhi, p);
  }
  for (int r = tid; r < ROWS; r += flash::kThreads) {
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
    for (int e = tid; e < BK * C::kRow; e += flash::kThreads) {
      const int t = e / C::kRow, i = e % C::kRow;
      const int kpos = j0 + t;
      const bool ok = kpos < kvlen;
      const long src = ok ? (((long)b * sk + kpos) * a.hkv + h) * DR : 0;
      C::row(base + L::kK + t * DS, kb + src, i, ok);
      C::row(base + L::kV + t * DS, vb + src, i, ok);
    }
    for (int e = tid; e < BK * C::kHalf; e += flash::kThreads) {
      const int t = e / C::kHalf, i = e % C::kHalf;
      const int kpos = j0 + t;
      const bool ok = kpos < kvlen;
      const long src = ok ? ((long)b * sk + kpos) * (DR / 2) : 0;
      C::half(base + L::kSin + t * HS, sin_tab + src, i, ok);
      C::half(base + L::kCos + t * HS, cos_tab + src, i, ok);
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
  // a warp without query rows reads row 0's position and Q rows, and
  // uses neither
  const int wrow = rows_warp ? warp * 16 : 0;
  const int pos[2] = {rowpos[wrow + (lane >> 2)],
                      rowpos[wrow + (lane >> 2) + 8]};
  const bf16* Qw = Qs + wrow * DS;
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

    if (rows_warp) {
      const int j0 = (jb0 + it) * BK;
      float s[BK / 8][4];
      if constexpr (kQInRegisters)
        flash::scores<D, BK>(s, qf, Ks, DS, lane);
      else
        flash::scores<D, BK>(s, Qw, DS, Ks, DS, lane);
      const bool full = j0 + BK <= kvlen &&
                        (!a.causal || j0 + BK - 1 <= qlo) &&
                        (a.window <= 0 || j0 > qhi - a.window);
      if (!full)
        flash::mask<BK>(s, j0, pos, kvlen, a.causal != 0, a.window, lane);
      float alpha[2];
      flash::softmax_step<BK>(s, m, l, alpha, scale_log2);
      flash::rescale<D / 8>(o, alpha);
      flash::rescale<RP / 8>(orr, alpha);
      flash::product<BK, D>(o, s, base + L::kV, DS, lane);
      flash::product<BK, RP>(orr, s, base + L::kVr, RS, lane);
    }
    __syncthreads();
  }
  flash::cp_async_wait<0>();
  if (!rows_warp) return;

  // epilogue: (O + O_r . B_v) / max(l, 1e-20)
  flash::product<RP, D>(o, orr, Bvs, DS, lane);
  flash::finish_rowsum(l);
  bf16* out = static_cast<bf16*>(a.out);
  bf16* dst[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + (lane >> 2) + 8 * hh;
    dst[hh] = r < nrows ? out + (out_tile + (long)(r / G) * a.hq + r % G) * DR
                        : nullptr;
  }
  flash::store_cols<D, D, DR>(o, l, dst, 0, lane);
}

template <int D, int BK, int RP, int DR = D, int ROWS = flash::kRows>
int launch_mma(const Args& a, int bsz, cudaStream_t stream) {
  using L = MmaLayout<D, BK, RP, ROWS>;
  auto kernel = residual_attention_mma_kernel<D, BK, RP, DR, ROWS>;
  if (a.tq * (a.hq / a.hkv) > ROWS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((a.sq + a.tq - 1) / a.tq) * a.hkv * bsz;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, flash::kThreads, L::kBytes, stream>>>(a, bsz);
  return (int)cudaGetLastError();
}

// The chunked instance of the bf16 prefill: ranks above kRankChunk
// (rank_chunk.cuh's ChunkPipe).  The CTAs, 128 rows (every warp with query
// rows, also at D 256), masks and positions of
// residual_attention_mma_kernel, with the q tiles of a (row, kv head) in
// clusters of NC CTAs that rebuild each key block once between them; per
// block K and V come whole from the cluster, so the key loop is O += P V
// with no O_r and no B_v epilogue.
template <int D, int BK, int DR, int NC>
struct DenseChunk {
  using L = flash::ChunkPrefill<D, BK, NC, false>;
  // the cluster's tile ranges (NC x 4 ints, 64 bytes), row positions
  // (kRows ints), Q (kRows x DS bf16)
  static constexpr int kRowpos = 64, kQ = kRowpos + 4 * flash::kRows,
                       kHead = kQ + 2 * flash::kRows * L::DS;
  static constexpr int S = L::stages(kHead);
  static constexpr int kBytes = L::bytes(kHead);
  static_assert(kBytes <= flash::kSmemPerCta,
                "a CTA's shared memory on the H100");
  static_assert(4 * NC * sizeof(int) <= kRowpos, "the tile ranges");
};

template <int D, int BK, int DR, int NC>
__global__ void __launch_bounds__(flash::kThreads, 1)
residual_attention_chunk_kernel(Args a, int bsz) {
  using flash::bf16;
  using T = DenseChunk<D, BK, DR, NC>;
  using L = typename T::L;
  using C = flash::Cols<D, DR>;
  constexpr int DS = L::DS, ROWS = flash::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* rng = reinterpret_cast<int*>(smem_raw);
  int* rowpos = reinterpret_cast<int*>(smem_raw + T::kRowpos);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + T::kQ);
  unsigned char* tiles = smem_raw + T::kHead;
  unsigned char* stages = tiles + L::kTiles;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.hq / a.hkv, R = a.r;
  const int ntiles = (a.sq + a.tq - 1) / a.tq;
  const int per_tile = a.hkv * bsz;
  const int cl = (int)(blockIdx.x / NC), rank = (int)(blockIdx.x % NC);
  const int slot = cl / per_tile;
  const int h = cl % per_tile % a.hkv, b = cl % per_tile / a.hkv;
  const int tile = flash::chunk_cluster_tile(ntiles, NC, slot, rank);
  const long sk = a.sk;
  const int kvlen = a.kv_len ? min(max(a.kv_len[b], 0), a.sk) : a.sk;
  const int q0 = tile * a.tq;
  const int nq = tile < 0 ? 0 : min(a.tq, a.sq - q0);   // 0: padding CTA
  const int nrows = nq * G;                         // row = qi * G + g
  const long out_tile = ((long)b * a.sq + q0) * a.hq + (long)h * G;
  const long hd = (long)a.hkv * DR;

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < ROWS * C::kRow; e += flash::kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < nrows;
    const bf16* src =
        ok ? q + (out_tile + (long)(r / G) * a.hq + r % G) * DR : q;
    C::row(Qs + r * DS, src, i, ok);
  }
  flash::cp_async_commit();
  C::zero_gaps(Qs, ROWS, DS, tid, flash::kThreads);
  if constexpr (C::kGap > 0)       // the gap columns, never copied
    for (int e = tid; e < T::S * L::kStage / 16; e += flash::kThreads)
      reinterpret_cast<uint4*>(stages)[e] = make_uint4(0, 0, 0, 0);
  // the key blocks of the cluster's tiles: warp w < NC takes the tile of
  // rank w (qlo, qhi, first and last block; an empty range when first >
  // last)
  if (warp < NC) {
    const int tw = flash::chunk_cluster_tile(ntiles, NC, slot, warp);
    const int q0w = tw * a.tq, nqw = tw < 0 ? 0 : min(a.tq, a.sq - q0w);
    int qlo = INT_MAX, qhi = INT_MIN;
    for (int i = lane; i < nqw; i += 32) {
      const int p = a.qpos ? a.qpos[(long)b * a.sq + q0w + i] : kvlen - 1;
      qlo = min(qlo, p);
      qhi = max(qhi, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, o));
      qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, o));
    }
    if (lane == 0) {
      const int last_k = a.causal ? min(kvlen - 1, qhi) : kvlen - 1;
      const int first_k = a.window > 0 ? max(qlo - (a.window - 1), 0) : 0;
      const bool live = nqw > 0 && last_k >= 0 && last_k / BK >= first_k / BK;
      rng[4 * warp] = qlo;
      rng[4 * warp + 1] = qhi;
      rng[4 * warp + 2] = live ? first_k / BK : 1;
      rng[4 * warp + 3] = live ? last_k / BK : 0;
    }
  }
  if (nq > 0)
    for (int r = tid; r < ROWS; r += flash::kThreads) {
      const int i = min(r, nrows - 1) / G;
      rowpos[r] = a.qpos ? a.qpos[(long)b * a.sq + q0 + i] : kvlen - 1;
    }
  __syncthreads();
  int jlo = INT_MAX, jhi = -1;
#pragma unroll
  for (int w = 0; w < NC; ++w)
    if (rng[4 * w + 2] <= rng[4 * w + 3]) {
      jlo = min(jlo, rng[4 * w + 2]);
      jhi = max(jhi, rng[4 * w + 3]);
    }
  const int jb0 = jhi >= 0 ? jlo : 0, nblocks = jhi >= 0 ? jhi - jlo + 1 : 0;
  const int qlo = rng[4 * rank], qhi = rng[4 * rank + 1];
  const int own_lo = rng[4 * rank + 2] - jb0, own_hi = rng[4 * rank + 3] - jb0;

  const long tok0 = (long)b * sk;                   // row b's first key
  const long b0 = (long)b * R * hd + (long)h * DR;
  const flash::ChunkSrc src{
      a.kb, a.vb, nullptr, nullptr, static_cast<const bf16*>(a.kr),
      static_cast<const bf16*>(a.vr), static_cast<const bf16*>(a.bk) + b0,
      static_cast<const bf16*>(a.bv) + b0, hd,
      static_cast<const bf16*>(a.sin), static_cast<const bf16*>(a.cos), R};
  auto tok = [=](int kpos) { return (tok0 + kpos) * a.hkv + h; };
  auto res = [=](int kpos) { return tok0 + kpos; };
  constexpr bool kQInRegisters = D <= 128;
  flash::ChunkPipe<D, DR, BK, NC, T::S, false, kQInRegisters, decltype(tok),
                   decltype(res), decltype(res)>
      pipe(tiles, stages, reinterpret_cast<unsigned char*>(Qs), src, rank,
           jb0, nblocks, kvlen, tok, res, res);

  float o[D / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  m[0] = m[1] = flash::kNegInit;
  l[0] = l[1] = 0.f;
  const float scale_log2 = a.scale * flash::kLog2e;

  const bf16* Qw = Qs + warp * 16 * DS;
  uint32_t qf[kQInRegisters ? D / 16 : 1][4];
  pipe.start([&] {                                  // Q and rowpos landed
    if constexpr (kQInRegisters) flash::load_q<D>(qf, Qw, DS, lane);
  });
  const int pos[2] = {rowpos[warp * 16 + (lane >> 2)],
                      rowpos[warp * 16 + (lane >> 2) + 8]};

  pipe.run([&](int blk, const bf16* Ks, const bf16* Vs) {
    if (blk < own_lo || blk > own_hi) return;       // not this tile's keys
    const int j0 = (jb0 + blk) * BK;
    float s[BK / 8][4], alpha[2];
    if constexpr (kQInRegisters)
      flash::gm_scores<D, BK>(s, qf, Ks, lane);
    else
      flash::gm_scores<D, BK>(s, Qw, DS, Ks, lane);
    const bool full = j0 + BK <= kvlen &&
                      (!a.causal || j0 + BK - 1 <= qlo) &&
                      (a.window <= 0 || j0 > qhi - a.window);
    if (!full)
      flash::mask<BK>(s, j0, pos, kvlen, a.causal != 0, a.window, lane);
    flash::softmax_step<BK>(s, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::gm_product<BK, D>(o, s, Vs, lane);
  });
  if (nq == 0) return;

  flash::finish_rowsum(l);
  bf16* out = static_cast<bf16*>(a.out);
  bf16* dst[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + (lane >> 2) + 8 * hh;
    dst[hh] = r < nrows ? out + (out_tile + (long)(r / G) * a.hq + r % G) * DR
                        : nullptr;
  }
  flash::store_cols<D, D, DR>(o, l, dst, 0, lane);
}

template <int D, int BK, int DR>
int launch_chunk(const Args& a, int bsz, cudaStream_t stream) {
  constexpr int NC = flash::cluster_ctas(D);
  using T = DenseChunk<D, BK, DR, NC>;
  if (a.tq * (a.hq / a.hkv) > flash::kRows) return (int)cudaErrorInvalidValue;
  const long clusters = (long)((a.sq + a.tq - 1) / a.tq + NC - 1) / NC;
  return flash::launch_cluster(residual_attention_chunk_kernel<D, BK, DR, NC>,
                               NC, clusters * a.hkv * bsz * NC, T::kBytes,
                               stream, a, bsz);
}

// RP: the smallest instance (16, 32, 64) that holds the rank; above 64 the
// chunked instance
template <int D, int BK, int DR = D>
int launch_mma_rank(const Args& a, int bsz, cudaStream_t s) {
  if (a.r > flash::kRankChunk) return launch_chunk<D, BK, DR>(a, bsz, s);
  if (a.r <= 16) return launch_mma<D, BK, 16, DR>(a, bsz, s);
  if (a.r <= 32) return launch_mma<D, BK, 32, DR>(a, bsz, s);
  // 64 query rows at D 256 (MmaLayout)
  return launch_mma<D, BK, 64, DR, D == 256 ? 64 : flash::kRows>(a, bsz, s);
}

// The bf16 prefill: D 32/64/128/256, and 120 in D 128's tile (split
// halves, ``flash::Cols``); any R >= 1, tq * G <= the instance's ROWS
// (128; 64 at D 256 from rank 33 to 64).
int dispatch_mma(const Args& a, int bsz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.r < 1 || a.tq < 1) return (int)cudaErrorInvalidValue;
  switch (a.d) {
    case 32: return launch_mma_rank<32, 64>(a, bsz, s);
    case 64: return launch_mma_rank<64, 64>(a, bsz, s);
    case 120: return launch_mma_rank<128, 64, 120>(a, bsz, s);
    case 128: return launch_mma_rank<128, 64>(a, bsz, s);
    case 256: return launch_mma_rank<256, 32>(a, bsz, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// bf16 decode, split over keys: residual_attention_decode (#8) with q in
// bf16.  Bound by bytes: a row reads its live keys' K_b, V_b (Hkv D each),
// K_r, V_r (R each) and sin, cos (D/2 each) once, and does ~(4 G + 2 R) D
// flops per key and kv head.  The main path calls it with one new token
// (`forward` at S 1: Sk 1, B 4), where the bound is ~0.1 us and the time
// is all latency: the launch, one dependent chain of loads, a few MMAs.
//
// #2's split-K decode (paged_residual_disagg.cu) over a contiguous cache
// (row b, key j, head h; no block tables), RoPE from the caller's per-key
// sin/cos:
//   * a CTA is 4 warps over 16 query heads of one kv head (one m16 tile:
//     G <= 16 heads, rows past G zero; a larger group takes several CTAs)
//     and one range of each row's live keys [max(kv_len - window, 0),
//     kv_len): n_split equal ranges of 64-key multiples, one per CTA along
//     the grid's x; within a range warp w takes the 16-key steps w, w + 4,
//     w + 8, ... with an online softmax of its own;
//   * per step, cp.async brings the 16 keys' K_b, V_b, K_r, V_r, sin and
//     cos rows into the warp's stage (two stages up to D 128, one at D 256,
//     where two would not fit); keys past the range are zero-filled and
//     masked;
//   * K_r . B_k (B_k in shared memory once per CTA) runs with the keys as
//     M, so n-tiles j and j + D/16 of a thread hold the RoPE pairs:
//     rotated in registers, K_b added in f32, rounded once to bf16, and
//     used at once as the B fragments of S = Q K^T (the keys as N, the
//     heads as M), 4 n-tiles at a time, so the rebuilt K never leaves the
//     registers and only 8 of them hold it;
//   * S, the online softmax in registers (base 2), O += P V_b and O_r +=
//     P V_r with P in bf16;
//   * the warps' f32 partials (m, l, O of D columns, O_r of RP) go to
//     shared memory, over their own stages, and are merged with weights
//     2^(m_w - max m) over the warps that saw a key.  With one range
//     (n_split 1, the main path: Sk 1 is one range) the CTA finishes the
//     row itself, each warp a quarter of D: O + O_r . B_v as an MMA (O_r in
//     bf16, #5's tile's epilogue) over max(l, 1e-20), so there is no
//     workspace and no second launch.  With several, each CTA writes its
//     merged partial to the caller's f32 workspace and a combine
//     (residual_attention_decode_combine_kernel) reduces the ranges and
//     applies B_v the same way (O_r rounded to bf16).
// A row with no key comes out exactly 0.  Q's A fragments stay in
// registers up to D 128; at D 256 the accumulator alone takes 128
// registers a thread, so they are read from shared memory per step.  The
// shared-memory attribute is set once per instance and device, not per
// launch.
namespace splitk {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 16;                   // keys per warp step
constexpr int kHeads = 16;                  // query heads per CTA
constexpr int kRangeKeys = kWarps * kKeys;  // a range: multiples of this

struct Args {
  const void* q;        // (B, Hq, D) bf16
  const void* kb;       // (B, Sk, Hkv, D)
  const void* vb;
  const void* kr;       // (B, Sk, R)
  const void* vr;
  const void* bk;       // (B, R, Hkv*D)
  const void* bv;
  const void* sin;      // (B, Sk, D/2)
  const void* cos;
  const int* kv_len;    // (B,) or null: all Sk keys valid
  float* ws_m;          // (B, Hq, n_split)       n_split > 1 only
  float* ws_l;          // (B, Hq, n_split)
  float* ws_acc;        // (B, Hq, n_split, D)
  float* ws_accr;       // (B, Hq, n_split, R)
  void* out;            // (B, Hq, D)
  int bsz, sk, hq, hkv, d, r, n_split, window;
  float scale;
};

// Bytes: Q (16 x DS), B_k and B_v (RP x DS), then per warp kStages stages
// of 16 keys' K, V (16 x DS), K_r, V_r (16 x RS), sin, cos (16 x HS), all
// bf16.  After the key loop a warp's stages hold its f32 partial: m, l (16
// heads each), O (16 x D), O_r (16 x RP).
template <int D, int RP>
struct Layout {
  static constexpr int DS = D + flash::kPad;
  static constexpr int RS = RP + flash::kPad;
  static constexpr int HS = D / 2 + flash::kPad;
  static constexpr int kStages = D > 128 ? 1 : 2;
  static constexpr int kK = 0, kV = kK + kKeys * DS * 2,
                       kKr = kV + kKeys * DS * 2, kVr = kKr + kKeys * RS * 2,
                       kSin = kVr + kKeys * RS * 2,
                       kCos = kSin + kKeys * HS * 2,
                       kStage = kCos + kKeys * HS * 2;
  static constexpr int kWarp = kStages * kStage;
  static constexpr int kQ = 0, kBk = kQ + kHeads * DS * 2,
                       kBv = kBk + RP * DS * 2, kWarp0 = kBv + RP * DS * 2,
                       kBytes = kWarp0 + kWarps * kWarp;
  // f32 offsets of a warp's partial
  static constexpr int kPm = 0, kPl = kHeads, kPo = 2 * kHeads,
                       kPr = kPo + kHeads * D;
  static_assert((kPr + kHeads * RP) * 4 <= kWarp, "a partial fits");
};

// [lo, hi) of range ``split``: n_split equal ranges of the row's live keys
// in whole kRangeKeys multiples (tests/test_torch_splitk.py repeats it)
struct Range {
  int lo, hi;
  __device__ Range(const Args& a, int b, int split) {
    const int kvlen = a.kv_len ? min(max(a.kv_len[b], 0), a.sk) : a.sk;
    const int first = a.window > 0 ? max(kvlen - a.window, 0) : 0;
    const int n = kvlen - first;
    const int per = ((n + a.n_split - 1) / a.n_split + kRangeKeys - 1) /
                    kRangeKeys * kRangeKeys;
    const long lo0 = first + (long)split * per;
    lo = lo0 < kvlen ? (int)lo0 : kvlen;
    hi = min(kvlen, lo + per);
  }
};

// Weights of the kWarps partials of head row ``r``: 2^(m_w - M) over the
// warps with l_w > 0, else 0; returns sum_w wt_w l_w.
template <int D, int RP>
__device__ __forceinline__ float warp_weights(const unsigned char* parts,
                                              int r, float (&wt)[kWarps]) {
  using L = Layout<D, RP>;
  float mx = flash::kNegInit;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float* p = reinterpret_cast<const float*>(parts + w * L::kWarp);
    if (p[L::kPl + r] > 0.f) mx = fmaxf(mx, p[L::kPm + r]);
  }
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float* p = reinterpret_cast<const float*>(parts + w * L::kWarp);
    wt[w] = p[L::kPl + r] > 0.f ? exp2f(p[L::kPm + r] - mx) : 0.f;
    lsum = fmaf(wt[w], p[L::kPl + r], lsum);
  }
  return lsum;
}

template <int D, int RP, int DR>
__global__ void __launch_bounds__(kThreads, 1)
residual_attention_decode_split_kernel(Args a) {
  using flash::bf16;
  using L = Layout<D, RP>;
  using C = flash::Cols<D, DR>;           // head rows of DR in D columns
  constexpr int DS = L::DS, RS = L::RS, HS = L::HS, HALF = D / 2;
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* Qs = reinterpret_cast<bf16*>(dyn + L::kQ);
  bf16* Bks = reinterpret_cast<bf16*>(dyn + L::kBk);
  bf16* Bvs = reinterpret_cast<bf16*>(dyn + L::kBv);
  unsigned char* parts = dyn + L::kWarp0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, G = a.hq / a.hkv, R = a.r;
  const int nht = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / nht;
  const int g0 = (blockIdx.y % nht) * kHeads;
  const int ng = min(kHeads, G - g0);               // heads of this CTA
  const long head0 = (long)b * a.hq + (long)h * G + g0;
  const long hd = (long)a.hkv * DR;
  const bool finish = a.n_split == 1;               // no combine
  const Range range(a, b, blockIdx.x);

  // Q rows (zero past ng); B_k and, to finish here, B_v (zero past R)
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < kHeads * C::kRow; e += kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < ng;
    C::row(Qs + r * DS, ok ? q + (head0 + r) * DR : q, i, ok);
  }
  const bf16* bk = static_cast<const bf16*>(a.bk);
  const bf16* bv = static_cast<const bf16*>(a.bv);
  for (int e = tid; e < RP * C::kRow; e += kThreads) {
    const int rr = e / C::kRow, i = e % C::kRow;
    const bool ok = rr < R;
    const long src = ok ? ((long)b * R + rr) * hd + (long)h * DR : 0;
    C::row(Bks + rr * DS, bk + src, i, ok);
    if (finish) C::row(Bvs + rr * DS, bv + src, i, ok);
  }
  flash::cp_async_commit();
  // the split-half layout's gap columns (DR < D) stay zero in Q, B_k, B_v
  // and the warp's stages, as do K_r / V_r columns R..RP-1
  C::zero_gaps(Qs, kHeads, DS, tid, kThreads);
  C::zero_gaps(Bks, RP, DS, tid, kThreads);
  C::zero_gaps(Bvs, RP, DS, tid, kThreads);
  unsigned char* mine = parts + warp * L::kWarp;
  for (int st = 0; st < L::kStages; ++st) {
    unsigned char* s = mine + st * L::kStage;
    bf16* kr_s = reinterpret_cast<bf16*>(s + L::kKr);
    bf16* vr_s = reinterpret_cast<bf16*>(s + L::kVr);
    for (int e = lane; e < kKeys * (RP - R); e += 32) {
      const int t = e / (RP - R), rr = R + e % (RP - R);
      kr_s[t * RS + rr] = __float2bfloat16(0.f);
      vr_s[t * RS + rr] = __float2bfloat16(0.f);
    }
    C::zero_gaps(reinterpret_cast<bf16*>(s + L::kK), kKeys, DS, lane, 32);
    C::zero_gaps(reinterpret_cast<bf16*>(s + L::kV), kKeys, DS, lane, 32);
    C::zero_table_gaps(reinterpret_cast<bf16*>(s + L::kSin), kKeys, HS, lane,
                       32);
    C::zero_table_gaps(reinterpret_cast<bf16*>(s + L::kCos), kKeys, HS, lane,
                       32);
  }
  flash::cp_async_wait<0>();
  __syncthreads();

  // Q's A fragments: in registers up to D 128, else read per step
  constexpr bool kQRegs = D <= 128;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) flash::load_q<D>(qf, Qs, DS, lane);
  auto q_frag = [&](int kk, uint32_t (&f)[4]) {
    if constexpr (kQRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = qf[kk][i];
    } else {
      flash::ldmatrix_x4(f, Qs + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
    }
  };

  const bf16* kb = static_cast<const bf16*>(a.kb);
  const bf16* vb = static_cast<const bf16*>(a.vb);
  const bf16* kr = static_cast<const bf16*>(a.kr);
  const bf16* vr = static_cast<const bf16*>(a.vr);
  const bf16* sin_tab = static_cast<const bf16*>(a.sin);
  const bf16* cos_tab = static_cast<const bf16*>(a.cos);
  const bool vec_res = (R % 8) == 0;
  const long tok0 = (long)b * a.sk;                 // row b's first key
  const int all_steps = (range.hi - range.lo + kKeys - 1) / kKeys;
  const int nsteps =
      all_steps > warp ? (all_steps - warp + kWarps - 1) / kWarps : 0;
  auto first_key = [&](int it) {
    return range.lo + (warp + kWarps * it) * kKeys;
  };

  // one step's loads into stage it % kStages; keys past the range are
  // zero-filled
  auto issue = [&](int it) {
    if (it < nsteps) {
      unsigned char* s = mine + (it % L::kStages) * L::kStage;
      const int k0 = first_key(it);
      for (int e = lane; e < kKeys * C::kRow; e += 32) {
        const int t = e / C::kRow, i = e % C::kRow;
        const bool ok = k0 + t < range.hi;
        const long src = ok ? ((tok0 + k0 + t) * a.hkv + h) * DR : 0;
        C::row(reinterpret_cast<bf16*>(s + L::kK) + t * DS, kb + src, i, ok);
        C::row(reinterpret_cast<bf16*>(s + L::kV) + t * DS, vb + src, i, ok);
      }
      if (vec_res) {
        for (int e = lane; e < kKeys * (R / 8); e += 32) {
          const int t = e / (R / 8), c = e % (R / 8);
          const bool ok = k0 + t < range.hi;
          const long src = ok ? (tok0 + k0 + t) * R + c * 8 : 0;
          flash::cp_async16(s + L::kKr + (t * RS + c * 8) * 2, kr + src, ok);
          flash::cp_async16(s + L::kVr + (t * RS + c * 8) * 2, vr + src, ok);
        }
      } else {          // rows of R elements are not 16-byte aligned
        bf16* kr_s = reinterpret_cast<bf16*>(s + L::kKr);
        bf16* vr_s = reinterpret_cast<bf16*>(s + L::kVr);
        for (int e = lane; e < kKeys * R; e += 32) {
          const int t = e / R, rr = e % R;
          const bool ok = k0 + t < range.hi;
          const long src = (tok0 + k0 + t) * R + rr;
          kr_s[t * RS + rr] = ok ? kr[src] : __float2bfloat16(0.f);
          vr_s[t * RS + rr] = ok ? vr[src] : __float2bfloat16(0.f);
        }
      }
      for (int e = lane; e < kKeys * C::kHalf; e += 32) {
        const int t = e / C::kHalf, i = e % C::kHalf;
        const bool ok = k0 + t < range.hi;
        const long src = ok ? (tok0 + k0 + t) * (DR / 2) : 0;
        C::half(reinterpret_cast<bf16*>(s + L::kSin) + t * HS, sin_tab + src,
                i, ok);
        C::half(reinterpret_cast<bf16*>(s + L::kCos) + t * HS, cos_tab + src,
                i, ok);
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

  if constexpr (L::kStages == 2) issue(0);
  for (int it = 0; it < nsteps; ++it) {
    if constexpr (L::kStages == 2) {
      issue(it + 1);
      flash::cp_async_wait<1>();
    } else {
      issue(it);
      flash::cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned char* s = mine + (it % L::kStages) * L::kStage;
    const bf16* Ks = reinterpret_cast<const bf16*>(s + L::kK);
    const bf16* Krs = reinterpret_cast<const bf16*>(s + L::kKr);
    const bf16* Sn = reinterpret_cast<const bf16*>(s + L::kSin);
    const bf16* Cs = reinterpret_cast<const bf16*>(s + L::kCos);

    // S = Q K^T over 16 heads x the step's 16 keys, K = K_b + RoPE(K_r .
    // B_k) rebuilt for columns 16 i.. and D/2 + 16 i.. (n-tiles 2i, 2i + 1
    // and their partners) and fed at once to the products of columns kk =
    // i and i + D/32: kf[n][hh] holds key (lane / 4) + 8 hh, columns
    // 2 (lane % 4) + {0, 1} of n-tile (2i, 2i + 1, 2i + D/16, 2i + 1 +
    // D/16)[n]
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      uint32_t kf[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * i + jj;
        float x1[4], x2[4];
        flash::lora_pair<D, RP>(x1, x2, Krs, RS, Bks, DS, j, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = (lane >> 2) + 8 * hh;
          const int col = 8 * j + 2 * (lane & 3);
          const float2 sn = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Sn + t * HS + col));
          const float2 cs = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Cs + t * HS + col));
          const float2 b1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Ks + t * DS + col));
          const float2 b2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Ks + t * DS + col +
                                                       HALF));
          kf[jj][hh] = flash::pack_bf16(
              b1.x + flash::rot(x1[2 * hh], cs.x, x2[2 * hh], -sn.x),
              b1.y + flash::rot(x1[2 * hh + 1], cs.y, x2[2 * hh + 1], -sn.y));
          kf[2 + jj][hh] = flash::pack_bf16(
              b2.x + flash::rot(x2[2 * hh], cs.x, x1[2 * hh], sn.x),
              b2.y + flash::rot(x2[2 * hh + 1], cs.y, x1[2 * hh + 1], sn.y));
        }
      }
      uint32_t qa[4];
      q_frag(i, qa);
      flash::mma(sc[0], qa, kf[0][0], kf[1][0]);
      flash::mma(sc[1], qa, kf[0][1], kf[1][1]);
      q_frag(i + D / 32, qa);
      flash::mma(sc[0], qa, kf[2][0], kf[3][0]);
      flash::mma(sc[1], qa, kf[2][1], kf[3][1]);
    }
    const int k0 = first_key(it);
    if (k0 + kKeys > range.hi) {
      const int pos[2] = {0, 0};              // not read: no causal mask
      flash::mask<kKeys>(sc, k0, pos, range.hi, false, 0, lane);
    }
    float alpha[2];
    flash::softmax_step<kKeys>(sc, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::rescale<RP / 8>(orr, alpha);
    flash::product<kKeys, D>(
        o, sc, reinterpret_cast<const bf16*>(s + L::kV), DS, lane);
    flash::product<kKeys, RP>(
        orr, sc, reinterpret_cast<const bf16*>(s + L::kVr), RS, lane);
    __syncwarp();                   // the stage is refilled next step
  }
  flash::cp_async_wait<0>();
  __syncwarp();

  // the warp's partial, over its own stages
  flash::finish_rowsum(l);
  {
    float* p = reinterpret_cast<float*>(mine);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = (lane >> 2) + 8 * hh, c = 2 * (lane & 3);
      if ((lane & 3) == 0) {
        p[L::kPm + r] = m[hh];
        p[L::kPl + r] = l[hh];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(p + L::kPo + r * D + 8 * n + c) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
#pragma unroll
      for (int n = 0; n < RP / 8; ++n)
        *reinterpret_cast<float2*>(p + L::kPr + r * RP + 8 * n + c) =
            make_float2(orr[n][2 * hh], orr[n][2 * hh + 1]);
    }
  }
  __syncthreads();

  if (finish) {
    // the row here: warp w takes columns [w D/4, (w + 1) D/4) of O + O_r .
    // B_v, O_r merged in f32 and rounded to bf16 as the MMA's A operand
    // (at D 32 a quarter is one n-tile of 8 columns)
    constexpr int QD = D / 4;
    const int c0 = warp * QD;
    float om[QD / 8][4], orm[RP / 8][4], lsum[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = (lane >> 2) + 8 * hh, c = 2 * (lane & 3);
      float wt[kWarps];
      lsum[hh] = warp_weights<D, RP>(parts, r, wt);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int n = 0; n < QD / 8; ++n) om[n][2 * hh + e] = 0.f;
#pragma unroll
        for (int n = 0; n < RP / 8; ++n) orm[n][2 * hh + e] = 0.f;
      }
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* p = reinterpret_cast<const float*>(parts + w * L::kWarp);
#pragma unroll
        for (int n = 0; n < QD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            om[n][2 * hh + e] = fmaf(
                wt[w], p[L::kPo + r * D + c0 + 8 * n + c + e],
                om[n][2 * hh + e]);
#pragma unroll
        for (int n = 0; n < RP / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            orm[n][2 * hh + e] = fmaf(wt[w], p[L::kPr + r * RP + 8 * n + c + e],
                                      orm[n][2 * hh + e]);
      }
    }
    flash::product<RP, QD>(om, orm, Bvs + c0, DS, lane);
    bf16* out = static_cast<bf16*>(a.out);
    bf16* dst[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = (lane >> 2) + 8 * hh;
      dst[hh] = r < ng ? out + (head0 + r) * DR : nullptr;
    }
    flash::store_cols<QD, D, DR>(om, lsum, dst, c0, lane);
    return;
  }

  // the CTA's merged partial into the workspace, for the combine: the DR
  // real columns of O (tile columns ``C::col``), then R of O_r
  for (int e = tid; e < ng * (DR + RP); e += kThreads) {
    const int r = e / (DR + RP), col = e % (DR + RP);
    if (col >= DR + R) continue;
    float wt[kWarps];
    const float lsum = warp_weights<D, RP>(parts, r, wt);
    const long row = (head0 + r) * a.n_split + blockIdx.x;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* p = reinterpret_cast<const float*>(parts + w * L::kWarp);
      v = fmaf(wt[w], col < DR ? p[L::kPo + r * D + C::col(col)]
                               : p[L::kPr + r * RP + col - DR], v);
    }
    if (col < DR)
      a.ws_acc[row * DR + col] = v;
    else
      a.ws_accr[row * R + col - DR] = v;
    if (col == 0) {
      float mx = flash::kNegInit;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* p = reinterpret_cast<const float*>(parts + w * L::kWarp);
        if (p[L::kPl + r] > 0.f) mx = fmaxf(mx, p[L::kPm + r]);
      }
      a.ws_m[row] = mx;
      a.ws_l[row] = lsum;
    }
  }
}

// out[b, head] = (sum_s w_s acc_s + bf16(sum_s w_s acc_r,s) . B_v[b, :,
// head's kv head]) / max(sum_s w_s l_s, 1e-20), w_s = 2^(m_s - M) over the
// ranges with l_s > 0: one CTA per (row, head); the rank in chunks of
// kRankChunk (threads over the chunk's merged acc_r in shared memory,
// then each thread's output columns, kept in registers across chunks).
__global__ void __launch_bounds__(kThreads)
residual_attention_decode_combine_kernel(Args a) {
  __shared__ float merged[flash::kRankChunk];
  constexpr int kCols = 2;                      // D <= kCols * kThreads
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
  const __nv_bfloat16* bv = static_cast<const __nv_bfloat16*>(a.bv) +
                            (long)b * a.r * a.hkv * a.d + (long)h * a.d;
  float o[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int col = threadIdx.x + i * kThreads;
    o[i] = 0.f;
    if (col < a.d)
      for (int s = 0; s < a.n_split; ++s)
        if (l[s] > 0.f)
          o[i] = fmaf(exp2f(m[s] - mx),
                      a.ws_acc[(row * a.n_split + s) * a.d + col], o[i]);
  }
  for (int r0 = 0; r0 < a.r; r0 += flash::kRankChunk) {
    const int n = min(flash::kRankChunk, a.r - r0);
    __syncthreads();                            // the chunk before read
    for (int rr = threadIdx.x; rr < n; rr += kThreads) {
      float v = 0.f;
      for (int s = 0; s < a.n_split; ++s)
        if (l[s] > 0.f)
          v = fmaf(exp2f(m[s] - mx),
                   a.ws_accr[(row * a.n_split + s) * a.r + r0 + rr], v);
      merged[rr] = __bfloat162float(__float2bfloat16(v));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int col = threadIdx.x + i * kThreads;
      if (col < a.d)
        for (int rr = 0; rr < n; ++rr)
          o[i] = fmaf(merged[rr],
                      __bfloat162float(bv[(long)(r0 + rr) * a.hkv * a.d +
                                          col]),
                      o[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int col = threadIdx.x + i * kThreads;
    if (col < a.d)
      static_cast<__nv_bfloat16*>(a.out)[row * a.d + col] =
          __float2bfloat16(o[i] / fmaxf(lsum, 1e-20f));
  }
}

// The rebuild instance of the split-K decode: ranks above
// flash::kDecodeRankMax (rank_chunk.cuh).  The grid, ranges and workspace
// of the split kernel above; the CTA walks its range in 64-key blocks, all
// 4 warps rebuilding K and V of a block rank chunk by chunk
// (flash::chunk_block), then warp w takes keys 16 w .. 16 w + 15 of it
// (the split kernel's steps w, w + 4, ...): S for the 16 heads, the online
// softmax, O += P V.  The warps' partials merge in shared memory as above,
// with no O_r: V is rebuilt, so one range finishes as O / max(l, 1e-20),
// and several go to the workspace for the combine, launched with no rank.
template <int D, int DR>
__global__ void __launch_bounds__(kThreads, 1)
residual_attention_decode_rebuild_kernel(Args a) {
  using flash::bf16;
  constexpr int BK = kRangeKeys;
  using L = flash::ChunkBlock<D, BK, false>;
  using C = flash::Cols<D, DR>;
  constexpr int DS = L::DS;
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* Qs = reinterpret_cast<bf16*>(dyn);
  unsigned char* blk = dyn + kHeads * DS * sizeof(bf16);
  const bf16* Ks = reinterpret_cast<const bf16*>(blk) + L::kK;
  const bf16* Vs = reinterpret_cast<const bf16*>(blk) + L::kV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, G = a.hq / a.hkv, R = a.r;
  const int nht = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / nht;
  const int g0 = (blockIdx.y % nht) * kHeads;
  const int ng = min(kHeads, G - g0);
  const long head0 = (long)b * a.hq + (long)h * G + g0;
  const long hd = (long)a.hkv * DR;
  const Range range(a, b, blockIdx.x);

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < kHeads * C::kRow; e += kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < ng;
    C::row(Qs + r * DS, ok ? q + (head0 + r) * DR : q, i, ok);
  }
  flash::cp_async_commit();
  C::zero_gaps(Qs, kHeads, DS, tid, kThreads);
  flash::chunk_zero_gaps<D, DR, BK, false>(blk, tid, kThreads);
  const long tok0 = (long)b * a.sk;                 // row b's first key
  const long b0 = (long)b * R * hd + (long)h * DR;
  const flash::ChunkSrc src{
      a.kb, a.vb, nullptr, nullptr, static_cast<const bf16*>(a.kr),
      static_cast<const bf16*>(a.vr), static_cast<const bf16*>(a.bk) + b0,
      static_cast<const bf16*>(a.bv) + b0, hd,
      static_cast<const bf16*>(a.sin), static_cast<const bf16*>(a.cos), R};
  auto tok = [&](int kpos) { return (tok0 + kpos) * a.hkv + h; };
  auto res = [&](int kpos) { return tok0 + kpos; };

  float o[D / 8][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  m[0] = m[1] = flash::kNegInit;
  l[0] = l[1] = 0.f;
  const float scale_log2 = a.scale * flash::kLog2e;

  flash::cp_async_wait<0>();
  __syncthreads();
  constexpr bool kQRegs = D <= 128;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) flash::load_q<D>(qf, Qs, DS, lane);
  const int nblocks =
      range.lo < range.hi ? (range.hi - range.lo + BK - 1) / BK : 0;
  for (int it = 0; it < nblocks; ++it) {
    const int j0 = range.lo + it * BK;
    flash::chunk_block<D, DR, BK, kWarps, false>(
        blk, src, j0, range.lo, range.hi, tok, res, res, tid, warp, lane);
    float sc[2][4], alpha[2];
    const bf16* kw = Ks + warp * kKeys * DS;
    if constexpr (kQRegs)
      flash::scores<D, kKeys>(sc, qf, kw, DS, lane);
    else
      flash::scores<D, kKeys>(sc, Qs, DS, kw, DS, lane);
    const int k0 = j0 + warp * kKeys;
    if (k0 + kKeys > range.hi) {
      const int pos[2] = {0, 0};              // not read: no causal mask
      flash::mask<kKeys>(sc, k0, pos, range.hi, false, 0, lane);
    }
    flash::softmax_step<kKeys>(sc, m, l, alpha, scale_log2);
    flash::rescale<D / 8>(o, alpha);
    flash::product<kKeys, D>(o, sc, Vs + warp * kKeys * DS, DS, lane);
    __syncthreads();                  // the tiles are refilled next block
  }

  // the warps' partials over the block's buffers: m, l (16 heads), O (16 x
  // D), f32
  constexpr int kPart = 2 * kHeads + kHeads * D;
  flash::finish_rowsum(l);
  {
    float* p = reinterpret_cast<float*>(blk) + warp * kPart;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = (lane >> 2) + 8 * hh, c = 2 * (lane & 3);
      if ((lane & 3) == 0) {
        p[r] = m[hh];
        p[kHeads + r] = l[hh];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(p + 2 * kHeads + r * D + 8 * n + c) =
            make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
  }
  __syncthreads();
  const float* parts = reinterpret_cast<const float*>(blk);
  bf16* out = static_cast<bf16*>(a.out);
  for (int e = tid; e < ng * DR; e += kThreads) {
    const int r = e / DR, col = e % DR;
    float mx = flash::kNegInit;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (parts[w * kPart + kHeads + r] > 0.f)
        mx = fmaxf(mx, parts[w * kPart + r]);
    float lsum = 0.f, v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* p = parts + w * kPart;
      const float wt = p[kHeads + r] > 0.f ? exp2f(p[r] - mx) : 0.f;
      lsum = fmaf(wt, p[kHeads + r], lsum);
      v = fmaf(wt, p[2 * kHeads + r * D + C::col(col)], v);
    }
    if (a.n_split == 1) {
      out[(head0 + r) * DR + col] = __float2bfloat16(v / fmaxf(lsum, 1e-20f));
      continue;
    }
    const long row = (head0 + r) * a.n_split + blockIdx.x;
    a.ws_acc[row * DR + col] = v;
    if (col == 0) {
      a.ws_m[row] = mx;
      a.ws_l[row] = lsum;
    }
  }
}

// The chunked instance of the split-K decode: ranks from kRankChunk + 1 to
// flash::kDecodeRankMax, on flash::DecodePipe (rank_chunk.cuh).  The grid,
// ranges and workspace of the split kernel above; the CTA walks its range
// in 64-key blocks, K rebuilt by keys with the sums in registers, O and
// acc_r split by columns, no V tile rebuilt and B_v never read per block.
// One range (n_split 1) finishes here as the RP kernel does: O +
// bf16(acc_r) . B_v as MMAs (B_v rows by rank chunk) over max(l, 1e-20);
// several write the CTA's partial to the workspace for the combine.
template <int D, int DR, bool HOLD, int S>
__global__ void __launch_bounds__(kThreads, 1)
residual_attention_decode_chunk_kernel(Args a) {
  using flash::bf16;
  using L = flash::DecodeChunk<D, false, HOLD, S>;
  using C = flash::Cols<D, DR>;
  constexpr int DS = L::DS;
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* Qs = reinterpret_cast<bf16*>(dyn + L::kQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, G = a.hq / a.hkv, R = a.r;
  const int nht = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / nht;
  const int g0 = (blockIdx.y % nht) * kHeads;
  const int ng = min(kHeads, G - g0);
  const long head0 = (long)b * a.hq + (long)h * G + g0;
  const long hd = (long)a.hkv * DR;
  const Range range(a, b, blockIdx.x);

  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = tid; e < kHeads * C::kRow; e += kThreads) {
    const int r = e / C::kRow, i = e % C::kRow;
    const bool ok = r < ng;
    C::row(Qs + r * DS, ok ? q + (head0 + r) * DR : q, i, ok);
  }
  const long tok0 = (long)b * a.sk;                 // row b's first key
  const long b0 = (long)b * R * hd + (long)h * DR;
  const flash::ChunkSrc src{
      a.kb, a.vb, nullptr, nullptr, static_cast<const bf16*>(a.kr),
      static_cast<const bf16*>(a.vr), static_cast<const bf16*>(a.bk) + b0,
      static_cast<const bf16*>(a.bv) + b0, hd,
      static_cast<const bf16*>(a.sin), static_cast<const bf16*>(a.cos), R};
  auto tok = [&](int kpos) { return (tok0 + kpos) * a.hkv + h; };
  auto res = [&](int kpos) { return tok0 + kpos; };
  const flash::DecodePipe<D, DR, false, HOLD, S, decltype(tok),
                          decltype(res), decltype(res)>
      pipe(dyn, src, range.lo, range.hi, tok, res, res);
  pipe.issue_held();
  flash::cp_async_commit();
  C::zero_gaps(Qs, kHeads, DS, tid, kThreads);
  pipe.zero_gaps();
  pipe.start();
  flash::cp_async_wait<L::S - 1>();                 // Q landed
  __syncthreads();
  // Q's A fragments: in registers up to D 128, else read per use
  constexpr bool kQRegs = D <= 128;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) flash::load_q<D>(qf, Qs, DS, lane);
  auto qfrag = [&](int kk, uint32_t (&f)[4]) {
    if constexpr (kQRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = qf[kk][i];
    } else {
      flash::ldmatrix_x4(f, Qs + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
    }
  };
  float o[L::QD / 8][4], accr[2 * L::kNch][4], m[2], l[2], lsum[2];
  pipe.run(o, accr, m, l, a.scale * flash::kLog2e, qfrag);
  pipe.row_sums(l, lsum);

  if (a.n_split == 1) {
    pipe.apply_bv(o, accr);
    bf16* out = static_cast<bf16*>(a.out);
    bf16* dst[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = (lane >> 2) + 8 * hh;
      dst[hh] = r < ng ? out + (head0 + r) * DR : nullptr;
    }
    flash::store_cols<L::QD, D, DR>(o, lsum, dst, warp * L::QD, lane);
    return;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = (lane >> 2) + 8 * hh;
    if (r >= ng) continue;
    pipe.store_partial(o, accr, m, lsum, hh,
                       (head0 + r) * a.n_split + blockIdx.x, a.ws_m, a.ws_l,
                       a.ws_acc, a.ws_accr);
  }
}

// the rebuild instance (above flash::kDecodeRankMax) and the combine with
// no rank (V carries B_v)
template <int D, int DR>
int launch_rebuild(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = (size_t)kHeads * (D + flash::kPad) * 2 +
                          flash::ChunkBlock<D, kRangeKeys, false>::kBytes;
  static_assert(smem <= 232448, "a CTA's shared memory on the H100");
  static_assert(4 * kWarps * (2 * kHeads + kHeads * D) <=
                    flash::ChunkBlock<D, kRangeKeys, false>::kBytes,
                "the warps' partials fit over the key block");
  auto kernel = residual_attention_decode_rebuild_kernel<D, DR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = a.hq / a.hkv;
  const dim3 grid(a.n_split, a.hkv * ((G + kHeads - 1) / kHeads), a.bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  Args c = a;
  c.r = 0;
  residual_attention_decode_combine_kernel<<<(unsigned)((long)a.bsz * a.hq),
                                             kThreads, 0, stream>>>(c);
  return (int)cudaGetLastError();
}

// the chunked instance on the rank route and the combine with the rank
template <int D, int DR, class L>
int launch_route(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)L::kBytes + (size_t)L::held(a.r);
  auto kernel = residual_attention_decode_chunk_kernel<D, DR, L::kHold,
                                                       L::S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = a.hq / a.hkv;
  const dim3 grid(a.n_split, a.hkv * ((G + kHeads - 1) / kHeads), a.bsz);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  residual_attention_decode_combine_kernel<<<(unsigned)((long)a.bsz * a.hq),
                                             kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// ranks above kRankChunk: the rank route up to flash::kDecodeRankMax, B_k
// held with 3 stages where a CTA fits, else streamed with 2; the rebuild
// instance above
template <int D, int DR>
int launch_chunk(const Args& a, cudaStream_t stream) {
  if (a.r > flash::kDecodeRankMax) return launch_rebuild<D, DR>(a, stream);
  if constexpr (flash::kDecodeHoldBk) {
    using L = flash::DecodeChunkFor<D, false, true, 3>;
    if (L::kBytes + L::held(a.r) <= flash::kSmemPerCta)
      return launch_route<D, DR, L>(a, stream);
  }
  return launch_route<D, DR, flash::DecodeChunkFor<D, false, false, 2>>(
      a, stream);
}

template <int D, int RP, int DR>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<D, RP>;
  auto kernel = residual_attention_decode_split_kernel<D, RP, DR>;
  // the shared-memory attribute, once per device (bit d of ``set``)
  static std::atomic<unsigned> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!((set.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    set.fetch_or(1u << dev);
  }
  const int G = a.hq / a.hkv;
  const dim3 grid(a.n_split, a.hkv * ((G + kHeads - 1) / kHeads), a.bsz);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  residual_attention_decode_combine_kernel<<<(unsigned)((long)a.bsz * a.hq),
                                             kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// RP: the smallest instance (16, 32, 64) that holds the rank; above 64 the
// chunked instance
template <int D, int DR = D>
int launch_rank(const Args& a, cudaStream_t s) {
  if (a.r > flash::kRankChunk) return launch_chunk<D, DR>(a, s);
  if (a.r <= 16) return launch<D, 16, DR>(a, s);
  if (a.r <= 32) return launch<D, 32, DR>(a, s);
  return launch<D, 64, DR>(a, s);
}

// D 32/64/128/256, and 120 in D 128's tile (split halves,
// ``flash::Cols``); any R >= 1, any G, n_split >= 1 (a workspace when > 1).
int dispatch(const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n_split < 1 || a.r < 1 || a.hkv < 1 ||
      a.hq % a.hkv != 0 || a.bsz > 65535 ||
      (long)a.hkv * ((a.hq / a.hkv + kHeads - 1) / kHeads) > 65535 ||
      (long)a.bsz * a.hq > INT_MAX || a.sk < 1 ||
      (a.n_split > 1 && (a.ws_m == nullptr || a.ws_l == nullptr ||
                         a.ws_acc == nullptr || a.ws_accr == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.d == 32) return launch_rank<32>(a, s);
  if (a.d == 64) return launch_rank<64>(a, s);
  if (a.d == 120) return launch_rank<128, 120>(a, s);
  if (a.d == 128) return launch_rank<128>(a, s);
  if (a.d == 256) return launch_rank<256>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace splitk

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The bf16 prefill runs the
// tensor-core kernel (tq * G <= 128 rows), the bf16 decode the split-K
// decode; every f32 launch the scalar kernel.
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

// ws_m/ws_l (B, Hq, n_split), ws_acc (B, Hq, n_split, D) and ws_accr (B,
// Hq, n_split, R): the caller's f32 workspace of the bf16 split-K decode
// when n_split > 1, else null; f32 launches read neither.
extern "C" int residual_attention_decode(
    int dtype, const void* q, const void* kb, const void* vb, const void* kr,
    const void* vr, const void* bk, const void* bv, const void* sin,
    const void* cos, const void* kv_len, void* ws_m, void* ws_l,
    void* ws_acc, void* ws_accr, void* out, int bsz, int sk, int hq,
    int hkv, int d, int r, int n_split, float scale, int window,
    void* stream) {
  if (dtype == 1) {
    const splitk::Args a{q, kb, vb, kr, vr, bk, bv, sin, cos,
                         static_cast<const int*>(kv_len),
                         static_cast<float*>(ws_m), static_cast<float*>(ws_l),
                         static_cast<float*>(ws_acc),
                         static_cast<float*>(ws_accr), out,
                         bsz, sk, hq, hkv, d, r, n_split, window, scale};
    return splitk::dispatch(a, stream);
  }
  const Args a{q, kb, vb, kr, vr, bk, bv, sin, cos, nullptr,
               static_cast<const int*>(kv_len), out,
               1, sk, hq, hkv, d, r, 1, scale, 1, window};
  return dispatch(dtype, a, bsz, stream);
}
