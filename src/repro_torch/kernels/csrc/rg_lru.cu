// RG-LRU linear scan for NVIDIA Hopper (sm_90a).
//
// Hand-written CUDA port of the Pallas kernel in repro/kernels/rg_lru.py:
//   rg_lru_scan (entry :48, body _rglru_kernel :27)
// and, below it, the scan's backward (rg_lru_scan_bwd_kernel), which the
// Pallas package does not have.
//
// It computes the Griffin / RecurrentGemma recurrence
//   h_t = a_t * h_{t-1} + b_t        a, b: (B, S, W), h0: (B, W)
// with the state kept in f32, each state written in the input dtype, and
// returns the last state as well (the same rounded value as states[:, -1]).
//
// Design (simple first; speed is later work):
//   * one thread per (request row, lane of W), 128 lanes per CTA: at each
//     time step a warp reads 32 neighbouring lanes of a and b, so every
//     load and store is coalesced.  The Pallas grid walks (B, W/128, S/128)
//     blocks with the sequence innermost and carries the state in VMEM
//     scratch; here the sequence is a loop inside the thread and the state
//     a register;
//   * a and b do not depend on h, so the loop reads them kUnroll steps at a
//     time and keeps the next group's loads in flight while it steps
//     through the current one (double buffering in registers);
//   * any S and W are taken as they are: the ragged W edge is masked and
//     the last group of steps is cut short, with no padding copies (the
//     Pallas entry pads with a = 1, b = 0);
//   * f32 and bf16 inputs; the arithmetic is one f32 FMA per step.
//
// Bound on an H100: 2 flops per element against 3 elements moved (read a
// and b, write the state), so it is bound by bytes (3.35 TB/s): at the
// model's launch (B 4, S 1000, W 4096, f32) 196.6 MB, 0.059 ms.  This
// design runs B*W/128 CTAs (128 there, for 132 SMs), so a short batch
// leaves the card under-filled; a chunked two-pass scan over S is later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kLanes = 128;      // threads per CTA, one lane of W each
constexpr int kUnroll = 16;      // time steps loaded ahead per group

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

// Loads steps t0 .. t0+kUnroll-1 of one lane (those below s) into av/bv,
// as they are: converting to f32 here would make the thread wait for the
// loads before the steps that do not need them yet.
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           long off, long stride, int t0,
                                           int s, T (&av)[kUnroll],
                                           T (&bv)[kUnroll]) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    if (t0 + i < s) {
      const long e = off + (long)(t0 + i) * stride;
      av[i] = a[e];
      bv[i] = b[e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
rg_lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ h0, T* __restrict__ out,
                   T* __restrict__ h_last, int s, int w) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const int row = blockIdx.y;
  if (lane >= w) return;
  const long off = (long)row * s * w + lane;     // element (row, 0, lane)
  float h = to_f32(h0[(long)row * w + lane]);
  T ca[kUnroll], cb[kUnroll], na[kUnroll], nb[kUnroll];
  load_group(a, b, off, w, 0, s, ca, cb);
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    load_group(a, b, off, w, t0 + kUnroll, s, na, nb);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < s) {
        h = fmaf(to_f32(ca[i]), h, to_f32(cb[i]));
        out[off + (long)(t0 + i) * w] = from_f32<T>(h);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = na[i];
      cb[i] = nb[i];
    }
  }
  h_last[(long)row * w + lane] = from_f32<T>(h);
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out,
           void* h_last, int bsz, int s, int w, cudaStream_t stream) {
  const dim3 grid((w + kLanes - 1) / kLanes, bsz);
  rg_lru_scan_kernel<T><<<grid, kLanes, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(h0), static_cast<T*>(out),
      static_cast<T*>(h_last), s, w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The backward of the scan, for training (the Pallas package has no
// backward kernel: jax.grad differentiates the reference's associative
// scan).  A linear recurrence has a linear recurrence run in reverse as its
// gradient: with g the gradient reaching h_t,
//   g_S = dstates_S + dh_last,   g_t = dstates_t + a_{t+1} g_{t+1},
//   db_t = g_t,   da_t = g_t h_{t-1} (h_0 := h0),   dh0 = a_1 g_1
// (steps numbered 1..S).  Same design as the forward: one thread per (row,
// lane of W) walks S backwards with the carry g in f32 in a register, and
// keeps the next group of kUnroll steps' loads (a, dstates and the states
// one step earlier) in flight while it steps through the current one.
// h_{t-1} is read from the forward's saved states, not recomputed: the
// carry would have to be rebuilt from a, b and h0 in a forward pass and
// stored anyway, and the hybrid runs the scan in f32 (a and the gated
// input are f32 there), where the saved states are the carry exactly; in
// bf16 da carries the states' rounding (2^-9 relative), as the plain
// version rg_lru_scan_bwd_ref does.
// Bound on an H100: bytes (3.35 TB/s): a, the states and dstates read once,
// da and db written once, plus the (B, W) rows h0, dh_last and dh0.

// Loads steps t0, t0-1, .., t0-kUnroll+1 (those >= 0) of one lane: a_t,
// dstates_t and h_{t-1} (the state one step earlier, or h0 at t = 0).
template <typename T>
__device__ __forceinline__ void load_group_rev(
    const T* __restrict__ a, const T* __restrict__ states,
    const T* __restrict__ dstates, T h0v, long off, long stride, int t0,
    T (&av)[kUnroll], T (&gv)[kUnroll], T (&hv)[kUnroll]) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int t = t0 - i;
    if (t >= 0) {
      const long e = off + (long)t * stride;
      av[i] = a[e];
      gv[i] = dstates[e];
      hv[i] = t > 0 ? states[e - stride] : h0v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
rg_lru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ states,
                       const T* __restrict__ h0,
                       const T* __restrict__ dstates,
                       const T* __restrict__ dh_last, T* __restrict__ da,
                       T* __restrict__ db, T* __restrict__ dh0, int s,
                       int w) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const int row = blockIdx.y;
  if (lane >= w) return;
  const long off = (long)row * s * w + lane;     // element (row, 0, lane)
  const long r = (long)row * w + lane;
  const T h0v = h0[r];
  float c = to_f32(dh_last[r]);                  // a_{t+1} g_{t+1}
  T ca[kUnroll], cg[kUnroll], chh[kUnroll];
  T na[kUnroll], ng[kUnroll], nh[kUnroll];
  load_group_rev(a, states, dstates, h0v, off, w, s - 1, ca, cg, chh);
  for (int t0 = s - 1; t0 >= 0; t0 -= kUnroll) {
    load_group_rev(a, states, dstates, h0v, off, w, t0 - kUnroll, na, ng,
                   nh);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 - i;
      if (t >= 0) {
        const float g = to_f32(cg[i]) + c;
        const long e = off + (long)t * w;
        db[e] = from_f32<T>(g);
        da[e] = from_f32<T>(g * to_f32(chh[i]));
        c = to_f32(ca[i]) * g;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = na[i];
      cg[i] = ng[i];
      chh[i] = nh[i];
    }
  }
  dh0[r] = from_f32<T>(c);
}

template <typename T>
int launch_bwd(const void* a, const void* states, const void* h0,
               const void* dstates, const void* dh_last, void* da, void* db,
               void* dh0, int bsz, int s, int w, cudaStream_t stream) {
  const dim3 grid((w + kLanes - 1) / kLanes, bsz);
  rg_lru_scan_bwd_kernel<T><<<grid, kLanes, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(states),
      static_cast<const T*>(h0), static_cast<const T*>(dstates),
      static_cast<const T*>(dh_last), static_cast<T*>(da),
      static_cast<T*>(db), static_cast<T*>(dh0), s, w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a, states, dstates, da, db: (B, S,
// W); h0, dh_last, dh0: (B, W), all contiguous and of one dtype.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int rg_lru_scan_bwd(int dtype, const void* a, const void* states,
                               const void* h0, const void* dstates,
                               const void* dh_last, void* da, void* db,
                               void* dh0, int bsz, int s, int w,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bsz < 1 || bsz > 65535 || s < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(a, states, h0, dstates, dh_last, da, db, dh0,
                             bsz, s, w, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, states, h0, dstates, dh_last, da, db,
                                     dh0, bsz, s, w, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  a, b, out: (B, S, W); h0, h_last:
// (B, W), all contiguous and of one dtype.  Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int rg_lru_scan(int dtype, const void* a, const void* b,
                           const void* h0, void* out, void* h_last, int bsz,
                           int s, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, out, h_last, bsz, s, w, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, out, h_last, bsz, s, w, st);
  return (int)cudaErrorInvalidValue;
}
