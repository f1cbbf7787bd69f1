// P2, the bf16 probe: the `mul` and `mix` chains of P1 in f32 and in bf16,
// to say whether bf16 shading math could issue faster than f32 on this
// card (the data RenderConfig.bf16_shading waits on; probes/bf16_probe.py).
//
// Replaces the JAX package's scripts/bf16_probe.py::_chain_kernel (:71, its
// step _step :50), launched from _time_chain (:94).  x is [8*G, 256] f32 in
// 8x256 tiles; c = 2*tile[0,0] and d = tile[0,1] are read in f32 and
// rounded to the chain's type, as is d*0.1; bfix = x > d in f32.  The f32
// kernel runs one element a chain; the bf16 kernel one pair of neighbouring
// elements, packed in an __nv_bfloat162, so a thread's chain covers two
// elements.  The output is the chains' sum in the chain's type, stored as
// f32.
//
// What runs packed on Hopper (sm_90): the bf16x2 multiply and add
// (__hmul2_rn, __hadd2_rn: one rounding each, never contracted, like
// -fmad=false's FMUL/FADD), the compare (__hgt2_mask: a bf16x2 set, one
// 16-bit mask a half) and the select (a bitwise blend of the two words on
// that mask).  The compare is exact against the JAX chain's f32 compare
// y > d: for a bf16 y, y > d holds exactly when y > bf16_round_down(d).
// What is upcast: rsqrt (Hopper has no bf16 rsqrt; both halves go to f32,
// rsqrtf on the MUFU, and back with one packing round), as the JAX chain
// upcasts it.
//
// Bound: issue, as P1 (csrc/op_probe.cu): chains in registers (NC a
// template parameter), the loop unrolled by 4, c and d from memory, bfix
// through an empty asm each step, every chain in the stored sum, built
// with -fmad=false (kernels/cuda_build.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rtfs {

constexpr int kThreads = 256;
constexpr int kTileElems = 8 * 256;
// probes/bf16_probe.py::NC_SWEEP
constexpr int kNcs[] = {4, 8, 12, 16};
constexpr int kNumNcs = sizeof(kNcs) / sizeof(kNcs[0]);

// probes/bf16_probe.py::INJECTS
enum Inject : int { kMul = 0, kMix, kNumInjects };

__device__ __forceinline__ unsigned as_bits(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof u);
  return u;
}

__device__ __forceinline__ __nv_bfloat162 from_bits(unsigned u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof u);
  return v;
}

// a where m's half is all ones, else b
__device__ __forceinline__ __nv_bfloat162 select2(unsigned m,
                                                  __nv_bfloat162 a,
                                                  __nv_bfloat162 b) {
  return from_bits((as_bits(a) & m) | (as_bits(b) & ~m));
}

template <int INJ, int NC>
__global__ void __launch_bounds__(kThreads)
f32_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
           int iters) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    const int t0 = e - e % kTileElems;
    const float c = x[t0] * 2.0f;
    const float d = x[t0 + 1];
    const float d01 = d * 0.1f;
    const float xe = x[e];
    int bfix = xe > d;
    float y[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) y[j] = xe * static_cast<float>(1.0 + 0.001 * j);
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
      asm("" : "+r"(bfix));
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float v = y[j];
        if constexpr (INJ == kMul) {
          v = v * c;
        } else {
          v = v > d ? v * c : v + d;
          v = bfix ? v * c + d : v;
          v = rsqrtf(v * c + d01);
          v = v * c;
        }
        y[j] = v;
      }
    }
    float acc = y[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) acc = acc + y[j];
    out[e] = acc;
  }
}

// Pairs (2p, 2p+1): the low half holds element 2p.
template <int INJ, int NC>
__global__ void __launch_bounds__(kThreads)
bf16_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
            int iters) {
  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n / 2;
       p += stride) {
    const int e = 2 * p;
    const int t0 = e - e % kTileElems;
    const float d32 = x[t0 + 1];
    const __nv_bfloat162 c = __float2bfloat162_rn(x[t0] * 2.0f);
    const __nv_bfloat162 d = __float2bfloat162_rn(d32);
    const __nv_bfloat162 d01 = __float2bfloat162_rn(d32 * 0.1f);
    const __nv_bfloat16 dlo = __float2bfloat16_rd(d32);
    const __nv_bfloat162 dcmp = __halves2bfloat162(dlo, dlo);
    const float x0 = x[e], x1 = x[e + 1];
    unsigned bfix = (x0 > d32 ? 0x0000ffffu : 0u) |
                    (x1 > d32 ? 0xffff0000u : 0u);
    const __nv_bfloat162 xb = __floats2bfloat162_rn(x0, x1);
    __nv_bfloat162 y[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      y[j] = __hmul2_rn(xb, __float2bfloat162_rn(
                                static_cast<float>(1.0 + 0.001 * j)));
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
      asm("" : "+r"(bfix));
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        __nv_bfloat162 v = y[j];
        if constexpr (INJ == kMul) {
          v = __hmul2_rn(v, c);
        } else {
          const unsigned gt = __hgt2_mask(v, dcmp);
          v = select2(gt, __hmul2_rn(v, c), __hadd2_rn(v, d));
          v = select2(bfix, __hadd2_rn(__hmul2_rn(v, c), d), v);
          const float2 a = __bfloat1622float2(__hadd2_rn(__hmul2_rn(v, c),
                                                         d01));
          v = __floats2bfloat162_rn(rsqrtf(a.x), rsqrtf(a.y));
          v = __hmul2_rn(v, c);
        }
        y[j] = v;
      }
    }
    __nv_bfloat162 acc = y[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) acc = __hadd2_rn(acc, y[j]);
    const float2 f = __bfloat1622float2(acc);
    out[e] = f.x;
    out[e + 1] = f.y;
  }
}

using ChainKernel = void (*)(const float*, float*, int, int);

// The instantiation of class `inj` in bf16 (or f32) with `nc` chains, or
// nullptr.
template <int I, int J>
ChainKernel find(int inj, int bf16, int nc) {
  if constexpr (I >= kNumInjects) {
    return nullptr;
  } else if constexpr (J >= kNumNcs) {
    return find<I + 1, 0>(inj, bf16, nc);
  } else {
    if (inj == I && nc == kNcs[J])
      return bf16 ? bf16_kernel<I, kNcs[J]> : f32_kernel<I, kNcs[J]>;
    return find<I, J + 1>(inj, bf16, nc);
  }
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/probe.py).  x and out are n f32
// (n a multiple of 8*256); `blocks` blocks of 256 threads stride over the
// elements (f32) or the pairs (bf16).  Each returns the CUDA error of its
// call.
extern "C" int rtfs_bf16_chain(const float* x, float* out, int n, int iters,
                               int inject, int bf16, int nc, int blocks,
                               void* stream) {
  const rtfs::ChainKernel k = rtfs::find<0, 0>(inject, bf16, nc);
  if (k == nullptr || n % rtfs::kTileElems != 0 || blocks < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<blocks, rtfs::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 256 threads of one instantiation one SM holds at once.
extern "C" int rtfs_bf16_occupancy(int inject, int bf16, int nc,
                                   int* blocks_per_sm) {
  const rtfs::ChainKernel k = rtfs::find<0, 0>(inject, bf16, nc);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, rtfs::kThreads, 0);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* rtfs_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
