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
// -fmad=false's FMUL/FADD; HMUL2.BF16_V2 and HADD2.BF16_V2 in the SASS),
// the compare (__hgt2_mask: HSET2, one 16-bit mask a half) and the select
// (one LOP3 blending the two words on that mask).  The compare is exact
// against the JAX chain's f32 compare y > d: for a bf16 y, y > d holds
// exactly when y > bf16_round_down(d).  What is upcast: rsqrt (Hopper has
// no bf16 rsqrt; both halves go to f32, to the MUFU, and back with one
// packing round), as the JAX chain upcasts it.
//
// Bound (probes/common.py::chain_step_bound, pipe by pipe): `mul` by the
// packed lanes, `mix` by the MUFU (two rsqrt a pair).  On this card the
// packed multiply and add issue to the FMA pipe (HMUL2, HADD2, HFMA2) at
// half the FP32 warp rate, bf16 and fp16 alike, and to the HFMA2.MMA form
// at the same rate again; ptxas splits a chain's packed operations between
// the two only where no operand is a swizzled half (R.H0_H0), the form it
// picks for a pair whose halves it can prove equal, as c's are.  So the
// `mul` chain takes c through a shuffle of the thread's own lane
// (`opaque`): a whole register operand, half the multiplies on
// HFMA2.MMA, twice FP32's element rate.  The `mix` chain keeps the FMA
// pipe alone: the MUFU bounds it, and the HFMA2.MMA form made it slower
// (PERF.md §6).  Its step unpacks with a shift and a mask, and both
// kernels' rsqrt is rsqrtf, so the ratio compares the two types and
// nothing else.
//
// Chains in registers (NC a template parameter), the loop unrolled by 4,
// c and d from memory, bfix through an empty asm each step, every chain
// in the stored sum, built with -fmad=false (kernels/cuda_build.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rtfs {

constexpr int kThreads = 256;
constexpr int kTileElems = 8 * 256;
// kernels/probe.py::BF16_NCS
constexpr int kNcs[] = {4, 8, 12, 16, 32};
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

// a where m's half is all ones, else b (one LOP3)
__device__ __forceinline__ unsigned select2(unsigned m, unsigned a,
                                            unsigned b) {
  return (a & m) | (b & ~m);
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

__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  return as_bits(__hmul2_rn(from_bits(a), from_bits(b)));
}

__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  return as_bits(__hadd2_rn(from_bits(a), from_bits(b)));
}

// v itself, through a shuffle of the thread's own lane: ptxas cannot see
// that its halves are equal, so it keeps it a whole register operand.
__device__ __forceinline__ unsigned opaque(unsigned v) {
  return __shfl_sync(__activemask(), v, threadIdx.x & 31);
}

// rsqrt of each half of a packed pair, in f32 with rsqrtf as the f32
// kernel's, rounded back to bf16; the unpack is a shift and a mask.
__device__ __forceinline__ unsigned rsqrt2(unsigned a) {
  const float lo = __uint_as_float(a << 16);
  const float hi = __uint_as_float(a & 0xffff0000u);
  return as_bits(__floats2bfloat162_rn(rsqrtf(lo), rsqrtf(hi)));
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
    const unsigned c2 = as_bits(__float2bfloat162_rn(x[t0] * 2.0f));
    const unsigned c = INJ == kMul ? opaque(c2) : c2;
    const unsigned d = as_bits(__float2bfloat162_rn(d32));
    const unsigned d01 = as_bits(__float2bfloat162_rn(d32 * 0.1f));
    const __nv_bfloat16 dlo = __float2bfloat16_rd(d32);
    const unsigned dcmp = as_bits(__halves2bfloat162(dlo, dlo));
    const float x0 = x[e], x1 = x[e + 1];
    unsigned bfix = (x0 > d32 ? 0x0000ffffu : 0u) |
                    (x1 > d32 ? 0xffff0000u : 0u);
    const unsigned xb = as_bits(__floats2bfloat162_rn(x0, x1));
    unsigned y[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      y[j] = mul2(xb, as_bits(__float2bfloat162_rn(
                          static_cast<float>(1.0 + 0.001 * j))));
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
      asm("" : "+r"(bfix));
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        unsigned v = y[j];
        if constexpr (INJ == kMul) {
          v = mul2(v, c);
        } else {
          const unsigned gt = __hgt2_mask(from_bits(v), from_bits(dcmp));
          v = select2(gt, mul2(v, c), add2(v, d));
          v = select2(bfix, add2(mul2(v, c), d), v);
          v = mul2(rsqrt2(add2(mul2(v, c), d01)), c);
        }
        y[j] = v;
      }
    }
    unsigned acc = y[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) acc = add2(acc, y[j]);
    const float2 f = __bfloat1622float2(from_bits(acc));
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
