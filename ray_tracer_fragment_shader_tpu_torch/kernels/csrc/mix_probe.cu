// K9, the mix-rate probe: the issue rate of register-resident dependent
// chains whose op classes follow a kernel's own blend, in budget ops per
// second (the denominator of utils/roofline.py's speed of light).
//
// Replaces the JAX package's utils/roofline.py::_mix_kernel (:161, its ops
// _emit :100), launched from _measure_mix_rate_cached (:194).  x is
// [8*G, 256] f32 in 8x256 tiles; every element of a tile reads the tile's
// c = tile[0,0] and d = tile[0,1] from memory, as the TPU kernel read them
// from its VMEM tile.  Each element runs NC independent chains from
// x*(1 + 0.001 j) for `iters` iterations of the class schedule
// RTFS_MIX_SCHED, then one select that consumes the last compare (so no
// compare is dead); it stores the chains' sum, so every chain reaches the
// output.  The values settle at a fixed point of normal numbers (about
// 4.2-4.4 for the render blend), so IEEE division and sqrtf never take
// their slow paths.
//
// Bound: issue.  Nothing moves through memory inside the loop; each thread
// holds NC chains in registers.  What the design does about it:
// - the schedule is fixed at compile time: -DRTFS_MIX_SCHED=s<digits>, one
//   digit per budget op, the class ids of utils/roofline.py::_MIX_CLASSES
//   (kernels/probe.py::mix_defines; a token without commas, which nvcc
//   would split), expanded by an if-constexpr recursion that halves the
//   index range (depth log2 of the length), so each op is its own
//   instruction or sequence, with no branch or table read to pick it;
// - NC is a template parameter (the instantiations RTFS_MIX_NC_MASK
//   selects from kNcChoices), so the chains stay in registers;
// - built with -fmad=false, like the kernels it prices (kernels/
//   cuda_build.py): `basic` alternates y*c and y+d, one FFMA pair when
//   contraction is on, and a probe built with it would read about twice
//   the rate the kernels' code can reach;
// - the fixed compare bfix reaches each iteration through an empty asm, so
//   the compiler cannot unswitch the loop on it and drop the selects of the
//   lanes where it is false;
// - a grid-stride loop over the elements, so the host sets the blocks per
//   SM (kernels/probe.py sweeps them with NC and takes the best).
// Classes on the card: `rsqrt` is rsqrtf (MUFU), `sqrt` and `div` are IEEE
// (nvcc's default -prec-sqrt/-prec-div: multi-instruction sequences),
// `recip_nr` is rcp.approx.f32 plus one Newton step, `floor` floorf.
#include <cuda_runtime.h>

#ifndef RTFS_MIX_SCHED
#error "RTFS_MIX_SCHED (the schedule's class ids as s<digits>) is required"
#endif
#ifndef RTFS_MIX_NC_MASK
#error "RTFS_MIX_NC_MASK (the chain counts to instantiate) is required"
#endif

#define RTFS_STR2(x) #x
#define RTFS_STR(x) RTFS_STR2(x)

namespace rtfs {

constexpr int kThreads = 256;
constexpr int kTileElems = 8 * 256;
// chain counts an instantiation may take (kernels/probe.py::NC_CHOICES)
constexpr int kNcChoices[] = {1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96};
constexpr int kNumNcChoices = sizeof(kNcChoices) / sizeof(kNcChoices[0]);

// utils/roofline.py::_MIX_CLASSES, in order
enum MixClass : int {
  kBasic = 0, kSelect, kCmp, kAbs, kSign, kRsqrt, kSqrt, kDiv, kRecipNr,
  kFloor
};

constexpr char kSchedStr[] = RTFS_STR(RTFS_MIX_SCHED);  // "s" + digits
constexpr int kSchedLen = static_cast<int>(sizeof(kSchedStr)) - 2;

// (host and device: kSchedStr's elements may be read in device code only
// inside a constexpr function called in a constant expression)
__host__ __device__ constexpr int sched_at(int k) {
  return kSchedStr[k + 1] - '0';
}

__device__ __forceinline__ float rcp_approx(float y) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// One budget op of class CLS at schedule position K on value y; b is the
// bool of the most recent compare (utils/roofline.py::_emit).
template <int CLS, int K>
__device__ __forceinline__ void emit(float& y, bool& b, float c, float d,
                                     float c4) {
  if constexpr (CLS == kBasic) {
    if constexpr (K % 2 == 0) y = y * c; else y = y + d;
  } else if constexpr (CLS == kCmp) {
    b = y > d;
  } else if constexpr (CLS == kSelect) {
    y = b ? y : d;
  } else if constexpr (CLS == kAbs) {
    y = fabsf(y);
  } else if constexpr (CLS == kSign) {
    y = static_cast<float>((y > 0.0f) - (y < 0.0f)) * d;
  } else if constexpr (CLS == kRsqrt) {
    y = rsqrtf(y);
  } else if constexpr (CLS == kSqrt) {
    y = sqrtf(y);
  } else if constexpr (CLS == kDiv) {
    y = c / y;
  } else if constexpr (CLS == kRecipNr) {
    const float r = rcp_approx(y);
    y = r * (2.0f - y * r);
  } else {
    static_assert(CLS == kFloor, "unknown class id in RTFS_MIX_SCHED");
    y = floorf(y * 1.618f) * d + c4;
  }
}

// Schedule positions [LO, HI) on every chain, position by position.
template <int LO, int HI, int NC>
__device__ __forceinline__ void run(float (&y)[NC], bool (&b)[NC], float c,
                                    float d, float c4) {
  if constexpr (HI - LO == 1) {
#pragma unroll
    for (int j = 0; j < NC; ++j) emit<sched_at(LO), LO>(y[j], b[j], c, d, c4);
  } else if constexpr (HI - LO > 1) {
    run<LO, (LO + HI) / 2, NC>(y, b, c, d, c4);
    run<(LO + HI) / 2, HI, NC>(y, b, c, d, c4);
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
           int iters) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    const int t0 = e - e % kTileElems;
    const float c = x[t0];
    const float d = x[t0 + 1];
    const float c4 = c * 0.25f;
    const float xe = x[e];
    int bfix = xe > d;
    float y[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) y[j] = xe * static_cast<float>(1.0 + 0.001 * j);
    for (int it = 0; it < iters; ++it) {
      asm("" : "+r"(bfix));
      bool b[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) b[j] = bfix != 0;
      run<0, kSchedLen, NC>(y, b, c, d, c4);
#pragma unroll
      for (int j = 0; j < NC; ++j) y[j] = b[j] ? y[j] : d;
    }
    float acc = y[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) acc = acc + y[j];
    out[e] = acc;
  }
}

using MixKernel = void (*)(const float*, float*, int, int);

// The instantiation for `nc` chains, or nullptr where this build has none.
template <int I>
MixKernel find(int nc) {
  if constexpr (I >= kNumNcChoices) {
    return nullptr;
  } else {
    if constexpr (((RTFS_MIX_NC_MASK) >> I) & 1) {
      if (nc == kNcChoices[I]) return mix_kernel<kNcChoices[I]>;
    }
    return find<I + 1>(nc);
  }
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/probe.py).  x and out are n f32
// (n a multiple of 8*256); `blocks` blocks of 256 threads stride over them.
// Each returns the CUDA error of its call.
extern "C" int rtfs_mix_chain(const float* x, float* out, int n, int iters,
                              int nc, int blocks, void* stream) {
  const rtfs::MixKernel k = rtfs::find<0>(nc);
  if (k == nullptr || n % rtfs::kTileElems != 0 || blocks < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<blocks, rtfs::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 256 threads of the `nc` instantiation one SM holds at once.
extern "C" int rtfs_mix_occupancy(int nc, int* blocks_per_sm) {
  const rtfs::MixKernel k = rtfs::find<0>(nc);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, rtfs::kThreads, 0);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* rtfs_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
