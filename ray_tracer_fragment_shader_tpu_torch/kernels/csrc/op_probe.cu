// P1, the per-class op probe: pure one-class dependent chains, one
// instantiation per class, whose times against the `mul` chain give each
// class's cost in FP32 issue slots (probes/op_probe.py).
//
// Replaces the JAX package's scripts/vpu_op_probe.py::_chain_kernel (:119,
// its step _step :64), launched from _time_chain (:135).  x is [8*G, 256]
// f32 in 8x256 tiles: c = 2*tile[0,0] (about 1) and d = tile[0,1] (about
// 0.6) from memory, bfix = x > d.  Each element runs NC independent chains
// from x*(1 + 0.001 j) for `iters` steps of class INJ and stores their sum.
// The classes on the card: `recip` is rcp.approx.f32 (MUFU), `recip_nr`
// adds one Newton step, `div` and `sqrt` are IEEE (nvcc's defaults),
// `rsqrt` is rsqrtf (MUFU); the others are FP32 ALU instructions.
//
// Bound: issue, as K9 (csrc/mix_probe.cu): the chains live in registers
// (NC a template parameter), the iteration loop is unrolled by 4, c, d and
// bfix come from memory (bfix through an empty asm each step, so the loop
// is not unswitched on it), every chain reaches the stored sum, and the
// source is built with -fmad=false (kernels/cuda_build.py), so `mul` is one
// FMUL a step and `mix` issues its multiplies and adds apart, as the
// kernels it prices do.
#include <cuda_runtime.h>

namespace rtfs {

constexpr int kThreads = 256;
constexpr int kTileElems = 8 * 256;
// probes/op_probe.py::NC_SWEEP
constexpr int kNcs[] = {4, 8, 12, 16};
constexpr int kNumNcs = sizeof(kNcs) / sizeof(kNcs[0]);

// probes/op_probe.py::INJECTS, in order
enum Inject : int {
  kMul = 0, kAdd, kMax, kSel, kCmpSel, kAbs, kSign, kRsqrt, kSqrt, kDiv,
  kRecip, kRecipNr, kFloor, kMix, kNumInjects
};

__device__ __forceinline__ float rcp_approx(float y) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// Loop-invariant scalars of a tile: c, d and the products the JAX step
// forms on its scalar core (c*0.25, -c, d*0.1).
struct Tile {
  float c, d, c4, negc, d01;
};

// One chain step of class INJ (vpu_op_probe.py::_step).
template <int INJ>
__device__ __forceinline__ float step(float y, const Tile& t, bool bfix) {
  if constexpr (INJ == kMul) {
    return y * t.c;
  } else if constexpr (INJ == kAdd) {
    return (t.d - y) + t.c4;
  } else if constexpr (INJ == kMax) {
    return fmaxf(y, t.d) * t.c;
  } else if constexpr (INJ == kSel) {
    return (bfix ? y : t.d) * t.c;
  } else if constexpr (INJ == kCmpSel) {
    return y > t.d ? y * 0.98f : y * 1.01f;
  } else if constexpr (INJ == kAbs) {
    return fabsf(y) * t.negc;
  } else if constexpr (INJ == kSign) {
    return static_cast<float>((y > 0.0f) - (y < 0.0f)) * t.d;
  } else if constexpr (INJ == kRsqrt) {
    return rsqrtf(y);
  } else if constexpr (INJ == kSqrt) {
    return sqrtf(y);
  } else if constexpr (INJ == kDiv) {
    return t.c / y;
  } else if constexpr (INJ == kRecip) {
    return rcp_approx(y);
  } else if constexpr (INJ == kRecipNr) {
    const float r = rcp_approx(y);
    return r * (2.0f - y * r);
  } else if constexpr (INJ == kFloor) {
    return floorf(y * 1.618f) * t.d;
  } else {
    static_assert(INJ == kMix, "unknown inject");
    // the render kernels' dominant ratio: 8 basic + 2 select + 1 cmp +
    // 1 rsqrt a step
    y = y > t.d ? y * t.c : y + t.d;
    y = bfix ? y * t.c + t.d : y;
    y = rsqrtf(y * t.c + t.d01);
    return y * t.c;
  }
}

template <int INJ, int NC>
__global__ void __launch_bounds__(kThreads)
op_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
          int iters) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    const int t0 = e - e % kTileElems;
    Tile t;
    t.c = x[t0] * 2.0f;
    t.d = x[t0 + 1];
    t.c4 = t.c * 0.25f;
    t.negc = -t.c;
    t.d01 = t.d * 0.1f;
    const float xe = x[e];
    int bfix = xe > t.d;
    float y[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) y[j] = xe * static_cast<float>(1.0 + 0.001 * j);
#pragma unroll 4
    for (int it = 0; it < iters; ++it) {
      asm("" : "+r"(bfix));
#pragma unroll
      for (int j = 0; j < NC; ++j) y[j] = step<INJ>(y[j], t, bfix != 0);
    }
    float acc = y[0];
#pragma unroll
    for (int j = 1; j < NC; ++j) acc = acc + y[j];
    out[e] = acc;
  }
}

using OpKernel = void (*)(const float*, float*, int, int);

// The instantiation of class `inj` with `nc` chains, or nullptr.
template <int I, int J>
OpKernel find(int inj, int nc) {
  if constexpr (I >= kNumInjects) {
    return nullptr;
  } else if constexpr (J >= kNumNcs) {
    return find<I + 1, 0>(inj, nc);
  } else {
    if (inj == I && nc == kNcs[J]) return op_kernel<I, kNcs[J]>;
    return find<I, J + 1>(inj, nc);
  }
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/probe.py).  x and out are n f32
// (n a multiple of 8*256); `blocks` blocks of 256 threads stride over them.
// Each returns the CUDA error of its call.
extern "C" int rtfs_op_chain(const float* x, float* out, int n, int iters,
                             int inject, int nc, int blocks, void* stream) {
  const rtfs::OpKernel k = rtfs::find<0, 0>(inject, nc);
  if (k == nullptr || n % rtfs::kTileElems != 0 || blocks < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  k<<<blocks, rtfs::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 256 threads of one instantiation one SM holds at once.
extern "C" int rtfs_op_occupancy(int inject, int nc, int* blocks_per_sm) {
  const rtfs::OpKernel k = rtfs::find<0, 0>(inject, nc);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, rtfs::kThreads, 0);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* rtfs_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
