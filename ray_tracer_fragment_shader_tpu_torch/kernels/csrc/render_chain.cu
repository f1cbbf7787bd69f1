// Chain forward render kernel: primary-ray directions in, RGB out, over
// depth+1 bounce levels; with PACKED also one packed residual per level,
// with RESIDUALS the unpacked residual planes, with RECORDS each hit
// level's topology record (the fit's K6 forward).
//
// Replaces the JAX package's kernels/render_pallas.py::_render_tile_kernel
// (its device code: _make_tile_ops and _chain_forward), in its plain form
// and, as the RESIDUALS instantiation, in its residual form
// (_call_kernel(with_residuals=True), reached from
// render_forward_with_residuals: the forward of the split-mode fit and of
// render_image_diff); and, as the PACKED instantiation,
// render_pallas.py::_render_tile_packed_kernel (phase 1 of the two-phase
// fit); and, as the RECORDS instantiation, the forward half of
// adjoint_fused.py::_fused_fwd_bwd_kernel (K6, whose adjoint
// adjoint_fused.cu runs on the records).  It serves every scene whose
// materials have all-0 or all-1
// transparency: there the bounce tree is a single path, and each level
// takes the transmitted child if the material transmits, else the
// reflected one.
//
// Bound: compute for the image and PACKED.  A pixel moves 24 bytes of
// device memory (12 in, 12 out; PACKED adds 4 per level) against thousands
// of FP32 operations (one closest-hit sweep plus one shadow sweep per light
// at every level).  RESIDUALS writes (2+nl)*4 bytes per level, a bi, a mid
// and a lit plane per light (tile_ops.cuh::ResidualWriter), which makes it
// the one forward bound by its bytes at config 3; RECORDS writes 8 bytes
// per hit level and 4 per pixel (tile_ops.cuh::RecordWriter).  The design
// keeps the
// scene in shared memory, one thread per pixel, and cuts work that adds
// exactly zero: a ray that misses ends its chain, and an all-opaque
// scene's shadow sweep stops at the first occluder.  Its time follows the
// instructions it issues and the warps a SM holds to hide their latency
// (PERF.md §6: the SASS census of its sweeps and the alternated runs),
// so the sweeps fold their gates into predicates (tile_ops.cuh), and each
// form is built for the blocks a SM it runs fastest with
// (ChainMinBlocks).  Each residual form is the same image code, as the
// JAX package keeps every chain forward one program shape; levels after
// the chain ends are still stored, with the value a dead lane has there.
// RESIDUALS has no 2^24 pack limit: only the 32-bit lit word caps it, at
// 32 lights.  Every form has a BF16 instantiation,
// RenderConfig.bf16_shading (tile_ops.cuh's bf16 shadow sweep and Phong
// blend; the C entries' `bf16`).
#include "tile_ops.cuh"

namespace rtfs {

// What a chain kernel writes besides the image.
enum class ChainOut { kImage, kPacked, kResiduals, kRecords };

// Blocks of 256 threads a SM each instantiation is built to hold, chosen
// by alternated runs against the registers the compiler picks on its own
// (PERF.md §6): 4 (at most 64 registers a thread) for the all-opaque
// packed and bf16 residual forms and the transmitting bf16 packed form; 3
// (80) for the other transmitting forms, whose packed and residual forms
// took 84 and 87 registers, 2 blocks, on their own; no limit for the
// all-opaque image forms (63-64 registers on their own) and the
// all-opaque f32 residual form, which spills at 64 and runs slower with
// 15 lights.  The records form takes the packed form's.
template <bool WANT_TRANS, ChainOut OUT, bool BF16>
struct ChainMinBlocks {
  static constexpr bool kPackedLike =
      OUT == ChainOut::kPacked || OUT == ChainOut::kRecords;
  static constexpr int value =
      WANT_TRANS ? (kPackedLike && BF16 ? 4 : 3)
      : (kPackedLike || (OUT == ChainOut::kResiduals && BF16)) ? 4 : 1;
};

template <bool WANT_TRANS, ChainOut OUT, bool BF16>
__global__ void __launch_bounds__(
    256, (ChainMinBlocks<WANT_TRANS, OUT, BF16>::value))
render_chain_kernel(const float* __restrict__ tables, Params prm,
                    const float* __restrict__ v, float* __restrict__ out,
                    int num_pixels) {
  extern __shared__ float smem[];
  if constexpr (OUT == ChainOut::kRecords) {
    __shared__ BlockMarks marks;
    if (threadIdx.x == 0) marks.arrived = 0;
    const Scene s = load_scene(smem, tables, prm);
    records_forward(prm, out, num_pixels, marks,
                    [&](int p, float col[3], RecordWriter& rw) {
                      return chain_forward<WANT_TRANS, BF16>(
                          s, prm, v[3 * p], v[3 * p + 1], v[3 * p + 2], col,
                          [&](int lv, int bi, int mid, unsigned lit_bits) {
                            rw.hit(lv, bi, mid, lit_bits);
                          });
                    });
    return;
  }
  const Scene s = load_scene(smem, tables, prm);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= num_pixels) return;

  float col[3] = {0.0f, 0.0f, 0.0f};
  ResidualWriter res(prm, prm.depth + 1, num_pixels, p);
  int level = chain_forward<WANT_TRANS, BF16>(
      s, prm, v[3 * p], v[3 * p + 1], v[3 * p + 2], col,
      [&](int lv, int bi, int mid, unsigned lit_bits) {
        if constexpr (OUT == ChainOut::kPacked) {
          // (bi+1) + mid*bw_bi + lit_bits*bw_bi*bw_mid: exact f32 integers
          // (render_pallas.py:690-695)
          prm.pk[static_cast<size_t>(lv) * num_pixels + p] =
              static_cast<float>(bi + 1) +
              static_cast<float>(mid) * prm.bw_bi +
              static_cast<float>(lit_bits) * (prm.bw_bi * prm.bw_mid);
        } else if constexpr (OUT == ChainOut::kResiduals) {
          res.hit(lv, bi, mid, lit_bits);
        }
      });
  if constexpr (OUT == ChainOut::kPacked) {
    // the miss level and every later one: bi + 1 = 0, mid = 0 (the JAX
    // blend's miss values) and every lit bit set (a dead lane's shadow
    // sweep finds no occluder)
    const float dead = static_cast<float>((1u << prm.nl) - 1u) *
                       (prm.bw_bi * prm.bw_mid);
    for (; level <= prm.depth; ++level)
      prm.pk[static_cast<size_t>(level) * num_pixels + p] = dead;
  } else if constexpr (OUT == ChainOut::kResiduals) {
    res.fill_to(prm.depth + 1);  // the same dead values, unpacked
  }
  out[3 * p] = col[0];
  out[3 * p + 1] = col[1];
  out[3 * p + 2] = col[2];
}

// The instantiation of form OUT for the launch's flags.
template <ChainOut OUT>
RenderKernel pick_chain(int want_trans, int bf16) {
  if (bf16)
    return want_trans ? render_chain_kernel<true, OUT, true>
                      : render_chain_kernel<false, OUT, true>;
  return want_trans ? render_chain_kernel<true, OUT, false>
                    : render_chain_kernel<false, OUT, false>;
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/render.py).  `tables` is the
// flat misc | sph | tri | mat | light buffer; `v` and `out` are
// [num_pixels, 3] f32; `bf16` selects the bf16_shading instantiation.  Each
// launches on `stream` and returns the launch's cudaError_t.
extern "C" int rtfs_render_chain(const float* tables, int ns, int nt, int m,
                                 int nl, const float* v, float* out,
                                 int num_pixels, float eye_x, float eye_y,
                                 float eye_z, int depth, float small,
                                 float atten, int white_id, int black_id,
                                 int want_trans, int bf16, void* stream) {
  rtfs::Params prm{ns, nt, m, nl, depth, white_id, black_id,
                   small, atten, eye_x, eye_y, eye_z};
  return static_cast<int>(rtfs::launch_render(
      rtfs::pick_chain<rtfs::ChainOut::kImage>(want_trans, bf16), tables, prm,
      v, out, num_pixels, static_cast<cudaStream_t>(stream)));
}

// The packed forward: as rtfs_render_chain, plus `pk` [depth+1, num_pixels]
// f32 with the field widths of kernels/render.py::pack_widths.
extern "C" int rtfs_render_packed(const float* tables, int ns, int nt, int m,
                                  int nl, const float* v, float* out,
                                  int num_pixels, float eye_x, float eye_y,
                                  float eye_z, int depth, float small,
                                  float atten, int white_id, int black_id,
                                  int want_trans, int bf16, float* pk,
                                  float bw_bi, float bw_mid, void* stream) {
  if (nl < 0 || nl > 24) return static_cast<int>(cudaErrorInvalidValue);
  rtfs::Params prm{ns, nt, m, nl, depth, white_id, black_id,
                   small, atten, eye_x, eye_y, eye_z, pk, bw_bi, bw_mid};
  return static_cast<int>(rtfs::launch_render(
      rtfs::pick_chain<rtfs::ChainOut::kPacked>(want_trans, bf16), tables,
      prm, v, out, num_pixels, static_cast<cudaStream_t>(stream)));
}

// The residual forward: as rtfs_render_chain, plus `res` [2+nl, depth+1,
// num_pixels] f32, the unpacked planes bi | mid | lit (tile_ops.cuh::
// ResidualWriter).  At most kResidualMaxLights lights.
extern "C" int rtfs_render_chain_residuals(
    const float* tables, int ns, int nt, int m, int nl, const float* v,
    float* out, int num_pixels, float eye_x, float eye_y, float eye_z,
    int depth, float small, float atten, int white_id, int black_id,
    int want_trans, int bf16, float* res, void* stream) {
  if (nl < 0 || nl > rtfs::kResidualMaxLights || res == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  rtfs::Params prm{ns, nt, m, nl, depth, white_id, black_id, small, atten,
                   eye_x, eye_y, eye_z, nullptr, 0.0f, 0.0f, res};
  return static_cast<int>(rtfs::launch_render(
      rtfs::pick_chain<rtfs::ChainOut::kResiduals>(want_trans, bf16), tables,
      prm, v, out, num_pixels, static_cast<cudaStream_t>(stream)));
}

// The records forward of K6 (its forward half): as rtfs_render_chain but
// `out` written for live pixels only, plus `rec` [depth+1, num_pixels]
// NodeRecords and `rec_n` [num_pixels] int (tile_ops.cuh::RecordWriter;
// rec_n written for live pixels), and the live list's marks of the L2
// cotangent g_scale * mask * (img - target) (target [P,3], mask [P]):
// `ballots` [B * 8], `counts` and `loss_rows` [B], B = max(ceil(P/256), 1)
// (tile_ops.cuh::records_forward).  At most kRecordMaxLights lights.
extern "C" int rtfs_render_chain_records(
    const float* tables, int ns, int nt, int m, int nl, const float* v,
    float* out, int num_pixels, float eye_x, float eye_y, float eye_z,
    int depth, float small, float atten, int white_id, int black_id,
    int want_trans, int bf16, void* rec, int* rec_n, const float* target,
    const float* mask, float g_scale, unsigned* ballots, int* counts,
    float* loss_rows, void* stream) {
  if (nl < 0 || nl > rtfs::kRecordMaxLights ||
      (num_pixels > 0 && (rec == nullptr || rec_n == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  rtfs::Params prm{ns, nt, m, nl, depth, white_id, black_id, small, atten,
                   eye_x, eye_y, eye_z, nullptr, 0.0f, 0.0f, nullptr,
                   static_cast<rtfs::NodeRecord*>(rec), rec_n, target, mask,
                   g_scale, ballots, counts, loss_rows};
  return static_cast<int>(rtfs::launch_render(
      rtfs::pick_chain<rtfs::ChainOut::kRecords>(want_trans, bf16), tables,
      prm, v, out, num_pixels, static_cast<cudaStream_t>(stream)));
}

// Blocks of the chain kernel's instantiation (want_trans, form: 0 image,
// 1 packed, 2 residuals, 3 records; bf16) one SM holds at once with
// `smem_bytes` of tables, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int rtfs_chain_occupancy(int want_trans, int form, int bf16,
                                    int smem_bytes, int* blocks) {
  using rtfs::ChainOut;
  const rtfs::RenderKernel k =
      form == 0   ? rtfs::pick_chain<ChainOut::kImage>(want_trans, bf16)
      : form == 1 ? rtfs::pick_chain<ChainOut::kPacked>(want_trans, bf16)
      : form == 2 ? rtfs::pick_chain<ChainOut::kResiduals>(want_trans, bf16)
                  : rtfs::pick_chain<ChainOut::kRecords>(want_trans, bf16);
  const cudaError_t e = rtfs::kernel_occupancy(k, smem_bytes, blocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* rtfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
