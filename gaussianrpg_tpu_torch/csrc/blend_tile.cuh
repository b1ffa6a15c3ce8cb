// Shared by kernel B (blend_fwd.cu) and kernel C (blend_bwd.cu): the pair
// row's geometry, the explicitly rounded per-pixel test, the per-pair cull
// rectangle, the pixel layout of a tile's warps and the pairs a warp walks
// at a time, and the bulk copy that stages a chunk.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace blend_tile {

constexpr int kChunk = 128;          // pairs per chunk (binning's G_CHUNK)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinAlpha = 1.0f / 255.0f;

// A pair row's geometry, read by two vector loads: rows are 16-byte aligned
// (NF % 4 == 0, and the chunk buffers are aligned).
struct Geom {
  float mx, my, ca, cb, cc, op;
};

__device__ __forceinline__ Geom load_geom(const float* g) {
  const float4 a = *reinterpret_cast<const float4*>(g);
  const float2 b = *reinterpret_cast<const float2*>(g + 4);
  return {a.x, a.y, a.z, a.w, b.x, b.y};
}

// power = -(ca dx^2 + cc dy^2)/2 - cb dx dy at one pixel, every operation
// rounded on its own (no FMA contraction): kernel C replays kernel B's
// skip/stop decisions bit for bit because both evaluate this function.
__device__ __forceinline__ float pair_power(float mx, float my, float ca,
                                            float cb, float cc, float px,
                                            float py, float& dx, float& dy) {
  dx = __fsub_rn(mx, px);
  dy = __fsub_rn(my, py);
  return __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                 __fmul_rn(__fmul_rn(cc, dy), dy))),
      __fmul_rn(__fmul_rn(cb, dx), dy));
}

// The cull rectangle of one pair row (mx, my, ca, cb, cc, op, ...), as
// (x_lo, x_hi, y_lo, y_hi) in pixel coordinates: every pixel at which the
// exact test above lets the pair through (power <= 0 and
// op*expf(power) >= 1/255, rounded as kernels B and C round it) lies inside.
// `ops/blend.cull_rect_plain` is the same formula in PyTorch, and
// tests/test_torch_blend_cull.py holds it to that promise. Derivation:
//  - A test that passes needs op*G >= (1/255)(1 - 2^-24) with
//    G = expf(power) <= exp(power)(1 + 2.4e-7), so power >= -tau with
//    tau = ln(255 op) + 3e-7. With op < (1/255)(1 - 2^-20) no pixel passes:
//    the pair is culled whole (an empty rectangle).
//  - Otherwise a passing pixel has q_c = -2 power <= 2 tau_m, tau_m =
//    max(ln(255 op), 0)(1 + 1e-6) + 4e-6. The rounded q_c differs from the
//    exact q = d^T Q d (Q the conic) by at most 9.1 eps (a + b) + eps q_c,
//    a + b = ca dx^2 + cc dy^2 <= 2 r q with r = ca cc / det >= 1 the
//    conic's shear, so q <= 2 tau_m (1 + 36.4 eps r) while 18.2 eps r <= 1/2.
//    The ellipse q <= 2T has half-widths sqrt(2T cc/det), sqrt(2T ca/det)
//    (the diagonal of the conic's inverse); det's own rounding adds at most
//    8 eps r. The factor 1 + 64 eps r + 1e-5 covers all of it, r is capped
//    at kMaxShear (where 64 eps r = 0.38), and a margin of 1e-2 px +
//    1e-6 (|m| + h) covers the rounding of m -/+ h.
//  - Not culled (the whole plane): a conic that is not positive definite,
//    r > kMaxShear, and inputs past kMaxCentre / kMaxValue, beyond which
//    power could overflow into a NaN that the exact test would let through.
constexpr float kCullOpacity = kMinAlpha * (1.0f - 9.5367431640625e-07f);
constexpr float kMaxShear = 1e5f;
constexpr float kMaxCentre = 1e7f;
constexpr float kMaxValue = 1e20f;
constexpr float kEps = 5.9604644775390625e-08f;   // 2^-24

__device__ __forceinline__ float4 cull_rect(const float* g) {
  const float mx = g[0], my = g[1], ca = g[2], cb = g[3], cc = g[4];
  const float op = g[5];
  const float inf = __int_as_float(0x7f800000);
  const float4 everywhere = make_float4(-inf, inf, -inf, inf);
  const bool bounded = fabsf(mx) <= kMaxCentre && fabsf(my) <= kMaxCentre &&
                       fabsf(ca) <= kMaxValue && fabsf(cb) <= kMaxValue &&
                       fabsf(cc) <= kMaxValue && fabsf(op) <= kMaxValue;
  if (!bounded) return everywhere;
  if (op < kCullOpacity) return make_float4(inf, -inf, inf, -inf);
  const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
  if (!(ca > 0.0f && cc > 0.0f && det > 0.0f)) return everywhere;
  const float r = __fdiv_rn(__fmul_rn(ca, cc), det);
  if (!(r <= kMaxShear)) return everywhere;
  const float tau = fmaxf(logf(op * 255.0f), 0.0f) * (1.0f + 1e-6f) + 4e-6f;
  const float t2 = 2.0f * tau * (1.0f + 64.0f * kEps * r + 1e-5f) / det;
  const float hx = sqrtf(t2 * cc);
  const float hy = sqrtf(t2 * ca);
  const float ex = 1e-2f + 1e-6f * (fabsf(mx) + hx);
  const float ey = 1e-2f + 1e-6f * (fabsf(my) + hy);
  return make_float4(mx - hx - ex, mx + hx + ex, my - hy - ey, my + hy + ey);
}

// Does rectangle r overlap the pixels [x0, x1] x [y0, y1]? (r holds no NaN)
__device__ __forceinline__ bool overlaps(float4 r, float x0, float x1,
                                         float y0, float y1) {
  return r.y >= x0 && r.x <= x1 && r.w >= y0 && r.z <= y1;
}

// Pixel layout. A thread owns PPT pixels, one in each of its warp's PPT
// blocks of 8x4 pixels (lane = 8 * row + column); a warp's blocks form
// a region of kBW x kBH blocks, and the regions tile the tile row-major.
// A tile fits when tx % (8 kBW) == 0 and ty % (4 kBH) == 0 (`fits`).
template <int PPT>
struct Layout {
  static constexpr int kBW = PPT >= 4 ? 2 : 1;   // blocks across a region
  static constexpr int kBH = PPT / kBW;          // blocks down a region
  static constexpr int kRW = 8 * kBW;            // region width (pixels)
  static constexpr int kRH = 4 * kBH;            // region height
  int x0, y0;   // the warp's region origin in the tile
  int lx, ly;   // the lane's pixel within each block

  __device__ Layout(int warp, int lane, int tx) {
    const int nrx = tx / kRW;
    x0 = (warp % nrx) * kRW;
    y0 = (warp / nrx) * kRH;
    lx = lane & 7;
    ly = lane >> 3;
  }
  // block k's origin in the tile
  __device__ static constexpr int bx(int k) { return 8 * (k % kBW); }
  __device__ static constexpr int by(int k) { return 4 * (k / kBW); }
  // the lane's pixel of block k: index in the tile's planes
  __device__ int pix(int k, int tx) const {
    return (y0 + by(k) + ly) * tx + x0 + bx(k) + lx;
  }
};

// Pairs a warp walks at a time: two where a lane owns one pixel (nothing
// else to overlap with the exp's latency), one where it owns several
// (the pixels' tests overlap).
template <int PPT>
__host__ __device__ constexpr int pairs_at_once() { return PPT == 1 ? 2 : 1; }

inline bool fits(int ppt, int tx, int ty) {
  const int bw = ppt >= 4 ? 2 : 1;
  const int bh = ppt / bw;
  return tx % (8 * bw) == 0 && ty % (4 * bh) == 0;
}

// Chunk staging: one thread starts a bulk copy of a chunk's contiguous
// pair rows into shared memory (cp.async.bulk, completion counted in bytes
// on an mbarrier); every thread waits on the barrier's phase.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace blend_tile
