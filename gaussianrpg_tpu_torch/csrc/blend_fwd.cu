// Kernel B: the blend forward (front-to-back alpha compositing of each
// tile's depth-ordered Gaussian pair list).
//
// Replaces the TPU kernel `gaussianrpg_tpu/ops/pallas_blend.py`
// (`_blend_fns` forward call, body `_make_fwd_kernel`). The TPU kernel walks
// 128-pair chunks on a sequential grid with the chunk's Gaussians on
// sublanes and the tile's pixels on lanes, and gets each pixel's
// transmittance from a log-step cumulative product. Here it is the CUDA
// rasterizer's shape (`forward.cu:340-467`): one block per tile, each
// thread owns PPT pixels and keeps their transmittance T, done flag and
// rgb/depth/weight accumulators in registers; the S semantic accumulators
// of every pixel live in shared memory (S is a runtime width, and each
// slot is touched only by its owning thread). The block walks the tile's
// chunks in order and leaves the loop once every pixel is done
// (__syncthreads_count).
// Per pixel and pair (contract of the TPU kernel):
//   skip if power > 0 or alpha_raw = op*exp(power) < 1/255;
//   alpha = min(0.99, alpha_raw); stop (pair excluded) when
//   T*(1-alpha) < 1e-4; accumulate w = alpha*T times (r, g, b, depth, 1,
//   semantics); out rgb = C + T_final*bg.
// Output layout [n_tiles, 5+S, tx*ty] (planes r, g, b, depth, alpha, sem)
// is the TPU kernel's, so the caller's tile reassembly and the empty-tile
// background fill are shared code. Tiles the wrapper marks unwritten
// (no pairs, or a last chunk past capacity) are left untouched; nothing is
// read past the tile's last chunk.
//
// Bound: each live pair-pixel costs about 21 FP32 operations, one exp
// among them (plus 2 per semantic channel); the bytes are one 4*NF-byte
// row per real pair read and 4*(5+S) bytes per pixel of a written tile.
// On the frozen bench scene the two are close: bytes bind at 16x16 with
// S=0, operations at 16x16 with S>0 and at 64x32 (chip_smoke.py computes
// the bound from each run's pairs).
// What held the first version to ~14x its bound: every warp ran
// the ~35-instruction test for every pair of the chunk, whether 1 or 32
// of its lanes were live, while a pair's 2-6 px footprint touches one or
// two of a 16x16 tile's 8 warps (a quarter of the issued lane slots were
// live pixels; at 64x32 a pair was tested at ~540 pixels for a footprint
// of a few dozen), and the chunk was copied synchronously behind a
// barrier (0.118 of 0.916 ms at 16x16). This design:
//  - per-warp pair culling (blend_tile.cuh): when a chunk lands, 128
//    threads compute each pair's conservative pixel rectangle (the 1/255
//    ellipse of its conic, widened for rounding); each warp owns a compact
//    region of 8x4-pixel blocks (8x4 at 16x16, 16x16 at 64x32), ballots the
//    pairs whose rectangle meets its region and walks only those, in
//    depth order, testing the rectangle again per block. The branch is
//    warp-uniform, and a culled evaluation is one the exact test would
//    have skipped, so the output is unchanged; the exact, explicitly
//    rounded test (`pair_power`) runs for every evaluation not culled;
//  - chunk c+1 is staged by one bulk copy (cp.async.bulk into shared
//    memory, completed on an mbarrier) while chunk c is blended: a chunk's
//    128 rows are contiguous, so one instruction moves all of them and no
//    thread spends registers or issue slots on the copy (cp.async, the
//    fallback, would need 128*NF/4 16-byte copies spread over the threads);
//  - a pair's geometry and rectangle are read once (vector loads) for the
//    warp's PPT blocks; where a lane owns one pixel (16x16 tiles) a warp
//    walks two pairs at a time: their tests (the exp's latency) overlap,
//    their effects apply in depth order.
// Where the rectangles cover the whole tile (Gaussians wider than a tile,
// as in scenes initialized from points) nothing is culled, and the walk's
// per-pair bookkeeping (the index taken from the ballot mask, the row's
// address, the cull flags) is overhead against the first version's plain
// loop over the chunk. A group whose 32 pairs all reach the warp is
// therefore walked by a plain loop whose indices every lane shares. On
// such scenes this kernel stays the slower one: the first version fits 6
// blocks an SM in 40 registers, this one 5 in 45.

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using namespace blend_tile;

struct Params {
  const float* gdata;      // [capacity, nf] pair rows (F_* columns)
  const int* tile_start;   // [n_tiles] first chunk of the tile, -1: none
  const int* tile_end;     // [n_tiles] one past its last chunk, -1: none
  const float* bg;         // [3]
  float* out;              // [n_tiles, 5 + s_ch, tx*ty]
  int nf, ntx, tx, ty, s_ch;
};

size_t smem_bytes(int nf, int s_ch, int n_pix) {
  // two chunk buffers, the cull rectangles, the semantic accumulators
  return sizeof(float) * (2 * (size_t)kChunk * nf + 4 * kChunk +
                          (size_t)s_ch * n_pix);
}

// Resident blocks an SM that ptxas is asked to fit, by pixels per thread:
// its own choice at 2, 4 and 8. At 1 its own choice was 6 blocks (40
// registers) with spills in the pair loop, slower on every scene measured
// than 5 blocks without them.
template <int PPT>
__host__ __device__ constexpr int min_blocks() {
  return PPT == 1 ? 5 : PPT == 2 ? 4 : PPT == 4 ? 3 : 2;
}

template <int PPT>
__global__ void __launch_bounds__(256, min_blocks<PPT>()) blend_fwd(Params p) {
  using L = Layout<PPT>;
  constexpr int kPairs = pairs_at_once<PPT>();
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const int rows = kChunk * p.nf;
  float* chunks = smem;                                     // [2][rows]
  float4* rect = reinterpret_cast<float4*>(chunks + 2 * rows);   // [kChunk]
  float* sem_acc = reinterpret_cast<float*>(rect + kChunk);  // [s_ch][n_pix]
  const int tile = blockIdx.x;
  const int c0 = p.tile_start[tile];
  const int c1 = p.tile_end[tile];
  if (c0 < 0 || c1 <= c0) return;
  const int n_pix = p.tx * p.ty;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const L lay(warp, lane, p.tx);
  // the warp's region and the lane's pixels in image coordinates
  const float rx = static_cast<float>((tile % p.ntx) * p.tx + lay.x0);
  const float ry = static_cast<float>((tile / p.ntx) * p.ty + lay.y0);
  const float xl = rx + lay.lx, yl = ry + lay.ly;

  // r, g, b, alpha in float; depth (tens of metres, the planes' largest
  // values) in double: kernel C's dL/dalpha takes the difference of this
  // plane's total and its own running sum, which a float32 running sum
  // over hundreds of pairs leaves with rounding of the size of the
  // difference at saturated pixels
  float T[PPT], acc[PPT][4];   // r, g, b, alpha
  double dep[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = 1.0f;
    done[k] = false;
    dep[k] = 0.0;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;
  }
  for (int i = threadIdx.x; i < p.s_ch * n_pix; i += blockDim.x)
    sem_acc[i] = 0.0f;

  const uint32_t bytes = static_cast<uint32_t>(rows * sizeof(float));
  if (threadIdx.x == 0) {
    barrier_init(&bars[0]);
    barrier_init(&bars[1]);
    barrier_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_load(chunks, p.gdata + (long long)c0 * rows, bytes, &bars[0]);

  for (int c = c0; c < c1; ++c) {
    const int i = c - c0, buf = i & 1;
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // barrier: also keeps the readers of chunk c-1 (buffer buf^1) and of
    // the rectangles ahead of their next writers
    if (__syncthreads_count(live) == 0) {
      // no copy may be left in flight into the block's shared memory
      if (threadIdx.x == 0) barrier_wait(&bars[buf], (i >> 1) & 1);
      break;
    }
    if (threadIdx.x == 0 && c + 1 < c1)
      bulk_load(chunks + (buf ^ 1) * rows, p.gdata + (long long)(c + 1) * rows,
                bytes, &bars[buf ^ 1]);
    barrier_wait(&bars[buf], (i >> 1) & 1);
    const float* ch = chunks + buf * rows;
    for (int t = threadIdx.x; t < kChunk; t += blockDim.x)
      rect[t] = cull_rect(ch + t * p.nf);
    __syncthreads();

    // blocks of this warp with a pixel still running
    unsigned blive = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (__any_sync(kFull, !done[k])) blive |= 1u << k;
    for (int q = 0; q < kChunk / 32; ++q) {
      unsigned m = 0;
      if (blive)
        m = __ballot_sync(kFull, overlaps(rect[q * 32 + lane], rx,
                                          rx + L::kRW - 1, ry,
                                          ry + L::kRH - 1));
      // kPairs pairs at a time (index -1: none): their tests are
      // independent, so they overlap; their effects apply in depth order
      auto walk = [&](const int (&jj)[kPairs]) {
        // the pairs' geometry and rectangles, read once for the PPT blocks
        Geom gg[kPairs];
        float4 rr[kPairs];
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          gg[u] = load_geom(ch + max(jj[u], 0) * p.nf);
          rr[u] = rect[max(jj[u], 0)];
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!((blive >> k) & 1)) continue;
          bool in[kPairs];
          bool any_in = false;
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            in[u] = jj[u] >= 0 &&
                    (PPT == 1 || overlaps(rr[u], rx + L::bx(k),
                                          rx + L::bx(k) + 7, ry + L::by(k),
                                          ry + L::by(k) + 3));
            any_in |= in[u];
          }
          if (!any_in || done[k]) continue;
          float ar[kPairs];
          bool pass[kPairs];
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            const Geom& g = gg[u];
            float dx, dy;
            const float power = pair_power(g.mx, g.my, g.ca, g.cb, g.cc,
                                           xl + L::bx(k), yl + L::by(k), dx,
                                           dy);
            ar[u] = __fmul_rn(g.op, expf(power));
            pass[u] = in[u] && !(power > 0.0f) && !(ar[u] < kMinAlpha);
          }
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            if (!pass[u] || done[k]) continue;
            const float* g = ch + jj[u] * p.nf;
            const float alpha = fminf(ar[u], 0.99f);
            const float test_t = __fmul_rn(T[k], __fsub_rn(1.0f, alpha));
            if (test_t < 1e-4f) {
              done[k] = true;
              continue;
            }
            const float w = __fmul_rn(alpha, T[k]);
            const float2 rg = *reinterpret_cast<const float2*>(g + 6);
            const float2 bd = *reinterpret_cast<const float2*>(g + 8);
            acc[k][0] += w * rg.x;
            acc[k][1] += w * rg.y;
            acc[k][2] += w * bd.x;
            dep[k] += static_cast<double>(w * bd.y);
            acc[k][3] += w;
            const int pix = lay.pix(k, p.tx);
            for (int s = 0; s < p.s_ch; ++s)
              sem_acc[s * n_pix + pix] += w * g[11 + s];
            T[k] = test_t;
          }
        }
      };
      if (m == kFull) {
        // every pair of the group reaches the warp (Gaussians wider than a
        // tile): a plain loop whose indices are the same on every lane
        for (int b = 0; b < 32; b += kPairs) {
          int jj[kPairs];
#pragma unroll
          for (int u = 0; u < kPairs; ++u) jj[u] = q * 32 + b + u;
          walk(jj);
        }
        continue;
      }
      while (m) {
        int jj[kPairs];
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          jj[u] = -1;
          if (m) {
            jj[u] = q * 32 + __ffs(m) - 1;
            m &= m - 1;
          }
        }
        walk(jj);
      }
    }
  }

  float* o = p.out + (long long)tile * (5 + p.s_ch) * n_pix;
  const float bg0 = p.bg[0], bg1 = p.bg[1], bg2 = p.bg[2];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = lay.pix(k, p.tx);
    o[pix] = acc[k][0] + T[k] * bg0;
    o[n_pix + pix] = acc[k][1] + T[k] * bg1;
    o[2 * n_pix + pix] = acc[k][2] + T[k] * bg2;
    o[3 * n_pix + pix] = static_cast<float>(dep[k]);
    o[4 * n_pix + pix] = acc[k][3];
    for (int s = 0; s < p.s_ch; ++s)
      o[(5 + s) * n_pix + pix] = sem_acc[s * n_pix + pix];
  }
}

const void* kernel_for(int ppt) {
  switch (ppt) {
    case 1: return (const void*)blend_fwd<1>;
    case 2: return (const void*)blend_fwd<2>;
    case 4: return (const void*)blend_fwd<4>;
    case 8: return (const void*)blend_fwd<8>;
    default: return nullptr;
  }
}

// The kernel and its threads per block for a tile shape; nullptr for a
// shape the kernel is not built for.
const void* configure(int tx, int ty, int* threads) {
  const int n_pix = tx * ty;
  *threads = n_pix >= 256 ? 256 : n_pix;
  if (*threads % 32 != 0 || n_pix % *threads != 0) return nullptr;
  const int ppt = n_pix / *threads;
  if (!kernel_for(ppt) || !fits(ppt, tx, ty)) return nullptr;
  return kernel_for(ppt);
}

}  // namespace

// Returns 0 on success, a CUDA error code, or -1 for a tile shape the
// kernel is not built for (tx*ty must be 128, 256, 512, 1024 or 2048, and
// the tile a whole number of the warps' regions: tx, ty multiples of 8, 4
// up to 256 pixels, of 8, 8 at 512, 16, 8 at 1024, 16, 16 at 2048), a
// shared-memory need above the card's 227 KB per block, or rows that are
// not 16-byte aligned.
extern "C" int grpg_blend_fwd(const float* gdata, int nf, const int* tile_start,
                              const int* tile_end, const float* bg, float* out,
                              int n_tiles, int ntx, int tx, int ty, int s_ch,
                              void* stream) {
  int threads;
  const void* f = configure(tx, ty, &threads);
  if (!f || nf % 4 != 0 || nf < 11 + s_ch ||
      reinterpret_cast<uintptr_t>(gdata) % 16 != 0)
    return -1;
  const size_t smem = smem_bytes(nf, s_ch, tx * ty);
  if (smem + 1024 > 232448) return -1;
  if (n_tiles == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  Params p{gdata, tile_start, tile_end, bg, out, nf, ntx, tx, ty, s_ch};
  void* args[] = {&p};
  e = cudaLaunchKernel(f, dim3(n_tiles), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Occupancy of the launch `grpg_blend_fwd` makes for this shape: info[0]
// resident blocks per SM, [1] registers per thread, [2] dynamic and [3]
// static shared memory per block (bytes), [4] threads per block. Returns 0,
// a CUDA error code, or -1 for a shape the kernel is not built for.
extern "C" int grpg_blend_fwd_info(int tx, int ty, int s_ch, int nf,
                                   int* info) {
  int threads;
  const void* f = configure(tx, ty, &threads);
  if (!f) return -1;
  const size_t smem = smem_bytes(nf, s_ch, tx * ty);
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, f);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  info[0] = blocks;
  info[1] = a.numRegs;
  info[2] = static_cast<int>(smem);
  info[3] = static_cast<int>(a.sharedSizeBytes);
  info[4] = threads;
  return 0;
}
