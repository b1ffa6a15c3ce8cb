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
// slot is touched only by its owning thread). The block loops over the
// tile's chunks in order, staging each [128, NF] chunk of pair rows in
// shared memory, and leaves the loop once every pixel is done
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
// Bound: each live pair-pixel costs about 21 FP32 operations, one exp
// among them (plus 2 per semantic channel); the bytes are one 4*NF-byte
// row per real pair read and 4*(5+S) bytes per pixel of a written tile.
// On the frozen bench scene the two are close: bytes bind at 16x16 with
// S=0, operations at 16x16 with S>0 and at 64x32 (chip_smoke.py computes
// the bound from each run's pairs). The design keeps every operand on chip
// (registers, shared memory broadcast) and stops at the first all-done
// chunk.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;   // pairs per chunk (binning's G_CHUNK)

struct Params {
  const float* gdata;      // [capacity, nf] pair rows (F_* columns)
  const int* tile_start;   // [n_tiles] first chunk of the tile, -1: none
  const int* tile_end;     // [n_tiles] one past its last chunk, -1: none
  const float* bg;         // [3]
  float* out;              // [n_tiles, 5 + s_ch, tx*ty]
  int nf, ntx, tx, ty, s_ch;
};

template <int PPT>
__global__ void __launch_bounds__(256) blend_fwd(Params p) {
  extern __shared__ float4 smem4[];
  float* chunk = reinterpret_cast<float*>(smem4);       // [kChunk * nf]
  float* sem_acc = chunk + kChunk * p.nf;               // [s_ch * n_pix]
  const int tile = blockIdx.x;
  const int c0 = p.tile_start[tile];
  const int c1 = p.tile_end[tile];
  if (c0 < 0 || c1 <= c0) return;
  const int n_pix = p.tx * p.ty;
  const int nt = blockDim.x;
  const int tile_x = tile % p.ntx;
  const int tile_y = tile / p.ntx;

  float px[PPT], py[PPT], T[PPT], acc[PPT][5];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * nt;
    px[k] = static_cast<float>(pix % p.tx + tile_x * p.tx);
    py[k] = static_cast<float>(pix / p.tx + tile_y * p.ty);
    T[k] = 1.0f;
    done[k] = false;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[k][c] = 0.0f;
  }
  for (int i = threadIdx.x; i < p.s_ch * n_pix; i += nt) sem_acc[i] = 0.0f;

  const int n4 = kChunk * p.nf / 4;
  for (int c = c0; c < c1; ++c) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // barrier: also keeps the previous chunk's readers ahead of the copy
    if (__syncthreads_count(live) == 0) break;
    const float4* src =
        reinterpret_cast<const float4*>(p.gdata + (long long)c * kChunk * p.nf);
    for (int i = threadIdx.x; i < n4; i += nt) smem4[i] = src[i];
    __syncthreads();
    for (int j = 0; j < kChunk; ++j) {
      const float* g = chunk + j * p.nf;
      const float mx = g[0], my = g[1], ca = g[2], cb = g[3], cc = g[4];
      const float op = g[5];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        // the skip/stop decisions are written with explicitly rounded
        // operations (no FMA contraction) so that kernel C
        // (blend_bwd.cu), which replays them, takes the same decisions
        const float dx = __fsub_rn(mx, px[k]);
        const float dy = __fsub_rn(my, py[k]);
        const float power = __fsub_rn(
            __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                       __fmul_rn(__fmul_rn(cc, dy), dy))),
            __fmul_rn(__fmul_rn(cb, dx), dy));
        if (power > 0.0f) continue;
        const float alpha_raw = __fmul_rn(op, expf(power));
        if (alpha_raw < 1.0f / 255.0f) continue;
        const float alpha = fminf(alpha_raw, 0.99f);
        const float test_t = __fmul_rn(T[k], __fsub_rn(1.0f, alpha));
        if (test_t < 1e-4f) {
          done[k] = true;
          continue;
        }
        const float w = __fmul_rn(alpha, T[k]);
        acc[k][0] += w * g[6];
        acc[k][1] += w * g[7];
        acc[k][2] += w * g[8];
        acc[k][3] += w * g[9];
        acc[k][4] += w;
        const int pix = threadIdx.x + k * nt;
        for (int s = 0; s < p.s_ch; ++s) sem_acc[s * n_pix + pix] += w * g[11 + s];
        T[k] = test_t;
      }
    }
  }

  float* o = p.out + (long long)tile * (5 + p.s_ch) * n_pix;
  const float bg0 = p.bg[0], bg1 = p.bg[1], bg2 = p.bg[2];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * nt;
    o[pix] = acc[k][0] + T[k] * bg0;
    o[n_pix + pix] = acc[k][1] + T[k] * bg1;
    o[2 * n_pix + pix] = acc[k][2] + T[k] * bg2;
    o[3 * n_pix + pix] = acc[k][3];
    o[4 * n_pix + pix] = acc[k][4];
    for (int s = 0; s < p.s_ch; ++s)
      o[(5 + s) * n_pix + pix] = sem_acc[s * n_pix + pix];
  }
}

template <int PPT>
int launch(const Params& p, int n_tiles, int threads, size_t smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blend_fwd<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  blend_fwd<PPT><<<n_tiles, threads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a CUDA error code, or -1 for a tile shape the
// kernel is not built for (tx*ty must be 128, 256, 512, 1024 or 2048) or
// a shared-memory need above the card's 227 KB per block.
extern "C" int grpg_blend_fwd(const float* gdata, int nf, const int* tile_start,
                              const int* tile_end, const float* bg, float* out,
                              int n_tiles, int ntx, int tx, int ty, int s_ch,
                              void* stream) {
  const int n_pix = tx * ty;
  const int threads = n_pix >= 256 ? 256 : n_pix;
  if (n_pix % threads != 0 || nf % 4 != 0 || nf < 11 + s_ch) return -1;
  const size_t smem = sizeof(float) * ((size_t)kChunk * nf + (size_t)s_ch * n_pix);
  if (smem > 232448) return -1;
  Params p{gdata, tile_start, tile_end, bg, out, nf, ntx, tx, ty, s_ch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles == 0) return 0;
  switch (n_pix / threads) {
    case 1: return launch<1>(p, n_tiles, threads, smem, s);
    case 2: return launch<2>(p, n_tiles, threads, smem, s);
    case 4: return launch<4>(p, n_tiles, threads, smem, s);
    case 8: return launch<8>(p, n_tiles, threads, smem, s);
    default: return -1;
  }
}
