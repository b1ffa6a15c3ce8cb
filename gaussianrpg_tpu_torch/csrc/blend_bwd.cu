// Kernel C: the blend backward (per pair-slot gradients of the front-to-back
// compositing of each tile's depth-ordered Gaussian pair list).
//
// Replaces the TPU kernel `gaussianrpg_tpu/ops/pallas_blend.py`
// (`_blend_fns` backward call, body `_make_bwd_kernel`). The TPU kernel
// streams 128-pair chunks front to back on its sequential grid and turns
// every per-pixel sum into small MXU moment contractions. Here it is the
// forward's shape (kernel B, blend_fwd.cu): one block per tile, each of its
// (up to 256) threads owns PPT pixels. Per pixel the prologue reads the saved
// planes `out` and their cotangents `dout` and folds the totals:
//   T_final = 1 - alpha_plane,
//   tot_ebt = sum_c tot_c * g_c + T_final * (bg . g_rgb),
// with tot the planes minus T_final*bg on r, g, b (the identity of
// backward.cu:468). The chunk loop stages 128 pair rows in shared memory
// and replays the forward per pixel with the forward's exact arithmetic
// (same explicitly rounded skip/stop tests, same sequential T), so the
// set of contributing pairs is the one that made `out`. For a
// contributing pair with w = alpha*T and e = sum_ch feat_ch * g_ch:
//   p_incl += w*e;  dL/dalpha = e*T - (tot_ebt - p_incl)/(1 - alpha);
//   q2 = G*dL/dalpha (opacity), q = op*q2,
//   gx = -q(ca dx + cb dy), gy = -q(cc dy + cb dx) (pixel-unit mean),
//   -q dx^2/2, -q dx dy, -q dy^2/2 (conic), w*g (colour, depth, sem),
//   |gx| W/2 + |gy| H/2 (the AbsGS statistic, in the F_RADIUS column).
// Each pair's 11+S sums over the tile's pixels: per-thread sums over its
// pixels, a warp shuffle reduction (skipped when __any_sync finds no
// contributing pixel in the warp), one shared-memory row per warp, then
// a cross-warp sum that writes the chunk's [128, NF] gradient rows once,
// coalesced. No atomics: every slot belongs to one tile. A tile stops at
// the first chunk where every pixel is done (__syncthreads_count); its
// remaining chunks are written as zeros. Blocks past the tiles zero the
// slots of every chunk no written tile owns (padding past the pairs, and
// tiles whose last chunk is past capacity, whose `out` is not read).
// Bound: each live pair-pixel costs about 21 FP32 operations for the
// forward replay and 45 + 4*S for the backward terms, one exp among them;
// the bytes are the real pair rows read once, the out and dout planes of
// the written tiles read once and the [capacity, NF] gradient rows written
// once. chip_smoke.py computes both from each run; operations bind at both
// tilings on the frozen bench scene. The design keeps every operand on chip
// and stops at the first all-done chunk, as the forward does.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;   // pairs per chunk (binning's G_CHUNK)
constexpr int kMaxThreads = 256;
constexpr int kNG = 11;       // fixed gradient columns (F_MX .. F_RADIUS)
constexpr int kZeroBlocks = 264;

struct Params {
  const float* gdata;      // [capacity, nf] pair rows (F_* columns)
  const int* chunk_meta;   // [n_chunks] tile | first<<24 | last<<25 | valid<<26
  const int* tile_start;   // [n_tiles] first chunk of the tile, -1: none
  const int* tile_end;     // [n_tiles] one past its last chunk, -1: none
  const float* bg;         // [3]
  const float* out;        // [n_tiles, 5 + s_ch, tx*ty] saved planes
  const float* dout;       // [n_tiles, 5 + s_ch, tx*ty] their cotangents
  float* grad;             // [capacity, nf] gradient rows
  int nf, n_chunks, n_tiles, ntx, tx, ty, s_ch;
  float half_w, half_h;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ void zero_rows(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = 0.0f;
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads) blend_bwd(Params p) {
  extern __shared__ float4 smem4[];
  const int ngw = kNG + p.s_ch;
  const int rows = kChunk * p.nf;
  if (blockIdx.x >= p.n_tiles) {
    // chunks no written tile owns come back zero
    for (int c = blockIdx.x - p.n_tiles; c < p.n_chunks;
         c += gridDim.x - p.n_tiles) {
      const int meta = p.chunk_meta[c];
      const int t = meta & 0xFFFFFF;
      const bool valid = (meta >> 26) & 1;
      const bool owned = valid && p.tile_start[t] >= 0 &&
                         p.tile_end[t] > p.tile_start[t];
      if (!owned) zero_rows(p.grad + (long long)c * rows, rows);
    }
    return;
  }
  float* chunk = reinterpret_cast<float*>(smem4);        // [kChunk * nf]
  const int n_warps = blockDim.x >> 5;
  float* part = chunk + rows;                            // [n_warps][kChunk][ngw]
  float* gsem = part + n_warps * kChunk * ngw;           // [s_ch][n_pix]
  const int tile = blockIdx.x;
  const int c0 = p.tile_start[tile];
  const int c1 = p.tile_end[tile];
  if (c0 < 0 || c1 <= c0) return;
  const int n_pix = p.tx * p.ty;
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_x = tile % p.ntx;
  const int tile_y = tile / p.ntx;
  const float bg0 = p.bg[0], bg1 = p.bg[1], bg2 = p.bg[2];
  const int nfo = 5 + p.s_ch;
  const float* o = p.out + (long long)tile * nfo * n_pix;
  const float* d = p.dout + (long long)tile * nfo * n_pix;

  float px[PPT], py[PPT], T[PPT], pref[PPT], tot[PPT], g[PPT][5];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * nt;
    px[k] = static_cast<float>(pix % p.tx + tile_x * p.tx);
    py[k] = static_cast<float>(pix / p.tx + tile_y * p.ty);
    T[k] = 1.0f;
    pref[k] = 0.0f;
    done[k] = false;
#pragma unroll
    for (int c = 0; c < 5; ++c) g[k][c] = d[c * n_pix + pix];
    const float t_final = 1.0f - o[4 * n_pix + pix];
    float s = (o[pix] - t_final * bg0) * g[k][0] +
              (o[n_pix + pix] - t_final * bg1) * g[k][1] +
              (o[2 * n_pix + pix] - t_final * bg2) * g[k][2] +
              o[3 * n_pix + pix] * g[k][3] + o[4 * n_pix + pix] * g[k][4];
    for (int c = 0; c < p.s_ch; ++c) {
      const float gs = d[(5 + c) * n_pix + pix];
      gsem[c * n_pix + pix] = gs;   // read back only by this thread
      s += o[(5 + c) * n_pix + pix] * gs;
    }
    tot[k] = s + t_final * (g[k][0] * bg0 + g[k][1] * bg1 + g[k][2] * bg2);
  }

  const int n4 = rows / 4;
  for (int c = c0; c < c1; ++c) {
    float* dst = p.grad + (long long)c * rows;
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // barrier: also keeps the previous chunk's readers ahead of the copy
    if (__syncthreads_count(live) == 0) {
      zero_rows(dst, rows);
      continue;
    }
    const float4* src = reinterpret_cast<const float4*>(p.gdata + (long long)c * rows);
    for (int i = threadIdx.x; i < n4; i += nt) smem4[i] = src[i];
    __syncthreads();
    for (int j = 0; j < kChunk; ++j) {
      const float* gr = chunk + j * p.nf;
      const float mx = gr[0], my = gr[1], ca = gr[2], cb = gr[3], cc = gr[4];
      const float op = gr[5];
      float acc[kNG];
#pragma unroll
      for (int i = 0; i < kNG; ++i) acc[i] = 0.0f;
      float wk[PPT];
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        wk[k] = 0.0f;
        if (done[k]) continue;
        // the forward's skip/stop arithmetic, operation for operation
        // (blend_fwd.cu): the same decisions, bit for bit
        const float dx = __fsub_rn(mx, px[k]);
        const float dy = __fsub_rn(my, py[k]);
        const float power = __fsub_rn(
            __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                       __fmul_rn(__fmul_rn(cc, dy), dy))),
            __fmul_rn(__fmul_rn(cb, dx), dy));
        if (power > 0.0f) continue;
        const float G = expf(power);
        const float alpha_raw = __fmul_rn(op, G);
        if (alpha_raw < 1.0f / 255.0f) continue;
        const float alpha = fminf(alpha_raw, 0.99f);
        const float one_m = __fsub_rn(1.0f, alpha);
        const float test_t = __fmul_rn(T[k], one_m);
        if (test_t < 1e-4f) {
          done[k] = true;
          continue;
        }
        const float w = __fmul_rn(alpha, T[k]);
        const int pix = threadIdx.x + k * nt;
        float e = gr[6] * g[k][0] + gr[7] * g[k][1] + gr[8] * g[k][2] +
                  gr[9] * g[k][3] + g[k][4];
        for (int s = 0; s < p.s_ch; ++s) e += gr[11 + s] * gsem[s * n_pix + pix];
        pref[k] += w * e;
        const float dl = e * T[k] - (tot[k] - pref[k]) / one_m;
        const float q2 = G * dl;
        const float q = op * q2;
        const float gx = -q * (ca * dx + cb * dy);
        const float gy = -q * (cc * dy + cb * dx);
        acc[0] += gx;
        acc[1] += gy;
        acc[2] += -0.5f * q * dx * dx;
        acc[3] += -q * dx * dy;
        acc[4] += -0.5f * q * dy * dy;
        acc[5] += q2;
        acc[6] += w * g[k][0];
        acc[7] += w * g[k][1];
        acc[8] += w * g[k][2];
        acc[9] += w * g[k][3];
        acc[10] += p.half_w * fabsf(gx) + p.half_h * fabsf(gy);
        wk[k] = w;
        any = true;
        T[k] = test_t;
      }
      float* prow = part + (warp * kChunk + j) * ngw;
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int i = 0; i < kNG; ++i) {
          const float v = warp_sum(acc[i]);
          if (lane == 0) prow[i] = v;
        }
        for (int s = 0; s < p.s_ch; ++s) {
          float v = 0.0f;
#pragma unroll
          for (int k = 0; k < PPT; ++k)
            v += wk[k] * gsem[s * n_pix + threadIdx.x + k * nt];
          v = warp_sum(v);
          if (lane == 0) prow[kNG + s] = v;
        }
      } else if (lane == 0) {
        for (int i = 0; i < ngw; ++i) prow[i] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += nt) {
      const int j = i / p.nf;
      const int col = i - j * p.nf;
      float v = 0.0f;
      if (col < ngw)
        for (int w = 0; w < n_warps; ++w) v += part[(w * kChunk + j) * ngw + col];
      dst[i] = v;
    }
  }
}

template <int PPT>
int launch(const Params& p, int grid, int threads, size_t smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blend_bwd<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  blend_bwd<PPT><<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a CUDA error code, or -1 for a tile shape the
// kernel is not built for (tx*ty must be 128, 256, 512, 1024 or 2048) or a
// shared-memory need above the card's 227 KB per block.
extern "C" int grpg_blend_bwd(const float* gdata, int nf, const int* chunk_meta,
                              int n_chunks, const int* tile_start,
                              const int* tile_end, const float* bg,
                              const float* out, const float* dout, float* grad,
                              int n_tiles, int ntx, int tx, int ty, int s_ch,
                              float half_w, float half_h, void* stream) {
  const int n_pix = tx * ty;
  const int threads = n_pix >= kMaxThreads ? kMaxThreads : n_pix;
  if (n_pix % threads != 0 || threads % 32 != 0 || nf % 4 != 0 ||
      nf < kNG + s_ch)
    return -1;
  const size_t smem = sizeof(float) *
      ((size_t)kChunk * nf + (size_t)(threads / 32) * kChunk * (kNG + s_ch) +
       (size_t)s_ch * n_pix);
  if (smem > 232448) return -1;
  Params p{gdata, chunk_meta, tile_start, tile_end, bg, out, dout, grad,
           nf, n_chunks, n_tiles, ntx, tx, ty, s_ch, half_w, half_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0) return 0;
  const int grid = n_tiles + kZeroBlocks;
  switch (n_pix / threads) {
    case 1: return launch<1>(p, grid, threads, smem, s);
    case 2: return launch<2>(p, grid, threads, smem, s);
    case 4: return launch<4>(p, grid, threads, smem, s);
    case 8: return launch<8>(p, grid, threads, smem, s);
    default: return -1;
  }
}
