// Kernel C: the blend backward (per pair-slot gradients of the front-to-back
// compositing of each tile's depth-ordered Gaussian pair list).
//
// Replaces the TPU kernel `gaussianrpg_tpu/ops/pallas_blend.py`
// (`_blend_fns` backward call, body `_make_bwd_kernel`). The TPU kernel
// streams 128-pair chunks front to back on its sequential grid and turns
// every per-pixel sum into small MXU moment contractions. Here it has the
// forward's shape (kernel B, blend_fwd.cu): one block per tile, each of its
// (up to 256) threads owns PPT pixels, laid out and culled as kernel B lays
// them out and culls (blend_tile.cuh). Per pixel the prologue reads the
// saved planes `out` and their cotangents `dout` and folds the totals:
//   T_final = 1 - alpha_plane,
//   tot_ebt = sum_c tot_c * g_c + T_final * (bg . g_rgb),
// with tot the planes minus T_final*bg on r, g, b (the identity of
// backward.cu:468). The chunk loop replays the forward per pixel with the
// forward's exact arithmetic (`pair_power`, the same sequential T), so the
// set of contributing pairs is the one that made `out`. For a contributing
// pair with w = alpha*T and e = sum_ch feat_ch * g_ch:
//   p_incl += w*e;  dL/dalpha = e*T - (tot_ebt - p_incl)/(1 - alpha);
//   q2 = G*dL/dalpha (opacity), q = op*q2,
//   gx = -q(ca dx + cb dy), gy = -q(cc dy + cb dx) (pixel-unit mean),
//   -q dx^2/2, -q dx dy, -q dy^2/2 (conic), w*g (colour, depth, sem),
//   |gx| W/2 + |gy| H/2 (the AbsGS statistic, in the F_RADIUS column).
// A group of 32 pairs' gradient rows is written once, coalesced, after a
// cross-warp sum of per-warp partial rows in shared memory. No atomics:
// every slot belongs to one tile. A tile stops at the first chunk where
// every pixel is done (__syncthreads_count); its remaining chunks are
// written as zeros. Blocks past the tiles zero the slots of every chunk no
// written tile owns (padding past the pairs, and tiles whose last chunk is
// past capacity, whose `out` is not read).
//
// Bound: each live pair-pixel costs about 21 FP32 operations for the
// forward replay and 45 + 4*S for the backward terms, one exp among them;
// the bytes are the real pair rows read once, the out and dout planes of
// the written tiles read once and the [capacity, NF] gradient rows written
// once. chip_smoke.py computes both from each run; operations bind at both
// tilings on the frozen bench scene.
// What held the first version to ~18x its bound: besides kernel B's
// waste (every warp tested every pair; synchronous staging), every
// (pair, warp) with a contributing pixel ran 11 + S warp_sum shuffle
// chains (55 SHFL + 55 FADD at S=0), about 55 SM clocks of shuffle
// against ~16 of arithmetic for the warp's 32 pixels, and the per-warp
// partial rows of a whole chunk (45 KB at S=0) left 2 blocks an SM at
// 16x16 and 1 at 64x32. This design keeps kernel B's per-warp culling and
// double-buffered bulk copies, and sums over pixels in the TPU kernel's
// moment form (pallas_blend.py:464-496):
//  - per evaluation of a pair at one 8x4 block of a warp (any lane
//    contributing), each lane stages q, gx, gy and w in the warp's
//    [kStaged][kSlots][33] shared-memory tile;
//  - layout (a): when kSlots evaluations are staged, the warp transposes
//    them: lane (slot e, block row h) reads slot e's 8 pixels of row h and
//    sums q, x q, x^2 q (x = 0..7 block-local, multiplies by immediates),
//    absp = W/2 |gx| + H/2 |gy|, gx, gy, and w times the pixels'
//    cotangents (staged once a tile in shared memory); y = h gives y q,
//    x y q, y^2 q; two shuffle steps, issued for all 13 sums together,
//    join the 4 rows: ~26 shuffles per kSlots evaluations, not 11 + S
//    chains of 5 each. Layout (b), a butterfly transpose-reduce in
//    registers (9 shuffles a value per 8 evaluations), lost the A/B to
//    this one by 31-33% at every shape measured (PERF.md section 5);
//  - the conic and opacity columns recombine per slot from the moments as
//    pallas_blend.py:474-496 does (sum q2 = sum q / op), in block-local
//    coordinates (|mx - block origin| is a few pixels for the pairs that
//    reach the block). The mean columns are the staged gx, gy summed: their
//    recombination -(ca sum q dx + cb sum q dy) cancels on strongly
//    sheared conics and missed the 5e-5 limit there (1.2e-4 of the max on
//    an H100, tests/test_torch_cuda.py's adversarial pairs at 64x32).
//    Where a warp owns several blocks (PPT > 1), slots of one pair are
//    consecutive, and a 3-step segmented scan adds their columns before
//    one lane adds the row into the warp's partial rows;
//  - partial rows cover one group of 32 pairs (a ballot's worth), summed
//    over warps and written after each group: a quarter of the shared
//    memory of whole-chunk rows, so 3 blocks an SM fit at 16x16;
//  - where a lane owns one pixel (16x16 tiles) a warp walks two pairs at a
//    time: their tests (the exp's latency) overlap, their effects apply in
//    depth order.
// kNoGrad (tools/bwd_ablate.py only, unreachable from blend_backward): the
// walk, replay and per-pixel terms without staging or sums; writes zero
// rows (a sink keeps the terms live), like the JAX kernel's "nograd".

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using namespace blend_tile;

constexpr int kMaxThreads = 256;
constexpr int kNG = 11;       // fixed gradient columns (F_MX .. F_RADIUS)
constexpr int kZeroBlocks = 264;
constexpr int kSlots = 8;     // evaluations a warp collects before a sum
constexpr int kStaged = 4;    // staged per pixel: q, gx, gy, w
constexpr int kGroup = 32;    // pairs whose rows are summed over warps at once
constexpr int kPad = 33;      // padded row of 32 pixels (no bank conflicts)

// kMoments is kernel C; kNoGrad is tools/bwd_ablate.py's form, unreachable
// from blend_backward.
constexpr int kMoments = 0;
constexpr int kNoGrad = 1;

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

// Shared memory (floats): two chunk buffers, the cull rectangles, per-warp
// partial rows of a group of pairs [n_warps][kGroup][11 + S], per-warp staging
// [n_warps][kStaged][kSlots][kPad] (kMoments only), the pixels' cotangents
// (r, g, b, depth, sem) by block [n_pix / 32][4 + S][kPad].
size_t smem_bytes(int form, int nf, int s_ch, int n_pix, int threads) {
  const size_t n_warps = threads / 32;
  const size_t blocks = n_pix / 32;
  const size_t staged = form == kMoments ? kStaged * kSlots * kPad : 0;
  return sizeof(float) *
         (2 * (size_t)kChunk * nf + 4 * kChunk +
          n_warps * kGroup * (kNG + s_ch) + n_warps * staged +
          blocks * (4 + s_ch) * kPad);
}

__device__ void zero_rows(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = 0.0f;
}

// The gradient columns of one pair at one 8x4 block from its sums over the
// block's pixels: the moments of q against block-local [1, x, y, x^2, xy,
// y^2] recombine as pallas_blend.py:474-496 (dx = M - x, dy = N - y with
// M, N the centre's offset from the block's origin); gx, gy are summed
// as staged (their recombination cancels on strongly sheared conics).
// m = {q, x q, y q, x^2 q, x y q, y^2 q}, s = {absp, gx, gy}, wg = w times
// the r, g, b, depth cotangents.
__device__ __forceinline__ void recombine(const float (&m)[6],
                                          const float (&s)[3],
                                          const float (&wg)[4], float M,
                                          float N, float op,
                                          float (&col)[kNG]) {
  col[0] = s[1];
  col[1] = s[2];
  col[2] = -0.5f * (M * M * m[0] - 2.0f * M * m[1] + m[3]);
  col[3] = -(M * N * m[0] - M * m[2] - N * m[1] + m[4]);
  col[4] = -0.5f * (N * N * m[0] - 2.0f * N * m[2] + m[5]);
  col[5] = m[0] / fmaxf(op, 1e-20f);               // sum q2 = sum q / op
#pragma unroll
  for (int c = 0; c < 4; ++c) col[6 + c] = wg[c];
  col[10] = s[0];
}

// Layout (a), kernel C's: sum the warp's n staged evaluations (lane e
// holds slot e's pair index slot_j and block slot_k) into its partial rows
// `part` (those of the pairs' group). Lane (slot e, block row h) reads slot
// e's 8 pixels of row h from the staging tile and sums them (x = 0..7 are
// immediates; absp = W/2 |gx| + H/2 |gy| from the staged gx, gy); two
// shuffle steps, issued for all 13 sums together, join the 4 rows.
template <int PPT>
__device__ __forceinline__ void flush(const Params& p, int n, int slot_j,
                                      int slot_k, const float* stage,
                                      const float* gblk, const float* ch,
                                      float* part, float rx, float ry,
                                      int lane) {
  using L = Layout<PPT>;
  __syncwarp();
  const int e = lane & 7, h = lane >> 3;
  const int j = __shfl_sync(kFull, slot_j, e);
  const int k = __shfl_sync(kFull, slot_k, e);
  const int nc = 4 + p.s_ch;
  const float* st = stage + e * kPad + 8 * h;   // [kStaged][kSlots][kPad]
  const float* gk = gblk + k * nc * kPad + 8 * h;
  const float fh = static_cast<float>(h);
  float m[6], s[3], wg[4], wv[8];
  float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) wg[c] = 0.0f;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const float q = st[x];
    q0 += q;
    q1 += static_cast<float>(x) * q;
    q2 += static_cast<float>(x * x) * q;
    const float gx = st[kSlots * kPad + x], gy = st[2 * kSlots * kPad + x];
    s[0] += p.half_w * fabsf(gx) + p.half_h * fabsf(gy);
    s[1] += gx;
    s[2] += gy;
    wv[x] = st[3 * kSlots * kPad + x];
#pragma unroll
    for (int c = 0; c < 4; ++c) wg[c] += wv[x] * gk[c * kPad + x];
  }
  m[0] = q0;
  m[1] = q1;
  m[2] = fh * q0;        // y q
  m[3] = q2;
  m[4] = fh * q1;        // x y q
  m[5] = fh * fh * q0;   // y^2 q
  // join the slot's 4 rows (all shuffles of a step issue together)
#pragma unroll
  for (int o = 8; o <= 16; o <<= 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) m[i] += __shfl_xor_sync(kFull, m[i], o);
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] += __shfl_xor_sync(kFull, s[i], o);
#pragma unroll
    for (int c = 0; c < 4; ++c) wg[c] += __shfl_xor_sync(kFull, wg[c], o);
  }
  const Geom g = load_geom(ch + max(j, 0) * p.nf);
  float col[kNG];
  recombine(m, s, wg, g.mx - (rx + L::bx(k)), g.my - (ry + L::by(k)), g.op,
            col);
  // slots of one pair are consecutive (j does not decrease along the
  // slots): a segmented scan adds them, the pair's last slot writes
  bool add[3] = {false, false, false};
  bool tail = e < n;
  if (PPT > 1) {
    // every lane runs every shuffle (none behind a short-circuit)
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int up = __shfl_up_sync(kFull, j, 1 << t, 8);
      add[t] = e >= (1 << t) && up == j;
    }
    const int down = __shfl_down_sync(kFull, j, 1, 8);
    tail = tail && (e == n - 1 || down != j);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int c = 0; c < kNG; ++c) {
        const float u = __shfl_up_sync(kFull, col[c], 1 << t, 8);
        if (add[t]) col[c] += u;
      }
  }
  const bool write = tail && h == 0;
  float* row = part + (j % kGroup) * (kNG + p.s_ch);
  if (write)
#pragma unroll
    for (int c = 0; c < kNG; ++c) row[c] += col[c];
  for (int c = 0; c < p.s_ch; ++c) {   // semantics: w times their cotangents
    float u = 0.0f;
#pragma unroll
    for (int x = 0; x < 8; ++x) u += wv[x] * gk[(4 + c) * kPad + x];
    u += __shfl_xor_sync(kFull, u, 8);
    u += __shfl_xor_sync(kFull, u, 16);
    if (PPT > 1) {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const float d = __shfl_up_sync(kFull, u, 1 << t, 8);
        if (add[t]) u += d;
      }
    }
    if (write) row[kNG + c] += u;
  }
  __syncwarp();
}

template <int PPT, int FORM>
__global__ void __launch_bounds__(kMaxThreads) blend_bwd(Params p) {
  using L = Layout<PPT>;
  constexpr int kPairs = pairs_at_once<PPT>();
  constexpr bool kSums = FORM != kNoGrad;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const int ngw = kNG + p.s_ch;
  const int nc = 4 + p.s_ch;
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
  const int tile = blockIdx.x;
  const int c0 = p.tile_start[tile];
  const int c1 = p.tile_end[tile];
  if (c0 < 0 || c1 <= c0) return;
  const int n_pix = p.tx * p.ty;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int staged = FORM == kMoments ? kStaged * kSlots * kPad : 0;
  float* chunks = smem;                                          // [2][rows]
  float4* rect = reinterpret_cast<float4*>(chunks + 2 * rows);   // [kChunk]
  float* part = reinterpret_cast<float*>(rect + kChunk);
  float* stage = part + n_warps * kGroup * ngw;
  float* gpix = stage + n_warps * staged;
  float* my_part = part + warp * kGroup * ngw;
  float* my_stage = stage + warp * staged;
  float* my_g = gpix + warp * PPT * nc * kPad;   // [PPT][nc][kPad]
  const L lay(warp, lane, p.tx);
  const float rx = static_cast<float>((tile % p.ntx) * p.tx + lay.x0);
  const float ry = static_cast<float>((tile / p.ntx) * p.ty + lay.y0);
  const float xl = rx + lay.lx, yl = ry + lay.ly;
  const float bg0 = p.bg[0], bg1 = p.bg[1], bg2 = p.bg[2];
  const int nfo = 5 + p.s_ch;
  const float* o = p.out + (long long)tile * nfo * n_pix;
  const float* d = p.dout + (long long)tile * nfo * n_pix;

  // the planes' total and the running sum of w*e in double: their
  // difference, the suffix of dL/dalpha, is small where a pixel nears
  // saturation, and float32 sums over hundreds of pairs rounded it by as
  // much (kernel B keeps its depth plane in double for the same reason)
  float T[PPT], ga[PPT];
  double pref[PPT], tot[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = lay.pix(k, p.tx);
    T[k] = 1.0f;
    pref[k] = 0.0;
    done[k] = false;
    float* gk = my_g + k * nc * kPad + lane;
    float g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      g[c] = d[c * n_pix + pix];
      gk[c * kPad] = g[c];
    }
    ga[k] = d[4 * n_pix + pix];
    const float t_final = 1.0f - o[4 * n_pix + pix];
    // products of two floats are exact in double
    double s = static_cast<double>(o[pix] - t_final * bg0) * g[0] +
               static_cast<double>(o[n_pix + pix] - t_final * bg1) * g[1] +
               static_cast<double>(o[2 * n_pix + pix] - t_final * bg2) * g[2] +
               static_cast<double>(o[3 * n_pix + pix]) * g[3] +
               static_cast<double>(o[4 * n_pix + pix]) * ga[k];
    for (int c = 0; c < p.s_ch; ++c) {
      const float gs = d[(5 + c) * n_pix + pix];
      gk[(4 + c) * kPad] = gs;   // read back by this warp only
      s += static_cast<double>(o[(5 + c) * n_pix + pix]) * gs;
    }
    tot[k] = s + static_cast<double>(t_final) *
                     (g[0] * bg0 + g[1] * bg1 + g[2] * bg2);
  }

  const uint32_t bytes = static_cast<uint32_t>(rows * sizeof(float));
  if (threadIdx.x == 0) {
    barrier_init(&bars[0]);
    barrier_init(&bars[1]);
    barrier_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_load(chunks, p.gdata + (long long)c0 * rows, bytes, &bars[0]);

  if (kSums)
    for (int t = lane; t < kGroup * ngw; t += 32) my_part[t] = 0.0f;
  float sink = 0.0f;
  for (int c = c0; c < c1; ++c) {
    const int i = c - c0, buf = i & 1;
    float* dst = p.grad + (long long)c * rows;
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // barrier: also keeps the readers of chunk c-1, of the rectangles and
    // of the partial rows ahead of their next writers
    if (__syncthreads_count(live) == 0) {
      // no copy may be left in flight into the block's shared memory
      if (threadIdx.x == 0) barrier_wait(&bars[buf], (i >> 1) & 1);
      for (int r = c; r < c1; ++r)
        zero_rows(p.grad + (long long)r * rows, rows);
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

    unsigned blive = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (__any_sync(kFull, !done[k])) blive |= 1u << k;
    int n_staged = 0, slot_j = -1, slot_k = 0;
    for (int q = 0; q < kChunk / kGroup; ++q) {
      unsigned m = 0;
      if (blive)
        m = __ballot_sync(kFull, overlaps(rect[q * kGroup + lane], rx,
                                          rx + L::kRW - 1, ry,
                                          ry + L::kRH - 1));
      while (m) {
        // up to kPairs pairs at a time: their tests are independent, so
        // they overlap; their effects apply in depth order
        int jj[kPairs];
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          jj[u] = -1;
          if (m) {
            jj[u] = q * kGroup + __ffs(m) - 1;
            m &= m - 1;
          }
        }
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
          if (!any_in) continue;
          // the forward's skip arithmetic (blend_tile.cuh): the same
          // decisions, bit for bit
          float G[kPairs], ar[kPairs], dx[kPairs], dy[kPairs];
          bool pass[kPairs];
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            const Geom& g = gg[u];
            const float power = pair_power(g.mx, g.my, g.ca, g.cb, g.cc,
                                           xl + L::bx(k), yl + L::by(k),
                                           dx[u], dy[u]);
            G[u] = expf(power);
            ar[u] = __fmul_rn(g.op, G[u]);
            pass[u] = in[u] && !done[k] && !(power > 0.0f) &&
                      !(ar[u] < kMinAlpha);
          }
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            if (!in[u]) continue;   // warp-uniform
            const float* gr = ch + jj[u] * p.nf;
            const float* gk = my_g + k * nc * kPad + lane;
            float qv = 0.0f, gx = 0.0f, gy = 0.0f, w = 0.0f;
            bool contrib = false;
            if (pass[u] && !done[k]) {
              const float alpha = fminf(ar[u], 0.99f);
              const float one_m = __fsub_rn(1.0f, alpha);
              const float test_t = __fmul_rn(T[k], one_m);
              if (test_t < 1e-4f) {
                done[k] = true;
              } else {
                w = __fmul_rn(alpha, T[k]);
                const Geom& g = gg[u];
                const float2 rg = *reinterpret_cast<const float2*>(gr + 6);
                const float2 bd = *reinterpret_cast<const float2*>(gr + 8);
                float e = rg.x * gk[0] + rg.y * gk[kPad] +
                          bd.x * gk[2 * kPad] + bd.y * gk[3 * kPad] + ga[k];
                for (int s = 0; s < p.s_ch; ++s)
                  e += gr[11 + s] * gk[(4 + s) * kPad];
                pref[k] += static_cast<double>(w * e);
                const float dl =
                    e * T[k] - static_cast<float>(tot[k] - pref[k]) / one_m;
                qv = g.op * (G[u] * dl);
                gx = -qv * (g.ca * dx[u] + g.cb * dy[u]);
                gy = -qv * (g.cc * dy[u] + g.cb * dx[u]);
                T[k] = test_t;
                contrib = true;
              }
            }
            if constexpr (FORM == kNoGrad) {
              sink += qv + p.half_w * fabsf(gx) + p.half_h * fabsf(gy) + w;
              continue;
            }
            if (!__any_sync(kFull, contrib)) continue;
            if (lane == n_staged) {
              slot_j = jj[u];
              slot_k = k;
            }
            float* st = my_stage + n_staged * kPad + lane;
            st[0] = qv;
            st[kSlots * kPad] = gx;
            st[2 * kSlots * kPad] = gy;
            st[3 * kSlots * kPad] = w;
            if (n_staged + 1 == kSlots)
              flush<PPT>(p, kSlots, slot_j, slot_k, my_stage, my_g, ch,
                         my_part, rx, ry, lane);
            n_staged = (n_staged + 1) % kSlots;
          }
        }
      }
      if constexpr (kSums) {
        if (n_staged)
          flush<PPT>(p, n_staged, slot_j, slot_k, my_stage, my_g, ch, my_part,
                     rx, ry, lane);
        n_staged = 0;
        __syncthreads();
        // the group's rows: its pairs' partial rows summed over the warps
        // (and zeroed for the next group), written once, coalesced
        float* dq = dst + q * kGroup * p.nf;
        for (int t = threadIdx.x; t < kGroup * p.nf; t += blockDim.x) {
          const int jl = t / p.nf;
          const int col = t - jl * p.nf;
          float v = 0.0f;
          if (col < ngw)
            for (int w = 0; w < n_warps; ++w) {
              float* pw = part + (w * kGroup + jl) * ngw + col;
              v += *pw;
              *pw = 0.0f;
            }
          dq[t] = v;
        }
        if (q + 1 < kChunk / kGroup) __syncthreads();
      }
    }
    if constexpr (!kSums) {
      zero_rows(dst, rows);
      if (sink == 1.17549435e-38f) dst[threadIdx.x] = sink;   // never
    }
  }
}

template <int FORM>
const void* kernel_for(int ppt) {
  switch (ppt) {
    case 1: return (const void*)blend_bwd<1, FORM>;
    case 2: return (const void*)blend_bwd<2, FORM>;
    case 4: return (const void*)blend_bwd<4, FORM>;
    case 8: return (const void*)blend_bwd<8, FORM>;
    default: return nullptr;
  }
}

// The kernel and its threads per block for a tile shape; nullptr for a
// shape the kernel is not built for.
template <int FORM>
const void* configure(int tx, int ty, int* threads) {
  const int n_pix = tx * ty;
  *threads = n_pix >= kMaxThreads ? kMaxThreads : n_pix;
  if (*threads % 32 != 0 || n_pix % *threads != 0) return nullptr;
  const int ppt = n_pix / *threads;
  if (!kernel_for<FORM>(ppt) || !fits(ppt, tx, ty)) return nullptr;
  return kernel_for<FORM>(ppt);
}

template <int FORM>
int run(const float* gdata, int nf, const int* chunk_meta, int n_chunks,
        const int* tile_start, const int* tile_end, const float* bg,
        const float* out, const float* dout, float* grad, int n_tiles,
        int ntx, int tx, int ty, int s_ch, float half_w, float half_h,
        void* stream) {
  int threads;
  const void* f = configure<FORM>(tx, ty, &threads);
  if (!f || nf % 4 != 0 || nf < kNG + s_ch ||
      reinterpret_cast<uintptr_t>(gdata) % 16 != 0)
    return -1;
  const size_t smem = smem_bytes(FORM, nf, s_ch, tx * ty, threads);
  if (smem + 1024 > 232448) return -1;
  if (n_chunks == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  Params p{gdata, chunk_meta, tile_start, tile_end, bg, out, dout, grad,
           nf, n_chunks, n_tiles, ntx, tx, ty, s_ch, half_w, half_h};
  void* args[] = {&p};
  e = cudaLaunchKernel(f, dim3(n_tiles + kZeroBlocks), dim3(threads), args,
                       smem, static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int FORM>
int info(int tx, int ty, int s_ch, int nf, int* out) {
  int threads;
  const void* f = configure<FORM>(tx, ty, &threads);
  if (!f) return -1;
  const size_t smem = smem_bytes(FORM, nf, s_ch, tx * ty, threads);
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, f);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(a.sharedSizeBytes);
  out[4] = threads;
  return 0;
}

}  // namespace

// Returns 0 on success, a CUDA error code, or -1 for a tile shape the
// kernel is not built for (those of kernel B, blend_fwd.cu), a
// shared-memory need above the card's 227 KB per block, or rows that are
// not 16-byte aligned.
extern "C" int grpg_blend_bwd(const float* gdata, int nf, const int* chunk_meta,
                              int n_chunks, const int* tile_start,
                              const int* tile_end, const float* bg,
                              const float* out, const float* dout, float* grad,
                              int n_tiles, int ntx, int tx, int ty, int s_ch,
                              float half_w, float half_h, void* stream) {
  return run<kMoments>(gdata, nf, chunk_meta, n_chunks, tile_start, tile_end,
                       bg, out, dout, grad, n_tiles, ntx, tx, ty, s_ch, half_w,
                       half_h, stream);
}

// Occupancy of the launch `grpg_blend_bwd` makes for this shape: info[0]
// resident blocks per SM, [1] registers per thread, [2] dynamic and [3]
// static shared memory per block (bytes), [4] threads per block. Returns 0,
// a CUDA error code, or -1 for a shape the kernel is not built for.
extern "C" int grpg_blend_bwd_info(int tx, int ty, int s_ch, int nf,
                                   int* out) {
  return info<kMoments>(tx, ty, s_ch, nf, out);
}

// tools/bwd_ablate.py's form, same arguments as grpg_blend_bwd: without the
// per-pair sums (zero rows).
extern "C" int grpg_blend_bwd_nograd(
    const float* gdata, int nf, const int* chunk_meta, int n_chunks,
    const int* tile_start, const int* tile_end, const float* bg,
    const float* out, const float* dout, float* grad, int n_tiles, int ntx,
    int tx, int ty, int s_ch, float half_w, float half_h, void* stream) {
  return run<kNoGrad>(gdata, nf, chunk_meta, n_chunks, tile_start, tile_end,
                      bg, out, dout, grad, n_tiles, ntx, tx, ty, s_ch, half_w,
                      half_h, stream);
}
