// Stripped variants of kernel B (blend_fwd.cu) that split the blend
// forward's cost into its floor, its chunk staging and its compute.
//
// Replaces the TPU kernel `tools/blend_floor.py:100` (`build`, bodies
// `k_empty:116`, `k_meta:123`, `k_ndone:139`). On the TPU the forward is a
// sequential grid of 128-pair chunks, and the stripped bodies keep its grid
// and block specs while dropping the blend: an empty body, the chunk
// metadata plus `out[tile] = acc + sum(gdata chunk)` for each valid chunk,
// and the same behind the all-pixels-done test. Here they keep kernel B's
// structure instead: one block of 256 threads per tile reads the tile's
// chunk range [tile_start, tile_end) (from `blend.tile_chunk_ranges`) and
// returns at once for a tile with none.
//   empty       writes the tile's [5, n_pix] output block with zeros (and
//               staged[tile] = 0): the launch, the range read and kernel
//               B's output write;
//   stage       stages each chunk of the tile in shared memory as kernel B
//               first did (a synchronous copy by the block's threads behind
//               a barrier; kernel B now overlaps a bulk copy of the next
//               chunk with the blend), sums it (block reduction) and
//               writes the last chunk's sum to every element of the block,
//               which is k_meta's result (its acc is never accumulated),
//               and the sum over all the chunks it staged to staged[tile],
//               so that a check sees every chunk of the range staged;
//   stage_done  the same, with kernel B's `__syncthreads_count` live test
//               as the barrier before each chunk. No
//               pixel is ever done here, as none is in k_ndone.
// Bound: bytes. Each chunk of a written tile is read once (128*NF floats),
// each written tile's block written once; the sums are one add a float.
// The variants exist to be timed beside kernel B on the same inputs
// (`gaussianrpg_tpu_torch/tools/blend_floor.py`), so they copy its loop
// and do nothing to be faster than it.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;    // pairs per chunk (binning's G_CHUNK)
constexpr int kThreads = 256;  // kernel B's block at tx*ty >= 256
enum Variant { kEmpty = 0, kStage = 1, kStageDone = 2 };

// Sum of v over the block, the same value in every thread (fixed order).
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads)
    blend_floor(const float* gdata, int nf, const int* tile_start,
                const int* tile_end, float* out, float* staged, int n_pix) {
  extern __shared__ float4 smem4[];   // [kChunk * nf / 4]
  __shared__ float red[kThreads / 32];
  const int tile = blockIdx.x;
  const int c0 = tile_start[tile];
  const int c1 = tile_end[tile];
  if (c0 < 0 || c1 <= c0) return;
  float keep = 0.f, total = 0.f;
  if (VARIANT != kEmpty) {
    const int n4 = kChunk * nf / 4;
    const bool done = false;
    for (int c = c0; c < c1; ++c) {
      if (VARIANT == kStageDone) {
        if (__syncthreads_count(!done) == 0) break;
      } else {
        __syncthreads();
      }
      const float4* src = reinterpret_cast<const float4*>(
          gdata + static_cast<long long>(c) * kChunk * nf);
      for (int i = threadIdx.x; i < n4; i += kThreads) smem4[i] = src[i];
      __syncthreads();
      float v = 0.f;
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 q = smem4[i];
        v += (q.x + q.y) + (q.z + q.w);
      }
      keep = block_sum(v, red);
      total += keep;
    }
  }
  if (threadIdx.x == 0) staged[tile] = total;
  float* o = out + static_cast<long long>(tile) * 5 * n_pix;
  for (int i = threadIdx.x; i < 5 * n_pix; i += kThreads) o[i] = keep;
}

template <int VARIANT>
int launch(const float* gdata, int nf, const int* tile_start,
           const int* tile_end, float* out, float* staged, int n_tiles,
           int n_pix, cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(kChunk) * nf;
  blend_floor<VARIANT><<<n_tiles, kThreads, smem, s>>>(
      gdata, nf, tile_start, tile_end, out, staged, n_pix);
  return cudaGetLastError();
}

}  // namespace

// variant 0 empty, 1 stage, 2 stage_done. gdata [capacity, nf] float32
// (16-byte aligned), tile_start / tile_end [n_tiles] int32, out
// [n_tiles, 5, n_pix] and staged [n_tiles] float32; the entries of tiles
// without chunks are left untouched. Returns 0, a CUDA error code, or -1
// for a bad argument.
extern "C" int grpg_blend_floor(int variant, const float* gdata, int nf,
                                const int* tile_start, const int* tile_end,
                                float* out, float* staged, int n_tiles,
                                int n_pix, void* stream) {
  if (nf <= 0 || nf % 4 != 0 || n_pix <= 0) return -1;
  if (sizeof(float) * static_cast<size_t>(kChunk) * nf > 48 * 1024) return -1;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kEmpty:
      return launch<kEmpty>(gdata, nf, tile_start, tile_end, out, staged,
                            n_tiles, n_pix, s);
    case kStage:
      return launch<kStage>(gdata, nf, tile_start, tile_end, out, staged,
                            n_tiles, n_pix, s);
    case kStageDone:
      return launch<kStageDone>(gdata, nf, tile_start, tile_end, out,
                                staged, n_tiles, n_pix, s);
    default:
      return -1;
  }
}
