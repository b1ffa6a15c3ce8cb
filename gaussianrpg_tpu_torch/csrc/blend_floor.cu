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
//   stage       stages the tile's chunks in shared memory as kernel B
//               does (blend_fwd.cu): two chunk buffers, one thread starts
//               the bulk copy (cp.async.bulk on an mbarrier) of chunk c+1
//               while the block consumes chunk c, the same barriers and
//               parity. Consuming a chunk is summing it (block reduction)
//               instead of blending it. The last chunk's sum goes to
//               every element of the block, which is k_meta's result (its
//               acc is never accumulated), and the sum over all the chunks
//               staged to staged[tile], so that a check sees every chunk
//               of the range staged;
//   stage_done  the same, with kernel B's `__syncthreads_count` live test
//               as the barrier before each chunk. No
//               pixel is ever done here, as none is in k_ndone.
// So `stage` minus `empty` is the cost of kernel B's present staging on the
// same inputs. One block walks a tile's range in order: the tile with the
// most chunks sets the kernel's tail (`tools/blend_floor.py` records it).
// Bound: bytes. Each chunk of a written tile is read once (128*NF floats),
// each written tile's block written once; the sums are one add a float.
// The variants exist to be timed beside kernel B on the same inputs
// (`gaussianrpg_tpu_torch/tools/blend_floor.py`), so they copy its loop
// and do nothing to be faster than it.

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using blend_tile::barrier_init;
using blend_tile::barrier_init_fence;
using blend_tile::barrier_wait;
using blend_tile::bulk_load;
using blend_tile::kChunk;

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
  extern __shared__ __align__(128) float chunks[];   // [2][kChunk * nf]
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float red[kThreads / 32];
  const int tile = blockIdx.x;
  const int c0 = tile_start[tile];
  const int c1 = tile_end[tile];
  if (c0 < 0 || c1 <= c0) return;
  float keep = 0.f, total = 0.f;
  if (VARIANT != kEmpty) {
    const int rows = kChunk * nf;
    const uint32_t bytes = static_cast<uint32_t>(rows * sizeof(float));
    if (threadIdx.x == 0) {
      barrier_init(&bars[0]);
      barrier_init(&bars[1]);
      barrier_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_load(chunks, gdata + static_cast<long long>(c0) * rows, bytes,
                &bars[0]);
    const bool done = false;
    for (int c = c0; c < c1; ++c) {
      const int i = c - c0, buf = i & 1;
      // barrier: also keeps the readers of chunk c-1 (buffer buf^1) ahead
      // of the copy into it
      if (VARIANT == kStageDone) {
        if (__syncthreads_count(!done) == 0) {
          if (threadIdx.x == 0) barrier_wait(&bars[buf], (i >> 1) & 1);
          break;
        }
      } else {
        __syncthreads();
      }
      if (threadIdx.x == 0 && c + 1 < c1)
        bulk_load(chunks + (buf ^ 1) * rows,
                  gdata + static_cast<long long>(c + 1) * rows, bytes,
                  &bars[buf ^ 1]);
      barrier_wait(&bars[buf], (i >> 1) & 1);
      const float4* ch = reinterpret_cast<const float4*>(chunks + buf * rows);
      float v = 0.f;
      for (int q = threadIdx.x; q < rows / 4; q += kThreads) {
        const float4 x = ch[q];
        v += (x.x + x.y) + (x.z + x.w);
      }
      keep = block_sum(v, red);
      total += keep;
    }
  }
  if (threadIdx.x == 0) staged[tile] = total;
  float* o = out + static_cast<long long>(tile) * 5 * n_pix;
  for (int i = threadIdx.x; i < 5 * n_pix; i += kThreads) o[i] = keep;
}

// the two chunk buffers
size_t smem_bytes(int nf) {
  return 2 * sizeof(float) * static_cast<size_t>(kChunk) * nf;
}

template <int VARIANT>
int launch(const float* gdata, int nf, const int* tile_start,
           const int* tile_end, float* out, float* staged, int n_tiles,
           int n_pix, cudaStream_t s) {
  const size_t smem = smem_bytes(nf);
  blend_floor<VARIANT><<<n_tiles, kThreads, smem, s>>>(
      gdata, nf, tile_start, tile_end, out, staged, n_pix);
  return cudaGetLastError();
}

}  // namespace

// variant 0 empty, 1 stage, 2 stage_done. gdata [capacity, nf] float32
// (16-byte aligned, nf <= 48: the two chunk buffers within 48 KB),
// tile_start / tile_end [n_tiles] int32, out
// [n_tiles, 5, n_pix] and staged [n_tiles] float32; the entries of tiles
// without chunks are left untouched. Returns 0, a CUDA error code, or -1
// for a bad argument.
extern "C" int grpg_blend_floor(int variant, const float* gdata, int nf,
                                const int* tile_start, const int* tile_end,
                                float* out, float* staged, int n_tiles,
                                int n_pix, void* stream) {
  if (nf <= 0 || nf % 4 != 0 || n_pix <= 0 ||
      reinterpret_cast<uintptr_t>(gdata) % 16 != 0)
    return -1;
  if (smem_bytes(nf) > 48 * 1024) return -1;
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
