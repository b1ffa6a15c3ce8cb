// Grid-step floor microbenchmarks of the blend kernels' TPU layout: one
// source for `floor_bench` and `floor_bench2`, which differ only in the
// template parameters below.
//
// Replaces the TPU kernels `tools/floor_bench.py:84` (body `make_kernel:44`)
// and `tools/floor_bench2.py:71` (body `make_kernel:48`). Both walk a grid
// of n_steps chunks of gdata [n_steps * BLOCK, 16] under packed chunk
// metadata (tile | last << 25 | valid << 26) and carry a running `acc` in
// VMEM from step to step: a valid step adds the sum of its chunk (and, in
// floor_bench2, of 0-2 extra [5, 2048] input blocks indexed by the step's
// tile or by the step), and the step then writes `acc` to an output block
// indexed by the tile, by the step, or fixed. On the TPU the grid runs in
// order, so `acc` at step c is the sum over the valid steps up to c.
// CUDA blocks run in no order, so that sum is computed explicitly:
//   pass 1  one block per TPU grid step reads its metadata and, for a
//           valid step, reduces its chunk and input blocks to sums[c]
//           (0 for an invalid step);
//   pass 2  one block per TPU grid step decides whether the step's write
//           is the one that stands in the output (below), and if so sums
//           sums[0..c] (the prefix the TPU carried in acc) and writes it to
//           every element of the output block.
// No atomics: each output block is written by one block of pass 2. Which
// step's write stands:
//   floor_bench, dynamic out   each last-of-tile step, to out[tile];
//   floor_bench, fixed out     the final last-of-tile step, to out[0]
//                              (the TPU rewrites out[0] at every one);
//   floor_bench2, out by tile  a valid step with no later valid step in
//                              its tile's run of steps, to out[tile];
//   floor_bench2, out by step  each valid step, to out[c].
// The output-by-tile forms assume each tile's steps are one contiguous run,
// as binning lays chunks out and the tools build their metadata. Blocks no
// step writes are left untouched, and a tile index at or past n_tiles (the
// block count of the tile-indexed arrays) reads and writes none of them.
// Bound: bytes. What a run's data needs: the metadata, the chunks and
// input blocks of valid steps, and the output blocks that are written.
// Pass 1 reads a chunk with 16-byte loads; pass 2's prefix reads n_steps
// floats from L2, far below the output block it writes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNF = 16;        // gdata columns, the tools' NF

enum Mode {
  kLastTile = 0,       // floor_bench, dynamic out
  kLastTileFixed = 1,  // floor_bench, fixed out
  kValidTile = 2,      // floor_bench2, out by tile
  kValidStep = 3,      // floor_bench2, out by step
};

__device__ __forceinline__ float sum4(float4 q) {
  return (q.x + q.y) + (q.z + q.w);
}

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

template <int BLOCK, int N_IN, bool DYN_IN>
__global__ void __launch_bounds__(kThreads)
    step_sums(const float4* gdata, const int* cm, const float4* in0,
              const float4* in1, int out4, int n_tiles, float* sums) {
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x;
  const int meta = cm[c];
  if (!((meta >> 26) & 1)) {
    if (threadIdx.x == 0) sums[c] = 0.f;
    return;
  }
  constexpr int kBlock4 = BLOCK * kNF / 4;
  const float4* g = gdata + static_cast<long long>(c) * kBlock4;
  float v = 0.f;
#pragma unroll
  for (int i = threadIdx.x; i < kBlock4; i += kThreads) v += sum4(g[i]);
  const long long b = DYN_IN ? (meta & 0xFFFFFF) : c;
  const bool in_ok = !DYN_IN || b < n_tiles;
  if (N_IN > 0 && in_ok)
    for (int i = threadIdx.x; i < out4; i += kThreads)
      v += sum4(in0[b * out4 + i]);
  if (N_IN > 1 && in_ok)
    for (int i = threadIdx.x; i < out4; i += kThreads)
      v += sum4(in1[b * out4 + i]);
  v = block_sum(v, red);
  if (threadIdx.x == 0) sums[c] = v;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    write_steps(const int* cm, int n_steps, const float* sums, float4* out,
                int out4, int n_tiles) {
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x;
  const int meta = cm[c];
  const int tile = meta & 0xFFFFFF;
  long long dst;
  if (MODE == kLastTile || MODE == kLastTileFixed) {
    if (!((meta >> 25) & 1)) return;
    dst = tile;
    if (MODE == kLastTile && tile >= n_tiles) return;
    if (MODE == kLastTileFixed) {
      for (int k = c + 1; k < n_steps; ++k)
        if ((cm[k] >> 25) & 1) return;
      dst = 0;
    }
  } else {
    if (!((meta >> 26) & 1)) return;
    dst = c;
    if (MODE == kValidTile) {
      for (int k = c + 1; k < n_steps && (cm[k] & 0xFFFFFF) == tile; ++k)
        if ((cm[k] >> 26) & 1) return;
      if (tile >= n_tiles) return;
      dst = tile;
    }
  }
  float v = 0.f;
  for (int k = threadIdx.x; k <= c; k += kThreads) v += sums[k];
  v = block_sum(v, red);
  const float4 q = make_float4(v, v, v, v);
  float4* o = out + dst * out4;
  for (int i = threadIdx.x; i < out4; i += kThreads) o[i] = q;
}

struct Args {
  const float* gdata;  // [n_steps * BLOCK, 16]
  const int* cm;       // [n_steps] chunk metadata
  int n_steps;
  const float* in0;    // [n_blocks, out_elems] extra inputs (floor_bench2)
  const float* in1;
  float* sums;         // [n_steps] scratch
  float* out;          // [n_out, out_elems]
  int out_elems;
  int n_tiles;         // blocks of the tile-indexed arrays
};

template <int BLOCK, int N_IN, bool DYN_IN, int MODE>
int run(const Args& a, cudaStream_t s) {
  const int out4 = a.out_elems / 4;
  step_sums<BLOCK, N_IN, DYN_IN><<<a.n_steps, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(a.gdata), a.cm,
      reinterpret_cast<const float4*>(a.in0),
      reinterpret_cast<const float4*>(a.in1), out4, a.n_tiles, a.sums);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  write_steps<MODE><<<a.n_steps, kThreads, 0, s>>>(
      a.cm, a.n_steps, a.sums, reinterpret_cast<float4*>(a.out), out4,
      a.n_tiles);
  return cudaGetLastError();
}

template <int BLOCK>
int floor_bench(const Args& a, int dyn_out, cudaStream_t s) {
  return dyn_out ? run<BLOCK, 0, false, kLastTile>(a, s)
                 : run<BLOCK, 0, false, kLastTileFixed>(a, s);
}

template <int N_IN, bool DYN_IN>
int floor_bench2(const Args& a, int dyn_out, cudaStream_t s) {
  return dyn_out ? run<128, N_IN, DYN_IN, kValidTile>(a, s)
                 : run<128, N_IN, DYN_IN, kValidStep>(a, s);
}

}  // namespace

// floor_bench: gdata [n_steps * block, 16] float32, chunk_meta [n_steps]
// int32, sums [n_steps] float32 scratch, out [n_tiles, out_elems] float32
// (16-byte aligned arrays, out_elems a multiple of 4; dyn_out: out[tile],
// else out[0]). Returns 0, a CUDA error code, or -1 for a block size other
// than 128, 256, 512 or 1024 or a bad argument.
extern "C" int grpg_floor_bench(const float* gdata, const int* chunk_meta,
                                int n_steps, int block, int dyn_out,
                                float* sums, float* out, int out_elems,
                                int n_tiles, void* stream) {
  if (n_steps <= 0 || out_elems <= 0 || out_elems % 4 != 0 || n_tiles <= 0)
    return -1;
  const Args a{gdata, chunk_meta, n_steps, nullptr, nullptr,
               sums,  out,        out_elems, n_tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: return floor_bench<128>(a, dyn_out, s);
    case 256: return floor_bench<256>(a, dyn_out, s);
    case 512: return floor_bench<512>(a, dyn_out, s);
    case 1024: return floor_bench<1024>(a, dyn_out, s);
    default: return -1;
  }
}

// floor_bench2: gdata [n_steps * 128, 16], n_in (0-2) input arrays indexed
// by tile ([n_tiles, out_elems], dyn_in) or by step ([n_steps, out_elems]),
// out indexed by tile ([n_tiles, out_elems], dyn_out) or by step
// ([n_steps, out_elems]). Returns as grpg_floor_bench.
extern "C" int grpg_floor_bench2(const float* gdata, const int* chunk_meta,
                                 int n_steps, const float* in0,
                                 const float* in1, int n_in, int dyn_in,
                                 int dyn_out, float* sums, float* out,
                                 int out_elems, int n_tiles, void* stream) {
  if (n_steps <= 0 || out_elems <= 0 || out_elems % 4 != 0 || n_tiles <= 0)
    return -1;
  const Args a{gdata, chunk_meta, n_steps, in0, in1,
               sums,  out,        out_elems, n_tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_in == 0) return floor_bench2<0, false>(a, dyn_out, s);
  if (n_in == 1)
    return dyn_in ? floor_bench2<1, true>(a, dyn_out, s)
                  : floor_bench2<1, false>(a, dyn_out, s);
  if (n_in == 2)
    return dyn_in ? floor_bench2<2, true>(a, dyn_out, s)
                  : floor_bench2<2, false>(a, dyn_out, s);
  return -1;
}
