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
// order, so `acc` at step c is the sum over the valid steps up to c. Which
// step's write stands in the output:
//   floor_bench, dynamic out   each last-of-tile step, to out[tile];
//   floor_bench, fixed out     the final last-of-tile step, to out[0]
//                              (the TPU rewrites out[0] at every one);
//   floor_bench2, out by tile  a valid step whose next valid step has
//                              another tile (or that has none), to
//                              out[tile];
//   floor_bench2, out by step  each valid step, to out[c].
// The output-by-tile forms assume each tile's steps are one contiguous run,
// as binning lays chunks out and the tools build their metadata. Blocks no
// step writes are left untouched, and a tile index at or past n_tiles (the
// block count of the tile-indexed arrays) reads and writes none of them.
//
// Bound: bytes. What a run's data needs: the metadata, the chunks and
// input blocks of valid steps, and the output blocks that are written;
// the few additions a float are far below the card's rate.
//
// CUDA blocks run in no order, so the carry is a single-pass scan with
// decoupled look-back, as kernel A's (`cummax.cu`), in one launch a call:
//   - a block takes a range of R = kRangeRows / BLOCK consecutive steps
//     (4096 gdata rows, so every variant has the same block count, 288
//     for the tools' 1,179,648 rows; of 2048, 4096 and 8192 rows it
//     measured best over all variants, PERF.md) from an atomic ticket, so
//     every range before its own belongs to a running block;
//   - warp 0 reads the range's metadata with one coalesced load and
//     decides valid, last and which writes stand by warp ballots; the one
//     decision that needs steps past the range (the range's final last
//     step in the fixed form, its final valid step in the out-by-tile
//     form) reads the following words 128 at a time until it is settled;
//   - the valid steps' chunks and input blocks are cut into items of 512
//     float4 (16 a lane), one warp an item, all of an item's loads issued
//     before the first is used, as streaming loads (each byte is read
//     once); a step's sum adds its items in order. A range with no valid
//     step reads no chunk byte;
//   - the block publishes its aggregate in its 64-bit status word,
//     (epoch << 34) | (state << 32) | float bits, written by one store; a
//     block that writes then takes its exclusive prefix by a look-back
//     over the kThreads ranges before it at a time (one word a thread), so
//     that ranges up to 256 back resolve in one round whether or not they
//     have published a prefix, and publishes its inclusive prefix;
//   - it writes its standing output blocks, acc = exclusive prefix +
//     the range's inclusive prefix at the step, with 16-byte streaming
//     stores spread over all its threads.
// The scratch (the ticket and the status words) needs no memset a call:
// the wrapper zeroes it once and passes each call a new epoch, a word
// whose epoch is not the call's reads as not ready, and the ticket wraps
// to 0 after the grid's last block (atomicInc). Each output block is
// written by one block of the grid. Where nothing is written (the skip-all
// forms of floor_bench2) a block reads its metadata, publishes a zero
// aggregate and exits: the call is one launch of 288 short blocks, where
// the two-pass form it replaces launched two grids of one block a step
// (18,432 blocks at 9216 steps).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNF = 16;            // gdata columns, the tools' NF
constexpr int kRangeRows = 4096;   // gdata rows of one block's range
constexpr int kItem4 = 512;        // float4 a warp reduces at once
constexpr int kLoads = kItem4 / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileMask = 0xFFFFFF;
// a range's steps are one warp's lanes at the smallest block, 128 rows
static_assert(kRangeRows / 128 <= 32, "a range must fit one warp");

// status word states; a word of an earlier call reads as kNotReady
constexpr uint32_t kNotReady = 0, kAggregate = 1, kPrefix = 2;

enum Mode {
  kLastTile = 0,       // floor_bench, dynamic out
  kLastTileFixed = 1,  // floor_bench, fixed out
  kValidTile = 2,      // floor_bench2, out by tile
  kValidStep = 3,      // floor_bench2, out by step
};

__device__ __forceinline__ bool is_last(int m) { return (m >> 25) & 1; }
__device__ __forceinline__ bool is_valid(int m) { return (m >> 26) & 1; }
__device__ __forceinline__ int tile_of(int m) { return m & kTileMask; }

// A status word: (epoch << 34) | (state << 32) | float bits, the epoch
// being the call's (1 .. 2^30 - 1, passed by the wrapper).
__device__ __forceinline__ uint64_t pack(uint32_t epoch, uint32_t state,
                                         float v) {
  return (static_cast<uint64_t>((epoch << 2) | state) << 32) |
         __float_as_uint(v);
}
// The state of a word this call wrote; kNotReady for any other word.
__device__ __forceinline__ uint32_t state_of(uint64_t s, uint32_t epoch) {
  const uint32_t tag = static_cast<uint32_t>(s >> 32);
  return (tag >> 2) == epoch ? (tag & 3) : kNotReady;
}
__device__ __forceinline__ float value_of(uint64_t s) {
  return __uint_as_float(static_cast<uint32_t>(s));
}

// Relaxed .gpu accesses, as in cummax.cu: an aligned 64-bit access is
// single-copy atomic, so a reader sees state and value together; nothing
// else in memory is handed over through a word.
__device__ __forceinline__ void publish(uint64_t* w, uint64_t s) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(w), "l"(s) : "memory");
}

__device__ __forceinline__ uint64_t peek(const uint64_t* w) {
  uint64_t s;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(s) : "l"(w) : "memory");
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float sum4(float4 q) {
  return (q.x + q.y) + (q.z + q.w);
}

// Warp 0: the metadata word of the first step at or after `from` whose
// metadata has bit `bit` set, or -1 (no word is negative) when none has.
// Reads 128 words at a time, all four loads a lane issued together.
__device__ int first_with_bit(const int* cm, int from, int n_steps, int bit) {
  const int lane = threadIdx.x & 31;
  for (int k = from; k < n_steps; k += 128) {
    int m[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = k + 32 * r + lane;
      m[r] = i < n_steps ? __ldg(cm + i) : 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned hit = __ballot_sync(kFull, (m[r] >> bit) & 1);
      if (hit) return __shfl_sync(kFull, m[r], __ffs(hit) - 1);
    }
  }
  return -1;
}

// The whole block, for range b > 0: the sum of the aggregates of ranges
// 0..b-1, from their status words, kThreads ranges at a time. Thread t
// reads range b-1-t; the nearest range that has published its inclusive
// prefix ends the walk, and the aggregates after it are added to it.
__device__ float look_back(const uint64_t* st, int b, uint32_t epoch,
                           int* s_first, float* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float excl = 0.f;
  for (int hi = b - 1;; hi -= kThreads) {
    const int idx = hi - static_cast<int>(threadIdx.x);
    // before range 0 there is nothing: a prefix of 0
    uint64_t s = idx >= 0 ? peek(st + idx) : pack(epoch, kPrefix, 0.f);
    while (state_of(s, epoch) == kNotReady) s = peek(st + idx);
    const unsigned pm = __ballot_sync(kFull, state_of(s, epoch) == kPrefix);
    if (lane == 0) s_first[warp] = pm ? 32 * warp + __ffs(pm) - 1 : kThreads;
    __syncthreads();
    int first = kThreads;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) first = min(first, s_first[w]);
    const float v = warp_sum(
        static_cast<int>(threadIdx.x) <= first ? value_of(s) : 0.f);
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) excl += s_red[w];
    __syncthreads();   // s_first and s_red are reused by the next round
    if (first < kThreads) return excl;
  }
}

struct Args {
  const float4* gdata;  // [n_steps * BLOCK, 16]
  const int* cm;        // [n_steps] chunk metadata
  int n_steps;
  const float4* in0;    // [n_blocks, out_elems] extra inputs (floor_bench2)
  const float4* in1;
  float4* out;          // [n_out, out_elems]
  int out4;             // out_elems / 4
  int n_tiles;          // blocks of the tile-indexed arrays
  uint32_t epoch;       // the call's tag for its status words
};

// Item j of a range's valid steps (ips items a step: its chunk's, then
// each input's blocks'): where its float4s start, and their count (len).
template <int kChunkItems, bool DYN_IN>
__device__ __forceinline__ const float4* item(const Args& a, int j, int ips,
                                              int in_items, int base,
                                              const int* s_vlist,
                                              const int* s_meta, int& len) {
  const int vi = j / ips, p = j - vi * ips;
  const int i = s_vlist[vi];
  const long long c = base + i;
  len = kItem4;
  if (p < kChunkItems) return a.gdata + (c * kChunkItems + p) * kItem4;
  const int pi = p - kChunkItems;
  const int k = pi / in_items, pp = pi - k * in_items;
  const long long blk = DYN_IN ? tile_of(s_meta[i]) : c;
  len = (DYN_IN && blk >= a.n_tiles) ? 0 : min(kItem4, a.out4 - pp * kItem4);
  return (k == 0 ? a.in0 : a.in1) + blk * a.out4 + pp * kItem4;
}

template <int BLOCK, int N_IN, bool DYN_IN, int MODE>
__global__ void __launch_bounds__(kThreads)
    step_floor(Args a, int in_items, unsigned* ticket, uint64_t* status) {
  constexpr int R = kRangeRows / BLOCK;          // steps of a range
  constexpr int kChunkItems = BLOCK * kNF / 4 / kItem4;
  extern __shared__ float s_part[];              // [R * items a step]
  __shared__ int s_meta[R];
  __shared__ int s_vlist[R];                     // valid steps, in order
  __shared__ float s_incl[R];                    // sums, then prefixes
  __shared__ int s_wstep[R];                     // standing writes
  __shared__ long long s_wdst[R];
  __shared__ int s_b, s_nv, s_nw;
  __shared__ float s_excl;
  __shared__ int s_first[kWarps];
  __shared__ float s_red[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the ticket wraps to 0 after the grid's last block, ready for the next
  // call on the same scratch
  if (threadIdx.x == 0)
    s_b = static_cast<int>(atomicInc(ticket, gridDim.x - 1));
  __syncthreads();
  const int b = s_b;
  const int base = b * R;
  const int n = min(R, a.n_steps - base);

  // metadata, lane i holding step i: valid list, standing writes inside
  // the range, and the one step whose write depends on the steps after
  // the range (pend)
  unsigned wmask = 0;
  int m = 0, pend = -1;
  if (warp == 0) {
    m = lane < n ? __ldg(a.cm + base + lane) : 0;   // absent: no bits
    if (lane < R) {
      s_meta[lane] = m;
      s_incl[lane] = 0.f;
    }
    const unsigned vmask = __ballot_sync(kFull, is_valid(m));
    if (is_valid(m)) s_vlist[__popc(vmask & ((1u << lane) - 1))] = lane;
    const int tile = tile_of(m);
    bool w = false;
    if (MODE == kLastTile) {
      w = is_last(m) && tile < a.n_tiles;
    } else if (MODE == kValidStep) {
      w = is_valid(m);
    } else if (MODE == kLastTileFixed) {
      const unsigned lm = __ballot_sync(kFull, is_last(m));
      if (lm) pend = 31 - __clz(lm);   // the highest wins
    } else {   // kValidTile: the next valid step in the range
      const unsigned above = lane == 31 ? 0u : vmask >> (lane + 1);
      const int next_tile = __shfl_sync(kFull, tile,
                                        above ? lane + __ffs(above) : lane);
      if (is_valid(m)) {
        if (above) w = next_tile != tile && tile < a.n_tiles;
        else if (tile < a.n_tiles) pend = lane;   // decided past the range
      }
      pend = __reduce_max_sync(kFull, pend);
    }
    wmask = __ballot_sync(kFull, w);
    if (lane == 0) s_nv = __popc(vmask);
  }
  __syncthreads();

  // the valid steps' sums: items of 512 float4, one warp an item
  const int nv = s_nv;
  if (nv > 0) {
    const int ips = kChunkItems + N_IN * in_items;   // items a step
    for (int j = warp; j < nv * ips; j += kWarps) {
      int len;
      const float4* src = item<kChunkItems, DYN_IN>(
          a, j, ips, in_items, base, s_vlist, s_meta, len);
      float4 q[kLoads];
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        const int e = 32 * r + lane;
        q[r] = e < len ? __ldcs(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < kLoads; ++r) v += sum4(q[r]);
      v = warp_sum(v);
      if (lane == 0) s_part[j] = v;
    }
    __syncthreads();
    for (int vi = threadIdx.x; vi < nv; vi += kThreads) {
      float v = 0.f;
      for (int p = 0; p < ips; ++p) v += s_part[vi * ips + p];
      s_incl[s_vlist[vi]] = v;
    }
    __syncthreads();
  }

  if (warp == 0) {
    // the range's inclusive prefix, lane i holding step i
    float incl = lane < R ? s_incl[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane < R) s_incl[lane] = incl;
    const float agg = __shfl_sync(kFull, incl, 31);
    if (lane == 0)
      publish(status + b, pack(a.epoch, b == 0 ? kPrefix : kAggregate, agg));

    // the decision that needs the steps after the range
    if ((MODE == kLastTileFixed || MODE == kValidTile) && pend >= 0) {
      const int bit = MODE == kLastTileFixed ? 25 : 26;
      const int next = first_with_bit(a.cm, base + n, a.n_steps, bit);
      const bool stands =
          MODE == kLastTileFixed
              ? next < 0
              : next < 0 || tile_of(next) != tile_of(s_meta[pend]);
      if (stands) wmask |= 1u << pend;
    }
    if ((wmask >> lane) & 1) {
      const int slot = __popc(wmask & ((1u << lane) - 1));
      s_wstep[slot] = lane;
      s_wdst[slot] = MODE == kValidStep        ? base + lane
                     : MODE == kLastTileFixed ? 0
                                              : tile_of(m);
    }
    if (lane == 0) {
      s_nw = __popc(wmask);
      s_excl = 0.f;
    }
  }
  __syncthreads();
  const int nw = s_nw;
  if (nw == 0) return;
  if (b > 0) {
    const float excl = look_back(status, b, a.epoch, s_first, s_red);
    if (threadIdx.x == 0) {
      publish(status + b, pack(a.epoch, kPrefix, excl + s_incl[R - 1]));
      s_excl = excl;
    }
    __syncthreads();
  }
  const float excl = s_excl;
  for (int w = 0; w < nw; ++w) {
    const float v = excl + s_incl[s_wstep[w]];
    const float4 q = make_float4(v, v, v, v);
    float4* o = a.out + s_wdst[w] * a.out4;
    for (int e = threadIdx.x; e < a.out4; e += kThreads) __stcs(o + e, q);
  }
}

int blocks_of(int n_steps, int block) {
  const int r = kRangeRows / block;
  return (n_steps + r - 1) / r;
}

template <int BLOCK, int N_IN, bool DYN_IN, int MODE>
int run(const Args& a, void* scratch, cudaStream_t s) {
  constexpr int R = kRangeRows / BLOCK;
  const int nb = blocks_of(a.n_steps, BLOCK);
  const int in_items = (a.out4 + kItem4 - 1) / kItem4;
  const size_t smem =
      sizeof(float) * R * (BLOCK * kNF / 4 / kItem4 + N_IN * in_items);
  if (smem > 48 * 1024) return -1;
  uint64_t* words = static_cast<uint64_t*>(scratch);
  step_floor<BLOCK, N_IN, DYN_IN, MODE><<<nb, kThreads, smem, s>>>(
      a, in_items, reinterpret_cast<unsigned*>(words), words + 1);
  return cudaGetLastError();
}

template <int BLOCK>
int floor_bench(const Args& a, int dyn_out, void* scratch, cudaStream_t s) {
  return dyn_out ? run<BLOCK, 0, false, kLastTile>(a, scratch, s)
                 : run<BLOCK, 0, false, kLastTileFixed>(a, scratch, s);
}

template <int N_IN, bool DYN_IN>
int floor_bench2(const Args& a, int dyn_out, void* scratch, cudaStream_t s) {
  return dyn_out ? run<128, N_IN, DYN_IN, kValidTile>(a, scratch, s)
                 : run<128, N_IN, DYN_IN, kValidStep>(a, scratch, s);
}

bool bad_args(int n_steps, int out_elems, int n_tiles, unsigned epoch) {
  return n_steps <= 0 || out_elems <= 0 || out_elems % 4 != 0 ||
         n_tiles <= 0 || epoch == 0 || epoch >= (1u << 30);
}

}  // namespace

// Steps of one block's range at a block size (gdata rows a chunk): 4096
// rows' worth. The wrappers' Python constant RANGE_ROWS mirrors it.
extern "C" int grpg_step_floor_range(int block) {
  return block > 0 && kRangeRows % block == 0 ? kRangeRows / block : -1;
}

// Bytes of device scratch both entries need for n_steps chunks of `block`
// rows: the ticket and one status word a range (8-byte aligned). The
// caller zeroes it once and keeps it for its calls on one stream: each
// call leaves the ticket at 0 and tags its words with its own epoch.
extern "C" long long grpg_step_floor_scratch_bytes(int n_steps, int block) {
  if (n_steps <= 0 || grpg_step_floor_range(block) <= 0) return -1;
  return 8 * (1 + static_cast<long long>(blocks_of(n_steps, block)));
}

// floor_bench: gdata [n_steps * block, 16] float32, chunk_meta [n_steps]
// int32, scratch of at least grpg_step_floor_scratch_bytes(n_steps, block)
// (see there) with the call's epoch (1 .. 2^30 - 1, other than the
// previous calls' on the same scratch since it was zeroed), out [n_tiles,
// out_elems] float32 (16-byte aligned arrays, out_elems a multiple of 4;
// dyn_out: out[tile], else out[0]). Returns 0, a CUDA error code, or -1
// for a block size other than 128, 256, 512 or 1024 or a bad argument.
extern "C" int grpg_floor_bench(const float* gdata, const int* chunk_meta,
                                int n_steps, int block, int dyn_out,
                                void* scratch, unsigned epoch, float* out,
                                int out_elems, int n_tiles, void* stream) {
  if (bad_args(n_steps, out_elems, n_tiles, epoch)) return -1;
  const Args a{reinterpret_cast<const float4*>(gdata), chunk_meta, n_steps,
               nullptr, nullptr, reinterpret_cast<float4*>(out),
               out_elems / 4, n_tiles, epoch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: return floor_bench<128>(a, dyn_out, scratch, s);
    case 256: return floor_bench<256>(a, dyn_out, scratch, s);
    case 512: return floor_bench<512>(a, dyn_out, scratch, s);
    case 1024: return floor_bench<1024>(a, dyn_out, scratch, s);
    default: return -1;
  }
}

// floor_bench2: gdata [n_steps * 128, 16], n_in (0-2) input arrays indexed
// by tile ([n_tiles, out_elems], dyn_in) or by step ([n_steps, out_elems]),
// scratch and epoch as for grpg_floor_bench (block 128), out indexed by
// tile ([n_tiles, out_elems], dyn_out) or by step ([n_steps, out_elems]).
// Returns as grpg_floor_bench.
extern "C" int grpg_floor_bench2(const float* gdata, const int* chunk_meta,
                                 int n_steps, const float* in0,
                                 const float* in1, int n_in, int dyn_in,
                                 int dyn_out, void* scratch, unsigned epoch,
                                 float* out, int out_elems, int n_tiles,
                                 void* stream) {
  if (bad_args(n_steps, out_elems, n_tiles, epoch)) return -1;
  const Args a{reinterpret_cast<const float4*>(gdata), chunk_meta, n_steps,
               reinterpret_cast<const float4*>(in0),
               reinterpret_cast<const float4*>(in1),
               reinterpret_cast<float4*>(out), out_elems / 4, n_tiles,
               epoch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_in == 0) return floor_bench2<0, false>(a, dyn_out, scratch, s);
  if (n_in == 1)
    return dyn_in ? floor_bench2<1, true>(a, dyn_out, scratch, s)
                  : floor_bench2<1, false>(a, dyn_out, scratch, s);
  if (n_in == 2)
    return dyn_in ? floor_bench2<2, true>(a, dyn_out, scratch, s)
                  : floor_bench2<2, false>(a, dyn_out, scratch, s);
  return -1;
}
