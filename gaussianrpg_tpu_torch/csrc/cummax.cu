// Kernel A: fused running max (inclusive cummax) over k int32 arrays.
//
// Replaces the TPU kernel `gaussianrpg_tpu/ops/pallas_scan.py`
// (`fused_cummax`, body `_make_cummax_kernel`), which scans 64K-element
// blocks in order on the TPU's sequential grid and carries each array's
// running max between grid steps in VMEM scratch. CUDA blocks run in no
// order, so the carry becomes a single-pass scan with decoupled look-back
// (after Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016), written here for a running max:
//   - a block takes its tile from an atomic ticket, not from blockIdx, so
//     every tile before its own already belongs to a running block and
//     the look-back below cannot wait on a block that never started.
//     Ticket i is tile i / k of array i % k: the k arrays are independent
//     chains that advance together;
//   - a tile is kThreads x kItems int32, 64 a thread (64 KB): each block
//     pays a ticket, three barriers and a look-back whatever its size, and
//     16 or 32 a thread measured 30% and 8% slower at the trainer's
//     capacity (PERF.md §6). Warp w owns kItems/4 rows
//     of 128 contiguous elements; each row is one 16-byte load a lane (a
//     fully coalesced 512-byte warp access), and all of a thread's loads
//     are issued before the first is used. The tile is scanned in registers:
//     within each int4, across the lanes of each row (shuffles, four rows'
//     chains interleaved), across rows (a running carry folded into the
//     values at once, so no per-row prefix stays live), across warps
//     (shared memory);
//   - each (array, tile) has one 64-bit status word, (state << 32) | value,
//     zeroed (not ready) before the launch and written by one store, so
//     that state and value are read together by one load. A tile
//     publishes its aggregate as soon as it is known; warp 0 then reads
//     the 32 tiles before it at a time, waits until none is
//     "not ready", takes the nearest inclusive prefix by ballot and the
//     max of the aggregates after it by a warp reduction, and goes on to
//     the next 32 while no prefix was found. Tile 0 publishes its
//     aggregate as its prefix. The tile then publishes its own inclusive
//     prefix and writes its outputs, once, with 16-byte stores.
// Running max is associative, commutative and idempotent with identity
// INT_MIN, so any grouping of the look-back gives the sequential result
// bit for bit.
// Bound: bytes. The function must read each input once and write each
// output once, 8*k*P bytes; its few operations an element are far below
// the card's rate. This kernel moves exactly those bytes (plus 8 bytes of
// status a tile and the memset that zeroes them), where the three-pass
// scan it replaces read and wrote every output a second time and scanned
// the block totals in one block per array.
// Contract (kept from the TPU kernel): P is a multiple of 65536; the
// wrapper also requires 16-byte aligned, contiguous int32 arrays.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 4;
constexpr int kThreads = 256;
constexpr int kItems = 64;                       // int32 a thread
constexpr int kRows = kItems / 4;                // int4 rows a warp
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kItems % 4 == 0 && 65536 % kTile == 0,
              "a tile must be whole int4 rows and divide 65536");

// status word states (0 is what the memset leaves)
constexpr uint32_t kNotReady = 0, kAggregate = 1, kPrefix = 2;

struct Arrays {
  const int* in[kMaxK];
  int* out[kMaxK];
};

__device__ __forceinline__ uint64_t pack(uint32_t state, int v) {
  return (static_cast<uint64_t>(state) << 32) | static_cast<uint32_t>(v);
}
__device__ __forceinline__ uint32_t state_of(uint64_t s) {
  return static_cast<uint32_t>(s >> 32);
}
__device__ __forceinline__ int value_of(uint64_t s) {
  return static_cast<int>(static_cast<uint32_t>(s));
}

// Relaxed .gpu accesses: an aligned 64-bit access is single-copy atomic,
// so a reader sees a whole word, state and value together. Nothing else
// in memory is handed over through a word, so no ordering against other
// accesses is needed (st.release / ld.acquire were 2-7% slower, PERF.md).
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

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Warp 0 of tile t > 0: the max over tiles 0..t-1 of one array, from
// their status words `st`, read 32 tiles at a time.
__device__ int look_back(const uint64_t* st, int t) {
  const int lane = threadIdx.x & 31;
  int excl = INT_MIN;
  for (int last = t - 1;; last -= 32) {
    const int idx = last - lane;   // lane 0 reads the nearest tile
    // before tile 0 there is nothing: a prefix of INT_MIN
    uint64_t s = idx >= 0 ? peek(st + idx) : pack(kPrefix, INT_MIN);
    while (__any_sync(kFull, state_of(s) == kNotReady))
      if (state_of(s) == kNotReady) s = peek(st + idx);
    const unsigned pm = __ballot_sync(kFull, state_of(s) == kPrefix);
    int v = value_of(s);
    // the nearest prefix and the aggregates after it; none beyond it
    if (pm && lane > __ffs(pm) - 1) v = INT_MIN;
    excl = max(excl, warp_max(v));
    if (pm) return excl;
  }
}

__global__ void __launch_bounds__(kThreads)
cummax_lookback(Arrays a, int k, int tiles, unsigned* ticket,
                uint64_t* status) {
  __shared__ int s_ticket;
  __shared__ int warp_tot[kWarps];
  __shared__ int s_excl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int j = s_ticket % k;
  const int t = s_ticket / k;
  const long long seg = static_cast<long long>(t) * kTile +
                        static_cast<long long>(warp) * 32 * kItems;
  const int4* src = reinterpret_cast<const int4*>(a.in[j] + seg) + lane;
  int4 q[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) q[r] = src[32 * r];

  // each int4 scanned in place; then, kGroup rows at a time (their
  // shuffle chains interleaved), each row across the lanes, and the max
  // of everything before a lane's int4 folded into it
  constexpr int kGroup = 4;
  int carry = INT_MIN;
#pragma unroll
  for (int r0 = 0; r0 < kRows; r0 += kGroup) {
    int incl[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      int4& v = q[r0 + u];
      v.y = max(v.y, v.x);
      v.z = max(v.z, v.y);
      v.w = max(v.w, v.z);
      incl[u] = v.w;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int n = __shfl_up_sync(kFull, incl[u], o);
        if (lane >= o) incl[u] = max(incl[u], n);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int before = __shfl_up_sync(kFull, incl[u], 1);
      const int p = lane == 0 ? carry : max(carry, before);
      int4& v = q[r0 + u];
      v = make_int4(max(v.x, p), max(v.y, p), max(v.z, p), max(v.w, p));
      carry = max(carry, __shfl_sync(kFull, incl[u], 31));
    }
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();
  int wpre = INT_MIN, agg = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = warp_tot[w];
    if (w < warp) wpre = max(wpre, x);
    agg = max(agg, x);
  }

  if (warp == 0) {
    uint64_t* st = status + static_cast<long long>(j) * tiles;
    int excl = INT_MIN;
    if (t == 0) {
      if (lane == 0) publish(st, pack(kPrefix, agg));
    } else {
      if (lane == 0) publish(st + t, pack(kAggregate, agg));
      excl = look_back(st, t);
      if (lane == 0) publish(st + t, pack(kPrefix, max(excl, agg)));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int p = max(s_excl, wpre);
  int4* dst = reinterpret_cast<int4*>(a.out[j] + seg) + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    dst[32 * r] = make_int4(max(q[r].x, p), max(q[r].y, p), max(q[r].z, p),
                            max(q[r].w, p));
}

long long tiles_of(long long p) { return p / kTile; }

}  // namespace

// Bytes of device scratch `grpg_fused_cummax` needs for k arrays of
// length p: the ticket and one status word an (array, tile).
extern "C" long long grpg_fused_cummax_scratch_bytes(int k, long long p) {
  return 8 * (1 + static_cast<long long>(k) * tiles_of(p));
}

// ins/outs: host arrays of k device pointers; scratch: at least
// `grpg_fused_cummax_scratch_bytes(k, p)` bytes on the device, 8-byte
// aligned, zeroed here on `stream` before the launch. Returns 0, a CUDA
// error code, or -1 for a bad argument.
extern "C" int grpg_fused_cummax(const void* const* ins, void* const* outs,
                                 int k, long long p, void* scratch,
                                 void* stream) {
  if (k < 1 || k > kMaxK || p <= 0 || p % 65536 != 0) return -1;
  const long long tiles = tiles_of(p);
  if (k * tiles > INT_MAX) return -1;
  Arrays a;
  for (int j = 0; j < kMaxK; ++j) {
    a.in[j] = j < k ? static_cast<const int*>(ins[j]) : nullptr;
    a.out[j] = j < k ? static_cast<int*>(outs[j]) : nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* words = static_cast<uint64_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      words, 0, grpg_fused_cummax_scratch_bytes(k, p), s);
  if (err != cudaSuccess) return err;
  cummax_lookback<<<static_cast<unsigned>(k * tiles), kThreads, 0, s>>>(
      a, k, static_cast<int>(tiles), reinterpret_cast<unsigned*>(words),
      words + 1);
  return cudaGetLastError();
}
