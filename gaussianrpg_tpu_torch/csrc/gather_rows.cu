// Row gather: out[i] = fields[src[i]], a zero row where src[i] lies outside
// [0, n_rows) (the padding slots of a pair list, pair_src = -1).
//
// Replaces the TPU kernel `tools/gather_fold.py:65` (body `:40-63`), which
// asks whether the blend kernel could fetch its pair rows itself: per
// 128-row chunk it starts one async DMA per row from the HBM field table
// into a [128, NF] VMEM scratch, waits for all of them, and writes the
// scratch out as one [128, NF] block. Here one block of 128 threads owns one
// 128-row chunk: it reads the chunk's row ids into shared memory, stages
// every row with 16-byte `cp.async` copies (NF/4 of them a row, issued by
// neighbouring threads, so a row is one 4*NF-byte segment; the card's form
// of the per-row DMA into a chunk scratch, and the front end a blend kernel
// that gathers its own rows would have), waits for the group, and writes
// the chunk with coalesced 16-byte stores.
// Bound: bytes. Each distinct field row that src names is read once, the
// index once, the output written once (no arithmetic). The design issues
// all of a chunk's copies before waiting on any, so each block keeps 128
// row reads in flight, and the stores are whole 16-byte words.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;    // rows per block: the TPU kernel's G
constexpr int kThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__global__ void __launch_bounds__(kThreads)
    gather_rows(const float4* fields, long long n_rows, int nf4,
                const int* src, long long n_out, float4* out) {
  extern __shared__ float4 stage[];   // [kChunk * nf4]
  __shared__ int rows[kChunk];
  const long long r0 = static_cast<long long>(blockIdx.x) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                     n_out - r0));
  if (threadIdx.x < n) rows[threadIdx.x] = src[r0 + threadIdx.x];
  __syncthreads();
  const int n4 = n * nf4;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const int r = i / nf4;
    const long long s = rows[r];
    if (s >= 0 && s < n_rows)
      cp_async16(&stage[i], fields + s * nf4 + (i - r * nf4));
    else
      stage[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float4* o = out + r0 * nf4;
  for (int i = threadIdx.x; i < n4; i += kThreads) o[i] = stage[i];
}

}  // namespace

// fields [n_rows, nf] and out [n_out, nf] float32, src [n_out] int32; both
// float arrays 16-byte aligned. Returns 0, a CUDA error code, or -1 for an
// nf that is not a positive multiple of 4. A chunk wider than the 48 KB a
// block gets by default (nf above 92) opts in to more dynamic shared
// memory, up to the card's limit per block (227 KB on sm_90: nf up to 452);
// a wider one is refused with the attribute's error.
extern "C" int grpg_gather_rows(const float* fields, long long n_rows, int nf,
                                const int* src, long long n_out, float* out,
                                void* stream) {
  if (nf <= 0 || nf % 4 != 0) return -1;
  const size_t smem = sizeof(float) * static_cast<size_t>(kChunk) * nf;
  if (smem + sizeof(int) * kChunk > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (n_out == 0) return 0;
  const long long blocks = (n_out + kChunk - 1) / kChunk;
  if (blocks > 0x7FFFFFFFLL) return -1;
  gather_rows<<<static_cast<unsigned>(blocks), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(fields), n_rows, nf / 4, src, n_out,
      reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}
