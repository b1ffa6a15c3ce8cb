// The blend backward's skinny moment contraction, in two orientations.
//
// Replaces the TPU kernel `tools/mm_orient.py:62` (body `mk.kernel:25`):
// over n_steps grid steps it adds (st + x) . ba to a VMEM accumulator, with
// st [G4, P] and ba held in VMEM, f32 at HIGHEST precision, in form A
// (4G, P) x (P, C) -> [G4, C], form B (C, P) x (4G, P)^T -> [C, G4], or B
// followed by a transpose ("B+T", [G4, C]). It is the contraction of
// `gaussianrpg_tpu/ops/pallas_blend.py:_mm_pp:188`; on the TPU the question
// was which orientation the 128x128 matrix unit pads less.
// Here it is a register-tiled FP32 SIMT contraction (no tensor cores: TF32
// would break the HIGHEST/FP32 contract). Step s reads its own x[s], so no
// step can be folded into another, and every step's product is computed:
//   acc = sum_s (st + x[s]) . ba.
// Each block owns 64 rows of st and 128 of the contraction index p, and
// walks a range of steps: its ba rows sit in shared memory, and each thread
// keeps its 4 x 8 values of st in registers for the whole walk (st, like on
// the TPU, never changes) and 4 x 16 accumulators. Threads are laid out p
// slice major (a warp holds two p slices), so a warp's ba reads are
// broadcasts. The orientation decides the layout of ba and of the result:
//   form A  ba [P, C]: per p, one 64-byte row of ba (4 float4) and 64 FMAs;
//   form B  ba [C, P]: per c, 8 consecutive p of ba (2 float4) against the
//           step's 32 values of st + x[s] held in registers; result [C, G4];
//   B+T     form B's loop and accumulator, the result stored as [G4, C].
// The partial sums of each block (its p slices summed in shared memory, in
// a fixed order) go to partial[split, p block], and a second launch sums
// them in a fixed order into the output: no atomics, deterministic.
// Bound: operations, 2*G4*P*C multiply-adds plus G4*P adds a step at the
// FP32 rate; st and ba are read once.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 16;              // columns of ba, the tool's C
constexpr int kTG = 4;              // rows of st a thread owns
constexpr int kTP = 8;              // p indices a thread owns
constexpr int kRG = 16;             // row groups a block
constexpr int kPS = 16;             // p slices a block
constexpr int kThreads = kRG * kPS;  // 256
constexpr int kRows = kRG * kTG;     // 64 rows of st a block
constexpr int kCols = kPS * kTP;     // 128 p a block

enum Form { kA = 0, kB = 1, kBT = 2 };

template <bool FORM_B>
__global__ void __launch_bounds__(kThreads)
    mm_partial(const float* st, const float* ba, const float* x, int n_steps,
               int steps_per_split, int g4, int p, float* partial) {
  __shared__ float4 ba_s[kCols * kC / 4];          // 8 KB
  __shared__ float red[kPS][kRG][kC];              // 16 KB
  const int rg = threadIdx.x % kRG;
  const int ps = threadIdx.x / kRG;
  const int p0 = blockIdx.y * kCols;
  const int g0 = blockIdx.x * kRows + rg * kTG;
  // this block's rows of ba, in the form's layout
  if (!FORM_B) {          // [kCols][kC]
    const float4* src = reinterpret_cast<const float4*>(ba + p0 * kC);
    for (int i = threadIdx.x; i < kCols * kC / 4; i += kThreads)
      ba_s[i] = src[i];
  } else {                // [kC][kCols]
    for (int i = threadIdx.x; i < kCols * kC / 4; i += kThreads) {
      const int c = i / (kCols / 4);
      const int j = i % (kCols / 4);
      ba_s[i] = reinterpret_cast<const float4*>(ba + c * p + p0)[j];
    }
  }
  float st_r[kTG][kTP];
#pragma unroll
  for (int r = 0; r < kTG; ++r) {
    const float4* row = reinterpret_cast<const float4*>(
        st + static_cast<long long>(g0 + r) * p + p0 + ps * kTP);
    const float4 a = row[0], b = row[1];
    st_r[r][0] = a.x; st_r[r][1] = a.y; st_r[r][2] = a.z; st_r[r][3] = a.w;
    st_r[r][4] = b.x; st_r[r][5] = b.y; st_r[r][6] = b.z; st_r[r][7] = b.w;
  }
  float acc[kTG][kC];
#pragma unroll
  for (int r = 0; r < kTG; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
  __syncthreads();

  const int s0 = blockIdx.z * steps_per_split;
  const int s1 = min(n_steps, s0 + steps_per_split);
  const float* ba_f = reinterpret_cast<const float*>(ba_s);
  for (int s = s0; s < s1; ++s) {
    const float xs = __ldg(x + s);
    if (!FORM_B) {
#pragma unroll
      for (int j = 0; j < kTP; ++j) {
        float a[kTG];
#pragma unroll
        for (int r = 0; r < kTG; ++r) a[r] = st_r[r][j] + xs;
        const float4* brow = ba_s + (ps * kTP + j) * (kC / 4);
#pragma unroll
        for (int q = 0; q < kC / 4; ++q) {
          const float4 b = brow[q];
#pragma unroll
          for (int r = 0; r < kTG; ++r) {
            acc[r][4 * q + 0] += a[r] * b.x;
            acc[r][4 * q + 1] += a[r] * b.y;
            acc[r][4 * q + 2] += a[r] * b.z;
            acc[r][4 * q + 3] += a[r] * b.w;
          }
        }
      }
    } else {
      float a[kTG][kTP];
#pragma unroll
      for (int r = 0; r < kTG; ++r)
#pragma unroll
        for (int j = 0; j < kTP; ++j) a[r][j] = st_r[r][j] + xs;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4* bcol =
            reinterpret_cast<const float4*>(ba_f + c * kCols + ps * kTP);
        const float4 b0 = bcol[0], b1 = bcol[1];
        const float b[kTP] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < kTP; ++j)
#pragma unroll
          for (int r = 0; r < kTG; ++r) acc[r][c] += a[r][j] * b[j];
      }
    }
  }

  // sum the block's p slices (fixed order) and store its partial result
  const int part = blockIdx.z * gridDim.y + blockIdx.y;
  float* dst = partial + static_cast<long long>(part) * g4 * kC;
  const int orow = threadIdx.x / kC;   // 0..15: a row group of the block
  const int ocol = threadIdx.x % kC;
#pragma unroll
  for (int r = 0; r < kTG; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) red[ps][rg][c] = acc[r][c];
    __syncthreads();
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kPS; ++k) v += red[k][orow][ocol];
    const int g = blockIdx.x * kRows + orow * kTG + r;
    if (!FORM_B)
      dst[g * kC + ocol] = v;            // [G4, C]
    else
      dst[ocol * g4 + g] = v;            // [C, G4]
    __syncthreads();
  }
}

// out = sum over the partial results in a fixed order; B+T transposes
// form B's [C, G4] into [G4, C].
__global__ void mm_reduce(const float* partial, int n_part, int g4,
                          int transpose, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g4 * kC) return;
  float v = 0.f;
  for (int k = 0; k < n_part; ++k)
    v += partial[static_cast<long long>(k) * g4 * kC + i];
  if (transpose) {
    const int c = i / g4;
    const int g = i % g4;
    out[g * kC + c] = v;
  } else {
    out[i] = v;
  }
}

}  // namespace

// form 0 A, 1 B, 2 B+T. st [g4, p], ba [p, 16] (A) or [16, p] (B, B+T),
// x [n_steps], partial [n_split * p / 128, g4 * 16] scratch, out [g4, 16]
// (A, B+T) or [16, g4] (B); float32, 16-byte aligned. g4 a multiple of 64,
// p of 128; the steps are cut into n_split ranges, one per z block.
// Returns 0, a CUDA error code, or -1 for a bad argument.
extern "C" int grpg_mm_orient(int form, const float* st, const float* ba,
                              const float* x, int n_steps, int g4, int p,
                              int n_split, float* partial, float* out,
                              void* stream) {
  if (form < kA || form > kBT || n_steps <= 0 || g4 <= 0 || p <= 0 ||
      g4 % kRows != 0 || p % kCols != 0 || n_split <= 0 || n_split > n_steps)
    return -1;
  const int steps_per_split = (n_steps + n_split - 1) / n_split;
  n_split = (n_steps + steps_per_split - 1) / steps_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(g4 / kRows, p / kCols, n_split);
  if (form == kA)
    mm_partial<false><<<grid, kThreads, 0, s>>>(st, ba, x, n_steps,
                                                steps_per_split, g4, p,
                                                partial);
  else
    mm_partial<true><<<grid, kThreads, 0, s>>>(st, ba, x, n_steps,
                                               steps_per_split, g4, p,
                                               partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_out = g4 * kC;
  mm_reduce<<<(n_out + 255) / 256, 256, 0, s>>>(
      partial, n_split * (p / kCols), g4, form == kBT, out);
  return cudaGetLastError();
}
