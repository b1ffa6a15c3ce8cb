// The rasterizer's eval primitive stage: one thread per Gaussian, every
// intermediate in registers, the whole of `ops/rasterize.FieldSet` written
// in one pass.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses its elementwise graph into a few loops. PyTorch runs it eagerly as
// ~350 elementwise launches over strided column views and 14 column
// stacks, each over all N rows; on the street frame's 4,325,376 slots that
// was most of the rasterizer's device time. The stage is elementwise per
// Gaussian, so one kernel computes it from the inputs to the outputs.
//
// What a row computes (ops/projection.preprocess, ops/math3d
// build_covariance, ops/rasterize.primitive_fields_plain): the view
// transform and near-plane test; the 4x4 projection with its 1e-7
// denominator guard; the world covariance from the unnormalised
// quaternion and the scale modifier (or the precomputed one); the EWA
// 2D covariance with the 1.3 tan-FOV clamp and the +0.3 low-pass; the
// conic, the eigenvalue and the radius; the pixel mean; the tile rect,
// tightened by opacity where asked; visibility and the masked radius; the
// field row [mean, conic, opacity, colour, depth, radius, semantics,
// zero padding] and the rect, radius, depth and mean outputs.
//
// Numerics: the outputs equal the PyTorch composition's bit for bit.
// Each PyTorch op rounds on its own, and nvcc would contract a*b+c into
// one fused multiply-add, so every operation here is a round-to-nearest
// intrinsic in the composition's order: its clamps pass NaN through as
// PyTorch's do, a division by a Python number is a product with the
// float reciprocal (as PyTorch computes `tensor / scalar` on the card),
// `1.0 / t` is the reciprocal times 1.0, Python's double constants are
// rounded to float, and `torch.sum` over a row of three is taken in the
// order of its reduction kernel (`sum3`).
//
// Bound: bytes. A row reads 57 B (mean 12, scale 12, rotation 16,
// opacity 4, colour 12, mask 1) and writes 32 + 4*NF B (the NF-column
// field row, two rects 16, radius 4, depth 4, mean 8): 153 B at NF = 16,
// 662 MB for the street frame, 0.20 ms at 3.35 TB/s; ~200 FP32 operations
// a row are far below the card's rate. The design: inputs are read once
// into registers; a block of 128 rows stages its field rows in shared
// memory (pitch NF + 1, so a thread's column writes fall in distinct
// banks) and writes them as one contiguous span with coalesced stores; the
// other outputs are contiguous per thread. The camera's matrices are read
// from device memory at each launch, so a CUDA graph replay that copies
// in a new camera is seen.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;   // rows per block

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
// `1.0 / t` in PyTorch: the reciprocal, times 1.0
__device__ __forceinline__ float rdiv1(float t) {
  return mul(div(1.f, t), 1.f);
}
// torch.clamp with scalar bounds: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.minimum of two float tensors: NaN propagates
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// `.to(torch.int32)` of a float
__device__ __forceinline__ int to_i32(float v) { return __float2int_rz(v); }

// torch.sum over a contiguous row of three on the card: the reduction
// kernel gives the row two lanes (lane 0 the terms 0 and 2, lane 1 the
// term 1), each adds its terms into a zero accumulator, and lane 0 adds
// lane 1's sum to its own
__device__ __forceinline__ float sum3(float p0, float p1, float p2) {
  return add(add(add(0.f, p0), add(0.f, p2)), add(0.f, p1));
}

// row `r` of (M @ [x, y, z, 1]) for a row-major 4x4 M, as
// `projection.transform_point_4x3` sums it
__device__ __forceinline__ float affine(const float* m, int r, float x,
                                       float y, float z) {
  return add(add(add(mul(m[4 * r], x), mul(m[4 * r + 1], y)),
                 mul(m[4 * r + 2], z)),
             m[4 * r + 3]);
}

// a^T Sigma b for the packed symmetric Sigma, as `compute_cov2d.quad`
__device__ __forceinline__ float quad(const float* a, const float* b,
                                      const float* s) {
  const float xx = s[0], xy = s[1], xz = s[2], yy = s[3], yz = s[4],
              zz = s[5];
  const float s0 = add(add(mul(xx, b[0]), mul(xy, b[1])), mul(xz, b[2]));
  const float s1 = add(add(mul(xy, b[0]), mul(yy, b[1])), mul(yz, b[2]));
  const float s2 = add(add(mul(xz, b[0]), mul(yz, b[1])), mul(zz, b[2]));
  return add(add(mul(a[0], s0), mul(a[1], s1)), mul(a[2], s2));
}

// `tile_rect`'s fl: clamp(floor(v), 0, hi) as int32
__device__ __forceinline__ int tile_floor(float v, float hi) {
  return to_i32(clamp(floorf(v), 0.f, hi));
}

struct Args {
  const float* means3d;      // [N, 3]
  const float* scales;       // [N, 3] (unread with cov3d)
  const float* rotations;    // [N, 4] (w, x, y, z), unnormalised
  const float* cov3d;        // [N, 6] or null
  const float* opacities;    // [N]
  const float* colors;       // [N, 3]
  const float* semantics;    // [N, s_ch] or null
  const unsigned char* mask; // [N] bool or null (all active)
  const float* view;         // [4, 4] row-major, x_cam = V @ [x, 1]
  const float* proj;         // [4, 4]
  long long n;
  int nf, s_ch;
  int width, height, tile_x, tile_y;
  float focal_x, focal_y, lim_x, lim_y, scale_modifier;
  int tight;
  float* fields;             // [N, nf]
  int* rect_min;             // [N, 2]
  int* rect_max;             // [N, 2]
  int* radii;                // [N]
  float* depths;             // [N]
  float* means2d;            // [N, 2]
};

__global__ void __launch_bounds__(kThreads) primitive_fields(const Args a) {
  extern __shared__ float stage[];   // [kThreads, nf + 1]
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                        a.n - r0));
  const int pitch = a.nf + 1;
  if (t < rows) {
    const long long i = r0 + t;
    const float* V = a.view;
    const float x = a.means3d[3 * i], y = a.means3d[3 * i + 1],
                z = a.means3d[3 * i + 2];

    // view space and the near plane
    const float vx = affine(V, 0, x, y, z), vy = affine(V, 1, x, y, z),
                vz = affine(V, 2, x, y, z);
    const bool in_front = vz > static_cast<float>(0.2);

    // projection; the homogeneous denominator kept off zero
    const float* P = a.proj;
    const float hx = affine(P, 0, x, y, z), hy = affine(P, 1, x, y, z),
                hw = affine(P, 3, x, y, z);
    const float eps = static_cast<float>(1e-7);
    float denom = add(hw, eps);
    const float tiny = denom < 0.f ? static_cast<float>(-1e-7) : eps;
    if (fabsf(denom) < eps) denom = tiny;
    const float p_w = rdiv1(denom);
    const float px = mul(hx, p_w), py = mul(hy, p_w);

    // world covariance, packed (xx, xy, xz, yy, yz, zz)
    float cov[6];
    if (a.cov3d != nullptr) {
      for (int k = 0; k < 6; ++k) cov[k] = a.cov3d[6 * i + k];
    } else {
      const float* q = a.rotations + 4 * i;
      const float qr = q[0], qx = q[1], qy = q[2], qz = q[3];
      const float R[9] = {
          sub(1.f, mul(add(mul(qy, qy), mul(qz, qz)), 2.f)),
          mul(sub(mul(qx, qy), mul(qr, qz)), 2.f),
          mul(add(mul(qx, qz), mul(qr, qy)), 2.f),
          mul(add(mul(qx, qy), mul(qr, qz)), 2.f),
          sub(1.f, mul(add(mul(qx, qx), mul(qz, qz)), 2.f)),
          mul(sub(mul(qy, qz), mul(qr, qx)), 2.f),
          mul(sub(mul(qx, qz), mul(qr, qy)), 2.f),
          mul(add(mul(qy, qz), mul(qr, qx)), 2.f),
          sub(1.f, mul(add(mul(qx, qx), mul(qy, qy)), 2.f))};
      const float* s = a.scales + 3 * i;
      const float sm[3] = {mul(s[0], a.scale_modifier),
                           mul(s[1], a.scale_modifier),
                           mul(s[2], a.scale_modifier)};
      float M[9];
      for (int k = 0; k < 9; ++k) M[k] = mul(R[k], sm[k % 3]);
      const int pairs[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2},
                               {2, 2}};
      for (int k = 0; k < 6; ++k) {
        const float* u = M + 3 * pairs[k][0];
        const float* v = M + 3 * pairs[k][1];
        cov[k] = sum3(mul(u[0], v[0]), mul(u[1], v[1]), mul(u[2], v[2]));
      }
    }

    // EWA 2D covariance (compute_cov2d)
    const float tz = clamp_min(vz, static_cast<float>(0.2));
    const float tx = mul(clamp(div(vx, tz), -a.lim_x, a.lim_x), tz);
    const float ty = mul(clamp(div(vy, tz), -a.lim_y, a.lim_y), tz);
    const float inv_tz = rdiv1(tz);
    const float j00 = mul(inv_tz, a.focal_x);
    const float j02 = mul(mul(mul(tx, -a.focal_x), inv_tz), inv_tz);
    const float j11 = mul(inv_tz, a.focal_y);
    const float j12 = mul(mul(mul(ty, -a.focal_y), inv_tz), inv_tz);
    float u0[3], u1[3];
    for (int k = 0; k < 3; ++k) {
      u0[k] = add(mul(j00, V[k]), mul(j02, V[8 + k]));
      u1[k] = add(mul(j11, V[4 + k]), mul(j12, V[8 + k]));
    }
    const float low_pass = static_cast<float>(0.3);
    const float ca = add(quad(u0, u0, cov), low_pass);
    const float cb = quad(u0, u1, cov);
    const float cc = add(quad(u1, u1, cov), low_pass);

    // conic, eigenvalue, radius
    const float det = sub(mul(ca, cc), mul(cb, cb));
    const bool det_ok = det != 0.f;
    const float det_inv = det_ok ? rdiv1(det) : 0.f;
    const float conic0 = mul(cc, det_inv);
    const float conic1 = mul(-cb, det_inv);
    const float conic2 = mul(ca, det_inv);
    const float mid = mul(add(ca, cc), 0.5f);
    const float lam = add(mid, sqrtf(clamp_min(sub(mul(mid, mid), det),
                                               static_cast<float>(0.1))));
    const float radius_f = ceilf(mul(sqrtf(clamp_min(lam, 0.f)), 3.f));

    // pixel mean (ndc2pix)
    const float mx = mul(sub(mul(add(px, 1.f), static_cast<float>(a.width)),
                             1.f), 0.5f);
    const float my = mul(sub(mul(add(py, 1.f), static_cast<float>(a.height)),
                             1.f), 0.5f);

    // tile rect (tile_rect); a division by the tile size is a product
    // with its float reciprocal
    const float inv_tx = div(1.f, static_cast<float>(a.tile_x));
    const float inv_ty = div(1.f, static_cast<float>(a.tile_y));
    const float gx = static_cast<float>((a.width + a.tile_x - 1) / a.tile_x);
    const float gy = static_cast<float>((a.height + a.tile_y - 1) / a.tile_y);
    int rmin_x = tile_floor(mul(sub(mx, radius_f), inv_tx), gx);
    int rmin_y = tile_floor(mul(sub(my, radius_f), inv_ty), gy);
    int rmax_x = tile_floor(
        mul(sub(add(add(mx, radius_f), static_cast<float>(a.tile_x)), 1.f),
            inv_tx), gx);
    int rmax_y = tile_floor(
        mul(sub(add(add(my, radius_f), static_cast<float>(a.tile_y)), 1.f),
            inv_ty), gy);
    const bool visible = in_front && det_ok
                         && (rmax_x - rmin_x) * (rmax_y - rmin_y) > 0;
    int radius = visible ? to_i32(radius_f) : 0;

    const float op = a.opacities[i];
    if (a.tight) {
      // the opacity-tightened rect: the band where alpha can reach 1/255
      const float t_cut = clamp_min(
          mul(logf(mul(clamp_min(op, static_cast<float>(1e-12)), 255.f)),
              2.f), 0.f);
      const bool tighten = det > 0.f;
      const float rfull = visible ? radius_f : 0.f;
      const float grow = static_cast<float>(1.0 + 1e-5);
      const float pad = static_cast<float>(1e-3);
      float rx = add(mul(sqrtf(mul(t_cut, clamp_min(ca, 0.f))), grow), pad);
      float ry = add(mul(sqrtf(mul(t_cut, clamp_min(cc, 0.f))), grow), pad);
      rx = tighten ? minimum(rfull, rx) : rfull;
      ry = tighten ? minimum(rfull, ry) : rfull;
      const int tmin_x = to_i32(clamp(floorf(mul(sub(mx, rx), inv_tx)),
                                      0.f, gx));
      const int tmax_x = to_i32(clamp(
          add(floorf(mul(add(mx, rx), inv_tx)), 1.f), 0.f, gx));
      const int tmin_y = to_i32(clamp(floorf(mul(sub(my, ry), inv_ty)),
                                      0.f, gy));
      const int tmax_y = to_i32(clamp(
          add(floorf(mul(add(my, ry), inv_ty)), 1.f), 0.f, gy));
      rmin_x = max(rmin_x, tmin_x);
      rmin_y = max(rmin_y, tmin_y);
      rmax_x = min(rmax_x, tmax_x);
      rmax_y = min(rmax_y, tmax_y);
      if (mul(op, 255.f) < 1.f && tighten) {
        rmax_x = rmin_x;
        rmax_y = rmin_y;
      }
      rmax_x = max(rmax_x, rmin_x);
      rmax_y = max(rmax_y, rmin_y);
    }
    if (a.mask != nullptr && !a.mask[i]) radius = 0;

    float* row = stage + t * pitch;
    row[0] = mx;
    row[1] = my;
    row[2] = conic0;
    row[3] = conic1;
    row[4] = conic2;
    row[5] = op;
    for (int k = 0; k < 3; ++k) row[6 + k] = a.colors[3 * i + k];
    row[9] = vz;
    row[10] = __int2float_rn(radius);
    int c = 11;
    for (int k = 0; k < a.s_ch; ++k, ++c) row[c] = a.semantics[i * a.s_ch + k];
    for (; c < a.nf; ++c) row[c] = 0.f;

    reinterpret_cast<int2*>(a.rect_min)[i] = make_int2(rmin_x, rmin_y);
    reinterpret_cast<int2*>(a.rect_max)[i] = make_int2(rmax_x, rmax_y);
    a.radii[i] = radius;
    a.depths[i] = vz;
    reinterpret_cast<float2*>(a.means2d)[i] = make_float2(mx, my);
  }
  __syncthreads();
  // the block's rows are one contiguous span of the field table
  const int total = rows * a.nf;
  float* out = a.fields + r0 * a.nf;
  for (int k = t; k < total; k += kThreads) {
    const int r = k / a.nf;
    out[k] = stage[r * pitch + (k - r * a.nf)];
  }
}

}  // namespace

// Inputs float32 and contiguous, the mask bool (one byte a row); outputs
// allocated by the caller: fields [n, nf] float32, rect_min and rect_max
// [n, 2] int32, radii [n] int32, depths [n] float32, means2d [n, 2]
// float32. nf is NF_BASE + s_ch rounded up to 8. Returns 0, a CUDA error
// code, or -1 for arguments the kernel does not take. A block stages
// 128 x (nf + 1) floats; past the 48 KB a block gets by default (nf above
// 94) it opts in to more dynamic shared memory, up to the card's limit.
extern "C" int grpg_primitive_fields(
    const float* means3d, const float* scales, const float* rotations,
    const float* cov3d, const float* opacities, const float* colors,
    const float* semantics, int s_ch, const unsigned char* mask,
    const float* view, const float* proj, long long n, int nf, int width,
    int height, int tile_x, int tile_y, float focal_x, float focal_y,
    float lim_x, float lim_y, float scale_modifier, int tight,
    float* fields, int* rect_min, int* rect_max, int* radii, float* depths,
    float* means2d, void* stream) {
  if (nf < 11 + s_ch || nf % 8 != 0 || s_ch < 0 || tile_x <= 0
      || tile_y <= 0 || n < 0 || (cov3d == nullptr
                                  && (scales == nullptr
                                      || rotations == nullptr))
      || (s_ch > 0 && semantics == nullptr))
    return -1;
  const size_t smem = sizeof(float) * static_cast<size_t>(kThreads)
                      * (nf + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        primitive_fields, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return -1;
  const Args a{means3d, scales, rotations, cov3d, opacities, colors,
               semantics, mask, view, proj, n, nf, s_ch, width, height,
               tile_x, tile_y, focal_x, focal_y, lim_x, lim_y,
               scale_modifier, tight, fields, rect_min, rect_max, radii,
               depths, means2d};
  primitive_fields<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
