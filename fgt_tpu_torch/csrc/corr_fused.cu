// RAFT correlation lookup from pooled feature corners (kernel K1).
//
// Replaces fgt_tpu/ops/corr_fused_pallas.py::_fused_kernel. See
// fgt_tpu_torch/ops/corr_fused.py for the contract, the design and its
// bound on the H100. One warp per pixel; per level the (k+1)^2 corner dots
// f1 . f2_l[corner] are taken by 8-lane groups (4 corners per warp step)
// with f32 accumulation, stored in shared memory, and combined into the
// k^2 bilinear taps (dx slow, dy fast). Corners outside a level are zero.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entry below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 6;
constexpr int kWarps = 8;          // pixels per block
constexpr int kMaxCorners = 256;   // (2r+2)^2 for r <= 7

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int n = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int n = 8; };

// 16-byte load widened to f32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// NQ = C / (8 * VEC): 16-byte chunks of the channel vector per lane.
// Lane `part` (0..7 within its 8-lane group) owns channels
// q*8*VEC + part*VEC + [0, VEC) for q < NQ, so the group's loads of one
// corner vector are contiguous 128-byte runs.
template <typename T, int NQ>
__global__ void __launch_bounds__(kWarps * 32)
corr_fused_kernel(const T* __restrict__ f1, Levels lv, int num_levels,
                  const float* __restrict__ coords, T* __restrict__ out,
                  int n_pix, int hw, int c, int radius, float scale) {
  constexpr int VEC = VecWidth<T>::n;
  __shared__ float corner_dot[kWarps][kMaxCorners];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_pix) return;  // uniform across the warp
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int ncorner = kp * kp;
  const int kk = k * k;
  const int sub = lane >> 3;
  const int part = lane & 7;
  float* dots = corner_dot[warp];

  float a[NQ * VEC];
  const T* f1p = f1 + static_cast<size_t>(n) * c;
#pragma unroll
  for (int q = 0; q < NQ; ++q) load16(f1p + q * 8 * VEC + part * VEC, a + q * VEC);
#pragma unroll
  for (int i = 0; i < NQ * VEC; ++i) a[i] *= scale;

  const int b = n / hw;
  const float cx0 = coords[2 * n];
  const float cy0 = coords[2 * n + 1];
  T* outp = out + static_cast<size_t>(n) * num_levels * kk;

  for (int l = 0; l < num_levels; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float inv = 1.0f / static_cast<float>(1 << l);
    const float cx = cx0 * inv;
    const float cy = cy0 * inv;
    const float flx = floorf(cx);
    const float fly = floorf(cy);
    const float fx = cx - flx;
    const float fy = cy - fly;
    // far coordinates give all-zero taps; the clamp keeps the int cast defined
    const int x0 = static_cast<int>(fminf(fmaxf(flx, -1e6f), 1e6f)) - radius;
    const int y0 = static_cast<int>(fminf(fmaxf(fly, -1e6f), 1e6f)) - radius;
    const T* base = static_cast<const T*>(lv.ptr[l]) +
                    static_cast<size_t>(b) * hl * wl * c;

    for (int c0 = 0; c0 < ncorner; c0 += 4) {
      const int corner = c0 + sub;
      const int i = corner / kp;
      const int j = corner - i * kp;
      const int yy = y0 + i;
      const int xx = x0 + j;
      float acc = 0.f;
      if (corner < ncorner && yy >= 0 && yy < hl && xx >= 0 && xx < wl) {
        const T* p = base + (static_cast<size_t>(yy) * wl + xx) * c + part * VEC;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float v[VEC];
          load16(p + q * 8 * VEC, v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc = fmaf(a[q * VEC + e], v[e], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (part == 0 && corner < ncorner) dots[corner] = acc;
    }
    __syncwarp();
    const float w00 = (1.f - fx) * (1.f - fy);
    const float w01 = fx * (1.f - fy);
    const float w10 = (1.f - fx) * fy;
    const float w11 = fx * fy;
    for (int t = lane; t < kk; t += 32) {
      const int ax = t / k;        // dx index (slow)
      const int by = t - ax * k;   // dy index (fast)
      const float* r0 = dots + by * kp + ax;
      const float v = w00 * r0[0] + w01 * r0[1] + w10 * r0[kp] + w11 * r0[kp + 1];
      store(outp + l * kk + t, v);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* f1, const Levels& lv, int num_levels,
                   const float* coords, void* out, int n_pix, int hw, int c,
                   int radius, cudaStream_t stream) {
  constexpr int VEC = VecWidth<T>::n;
  const int nq = c / (8 * VEC);
  const float scale = 1.0f / sqrtf(static_cast<float>(c));
  const dim3 grid((n_pix + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const T* f = static_cast<const T*>(f1);
  T* o = static_cast<T*>(out);
  switch (nq) {
    case 1: corr_fused_kernel<T, 1><<<grid, block, 0, stream>>>(f, lv, num_levels, coords, o, n_pix, hw, c, radius, scale); break;
    case 2: corr_fused_kernel<T, 2><<<grid, block, 0, stream>>>(f, lv, num_levels, coords, o, n_pix, hw, c, radius, scale); break;
    case 4: corr_fused_kernel<T, 4><<<grid, block, 0, stream>>>(f, lv, num_levels, coords, o, n_pix, hw, c, radius, scale); break;
    case 8: corr_fused_kernel<T, 8><<<grid, block, 0, stream>>>(f, lv, num_levels, coords, o, n_pix, hw, c, radius, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// level_ptrs: host array of num_levels device pointers ([B, H_l, W_l, C]
// channels-last); level_hw: host array (H_0, W_0, H_1, W_1, ...).
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int corr_fused_lookup(const void* f1, const void* const* level_ptrs,
                                 const int* level_hw, int num_levels,
                                 const float* coords, void* out, int n_pix,
                                 int hw, int c, int radius, int dtype,
                                 void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 ||
      (2 * radius + 2) * (2 * radius + 2) > kMaxCorners || n_pix <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(f1, lv, num_levels, coords, out, n_pix, hw, c, radius, s)
      : launch<float>(f1, lv, num_levels, coords, out, n_pix, hw, c, radius, s);
  return static_cast<int>(err);
}
