// RAFT all-pairs correlation pyramid lookup (kernel K3).
//
// Replaces fgt_tpu/ops/corr_lookup_pallas.py::_lookup_kernel. See
// fgt_tpu_torch/ops/corr_lookup.py for the contract, the design and its
// bound on the H100. One warp per pixel serves every level in one launch:
// per level it gathers the clipped (k+1)^2 window of the pixel's map
// around floor(coords / 2^l) into shared memory (zero outside the level),
// then writes the k^2 bilinear taps (dx slow, dy fast) in f32. The taps
// contract y first, then x, as the TPU kernel does, with every product and
// sum rounded on its own (no FMA contraction), so the result equals the
// plain PyTorch version bit for bit in f32 and bf16 storage.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entry below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 6;
constexpr int kWarps = 4;          // pixels per block
constexpr int kMaxWindow = 256;    // (2r+2)^2 for r <= 7

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_kernel(Levels lv, int num_levels, const float* __restrict__ coords,
                   float* __restrict__ out, int n_pix, int radius) {
  __shared__ float window[kWarps][kMaxWindow];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_pix) return;  // uniform across the warp
  const int k = 2 * radius + 1;
  const int kp = k + 1;
  const int kk = k * k;
  const int nwin = kp * kp;
  float* win = window[warp];
  const float cx0 = coords[2 * n];
  const float cy0 = coords[2 * n + 1];
  float* outp = out + static_cast<size_t>(n) * num_levels * kk;

  for (int l = 0; l < num_levels; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float inv = 1.0f / static_cast<float>(1 << l);  // exact
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
                    static_cast<size_t>(n) * hl * wl;
    for (int i = lane; i < nwin; i += 32) {
      const int r = i / kp;
      const int yy = y0 + r;
      const int xx = x0 + i - r * kp;
      win[i] = (yy >= 0 && yy < hl && xx >= 0 && xx < wl)
                   ? load(base + static_cast<size_t>(yy) * wl + xx)
                   : 0.f;
    }
    __syncwarp();
    const float gx = 1.f - fx;
    const float gy = 1.f - fy;
    for (int t = lane; t < kk; t += 32) {
      const int ax = t / k;        // dx index (slow)
      const int by = t - ax * k;   // dy index (fast)
      const float* p = win + by * kp + ax;
      const float c0 = __fadd_rn(__fmul_rn(gy, p[0]), __fmul_rn(fy, p[kp]));
      const float c1 = __fadd_rn(__fmul_rn(gy, p[1]), __fmul_rn(fy, p[kp + 1]));
      outp[l * kk + t] = __fadd_rn(__fmul_rn(gx, c0), __fmul_rn(fx, c1));
    }
    __syncwarp();
  }
}

}  // namespace

// level_ptrs: host array of num_levels device pointers ([N, H_l, W_l]
// contiguous); level_hw: host array (H_0, W_0, H_1, W_1, ...); coords:
// [N, 2] level-0 (x, y) f32; out: [N, num_levels * (2r+1)^2] f32.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int corr_lookup_pyramid(const void* const* level_ptrs,
                                   const int* level_hw, int num_levels,
                                   const float* coords, float* out, int n_pix,
                                   int radius, int dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 ||
      (2 * radius + 2) * (2 * radius + 2) > kMaxWindow || n_pix <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  const dim3 grid((n_pix + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    corr_lookup_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        lv, num_levels, coords, out, n_pix, radius);
  else
    corr_lookup_kernel<float><<<grid, block, 0, s>>>(
        lv, num_levels, coords, out, n_pix, radius);
  return static_cast<int>(cudaGetLastError());
}
