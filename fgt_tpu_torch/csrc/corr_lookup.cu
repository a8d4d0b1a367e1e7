// RAFT all-pairs correlation pyramid lookup (kernel K3).
//
// Replaces fgt_tpu/ops/corr_lookup_pallas.py::_lookup_kernel. For pixel n
// and level l it takes the k x k bilinear taps (k = 2r+1) of the pixel's
// map vol_l[n] ([N, H_l, W_l], bf16 or f32) at (cx/2^l + dx, cy/2^l + dy),
// zero outside the level, dx slow and dy fast. The taps contract y first,
// then x, with every product and sum rounded on its own (no FMA
// contraction), so the result equals the plain PyTorch version bit for bit
// in f32 and bf16 storage; a bf16 output is the f32 tap rounded once.
//
// Bound on the H100 (fgt_tpu_torch/ops/corr_lookup.py has the numbers):
// bytes. A tap needs 9 flops and its window cells are read once, so the
// lookup moves the in-level window bytes, the coords and the taps. The
// window rows (k+1 cells: 20 B in bf16, 40 B in f32 at r = 4) start at any
// element, so the layout's own floor is the 32-byte sectors those rows
// touch (~1.6 a row in bf16), not their bytes.
//
// Design (what the warp-per-pixel body, kept below as the yardstick,
// lacked: it gathered one level's window at a time with 2-byte loads):
//  1. Persistent warps walk over pixels (grid = the SMs' resident blocks).
//     Each warp keeps a two-pixel ring in shared memory: all levels'
//     windows of the next pixel are in flight as cp.async copies while the
//     current pixel's taps are computed and stored, so no pixel waits for a
//     round trip per level.
//  2. Row-shaped 16-byte loads. A window row is staged as the aligned
//     16-byte lines that hold it (levels start 16-byte aligned, rows start
//     anywhere), lanes on (row, line) so a row's lines come from
//     neighbouring lanes. Lines outside the level are zero-filled by the
//     copy itself (src-size 0, clamped source address); a line that holds
//     a cell of the level is copied whole, and the taps mask the columns
//     outside [0, W_l) by a select. No padding in device memory.
//  3. The radius is a template parameter (RAFT's 4 and 3; others are
//     refused), so
//     k, k+1 and every index division are compile-time constants. The
//     staged row stride is an odd number of 16-byte lines, so the rows a
//     warp reads fall in different banks.
//  4. The taps come out in the consumer's dtype (f32, or bf16 for the bf16
//     update block: half the output bytes, and no separate cast pass).
//     Each warp store writes one level's consecutive taps, 128 (f32) or
//     64 (bf16) contiguous bytes, so the stores go straight to memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entries below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_bf16.cuh"

namespace {

using fgt_mma::cp_async16;
using fgt_mma::cp_async_commit;
using fgt_mma::cp_async_wait;

constexpr int kMaxLevels = 6;
constexpr int kWarps = 4;      // warps per block
constexpr int kMinBlocks = 8;  // resident blocks an SM: <= 64 registers

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// floor(c) as an int; far coordinates give all-zero taps, and the clamp
// keeps the cast defined (the chip phase feeds +-1e4 and -3e3)
__device__ __forceinline__ int floor_clamped(float fl) {
  return static_cast<int>(fminf(fmaxf(fl, -1e6f), 1e6f));
}

// The window of radius R in storage type T, staged in shared memory.
template <typename T, int R>
struct Geom {
  static constexpr int K = 2 * R + 1;
  static constexpr int KP = K + 1;   // window side
  static constexpr int KK = K * K;   // taps per level
  static constexpr int EPL = 16 / static_cast<int>(sizeof(T));  // per line
  // 16-byte lines that hold a window row at any element offset
  static constexpr int LINES = (KP * static_cast<int>(sizeof(T)) + 16 -
                                static_cast<int>(sizeof(T)) + 15) / 16;
  static constexpr int ROW = (LINES | 1) * EPL;  // staged row stride
  static constexpr int LEVEL = KP * ROW;         // staged level
};

// Start the copies of pixel n's windows, every level, into dst. The
// level loop is unrolled so the Levels fields stay in the parameter bank;
// offsets inside a map are 32-bit (a line's alignment is the level's
// start plus the map's offset, mod 16 bytes).
template <typename T, int R>
__device__ __forceinline__ void issue(const Levels& lv, int num_levels, int n,
                                      float2 c, T* dst, int lane) {
  using G = Geom<T, R>;
  constexpr int kCopies = G::KP * G::LINES;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= num_levels) break;
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float inv = 1.0f / static_cast<float>(1 << l);  // exact
    const int x0 = floor_clamped(floorf(c.x * inv)) - R;
    const int y0 = floor_clamped(floorf(c.y * inv)) - R;
    const int xlo = max(x0, 0);             // the level's columns of the
    const int xhi = min(x0 + G::KP, wl);    // window: [xlo, xhi)
    const T* base = static_cast<const T*>(lv.ptr[l]);
    const size_t map_at = static_cast<size_t>(n) * hl * wl;
    const T* map = base + map_at;
    const unsigned mo = static_cast<unsigned>(map_at) & (G::EPL - 1);
#pragma unroll
    for (int it = 0; it < (kCopies + 31) / 32; ++it) {
      const int i = lane + 32 * it;
      if (i >= kCopies) break;
      const int j = i / G::LINES;           // window row
      const int q = i - j * G::LINES;       // line of that row
      const int yy = y0 + j;
      const bool in_level = static_cast<unsigned>(yy) <
                                static_cast<unsigned>(hl) && xlo < xhi;
      const int row = in_level ? yy * wl : 0;   // (yy, 0) in the map
      const int line =
          static_cast<int>((mo + static_cast<unsigned>(row + x0)) &
                           ~static_cast<unsigned>(G::EPL - 1)) -
          static_cast<int>(mo) + q * G::EPL;
      const bool ok =
          in_level && line < row + xhi && line + G::EPL > row + xlo;
      cp_async16(dst + l * G::LEVEL + j * G::ROW + q * G::EPL,
                 ok ? map + line : base, ok);
    }
  }
}

// Pixel n's taps from its staged windows.
template <typename T, typename O, int R>
__device__ __forceinline__ void taps(const Levels& lv, int num_levels, int n,
                                     float2 c, const T* win, O* __restrict__ out,
                                     int lane) {
  using G = Geom<T, R>;
  O* dst = out + static_cast<size_t>(n) * num_levels * G::KK;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= num_levels) break;
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float inv = 1.0f / static_cast<float>(1 << l);
    const float cx = c.x * inv;
    const float cy = c.y * inv;
    const float flx = floorf(cx);
    const float fly = floorf(cy);
    const float fx = cx - flx;
    const float fy = cy - fly;
    const float gx = 1.f - fx;
    const float gy = 1.f - fy;
    const int x0 = floor_clamped(flx) - R;
    const int y0 = floor_clamped(fly) - R;
    // offset of window row 0's first cell in its first staged line
    const unsigned s0 =
        (static_cast<unsigned>(static_cast<size_t>(n) * hl * wl) +
         static_cast<unsigned>(y0) * wl + static_cast<unsigned>(x0)) &
        (G::EPL - 1);
    const T* w = win + l * G::LEVEL;
#pragma unroll
    for (int it = 0; it < (G::KK + 31) / 32; ++it) {
      const int t = lane + 32 * it;
      if (t >= G::KK) break;
      const int ax = t / G::K;        // dx index (slow)
      const int by = t - ax * G::K;   // dy index (fast)
      const T* r0 = w + by * G::ROW + ((s0 + by * wl) & (G::EPL - 1)) + ax;
      const T* r1 =
          w + (by + 1) * G::ROW + ((s0 + (by + 1) * wl) & (G::EPL - 1)) + ax;
      const bool m0 = static_cast<unsigned>(x0 + ax) < static_cast<unsigned>(wl);
      const bool m1 =
          static_cast<unsigned>(x0 + ax + 1) < static_cast<unsigned>(wl);
      const float v00 = m0 ? to_f32(r0[0]) : 0.f;
      const float v01 = m1 ? to_f32(r0[1]) : 0.f;
      const float v10 = m0 ? to_f32(r1[0]) : 0.f;
      const float v11 = m1 ? to_f32(r1[1]) : 0.f;
      const float c0 = __fadd_rn(__fmul_rn(gy, v00), __fmul_rn(fy, v10));
      const float c1 = __fadd_rn(__fmul_rn(gy, v01), __fmul_rn(fy, v11));
      put(dst + l * G::KK + t, __fadd_rn(__fmul_rn(gx, c0), __fmul_rn(fx, c1)));
    }
  }
}

template <typename T, typename O, int R>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
corr_lookup_kernel(Levels lv, int num_levels,
                   const float2* __restrict__ coords, O* __restrict__ out,
                   int n_pix) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = num_levels * Geom<T, R>::LEVEL;  // one pixel's windows
  T* ring = reinterpret_cast<T*>(smem) + warp * 2 * slot;
  const int stride = gridDim.x * kWarps;
  int n = blockIdx.x * kWarps + warp;
  if (n >= n_pix) return;  // uniform across the warp
  float2 cur = __ldg(coords + n);
  issue<T, R>(lv, num_levels, n, cur, ring, lane);
  cp_async_commit();
  float2 next = n + stride < n_pix ? __ldg(coords + n + stride) : cur;
  for (int s = 0;; s ^= 1) {
    const int nn = n + stride;
    if (nn < n_pix)
      issue<T, R>(lv, num_levels, nn, next, ring + (s ^ 1) * slot, lane);
    cp_async_commit();  // an empty group past the last pixel
    const float2 after =
        nn + stride < n_pix ? __ldg(coords + nn + stride) : next;
    cp_async_wait<1>();  // pixel n's windows have landed
    __syncwarp();
    taps<T, O, R>(lv, num_levels, n, cur, ring + s * slot, out, lane);
    __syncwarp();  // slot s is refilled two pixels on
    if (nn >= n_pix) break;
    n = nn;
    cur = next;
    next = after;
  }
}

template <typename T, typename O, int R>
int launch(const Levels& lv, int num_levels, const float* coords, void* out,
           int n_pix, cudaStream_t s) {
  const auto kernel = corr_lookup_kernel<T, O, R>;
  const int smem = kWarps * 2 * num_levels * Geom<T, R>::LEVEL *
                   static_cast<int>(sizeof(T));
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32,
                                                smem);
  const int need = (n_pix + kWarps - 1) / kWarps;
  const int grid = std::max(1, std::min(need, sms * std::max(per_sm, 1)));
  kernel<<<grid, kWarps * 32, smem, s>>>(
      lv, num_levels, reinterpret_cast<const float2*>(coords),
      static_cast<O*>(out), n_pix);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch_radius(const Levels& lv, int num_levels, const float* coords,
                  void* out, int n_pix, int radius, cudaStream_t s) {
  switch (radius) {
    case 3: return launch<T, O, 3>(lv, num_levels, coords, out, n_pix, s);
    case 4: return launch<T, O, 4>(lv, num_levels, coords, out, n_pix, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- The warp-per-pixel body: one level's window at a time.
// Kept only as the yardstick the redesign is timed against (chip_smoke.py);
// nothing in the port calls it.

constexpr int kMaxWindow = 256;  // (2r+2)^2 for r <= 7

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_warp_kernel(Levels lv, int num_levels,
                        const float* __restrict__ coords,
                        float* __restrict__ out, int n_pix, int radius) {
  __shared__ float window[kWarps][kMaxWindow];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_pix) return;
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
    const float inv = 1.0f / static_cast<float>(1 << l);
    const float cx = cx0 * inv;
    const float cy = cy0 * inv;
    const float flx = floorf(cx);
    const float fly = floorf(cy);
    const float fx = cx - flx;
    const float fy = cy - fly;
    const int x0 = floor_clamped(flx) - radius;
    const int y0 = floor_clamped(fly) - radius;
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
      const int ax = t / k;
      const int by = t - ax * k;
      const float* p = win + by * kp + ax;
      const float c0 = __fadd_rn(__fmul_rn(gy, p[0]), __fmul_rn(fy, p[kp]));
      const float c1 = __fadd_rn(__fmul_rn(gy, p[1]), __fmul_rn(fy, p[kp + 1]));
      outp[l * kk + t] = __fadd_rn(__fmul_rn(gx, c0), __fmul_rn(fx, c1));
    }
    __syncwarp();
  }
}

bool read_levels(const void* const* level_ptrs, const int* level_hw,
                 int num_levels, Levels* lv) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  for (int l = 0; l < num_levels; ++l) {
    lv->ptr[l] = level_ptrs[l];
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    if (reinterpret_cast<uintptr_t>(level_ptrs[l]) % 16 != 0) return false;
  }
  return true;
}

}  // namespace

// level_ptrs: host array of num_levels device pointers ([N, H_l, W_l]
// contiguous, each 16-byte aligned); level_hw: host array (H_0, W_0, H_1,
// W_1, ...); coords: [N, 2] level-0 (x, y) f32, 8-byte aligned; out:
// [N, num_levels * (2r+1)^2] in out_dtype. dtype / out_dtype: 0 = float32,
// 1 = bfloat16; radius 3 or 4. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int corr_lookup_pyramid(const void* const* level_ptrs,
                                   const int* level_hw, int num_levels,
                                   const float* coords, void* out, int n_pix,
                                   int radius, int dtype, int out_dtype,
                                   void* stream) {
  Levels lv;
  if (!read_levels(level_ptrs, level_hw, num_levels, &lv) || n_pix <= 0 ||
      n_pix > (1 << 30) || reinterpret_cast<uintptr_t>(coords) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (out_dtype == 1)
      return launch_radius<__nv_bfloat16, __nv_bfloat16>(
          lv, num_levels, coords, out, n_pix, radius, s);
    return launch_radius<__nv_bfloat16, float>(lv, num_levels, coords, out,
                                               n_pix, radius, s);
  }
  if (out_dtype == 1)
    return launch_radius<float, __nv_bfloat16>(lv, num_levels, coords, out,
                                               n_pix, radius, s);
  return launch_radius<float, float>(lv, num_levels, coords, out, n_pix,
                                     radius, s);
}

// The warp-per-pixel body (f32 out), same arguments but no out_dtype.
extern "C" int corr_lookup_pyramid_warp(const void* const* level_ptrs,
                                        const int* level_hw, int num_levels,
                                        const float* coords, float* out,
                                        int n_pix, int radius, int dtype,
                                        void* stream) {
  Levels lv;
  if (!read_levels(level_ptrs, level_hw, num_levels, &lv) || radius < 0 ||
      (2 * radius + 2) * (2 * radius + 2) > kMaxWindow || n_pix <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_pix + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    corr_lookup_warp_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        lv, num_levels, coords, out, n_pix, radius);
  else
    corr_lookup_warp_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        lv, num_levels, coords, out, n_pix, radius);
  return static_cast<int>(cudaGetLastError());
}
