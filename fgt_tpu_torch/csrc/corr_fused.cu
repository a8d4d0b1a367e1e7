// RAFT correlation lookup from pooled feature corners (kernel K1).
//
// Replaces fgt_tpu/ops/corr_fused_pallas.py::_fused_kernel. See
// fgt_tpu_torch/ops/corr_fused.py for the contract, the design and its
// bound on the H100. Per level, the (k+1)^2 corner dots f1 . f2_l[corner]
// of a pixel (f32 sums) are combined into the k^2 bilinear taps (dx slow,
// dy fast); corners outside a level are zero. Two bodies, chosen by dtype:
//
//   f32 (corr_fused_kernel, FMA units): one warp per pixel; 8-lane groups
//       each take one corner (4 corners per warp step), the dots go to
//       shared memory.
//   bf16 (tc::corr_fused_bf16_kernel, tensor cores): level 0 bf16, levels
//       >= 1 f32. One block of 8 warps per 8x8 pixel tile of one pair, f1's
//       tile in swizzled shared memory, two blocks an SM. Per level:
//         1. the bounding box of the tile's corner windows, clipped to the
//            level (pixels whose window misses the level add nothing);
//         2. box route (box <= kBoxCap corners): the box's feature rows
//            stream through a two-stage ring (global loads for chunk j+1
//            in flight in registers while chunk j multiplies), into
//            swizzled bf16 rows (an f32 level split into hi + lo rows);
//            mma.sync m16n8k16 products [16 pixels x 16 corners] a warp,
//            f32 accumulation, are scattered into each pixel's own
//            (k+1)^2 window dots in shared memory;
//         3. general route (box > kBoxCap: noisy or far-flung coords): a
//            warp per pixel, as the f32 body, on the level's own dtype;
//         4. each pixel combines its k^2 taps from its window dots.
//       Each block counts its (tile, level) pairs per route into routes[2].
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entry below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxLevels = 6;
constexpr int kWarps = 8;          // pixels per block
constexpr int kMaxCorners = 256;   // (2r+2)^2 for r <= 7

// level l: [B, h[l], w[l], C] channels-last; f32 levels in f32; in bf16,
// level 0 bf16 and levels >= 1 f32
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

// ------------------------------------------------- bf16, tensor cores

namespace tc {

using namespace fgt_mma;

constexpr int kTile = 8;               // pixel tile side
constexpr int kPix = kTile * kTile;    // pixels a block
constexpr int kThreads = 256;          // 8 warps
constexpr int kBoxCap = 1024;          // most corners a box route takes
constexpr int kStageRows = 32;         // bf16 rows of C channels a stage
// a stage holds 32 bf16 corner rows, or 16 f32 corners split into hi and
// lo rows (per 8 corners: 8 hi rows, then their 8 lo rows)
template <typename T> struct Stage;
template <> struct Stage<bf16> { static constexpr int n = 32; };
template <> struct Stage<float> { static constexpr int n = 16; };

// shared memory: f1's tile, the two-stage ring, each pixel's window dots
// (row stride ds floats), its level-0 coords, the box reduction
__host__ __device__ constexpr size_t smem_bytes(int c, int ds) {
  return sizeof(bf16) * kPix * c + 2 * sizeof(bf16) * kStageRows * c +
         sizeof(float) * kPix * ds + sizeof(float2) * kPix + sizeof(int) * 8;
}

// the first corner of a window around c (far coords clamped so that the
// int conversion stays defined; their windows miss every level)
__device__ __forceinline__ int window_origin(float c, int radius) {
  return static_cast<int>(fminf(fmaxf(floorf(c), -1e6f), 1e6f)) - radius;
}

// q / d for 0 <= q < 2^22 and d >= 1, by one multiply: (q + 1/2) / d lies
// at least 1/(2d) from an integer, far above the product's rounding
__device__ __forceinline__ int div_small(int q, float inv_d) {
  return static_cast<int>((static_cast<float>(q) + 0.5f) * inv_d);
}

// A level's box: [by0, by0 + bh) x [bx0, bx0 + bw), box-relative corner
// q = (y - by0) * bw + x - bx0 for q < nb.
template <typename T, int C>
struct Box {
  static constexpr int kRowChunks = C * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kLoads = Stage<T>::n * kRowChunks / kThreads;

  const T* base;  // this pair's level
  int wl, bx0, by0, bw, nb;
  float inv_bw;

  // global -> registers: the 16-byte chunks of corners [q0, q0 + n) this
  // thread carries (zeros past nb); thread-major within a row
  __device__ __forceinline__ void fetch(uint4 (&pre)[kLoads], int q0) const {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int q = q0 + idx / kRowChunks;
      const int ch = idx % kRowChunks;
      if (q < nb) {
        const int qy = div_small(q, inv_bw);
        const T* p = base +
                     (static_cast<size_t>(by0 + qy) * wl + bx0 + q - qy * bw) *
                         C +
                     ch * (16 / static_cast<int>(sizeof(T)));
        pre[u] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        pre[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // registers -> the stage's swizzled [32][C] bf16 rows
  __device__ __forceinline__ void put(const uint4 (&pre)[kLoads],
                                      bf16* stage) const {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int c = idx / kRowChunks;  // corner within the stage
      const int ch = idx % kRowChunks;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(stage + swz<C>(c, ch)) = pre[u];
      } else {
        // 4 f32 channels 4*ch.. -> bf16 hi and lo, half a 16-byte chunk
        const int hi_row = 16 * (c >> 3) + (c & 7);
        const float4 v = *reinterpret_cast<const float4*>(&pre[u]);
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
        const __nv_bfloat162 l0 = __floats2bfloat162_rn(
            v.x - __low2float(h0), v.y - __high2float(h0));
        const __nv_bfloat162 l1 = __floats2bfloat162_rn(
            v.z - __low2float(h1), v.w - __high2float(h1));
        const int off = (ch & 1) * 4;
        uint2 hv, lv;
        hv.x = *reinterpret_cast<const uint32_t*>(&h0);
        hv.y = *reinterpret_cast<const uint32_t*>(&h1);
        lv.x = *reinterpret_cast<const uint32_t*>(&l0);
        lv.y = *reinterpret_cast<const uint32_t*>(&l1);
        *reinterpret_cast<uint2*>(stage + swz<C>(hi_row, ch >> 1) + off) = hv;
        *reinterpret_cast<uint2*>(stage + swz<C>(hi_row + 8, ch >> 1) + off) =
            lv;
      }
    }
  }
};

// This thread's view of the two pixels whose accumulator rows it holds
// (tile pixels p and p + 8 of warp group pg): their dots rows and window
// origins at this level.
struct Rows {
  float* dots[2];
  int x0[2], y0[2];
};

// One stage's products for warp group pg (16 pixels) and this warp's half
// of the stage (16 bf16 corners, or 8 f32 corners as hi + lo), scattered
// into the pixels' window dots: dots[(y - y0) * kp + x - x0] for box
// corners inside a pixel's window.
template <typename T, int C>
__device__ __forceinline__ void stage_dots(const bf16* f1s, const bf16* stage,
                                           const Box<T, C>& box, int q0,
                                           const Rows& rows, int kp, int pg,
                                           int half, int lane, float scale) {
  constexpr int NT = sizeof(T) == 2 ? 2 : 1;  // n-tiles of 8 corners
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, f1s + swz<C>(16 * pg + a_row(lane), 2 * kk + a_chunk(lane)));
    ldmatrix_x4(b, stage + swz<C>(16 * half + bn_row(lane),
                                  2 * kk + bn_chunk(lane)));
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[NT - 1], a, b[2], b[3]);  // f32: the lo rows, same corners
  }
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int q = q0 + 8 * NT * half + 8 * j + 2 * t4 + e2;
      if (q >= box.nb) continue;
      const int qy = div_small(q, box.inv_bw);
      const int y = box.by0 + qy;
      const int x = box.bx0 + q - qy * box.bw;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = y - rows.y0[r];
        const int jx = x - rows.x0[r];
        if (static_cast<unsigned>(i) < static_cast<unsigned>(kp) &&
            static_cast<unsigned>(jx) < static_cast<unsigned>(kp))
          rows.dots[r][i * kp + jx] = acc[j][2 * r + e2] * scale;
      }
    }
}

// Box route of one level: the window dots of the tile's 64 pixels from one
// pass over the box's corner rows (global loads of the next stage in
// flight in registers while this one multiplies).
template <typename T, int C>
__device__ __forceinline__ void box_dots(const bf16* f1s, bf16* ring,
                                         const Box<T, C>& box,
                                         const Rows& rows, int kp, int pg,
                                         int half, int lane, float scale) {
  constexpr int NS = Stage<T>::n;
  const int nchunks = (box.nb + NS - 1) / NS;
  uint4 pre[Box<T, C>::kLoads];
  box.fetch(pre, 0);
  box.put(pre, ring);
  for (int j = 0; j < nchunks; ++j) {
    if (j + 1 < nchunks) box.fetch(pre, (j + 1) * NS);
    __syncthreads();  // stage j landed; the other stage is no longer read
    stage_dots<T, C>(f1s, ring + (j & 1) * kStageRows * C, box, j * NS, rows,
                     kp, pg, half, lane, scale);
    if (j + 1 < nchunks) box.put(pre, ring + ((j + 1) & 1) * kStageRows * C);
  }
}

// General route of one level for one pixel, a warp: the f32 body's corner
// dots on this level's dtype (f1 read in the matching channel layout and
// scaled), into dots[(k+1)^2], zero outside the level.
template <typename T, int C>
__device__ __forceinline__ void general_dots(const bf16* __restrict__ f1p,
                                             const T* base, int hl, int wl,
                                             int x0, int y0, int kp,
                                             float scale, float* dots,
                                             int lane) {
  constexpr int VEC = VecWidth<T>::n;
  constexpr int NQ = C / (8 * VEC);
  const int ncorner = kp * kp;
  const float inv_kp = 1.f / static_cast<float>(kp);
  const int sub = lane >> 3;
  const int part = lane & 7;
  float a[NQ * VEC];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const bf16* src = f1p + q * 8 * VEC + part * VEC;
    if constexpr (VEC == 8) {
      load16(src, a + q * VEC);
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 f0 = __bfloat1622float2(h[0]);
      const float2 f1 = __bfloat1622float2(h[1]);
      a[q * VEC] = f0.x; a[q * VEC + 1] = f0.y;
      a[q * VEC + 2] = f1.x; a[q * VEC + 3] = f1.y;
    }
  }
#pragma unroll
  for (int i = 0; i < NQ * VEC; ++i) a[i] *= scale;
#pragma unroll 2
  for (int c0 = 0; c0 < ncorner; c0 += 4) {
    const int corner = c0 + sub;
    const int i = div_small(corner, inv_kp);
    const int yy = y0 + i;
    const int xx = x0 + corner - i * kp;
    float acc = 0.f;
    if (corner < ncorner && yy >= 0 && yy < hl && xx >= 0 && xx < wl) {
      const T* p = base + (static_cast<size_t>(yy) * wl + xx) * C + part * VEC;
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
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
corr_fused_bf16_kernel(const bf16* __restrict__ f1, Levels lv, int num_levels,
                       const float* __restrict__ coords,
                       bf16* __restrict__ out, int h, int w, int radius,
                       int ds, float scale,
                       unsigned long long* __restrict__ routes) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* f1s = reinterpret_cast<bf16*>(smem_raw);  // [kPix][C] swizzled
  bf16* ring = f1s + kPix * C;                     // 2 x [kStageRows][C]
  float* dots = reinterpret_cast<float*>(ring + 2 * kStageRows * C);
  float2* pc = reinterpret_cast<float2*>(dots + kPix * ds);
  int* red = reinterpret_cast<int*>(pc + kPix);  // [2 warps][4]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pg = warp & 3;     // A rows: tile pixels 16*pg .. 16*pg + 15
  const int half = warp >> 2;  // this warp's half of a stage's corners
  const int tx0 = blockIdx.x * kTile;
  const int ty0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const size_t pix0 = static_cast<size_t>(b) * h * w;
  const int k = 2 * radius + 1;
  const int kk = k * k;
  const int kp = k + 1;
  const float inv_k = 1.f / static_cast<float>(k);

  // f1 of the tile (zero rows past the image) and its coords
  for (int idx = threadIdx.x; idx < kPix * (C / 8); idx += kThreads) {
    const int p = idx / (C / 8);
    const int ch = idx % (C / 8);
    const int y = ty0 + p / kTile;
    const int x = tx0 + p % kTile;
    const bool ok = y < h && x < w;
    const bf16* src =
        ok ? f1 + (pix0 + static_cast<size_t>(y) * w + x) * C + ch * 8 : f1;
    cp_async16(f1s + swz<C>(p, ch), src, ok);
  }
  cp_async_commit();
  if (threadIdx.x < kPix) {
    const int y = ty0 + threadIdx.x / kTile;
    const int x = tx0 + threadIdx.x % kTile;
    pc[threadIdx.x] =
        y < h && x < w
            ? reinterpret_cast<const float2*>(coords)[pix0 +
                                                       static_cast<size_t>(y) * w + x]
            : make_float2(0.f, 0.f);
  }
  cp_async_wait<0>();

  unsigned long long n_box = 0, n_general = 0;
  for (int l = 0; l < num_levels; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const float inv = 1.0f / static_cast<float>(1 << l);
    __syncthreads();  // the previous level's ring, dots and box are done

    // 1. the box: union of the pixels' windows clipped to the level
    if (warp < 2) {
      const int p = threadIdx.x;
      const int y = ty0 + p / kTile;
      const int x = tx0 + p % kTile;
      int xa = INT_MAX, xb = INT_MIN, ya = INT_MAX, yb = INT_MIN;
      if (y < h && x < w) {
        const int x0 = window_origin(pc[p].x * inv, radius);
        const int y0 = window_origin(pc[p].y * inv, radius);
        const int a0 = max(x0, 0), a1 = min(x0 + k, wl - 1);
        const int c0 = max(y0, 0), c1 = min(y0 + k, hl - 1);
        if (a0 <= a1 && c0 <= c1) {
          xa = a0; xb = a1; ya = c0; yb = c1;
        }
      }
      xa = __reduce_min_sync(0xffffffffu, xa);
      xb = __reduce_max_sync(0xffffffffu, xb);
      ya = __reduce_min_sync(0xffffffffu, ya);
      yb = __reduce_max_sync(0xffffffffu, yb);
      if (lane == 0) {
        red[4 * warp] = xa; red[4 * warp + 1] = xb;
        red[4 * warp + 2] = ya; red[4 * warp + 3] = yb;
      }
    }
    __syncthreads();
    const int bx0 = min(red[0], red[4]), bx1 = max(red[1], red[5]);
    const int by0 = min(red[2], red[6]), by1 = max(red[3], red[7]);
    const bool empty = bx0 > bx1;
    const int bw = empty ? 1 : bx1 - bx0 + 1;
    const int nb = empty ? 0 : bw * (by1 - by0 + 1);
    const bool box = nb <= kBoxCap;
    if (threadIdx.x == 0) ++(box ? n_box : n_general);

    // 2. box route: every pixel's window dots from the box's corner rows
    if (box && nb > 0) {
      Rows rows;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * pg + (lane >> 2) + 8 * r;
        rows.dots[r] = dots + p * ds;
        rows.x0[r] = window_origin(pc[p].x * inv, radius);
        rows.y0[r] = window_origin(pc[p].y * inv, radius);
      }
      const float inv_bw = 1.f / static_cast<float>(bw);
      if (l == 0) {
        const Box<bf16, C> bx{static_cast<const bf16*>(lv.ptr[0]) +
                                  static_cast<size_t>(b) * hl * wl * C,
                              wl, bx0, by0, bw, nb, inv_bw};
        box_dots<bf16, C>(f1s, ring, bx, rows, kp, pg, half, lane, scale);
      } else {
        const Box<float, C> bx{static_cast<const float*>(lv.ptr[l]) +
                                   static_cast<size_t>(b) * hl * wl * C,
                               wl, bx0, by0, bw, nb, inv_bw};
        box_dots<float, C>(f1s, ring, bx, rows, kp, pg, half, lane, scale);
      }
      __syncthreads();
    }

    // 3. the taps: warp w serves tile row w, one pixel at a time; dots of
    //    corners outside the level read as zero
    for (int px = 0; px < kTile; ++px) {
      const int p = warp * kTile + px;
      const int y = ty0 + warp;
      const int x = tx0 + px;
      if (y >= h || x >= w) break;  // uniform across the warp
      const size_t n = pix0 + static_cast<size_t>(y) * w + x;
      const float cx = pc[p].x * inv;
      const float cy = pc[p].y * inv;
      const float fx = cx - floorf(cx);
      const float fy = cy - floorf(cy);
      const int x0 = window_origin(cx, radius);
      const int y0 = window_origin(cy, radius);
      float* pd = dots + p * ds;
      if (!box) {
        if (l == 0)
          general_dots<bf16, C>(f1 + n * C,
                                static_cast<const bf16*>(lv.ptr[0]) +
                                    static_cast<size_t>(b) * hl * wl * C,
                                hl, wl, x0, y0, kp, scale, pd, lane);
        else
          general_dots<float, C>(f1 + n * C,
                                 static_cast<const float*>(lv.ptr[l]) +
                                     static_cast<size_t>(b) * hl * wl * C,
                                 hl, wl, x0, y0, kp, scale, pd, lane);
        __syncwarp();
      }
      const float w00 = (1.f - fx) * (1.f - fy);
      const float w01 = fx * (1.f - fy);
      const float w10 = (1.f - fx) * fy;
      const float w11 = fx * fy;
      bf16* outp = out + n * num_levels * kk + l * kk;
      for (int t = lane; t < kk; t += 32) {
        const int ax = div_small(t, inv_k);  // dx index (slow)
        const int by = t - ax * k;           // dy index (fast)
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = by + (e >> 1);
          const int j = ax + (e & 1);
          const int yy = y0 + i;
          const int xx = x0 + j;
          d[e] = yy >= 0 && yy < hl && xx >= 0 && xx < wl ? pd[i * kp + j]
                                                          : 0.f;
        }
        store(outp + t, w00 * d[0] + w01 * d[1] + w10 * d[2] + w11 * d[3]);
      }
    }
  }
  if (threadIdx.x == 0) {
    atomicAdd(routes, n_box);
    atomicAdd(routes + 1, n_general);
  }
}

template <int C>
cudaError_t launch_c(const void* f1, const Levels& lv, int num_levels,
                     const float* coords, void* out, int b, int h, int w,
                     int radius, unsigned long long* routes,
                     cudaStream_t stream) {
  const int kp = 2 * radius + 2;
  const int ds = kp * kp | 1;  // odd stride: pixels' rows spread the banks
  const size_t bytes = smem_bytes(C, ds);
  cudaError_t err = cudaFuncSetAttribute(
      corr_fused_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  corr_fused_bf16_kernel<C><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(f1), lv, num_levels, coords,
      static_cast<bf16*>(out), h, w, radius, ds,
      1.0f / sqrtf(static_cast<float>(C)), routes);
  return cudaGetLastError();
}

cudaError_t launch(const void* f1, const Levels& lv, int num_levels,
                   const float* coords, void* out, int b, int h, int w, int c,
                   int radius, unsigned long long* routes,
                   cudaStream_t stream) {
  // 16-byte cp.async and loads of f1 rows and level rows, float2 coords
  uintptr_t bits = reinterpret_cast<uintptr_t>(f1);
  for (int l = 0; l < num_levels; ++l)
    bits |= reinterpret_cast<uintptr_t>(lv.ptr[l]);
  if ((bits & 15) || (reinterpret_cast<uintptr_t>(coords) & 7))
    return cudaErrorMisalignedAddress;
  if (b > 65535) return cudaErrorInvalidValue;
  switch (c) {
    case 64: return launch_c<64>(f1, lv, num_levels, coords, out, b, h, w, radius, routes, stream);
    case 128: return launch_c<128>(f1, lv, num_levels, coords, out, b, h, w, radius, routes, stream);
    case 256: return launch_c<256>(f1, lv, num_levels, coords, out, b, h, w, radius, routes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// f1: [b, h, w, c]; level_ptrs: host array of num_levels device pointers
// ([b, H_l, W_l, c] channels-last); level_hw: host array (H_0, W_0, H_1,
// W_1, ...); coords: [b, h, w, 2] f32. dtype 0 = float32 (every level
// f32), 1 = bfloat16 (f1 and level 0 bf16, levels >= 1 f32; c of 64, 128
// or 256; routes a device int64[2] that the tensor-core body adds its
// (box, general) tile-levels to). The output is in f1's dtype. Returns
// cudaGetLastError().
extern "C" int corr_fused_lookup(const void* f1, const void* const* level_ptrs,
                                 const int* level_hw, int num_levels,
                                 const float* coords, void* out, int b, int h,
                                 int w, int c, int radius, int dtype,
                                 void* routes, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 ||
      (2 * radius + 2) * (2 * radius + 2) > kMaxCorners || b <= 0 ||
      h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? tc::launch(f1, lv, num_levels, coords, out, b, h, w, c,
                              radius,
                              static_cast<unsigned long long*>(routes), s)
                 : launch<float>(f1, lv, num_levels, coords, out, b * h * w,
                                 h * w, c, radius, s);
  return static_cast<int>(err);
}
