// K6: stage s5's Poisson blending, every frame and colour channel of a
// clip in one launch (wrapper and plain twin: ops/poisson.py).
//
// It replaces no Pallas kernel: the JAX package solves s5 on the host with
// one scipy splu factorization a frame. The kernel solves the same normal
// equations, (A^T A + 1e-8 I) x = A^T b, matrix-free by Jacobi-
// preconditioned CG in f64: the operator is a 4-neighbour stencil that
// follows from the hole and the gradient mask (ops/poisson.py's note).
//
// What bounds it. A plane holds 10^3-10^5 unknowns (a stroke frame
// 5-23 k, the 2x outpainting canvas's ring ~3 x 10^5) and its CG runs
// hundreds to thousands of dependent iterations, each a stencil pass, two
// dot products and two vector updates over ~72 B an unknown: at the HBM
// rate a stroke clip's iterations would take ~10 ms, and they sit in L2
// anyway. FLOPs are nothing. The time is the iterations' latency (block
// barriers, L2 round trips) times their number, on the clip's largest
// plane: the planes run side by side.
//
// Design. One block of 512 threads per plane (frame, channel), so no
// iteration leaves the block: the block barrier is the only
// synchronisation, each plane stops on its own residual, and the host
// waits once for the whole clip. The block first compacts its frame's
// hole pixels (raster order, as np.nonzero), then builds each unknown's
// diagonal, right-hand side and coupled neighbours (E and W are the next
// and previous unknowns; S and N are found by a binary search of the
// sorted pixel list), so the iterations read four int32 indices and f64
// vectors and never the masks. Each pass takes kUnroll unknowns a thread
// at a time with their loads issued together, so that a thread keeps
// kUnroll L2 round trips in flight, not one. Each dot product costs one
// barrier: every warp's partial goes to shared memory, and after the
// barrier every thread sums the partials in the same order, so all
// threads see one value and take one branch. Three barriers an iteration.
// Jacobi is the preconditioner because it needs no barrier of its own: a
// V-cycle (ops/diffusion.py's) would cut the iterations on the wide ring
// but adds a barrier per level and sweep on arbitrary hole shapes, and
// the stroke cell's thin holes take a few hundred Jacobi iterations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                    // unknowns a thread has in flight
constexpr int kStride = kThreads * kUnroll;
constexpr double kRidge = 1e-8;

// Sum of v over the block; every thread returns the same value. One
// barrier: buf[kWarps] must not be written again before the next barrier.
__device__ __forceinline__ double block_sum(double v, double* buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll 8
  for (int i = 0; i < kWarps; ++i) s += buf[i];
  return s;
}

__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           double* buf) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    buf[threadIdx.x >> 5] = a;
    buf[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  double sa = 0.0, sb = 0.0;
#pragma unroll 8
  for (int i = 0; i < kWarps; ++i) {
    sa += buf[i];
    sb += buf[kWarps + i];
  }
  a = sa;
  b = sb;
}

// First position in sorted idx[lo, hi) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* idx, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (idx[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, 1) poisson_pcg_kernel(
    const double* __restrict__ img, const double* __restrict__ gx,
    const double* __restrict__ gy, const uint8_t* __restrict__ hole,
    const uint8_t* __restrict__ gm, const int64_t* __restrict__ offsets,
    double* __restrict__ out, int* __restrict__ status, int* idx_all,
    int4* nbr_all, double* diag_all, double* x_all, double* r_all,
    double* p_all, double* ap_all, int h, int w, double rtol,
    int max_iters) {
  __shared__ double red_a[kWarps];
  __shared__ double red_b[2 * kWarps];
  __shared__ int wcount[kWarps];

  const int frame = blockIdx.x / 3, ch = blockIdx.x % 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = h * w;
  const int64_t off = offsets[frame];
  const int n = static_cast<int>(offsets[frame + 1] - off);
  const int64_t base = 3 * off + static_cast<int64_t>(ch) * n;
  int* idx = idx_all + base;
  int4* nbr = nbr_all + base;
  double* diag = diag_all + base;
  double* x = x_all + base;
  double* r = r_all + base;
  double* p = p_all + base;
  double* ap = ap_all + base;
  const uint8_t* hf = hole + static_cast<int64_t>(frame) * hw;
  const uint8_t* gf = gm + static_cast<int64_t>(frame) * hw;
  const int64_t fpix = static_cast<int64_t>(frame) * hw;

  // 1. compact the hole's pixels, in raster order: 4 a thread, a block
  // scan of the counts
  int found = 0;
  for (int c0 = 0; c0 < hw; c0 += 4 * kThreads) {
    const int p0 = c0 + 4 * tid;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p0 + j < hw && hf[p0 + j]) bits |= 1u << j;
    const int mine = __popc(bits);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wcount[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int c = wcount[i];
      before += i < warp ? c : 0;
      total += c;
    }
    int k = found + before + incl - mine;
    for (int j = 0; j < 4; ++j)
      if ((bits >> j & 1u) && k < n) idx[k++] = p0 + j;
    found += total;
    __syncthreads();
  }
  if (found != n) {  // the host's count disagrees with the mask
    if (tid == 0) status[blockIdx.x] = -2;
    return;
  }

  // 2. each unknown's row: diagonal, right-hand side, coupled unknowns
  double bb = 0.0, rz = 0.0;
  for (int k = tid; k < n; k += kThreads) {
    const int pix = idx[k];
    const int y = pix / w, xx = pix - y * w;
    const int64_t q3 = (fpix + pix) * 3 + ch;
    int4 nb = make_int4(-1, -1, -1, -1);
    int eqs = 0;  // b_p + 2 i_p
    double b = 0.0;
    // E: x_p - x_q = -gx[p] (q in the hole) or x_p = -gx[p] + I[q]
    if (xx + 1 < w && !gf[pix]) {
      const double g = -gx[q3];
      if (hf[pix + 1]) {
        eqs += 2; b += 2.0 * g; nb.x = k + 1;
      } else {
        eqs += 1; b += g + img[q3 + 3];
      }
    }
    // S: source -gy[p]
    if (y + 1 < h && !gf[pix]) {
      const double g = -gy[q3];
      if (hf[pix + w]) {
        eqs += 2; b += 2.0 * g;
        nb.y = lower_bound(idx, k + 1, min(n, k + w + 1), pix + w);
      } else {
        eqs += 1; b += g + img[q3 + 3 * static_cast<int64_t>(w)];
      }
    }
    // W: source gx[y, x-1]
    if (xx >= 1 && !gf[pix - 1]) {
      const double g = gx[q3 - 3];
      if (hf[pix - 1]) {
        eqs += 2; b += 2.0 * g; nb.z = k - 1;
      } else {
        eqs += 1; b += g + img[q3 - 3];
      }
    }
    // N: source gy[y-1, x]
    if (y >= 1 && !gf[pix - w]) {
      const double g = gy[q3 - 3 * static_cast<int64_t>(w)];
      if (hf[pix - w]) {
        eqs += 2; b += 2.0 * g;
        nb.w = lower_bound(idx, max(0, k - w), k, pix - w);
      } else {
        eqs += 1; b += g + img[q3 - 3 * static_cast<int64_t>(w)];
      }
    }
    const double d = static_cast<double>(eqs) + kRidge;
    const double z = b / d;
    nbr[k] = nb;
    diag[k] = d;
    x[k] = 0.0;
    r[k] = b;
    p[k] = z;
    bb += b * b;
    rz += b * z;
  }
  block_sum2(bb, rz, red_b);
  const double thresh = rtol * rtol * bb;
  double rr = bb;

  // 3. Jacobi-preconditioned CG. Each pass takes kUnroll unknowns a
  // thread at a time, their loads issued together.
  int it = 0;
  while (rr > thresh && it < max_iters) {
    __syncthreads();  // p complete
    double pap = 0.0;
    for (int k0 = tid; k0 < n; k0 += kStride) {
      int4 nb[kUnroll];
      double pk[kUnroll], dk[kUnroll], s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads;
        const bool in = k < n;
        nb[u] = in ? nbr[k] : make_int4(-1, -1, -1, -1);
        pk[u] = in ? p[k] : 0.0;
        dk[u] = in ? diag[k] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = 0.0;
        if (nb[u].x >= 0) s[u] += p[nb[u].x];
        if (nb[u].y >= 0) s[u] += p[nb[u].y];
        if (nb[u].z >= 0) s[u] += p[nb[u].z];
        if (nb[u].w >= 0) s[u] += p[nb[u].w];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n) {
          const double a = dk[u] * pk[u] - 2.0 * s[u];
          ap[k] = a;
          pap += pk[u] * a;
        }
      }
    }
    pap = block_sum(pap, red_a);
    const double alpha = rz / pap;
    double rz_new = 0.0, rr_new = 0.0;
    for (int k0 = tid; k0 < n; k0 += kStride) {
      double rk[kUnroll], ak[kUnroll], pk[kUnroll], xk[kUnroll], dk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads;
        const bool in = k < n;
        rk[u] = in ? r[k] : 0.0;
        ak[u] = in ? ap[k] : 0.0;
        pk[u] = in ? p[k] : 0.0;
        xk[u] = in ? x[k] : 0.0;
        dk[u] = in ? diag[k] : 1.0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n) {
          const double rn = rk[u] - alpha * ak[u];
          x[k] = xk[u] + alpha * pk[u];
          r[k] = rn;
          rz_new += rn * (rn / dk[u]);
          rr_new += rn * rn;
        }
      }
    }
    block_sum2(rz_new, rr_new, red_b);
    ++it;
    rr = rr_new;
    if (rr <= thresh) break;
    const double beta = rz_new / rz;
    rz = rz_new;
    for (int k0 = tid; k0 < n; k0 += kStride) {
      double rk[kUnroll], pk[kUnroll], dk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads;
        const bool in = k < n;
        rk[u] = in ? r[k] : 0.0;
        pk[u] = in ? p[k] : 0.0;
        dk[u] = in ? diag[k] : 1.0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n) p[k] = rk[u] / dk[u] + beta * pk[u];
      }
    }
  }

  for (int k = tid; k < n; k += kThreads)
    out[(fpix + idx[k]) * 3 + ch] = x[k];
  if (tid == 0) status[blockIdx.x] = rr <= thresh ? it : -1;
}

}  // namespace

// img, gx, gy: [n, h, w, 3] f64; hole, gm: [n, h, w] u8 {0, 1}; offsets:
// [n + 1] int64, the prefix sums of the frames' hole pixels (P in all);
// out: [n, h, w, 3] f64, each plane's solution written at its hole
// pixels (nothing else is written); status: [n, 3] int32, the iterations
// of each plane (-1 unconverged at max_iters, -2 a hole that disagrees
// with offsets); idx, nbr, diag, x, r, p, ap: scratch of 3 P elements.
extern "C" int poisson_pcg(const double* img, const double* gx,
                           const double* gy, const uint8_t* hole,
                           const uint8_t* gm, const int64_t* offsets,
                           double* out, int* status, int* idx, void* nbr,
                           double* diag, double* x, double* r, double* p,
                           double* ap, int n, int h, int w, double rtol,
                           int max_iters, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || static_cast<int64_t>(h) * w >= (1 << 30)
      || max_iters < 0 || reinterpret_cast<uintptr_t>(nbr) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  poisson_pcg_kernel<<<3 * n, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      img, gx, gy, hole, gm, offsets, out, status, idx,
      static_cast<int4*>(nbr), diag, x, r, p, ap, h, w, rtol, max_iters);
  return static_cast<int>(cudaGetLastError());
}
