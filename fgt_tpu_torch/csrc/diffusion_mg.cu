// K7: stage s2's flow diffusion, the multigrid-preconditioned flexible CG
// of every plane of a clip on the card (wrapper and plain twin:
// ops/diffusion.py).
//
// It replaces no Pallas kernel: the JAX package solves the diffusion with
// XLA code (fgt_tpu/ops/diffusion_tpu.py), which the port first carried
// over as eager PyTorch. That code spends ~650 launches an iteration (each
// 4-neighbour sum is 4 pads and 3 adds, the coarsest level 24 sweeps of
// ~17 launches) and reads the host once an iteration to test convergence,
// so the card idles while the host issues the next iteration.
//
// The same mathematics, the same iterations. f32 throughout; a mask
// pyramid of up to LEVELS halvings (a coarse pixel is hole where any of
// its 2x2 is); damped Jacobi (omega 0.8, one sweep before and after, 24 at
// the coarsest level); the 2x2 sum of the halved residual as restriction,
// repetition as prolongation; per-plane alpha, Polak-Ribiere beta and
// freezing once the residual is under RTOL of the right-hand side. Each
// elementwise step rounds as the plain twin's does (explicit _rn
// intrinsics, no contraction into FMAs); only the order of the dot
// products' sums and of the 2x2 sums differs.
//
// What bounds it. An iteration reads and writes the CG vectors (x, r, z,
// p; f32) at the hole pixels of every live plane, the masks once a pass,
// and a quarter of that again a level down: on the 2x outpainting canvas
// (46 planes of 480x864, 75% hole) ~0.9 GB an iteration, ~0.3 ms at the
// HBM rate; FLOPs are nothing. A removal clip's holes (3-13% of 46 planes
// of 240x432) move ~50 MB an iteration, which sits in L2: there the ~10
// launches an iteration and their dependencies bound it.
//
// Design. An iteration is ~10 launches, each a pass over one level:
//   direction (level 0): p = z + beta p_old and the partial sums of p.Ap,
//     Ap recomputed from p's neighbours (p is double-buffered);
//   update (level 0): alpha from those partials, x += alpha p, r -= alpha
//     Ap (Ap recomputed again, cheaper than storing it), partials of r.r;
//   V-cycle: one down pass a level (the pre-smooth from zero is pointwise,
//     x0 = r ninv, so the residual recomputes its neighbours from r; then
//     the halving, the 2x2 sum and the coarse mask), the coarsest level in
//     one launch (a block a plane, x, b and the mask in shared memory, 24
//     sweeps between block barriers; a plane too large for shared memory
//     takes 24 global sweep launches instead, chosen by the wrapper from
//     the shape), one up pass a level (prolong, add, post-smooth); the top
//     up pass writes z and the partials of r.z_new and r.z_old;
//   scalars (one block): each plane's sums of the partials in a fixed
//     order, beta, rz, rs, the live flags, the count of iterations in
//     which some plane was live and one "some plane live" flag.
// Every vector is read and written only at its level's hole pixels (it is
// zero elsewhere), so a removal clip's passes touch little beyond the
// masks. A frozen plane's blocks return at once: the plain twin's
// iterations leave its x and r unchanged (alpha 0), so skipping them
// changes nothing, and an iteration past convergence costs only launches.
// Reductions are deterministic: each block writes one partial, and each
// consumer sums a plane's partials in one fixed order (a warp, a butterfly
// of shuffles), so two runs give the same bits. The host issues
// iterations in chunks through k7_iterate and reads the flag once a chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // fine-grid passes
constexpr int kItems = 4;                  // pixels a thread
constexpr int kSpan = kThreads * kItems;   // pixels a block, one partial
constexpr int kWarps = kThreads / 32;
constexpr int kCoarseThreads = 1024;
constexpr int kCoarseSweeps = 24;
constexpr int kMaxLevels = 4;
constexpr float kRtol2 = 1e-12f;           // RTOL**2

// the damped Jacobi weight omega * m / max(n, 1) of a hole pixel with n
// in-grid neighbours, rounded as the plain twin's (0.8f / n in f32)
__constant__ float kNinv[5] = {0.8f / 1.0f, 0.8f / 1.0f, 0.8f / 2.0f,
                               0.8f / 3.0f, 0.8f / 4.0f};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ int ncount(int y, int x, int h, int w) {
  return (y + 1 < h) + (y > 0) + (x + 1 < w) + (x > 0);
}

// Sum of the 4 in-grid neighbours of v (a function of (y, x)) in the plain
// twin's order, ((y+1) + (y-1) + (x+1)) + (x-1), zero off the grid.
template <class F>
__device__ __forceinline__ float nbsum(const F& v, int y, int x, int h,
                                       int w) {
  float s = add(y + 1 < h ? v(y + 1, x) : 0.f, y > 0 ? v(y - 1, x) : 0.f);
  s = add(s, x + 1 < w ? v(y, x + 1) : 0.f);
  return add(s, x > 0 ? v(y, x - 1) : 0.f);
}

// Block sums, valid in thread 0: warp trees, then the warps in order.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) s += buf[i];
  return s;
}

__device__ __forceinline__ void block_sum2(float& a, float& b, float* buf) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    buf[threadIdx.x >> 5] = a;
    buf[kWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) {
      sa += buf[i];
      sb += buf[kWarps + i];
    }
  a = sa;
  b = sb;
}

// Sum of a plane's nb partials by one warp, in a fixed order: each lane a
// strided run, then a butterfly, which leaves the same bits in every lane.
__device__ __forceinline__ float warp_sum_parts(const float* part, int nb) {
  float s = 0.f;
  for (int i = threadIdx.x & 31; i < nb; i += 32) s += part[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// r = b = the 4-neighbour sum of the known pixels at each hole pixel; x,
// z, p = 0; the partials of b.b.
__global__ void __launch_bounds__(kThreads) k7_init_kernel(
    const float* __restrict__ planes, const uint8_t* __restrict__ hole,
    float* __restrict__ x, float* __restrict__ r, float* __restrict__ z,
    float* __restrict__ p, float* __restrict__ part, int h, int w, int nb) {
  __shared__ float buf[kWarps];
  const int hw = h * w;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * hw;
  planes += off;
  hole += off;
  float acc = 0.f;
  for (int k = 0; k < kItems; ++k) {
    const int i = blockIdx.x * kSpan + k * kThreads + threadIdx.x;
    if (i >= hw) break;
    float b = 0.f;
    if (hole[i]) {
      const int y = i / w, xx = i - y * w;
      b = nbsum([&](int yy, int xq) {
            const int j = yy * w + xq;
            return mul(planes[j], hole[j] ? 0.f : 1.f);
          }, y, xx, h, w);
      acc = add(acc, mul(b, b));
    }
    r[off + i] = b;
    x[off + i] = 0.f;
    z[off + i] = 0.f;
    p[off + i] = 0.f;
  }
  const float s = block_sum(acc, buf);
  if (threadIdx.x == 0) part[blockIdx.y * nb + blockIdx.x] = s;
}

// The coarse mask: hole where any pixel of the 2x2 below is.
__global__ void k7_pyramid_kernel(const uint8_t* __restrict__ m,
                                  uint8_t* __restrict__ mc, int h, int w,
                                  int hc, int wc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= hc * wc) return;
  const int ci = j / wc, cj = j - ci * wc;
  m += static_cast<int64_t>(blockIdx.y) * h * w;
  uint8_t any = 0;
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b) {
      const int y = 2 * ci + a, x = 2 * cj + b;
      if (y < h && x < w) any |= m[y * w + x];
    }
  mc[static_cast<int64_t>(blockIdx.y) * hc * wc + j] = any != 0;
}

// Down pass of level (h, w) to (hc, wc): pre-smooth from zero (x0 = r
// ninv), the residual halved, summed over each 2x2 and masked by the
// coarse mask. A thread a coarse pixel, its 4x4 footprint of x0 in
// registers.
__global__ void __launch_bounds__(kThreads) k7_down_kernel(
    const float* __restrict__ r, const uint8_t* __restrict__ m,
    const uint8_t* __restrict__ mc, float* __restrict__ rc,
    const int* __restrict__ live, int h, int w, int hc, int wc) {
  if (!live[blockIdx.y]) return;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= hc * wc) return;
  const int64_t cj0 = static_cast<int64_t>(blockIdx.y) * hc * wc + j;
  if (!mc[cj0]) return;  // never read
  const int ci = j / wc, cj = j - ci * wc;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * h * w;
  r += off;
  m += off;
  float x0[4][4], rv[2][2];
  bool mv[2][2];
#pragma unroll
  for (int dy = 0; dy < 4; ++dy)
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      const int y = 2 * ci - 1 + dy, x = 2 * cj - 1 + dx;
      float v = 0.f, rr = 0.f;
      bool mm = false;
      if (y >= 0 && y < h && x >= 0 && x < w && m[y * w + x]) {
        mm = true;
        rr = r[y * w + x];
        v = mul(rr, kNinv[ncount(y, x, h, w)]);
      }
      x0[dy][dx] = v;
      if (dy >= 1 && dy <= 2 && dx >= 1 && dx <= 2) {
        rv[dy - 1][dx - 1] = rr;
        mv[dy - 1][dx - 1] = mm;
      }
    }
  float sum = 0.f;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int y = 2 * ci + a, x = 2 * cj + b;
      if (y >= h || x >= w || !mv[a][b]) continue;  // residual 0 there
      float s = add(x0[a + 2][b + 1], x0[a][b + 1]);
      s = add(s, x0[a + 1][b + 2]);
      s = add(s, x0[a + 1][b]);
      const float av = sub(mul(static_cast<float>(ncount(y, x, h, w)),
                               x0[a + 1][b + 1]), s);
      sum = add(sum, mul(sub(rv[a][b], av), 0.5f));
    }
  rc[cj0] = sum;
}

// The coarsest level, one block a plane: 24 damped Jacobi sweeps from zero
// on b, with x (two buffers), b and the mask in shared memory.
__global__ void __launch_bounds__(kCoarseThreads) k7_coarse_kernel(
    const float* __restrict__ b, const uint8_t* __restrict__ m,
    float* __restrict__ out, const int* __restrict__ live, int h, int w) {
  extern __shared__ float sm[];
  if (!live[blockIdx.x]) return;
  const int hw = h * w;
  float* xa = sm;
  float* xb = sm + hw;
  float* bs = sm + 2 * hw;
  uint8_t* ms = reinterpret_cast<uint8_t*>(sm + 3 * hw);
  const int64_t off = static_cast<int64_t>(blockIdx.x) * hw;
  for (int i = threadIdx.x; i < hw; i += kCoarseThreads) {
    const uint8_t mm = m[off + i];
    ms[i] = mm;
    bs[i] = mm ? b[off + i] : 0.f;
    xa[i] = 0.f;
  }
  __syncthreads();
  for (int sweep = 0; sweep < kCoarseSweeps; ++sweep) {
    const float* src = (sweep & 1) ? xb : xa;
    float* dst = (sweep & 1) ? xa : xb;
    for (int i = threadIdx.x; i < hw; i += kCoarseThreads) {
      if (!ms[i]) {
        dst[i] = 0.f;
        continue;
      }
      const int y = i / w, x = i - y * w;
      const int n = ncount(y, x, h, w);
      const float xv = src[i];
      const float s = nbsum([&](int yy, int xq) { return src[yy * w + xq]; },
                            y, x, h, w);
      const float av = sub(mul(static_cast<float>(n), xv), s);
      dst[i] = add(xv, mul(sub(bs[i], av), kNinv[n]));
    }
    __syncthreads();
  }
  // an even number of sweeps ends in xa
  for (int i = threadIdx.x; i < hw; i += kCoarseThreads)
    if (ms[i]) out[off + i] = xa[i];
}

// One damped Jacobi sweep of the coarsest level in global memory (a plane
// too large for shared memory); first: from zero, src not read.
__global__ void __launch_bounds__(kThreads) k7_sweep_kernel(
    const float* __restrict__ b, const uint8_t* __restrict__ m,
    const float* __restrict__ src, float* __restrict__ dst,
    const int* __restrict__ live, int h, int w, int first) {
  if (!live[blockIdx.y]) return;
  const int hw = h * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * hw;
  m += off;
  if (!m[i]) return;
  src += off;
  const int y = i / w, x = i - y * w;
  const int n = ncount(y, x, h, w);
  auto xat = [&](int yy, int xq) {
    const int q = yy * w + xq;
    return (first || !m[q]) ? 0.f : src[q];
  };
  const float xv = xat(y, x);
  const float av = sub(mul(static_cast<float>(n), xv), nbsum(xat, y, x, h, w));
  dst[off + i] = add(xv, mul(sub(b[off + i], av), kNinv[n]));
}

// Up pass of level (h, w) from (hc, wc): x = x0 + prolong(xc) m, then one
// post-smooth on r. top: out is z; each pixel's old z is read first, and
// the partials of r.z_new and r.z_old go to part (two [P, nb] halves).
__global__ void __launch_bounds__(kThreads) k7_up_kernel(
    const float* __restrict__ r, const uint8_t* __restrict__ m,
    const float* __restrict__ xc, float* __restrict__ out,
    float* __restrict__ part, const int* __restrict__ live, int h, int w,
    int wc, int hcwc, int nb, int n_planes, int top) {
  __shared__ float buf[2 * kWarps];
  if (!live[blockIdx.y]) return;
  const int hw = h * w;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * hw;
  r += off;
  m += off;
  xc += static_cast<int64_t>(blockIdx.y) * hcwc;
  auto xat = [&](int yy, int xq) {
    const int q = yy * w + xq;
    if (!m[q]) return 0.f;
    const float x0 = mul(r[q], kNinv[ncount(yy, xq, h, w)]);
    return add(x0, xc[(yy >> 1) * wc + (xq >> 1)]);
  };
  float rzn = 0.f, rzo = 0.f;
  for (int k = 0; k < kItems; ++k) {
    const int i = blockIdx.x * kSpan + k * kThreads + threadIdx.x;
    if (i >= hw) break;
    if (!m[i]) continue;
    const int y = i / w, x = i - y * w;
    const int n = ncount(y, x, h, w);
    const float rv = r[i];
    const float xv = xat(y, x);
    const float av = sub(mul(static_cast<float>(n), xv), nbsum(xat, y, x, h, w));
    const float zv = add(xv, mul(sub(rv, av), kNinv[n]));
    if (top) {
      rzn = add(rzn, mul(rv, zv));
      rzo = add(rzo, mul(rv, out[off + i]));
    }
    out[off + i] = zv;
  }
  if (!top) return;
  block_sum2(rzn, rzo, buf);
  if (threadIdx.x == 0) {
    part[blockIdx.y * nb + blockIdx.x] = rzn;
    part[(static_cast<int64_t>(n_planes) + blockIdx.y) * nb + blockIdx.x] =
        rzo;
  }
}

// With a single level the coarsest sweeps are the whole cycle: z from
// their result, with the top up pass's partials.
__global__ void __launch_bounds__(kThreads) k7_top_kernel(
    const float* __restrict__ r, const uint8_t* __restrict__ m,
    const float* __restrict__ zn, float* __restrict__ z,
    float* __restrict__ part, const int* __restrict__ live, int hw, int nb,
    int n_planes) {
  __shared__ float buf[2 * kWarps];
  if (!live[blockIdx.y]) return;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * hw;
  float rzn = 0.f, rzo = 0.f;
  for (int k = 0; k < kItems; ++k) {
    const int i = blockIdx.x * kSpan + k * kThreads + threadIdx.x;
    if (i >= hw) break;
    if (!m[off + i]) continue;
    const float rv = r[off + i], zv = zn[off + i];
    rzn = add(rzn, mul(rv, zv));
    rzo = add(rzo, mul(rv, z[off + i]));
    z[off + i] = zv;
  }
  block_sum2(rzn, rzo, buf);
  if (threadIdx.x == 0) {
    part[blockIdx.y * nb + blockIdx.x] = rzn;
    part[(static_cast<int64_t>(n_planes) + blockIdx.y) * nb + blockIdx.x] =
        rzo;
  }
}

// p = z + beta p_old, stored, and the partials of p.Ap, Ap = n p - (the
// sum of p's neighbours) at hole pixels, the neighbours' p recomputed.
__global__ void __launch_bounds__(kThreads) k7_direction_kernel(
    const float* __restrict__ z, const float* __restrict__ p_old,
    const uint8_t* __restrict__ m, float* __restrict__ p,
    float* __restrict__ part, const float* __restrict__ scal,
    const int* __restrict__ live, int h, int w, int nb) {
  __shared__ float buf[kWarps];
  if (!live[blockIdx.y]) return;
  const int hw = h * w;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * hw;
  z += off;
  p_old += off;
  m += off;
  const float beta = scal[4 * blockIdx.y + 3];
  auto pat = [&](int yy, int xq) {
    const int q = yy * w + xq;
    return m[q] ? add(z[q], mul(beta, p_old[q])) : 0.f;
  };
  float acc = 0.f;
  for (int k = 0; k < kItems; ++k) {
    const int i = blockIdx.x * kSpan + k * kThreads + threadIdx.x;
    if (i >= hw) break;
    if (!m[i]) continue;
    const int y = i / w, x = i - y * w;
    const float pv = pat(y, x);
    const float av = sub(mul(static_cast<float>(ncount(y, x, h, w)), pv),
                         nbsum(pat, y, x, h, w));
    acc = add(acc, mul(pv, av));
    p[off + i] = pv;
  }
  const float s = block_sum(acc, buf);
  if (threadIdx.x == 0) part[blockIdx.y * nb + blockIdx.x] = s;
}

// alpha = rz / (p.Ap) from the direction pass's partials (every block of a
// plane sums them alike); x += alpha p, r -= alpha Ap; the partials of
// r.r.
__global__ void __launch_bounds__(kThreads) k7_update_kernel(
    const float* __restrict__ p, const uint8_t* __restrict__ m,
    float* __restrict__ x, float* __restrict__ r,
    const float* __restrict__ part_a, float* __restrict__ part_b,
    const float* __restrict__ scal, const int* __restrict__ live, int h,
    int w, int nb) {
  __shared__ float buf[kWarps];
  __shared__ float alpha_s;
  if (!live[blockIdx.y]) return;
  if (threadIdx.x < 32) {
    const float denom = warp_sum_parts(part_a + blockIdx.y * nb, nb);
    if (threadIdx.x == 0)
      alpha_s = __fdiv_rn(scal[4 * blockIdx.y], denom > 0.f ? denom : 1.f);
  }
  __syncthreads();
  const float alpha = alpha_s;
  const int hw = h * w;
  const int64_t off = static_cast<int64_t>(blockIdx.y) * hw;
  p += off;
  m += off;
  auto pat = [&](int yy, int xq) {
    const int q = yy * w + xq;
    return m[q] ? p[q] : 0.f;
  };
  float acc = 0.f;
  for (int k = 0; k < kItems; ++k) {
    const int i = blockIdx.x * kSpan + k * kThreads + threadIdx.x;
    if (i >= hw) break;
    if (!m[i]) continue;
    const int y = i / w, xx = i - y * w;
    const float pv = p[i];
    const float av = sub(mul(static_cast<float>(ncount(y, xx, h, w)), pv),
                         nbsum(pat, y, xx, h, w));
    x[off + i] = add(x[off + i], mul(alpha, pv));
    const float rn = sub(r[off + i], mul(alpha, av));
    r[off + i] = rn;
    acc = add(acc, mul(rn, rn));
  }
  const float s = block_sum(acc, buf);
  if (threadIdx.x == 0) part_b[blockIdx.y * nb + blockIdx.x] = s;
}

// Per plane (a warp each): rs, rz_new and r.z_old from the partials; at
// set-up tol2 and rz, later beta; the live flags; then the count of
// iterations in which some plane was live and the "some plane live" flag.
// scal[4 P]: rz, rs, tol2, beta; plane_iters[P]: each plane's iterations.
__global__ void __launch_bounds__(1024) k7_scalars_kernel(
    const float* __restrict__ part_b, const float* __restrict__ part_u,
    float* __restrict__ scal, int* __restrict__ live,
    int* __restrict__ plane_iters, int* __restrict__ count, int n_planes,
    int nb, int init) {
  const int lane = threadIdx.x & 31;
  int was = 0, now = 0;
  for (int pl = threadIdx.x >> 5; pl < n_planes; pl += 32) {
    if (!init && !live[pl]) continue;
    const float rs = warp_sum_parts(part_b + pl * nb, nb);
    const float rzn = warp_sum_parts(part_u + pl * nb, nb);
    const float rzo = warp_sum_parts(
        part_u + (static_cast<int64_t>(n_planes) + pl) * nb, nb);
    if (lane != 0) continue;
    float* s = scal + 4 * pl;
    if (init) {
      s[2] = mul(kRtol2, rs);
      s[3] = 0.f;
      plane_iters[pl] = 0;
    } else {
      s[3] = __fdiv_rn(sub(rzn, rzo), s[0] > 0.f ? s[0] : 1.f);
      plane_iters[pl] += 1;
      was = 1;
    }
    s[0] = rzn;
    s[1] = rs;
    live[pl] = rs > s[2];
    now |= live[pl];
  }
  was = __syncthreads_or(was);
  now = __syncthreads_or(now);
  if (threadIdx.x == 0) {
    if (init) count[0] = 0;
    else count[0] += was;
    count[1] = now;
  }
}

// x = the input outside the hole, the solution inside.
__global__ void k7_finish_kernel(const float* __restrict__ planes,
                                 const uint8_t* __restrict__ m,
                                 float* __restrict__ x, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < total && !m[i]) x[i] = planes[i];
}

}  // namespace

// The wrapper's view of one solve (ops/diffusion.py's _Args, field for
// field). Level l = 0 is the input's grid; mask/rc/xc[l] for l >= 1 are
// each level's hole mask, restricted residual and correction.
struct MgArgs {
  const float* planes;     // [P, h0, w0]
  const uint8_t* hole;     // [P, h0, w0], 0 / 1
  float* x;                // [P, h0, w0]: the solution, then the result
  float* r;
  float* z;
  float* p[2];             // p, double-buffered by iteration
  float* part_a;           // [P, nb]: p.Ap partials
  float* part_b;           // [P, nb]: r.r partials
  float* part_u;           // [2, P, nb]: r.z_new, r.z_old partials
  float* scal;             // [P, 4]: rz, rs, tol2, beta
  int* live;               // [P], 1 before set-up
  int* plane_iters;        // [P]
  int* count;              // [2]: iterations, some plane live
  float* sweep;            // coarsest-level scratch (global sweeps)
  float* top_tmp;          // [P, h0, w0] when levels == 1
  uint8_t* mask[kMaxLevels];
  float* rc[kMaxLevels];
  float* xc[kMaxLevels];
  int n_planes;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int levels;
  int nb;                  // partials a plane: ceil(h0 w0 / kSpan)
  int coarse_shared;       // the coarsest level in shared memory
};

namespace {

dim3 fine_grid(const MgArgs& a) { return dim3(a.nb, a.n_planes); }

dim3 pixel_grid(int hw, int n_planes) {
  return dim3((hw + kThreads - 1) / kThreads, n_planes);
}

size_t coarse_smem(int hw) {
  return static_cast<size_t>(hw) * 3 * sizeof(float) + ((hw + 3) & ~3);
}

void vcycle(const MgArgs& a, cudaStream_t s) {
  const int top = a.levels - 1;
  for (int l = 0; l < top; ++l) {
    const float* rl = l == 0 ? a.r : a.rc[l];
    const uint8_t* ml = l == 0 ? a.hole : a.mask[l];
    k7_down_kernel<<<pixel_grid(a.h[l + 1] * a.w[l + 1], a.n_planes),
                     kThreads, 0, s>>>(rl, ml, a.mask[l + 1], a.rc[l + 1],
                                       a.live, a.h[l], a.w[l], a.h[l + 1],
                                       a.w[l + 1]);
  }
  const float* b = top == 0 ? a.r : a.rc[top];
  const uint8_t* m = top == 0 ? a.hole : a.mask[top];
  float* out = top == 0 ? a.top_tmp : a.xc[top];
  const int hc = a.h[top], wc = a.w[top];
  if (a.coarse_shared) {
    k7_coarse_kernel<<<a.n_planes, kCoarseThreads, coarse_smem(hc * wc),
                       s>>>(b, m, out, a.live, hc, wc);
  } else {
    // the sweeps alternate between the scratch and out; the 24th writes
    // out
    for (int k = 0; k < kCoarseSweeps; ++k)
      k7_sweep_kernel<<<pixel_grid(hc * wc, a.n_planes), kThreads, 0, s>>>(
          b, m, (k & 1) ? a.sweep : out, (k & 1) ? out : a.sweep, a.live, hc,
          wc, k == 0);
  }
  for (int l = top - 1; l >= 0; --l) {
    const float* rl = l == 0 ? a.r : a.rc[l];
    const uint8_t* ml = l == 0 ? a.hole : a.mask[l];
    const int hw = a.h[l] * a.w[l];
    k7_up_kernel<<<dim3((hw + kSpan - 1) / kSpan, a.n_planes), kThreads, 0,
                   s>>>(rl, ml, a.xc[l + 1], l == 0 ? a.z : a.xc[l],
                        a.part_u, a.live, a.h[l], a.w[l], a.w[l + 1],
                        a.h[l + 1] * a.w[l + 1], a.nb, a.n_planes, l == 0);
  }
  if (top == 0)
    k7_top_kernel<<<fine_grid(a), kThreads, 0, s>>>(
        a.r, a.hole, a.top_tmp, a.z, a.part_u, a.live, a.h[0] * a.w[0], a.nb,
        a.n_planes);
}

bool valid(const MgArgs* a) {
  if (a == nullptr || a->n_planes <= 0 || a->n_planes > 65535 ||
      a->levels < 1 || a->levels > kMaxLevels || a->nb <= 0)
    return false;
  for (int l = 0; l < a->levels; ++l)
    if (a->h[l] <= 0 || a->w[l] <= 0 ||
        static_cast<int64_t>(a->h[l]) * a->w[l] >= (1 << 30))
      return false;
  return static_cast<int64_t>(a->nb) * kSpan >=
         static_cast<int64_t>(a->h[0]) * a->w[0];
}

}  // namespace

extern "C" {

// sizeof(MgArgs), which the wrapper checks against its own layout.
int k7_args_size() { return static_cast<int>(sizeof(MgArgs)); }

// The most dynamic shared memory a block of device may opt in to.
int k7_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

// Set-up: the mask pyramid, b, the first V-cycle z = M b, and the
// scalars (rz, rs, tol2, the live flags).
int k7_setup(const MgArgs* a, void* stream) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int top = a->levels - 1;
  if (a->coarse_shared) {
    const cudaError_t e = cudaFuncSetAttribute(
        k7_coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(coarse_smem(a->h[top] * a->w[top])));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int l = 1; l <= top; ++l)
    k7_pyramid_kernel<<<pixel_grid(a->h[l] * a->w[l], a->n_planes), kThreads,
                        0, s>>>(l == 1 ? a->hole : a->mask[l - 1], a->mask[l],
                                a->h[l - 1], a->w[l - 1], a->h[l], a->w[l]);
  k7_init_kernel<<<fine_grid(*a), kThreads, 0, s>>>(
      a->planes, a->hole, a->x, a->r, a->z, a->p[0], a->part_b, a->h[0],
      a->w[0], a->nb);
  vcycle(*a, s);
  k7_scalars_kernel<<<1, 1024, 0, s>>>(a->part_b, a->part_u, a->scal,
                                       a->live, a->plane_iters, a->count,
                                       a->n_planes, a->nb, 1);
  return static_cast<int>(cudaGetLastError());
}

// Iterations first .. first + n - 1 of the flexible CG; iteration k reads
// p[k % 2] and writes p[(k + 1) % 2].
int k7_iterate(const MgArgs* a, int first, int n, void* stream) {
  if (!valid(a) || first < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = first; k < first + n; ++k) {
    float* p_old = a->p[k & 1];
    float* p = a->p[(k + 1) & 1];
    k7_direction_kernel<<<fine_grid(*a), kThreads, 0, s>>>(
        a->z, p_old, a->hole, p, a->part_a, a->scal, a->live, a->h[0],
        a->w[0], a->nb);
    k7_update_kernel<<<fine_grid(*a), kThreads, 0, s>>>(
        p, a->hole, a->x, a->r, a->part_a, a->part_b, a->scal, a->live,
        a->h[0], a->w[0], a->nb);
    vcycle(*a, s);
    k7_scalars_kernel<<<1, 1024, 0, s>>>(a->part_b, a->part_u, a->scal,
                                         a->live, a->plane_iters, a->count,
                                         a->n_planes, a->nb, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// x = the input outside the hole, the solution inside: the result.
int k7_finish(const MgArgs* a, void* stream) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(a->n_planes) * a->h[0] * a->w[0];
  k7_finish_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(a->planes, a->hole,
                                                          a->x, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
