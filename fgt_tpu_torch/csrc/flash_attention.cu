// Forward flash attention, head dim 128 (kernel K2).
//
// Replaces fgt_tpu/ops/flash_attention.py::_flash_kernel. See
// fgt_tpu_torch/ops/flash_attention.py for the contract, the design and
// its bound on the H100. Two bodies, chosen by dtype:
//
// * bf16 (flash_fwd_bf16_kernel, tensor cores): one block of 4 warps per
//   (n, 64-query tile), each warp owning 16 query rows whose q fragments
//   it loads into registers once. k and v stream through a two-stage ring
//   of 64-key tiles (bf16, swizzled, 16-byte cp.async: the next tile's
//   loads are in flight while this one's products run). s = q.k^T and
//   o += p.v are mma.sync m16n8k16 with f32 accumulation; p goes from the
//   s accumulators to bf16 A fragments in registers, v's B fragments come
//   from ldmatrix.trans. Online softmax on the accumulators in f32 (row
//   max and sum across each lane quad), scale folded into exp2f as
//   scale*log2(e) on the f32 scores; p is rounded to bf16 only for p.v,
//   the row sum takes the unrounded p (the TPU kernel's p.astype(v.dtype)).
//   80 KB of shared memory a block, two blocks an SM.
// * f32 (flash_fwd_kernel, f32 FMA units, full f32): one block (256
//   threads, 16x16) per (n, 64-query tile); k/v tiles of 64 keys staged in
//   shared memory as f32; online softmax with f32 running max/sum.
//
// Both mask keys >= L in the kernel and write no query row >= L.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entry below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int D = 128;      // head dim
constexpr int BQ = 64;      // queries per block
constexpr int BK = 64;      // keys per tile
constexpr int QS = D + 1;   // padded row stride of the q/k tiles
constexpr int PS = BK + 1;  // padded row stride of the probability tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes =
    sizeof(float) * (BQ * QS + BK * QS + BK * D + BQ * PS);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// rows [r0, r0 + 64) of a [L, D] matrix into a [64][stride] f32 tile,
// times `mul`; rows past L become zero. Consecutive threads take
// consecutive columns (coalesced reads, conflict-free writes).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int len, float* dst, int stride,
                                          float mul) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    dst[r * stride + d] =
        row < len ? to_f(src[static_cast<size_t>(row) * D + d]) * mul : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int len, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][QS], pre-scaled
  float* ks = qs + BQ * QS;       // [BK][QS]
  float* vs = ks + BK * QS;       // [BK][D]
  float* ps = vs + BK * D;        // [BQ][PS]

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15;   // key columns tx + 16j / out cols tx + 16j
  const int ty = threadIdx.x >> 4;   // query rows ty*4 + i
  const size_t base = static_cast<size_t>(n) * len * D;

  load_tile(q + base, q0, len, qs, QS, scale);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(k + base, k0, len, ks, QS, 1.f);
    load_tile(v + base, k0, len, vs, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= len) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads sharing row ty*4+i are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= len) continue;
    const float inv = 1.f / l[i];
    T* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
    if (tx == 0) lse[static_cast<size_t>(n) * len + row] = m[i] + logf(l[i]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int n, int len, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((len + BQ - 1) / BQ, n);
  flash_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, len, scale);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16, tensor cores

namespace tc {

using namespace fgt_mma;

constexpr int kWarps = 4;  // 64-query tiles, two blocks (8 warps) an SM
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;  // queries per block, 16 per warp
constexpr int BK = 64;           // keys per tile
constexpr int kTile = BK * D;    // bf16 elements of one k or v tile
constexpr float kLog2e = 1.4426950408889634f;
// q tile + two stages of (k, v) tiles
constexpr size_t kSmemBytes = sizeof(bf16) * (BQ * D + 4 * kTile);

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int len, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][D]
  bf16* ring = qs + BQ * D;  // stage s: k at ring + 2*s*kTile, v after it

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int t4 = lane & 3;  // accumulator cols 2*t4, 2*t4 + 1 of each tile
  const size_t base = static_cast<size_t>(n) * len * D;
  const int ntiles = (len + BK - 1) / BK;

  load_rows_async<BQ, kThreads>(q + base, q0, len, qs);
  load_rows_async<BK, kThreads>(k + base, 0, len, ring);
  load_rows_async<BK, kThreads>(v + base, 0, len, ring + kTile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as 8 A fragments (head-dim steps of 16)
  uint32_t qf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    ldmatrix_x4(qf[kk], qs + swz<D>(warp * 16 + a_row(lane),
                                    2 * kk + a_chunk(lane)));

  const float c = scale * kLog2e;  // exp(x*scale) = exp2(x*c)
  float m[2] = {kNegInf, kNegInf};  // running max of raw scores, rows g, g+8
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float acc[16][4];                 // o rows g, g+8 x 16 tiles of 8 cols
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      bf16* nxt = ring + ((t + 1) & 1) * 2 * kTile;
      load_rows_async<BK, kThreads>(k + base, (t + 1) * BK, len, nxt);
      load_rows_async<BK, kThreads>(v + base, (t + 1) * BK, len, nxt + kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed (tile t + 1 may be in flight)
    __syncthreads();
    const bf16* ks = ring + (t & 1) * 2 * kTile;
    const bf16* vs = ks + kTile;

    // s = q.k^T: 16 rows x 64 keys (8 tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + swz<D>(16 * jp + bn_row(lane),
                                   2 * kk + bn_chunk(lane)));
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }

    if ((t + 1) * BK > len) {  // ragged last tile: keys >= L
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * BK + 8 * j + 2 * t4 + (e & 1) >= len) s[j][e] = kNegInf;
    }

    // online softmax: the 4 lanes of a quad share rows g and g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * c);
      m[r] = mx[r];
      mc[r] = mx[r] * c;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));  // unrounded p
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // o += bf16(p).v: 4 key steps of 16 x 16 tiles of 8 head-dim cols
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + swz<D>(16 * kk + bt_row(lane),
                                         2 * jp + bt_chunk(lane)));
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= len) continue;
    bf16* orow = o + base + static_cast<size_t>(row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
    if (t4 == 0)
      lse[static_cast<size_t>(n) * len + row] = m[r] * scale + logf(l[r]);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int n, int len, float scale,
                   cudaStream_t stream) {
  // 16-byte cp.async and 4-byte stores need aligned rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((len + BQ - 1) / BQ, n);
  flash_fwd_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, len, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, k, v, o: [n, len, 128] contiguous (dtype 0 = float32: the f32 body,
// 1 = bfloat16: the tensor-core body, rows 16-byte aligned); lse: [n, len]
// float32. Returns cudaGetLastError().
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int n, int len, float scale, int dtype,
                                       void* stream) {
  if (n <= 0 || len <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      dtype == 1 ? tc::launch(q, k, v, o, l, n, len, scale, s)
                 : launch<float>(q, k, v, o, l, n, len, scale, s);
  return static_cast<int>(err);
}
