// Forward flash attention, head dim 128 (kernel K2).
//
// Replaces fgt_tpu/ops/flash_attention.py::_flash_kernel. See
// fgt_tpu_torch/ops/flash_attention.py for the contract, the design and
// its bound on the H100. One block (256 threads, 16x16) per (n, 64-query
// tile); k/v tiles of 64 keys staged in shared memory as f32; online
// softmax with f32 running max/sum; keys >= L masked in the kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entry below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

}  // namespace

// q, k, v, o: [n, len, 128] contiguous (dtype 0 = float32, 1 = bfloat16);
// lse: [n, len] float32. Returns cudaGetLastError().
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int n, int len, float scale, int dtype,
                                       void* stream) {
  if (n <= 0 || len <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(q, k, v, o, l, n, len, scale, s)
                 : launch<float>(q, k, v, o, l, n, len, scale, s);
  return static_cast<int>(err);
}
