// Flash attention backward, head dim 128 (kernels K4 and K5).
//
// Replaces fgt_tpu/ops/flash_attention.py::_flash_dq_kernel (K4) and
// ::_flash_dkv_kernel (K5). See fgt_tpu_torch/ops/flash_attention.py for
// the contract, the design and the bounds on the H100. Both kernels
// recompute p = exp(q.k^T * scale - lse) from the row logsumexp that K2
// saved, take dsum = rowsum(dO * O) from the caller, and accumulate in
// f32 with no atomics (each output row is owned by one block, so results
// are deterministic).
//
//   K4 (dq): one block per (n, 64-query tile); loops over key tiles:
//            s = q.k^T*scale, p = exp(s - lse), dp = dO.v^T,
//            ds = p*(dp - dsum)*scale, dq += ds.k.
//   K5 (dk, dv): one block per (n, 64-key tile); loops over query tiles:
//            dv += p^T.dO, dk += ds^T.q; dk/dv accumulators in registers.
//
// Keys >= L get p = 0 and query rows >= L get p = ds = 0 in the kernel
// (their lse/dsum are never read), so ragged L needs no padding in memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entries below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;      // head dim
constexpr int BT = 64;      // rows per tile (queries or keys)
constexpr int QS = D + 1;   // padded row stride of the [64][128] tiles
constexpr int PS = BT + 1;  // padded row stride of the [64][64] tiles
constexpr int kThreads = 256;
// K4: q, k, v, dO tiles + ds tile
constexpr size_t kDqSmem = sizeof(float) * (4 * BT * QS + BT * PS);
// K5: k, v, q, dO tiles + p and ds tiles
constexpr size_t kDkvSmem = sizeof(float) * (4 * BT * QS + 2 * BT * PS);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [r0, r0 + 64) of a [L, D] matrix into a [64][QS] f32 tile; rows
// past L become zero. Consecutive threads take consecutive columns.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int len, float* dst) {
  for (int idx = threadIdx.x; idx < BT * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    dst[r * QS + d] =
        row < len ? to_f(src[static_cast<size_t>(row) * D + d]) : 0.f;
  }
}

// The 64x64 score and dO.v^T tiles of one (query tile, key tile) pair:
// thread (ty, tx) computes rows ty*4 + i and columns tx + 16j of both
// a = qs.ks^T and b = dos.vs^T in one pass over the head dim.
__device__ __forceinline__ void two_products(const float* qs, const float* ks,
                                             const float* dos,
                                             const float* vs, int ty, int tx,
                                             float a[4][4], float b[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[i][j] = 0.f;
      b[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4], dv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty * 4 + i) * QS + d];
      dv[i] = dos[(ty * 4 + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * QS + d];
      vv[j] = vs[(tx + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = fmaf(qv[i], kv[j], a[i][j]);
        b[i][j] = fmaf(dv[i], vv[j], b[i][j]);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                T* __restrict__ dq, int len, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // [BT][QS]
  float* dos = qs + BT * QS;      // [BT][QS]
  float* ks = dos + BT * QS;      // [BT][QS]
  float* vs = ks + BT * QS;       // [BT][QS]
  float* dss = vs + BT * QS;      // [BT][PS] ds of the current key tile

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(n) * len * D;
  const size_t rbase = static_cast<size_t>(n) * len;

  load_tile(q + base, q0, len, qs);
  load_tile(dout + base, q0, len, dos);

  // query rows >= L: lse/dsum never read, their ds forced to zero below
  float row_lse[4], row_dsum[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    row_ok[i] = row < len;
    row_lse[i] = row_ok[i] ? lse[rbase + row] : 0.f;
    row_dsum[i] = row_ok[i] ? dsum[rbase + row] : 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < len; k0 += BT) {
    __syncthreads();  // previous k/v/ds tiles fully consumed
    load_tile(k + base, k0, len, ks);
    load_tile(v + base, k0, len, vs);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok[i] && (k0 + tx + 16 * j < len);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[(ty * 4 + i) * PS + tx + 16 * j] =
            p * (dp[i][j] - row_dsum[i]) * scale;
      }
    __syncthreads();

    for (int c = 0; c < BT; ++c) {
      float dv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = dss[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    T* out = dq + base + static_cast<size_t>(q0 + ty * 4 + i) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) store(out + tx + 16 * j, acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, T* __restrict__ dk,
                 T* __restrict__ dv, int len, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;               // [BT][QS] this block's keys
  float* vs = ks + BT * QS;       // [BT][QS]
  float* qs = vs + BT * QS;       // [BT][QS] current query tile
  float* dos = qs + BT * QS;      // [BT][QS]
  float* ps = dos + BT * QS;      // [BT][PS] p  [query][key]
  float* dss = ps + BT * PS;      // [BT][PS] ds [query][key]

  const int n = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = static_cast<size_t>(n) * len * D;
  const size_t rbase = static_cast<size_t>(n) * len;

  load_tile(k + base, k0, len, ks);
  load_tile(v + base, k0, len, vs);

  bool key_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) key_ok[j] = k0 + tx + 16 * j < len;

  // thread (ty, tx) owns key rows ty*4 + i, columns tx + 16j of dk and dv
  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < len; q0 += BT) {
    __syncthreads();  // previous q/dO/p/ds tiles fully consumed
    load_tile(q + base, q0, len, qs);
    load_tile(dout + base, q0, len, dos);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const bool row_ok = row < len;
      const float l = row_ok ? lse[rbase + row] : 0.f;
      const float ds_row = row_ok ? dsum[rbase + row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && key_ok[j];
        const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
        ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        dss[(ty * 4 + i) * PS + tx + 16 * j] = p * (dp[i][j] - ds_row) * scale;
      }
    }
    __syncthreads();

    for (int r = 0; r < BT; ++r) {
      float pv[4], dsv[4], dov[8], qv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * PS + ty * 4 + i];
        dsv[i] = dss[r * PS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dov[j] = dos[r * QS + tx + 16 * j];
        qv[j] = qs[r * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_v[i][j] = fmaf(pv[i], dov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= len) continue;
    T* dk_row = dk + base + static_cast<size_t>(row) * D;
    T* dv_row = dv + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store(dk_row + tx + 16 * j, acc_k[i][j]);
      store(dv_row + tx + 16 * j, acc_v[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, int n, int len, float scale,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDqSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((len + BT - 1) / BT, n);
  flash_dq_kernel<T><<<grid, kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dk, void* dv, int n, int len, float scale,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDkvSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((len + BT - 1) / BT, n);
  flash_dkv_kernel<T><<<grid, kThreads, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), len, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq: [n, len, 128] contiguous (dtype 0 = float32,
// 1 = bfloat16); lse, dsum: [n, len] float32. Returns cudaGetLastError().
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* dsum, void* dq, int n, int len,
                                  float scale, int dtype, void* stream) {
  if (n <= 0 || len <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  const cudaError_t err =
      dtype == 1
          ? launch_dq<__nv_bfloat16>(q, k, v, dout, l, ds, dq, n, len, scale, s)
          : launch_dq<float>(q, k, v, dout, l, ds, dq, n, len, scale, s);
  return static_cast<int>(err);
}

// as above, writing dk and dv: [n, len, 128] in the input dtype.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dsum,
                                   void* dk, void* dv, int n, int len,
                                   float scale, int dtype, void* stream) {
  if (n <= 0 || len <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  const cudaError_t err =
      dtype == 1 ? launch_dkv<__nv_bfloat16>(q, k, v, dout, l, ds, dk, dv, n,
                                             len, scale, s)
                 : launch_dkv<float>(q, k, v, dout, l, ds, dk, dv, n, len,
                                     scale, s);
  return static_cast<int>(err);
}
