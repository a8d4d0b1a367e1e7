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
//            ds = p*(dp - dsum)*scale, dq += ds.k. Two bodies, chosen by
//            dtype:
//     bf16 (flash_dq_bf16_kernel, tensor cores): K2's loop shape, 4 warps,
//            16 query rows a warp; q and dO stay in bf16 shared memory for
//            the block's life (held in registers they would push the warp
//            past 255 registers beside dq, s and dp), k and v tiles stream
//            through a two-stage cp.async ring. Per key tile:
//              1. s = q.k^T and dp = dO.v^T (mma.sync m16n8k16, f32
//                 accumulation), A fragments of q and dO from shared
//                 memory, B fragments of k and v as K2 takes k^T;
//              2. p = exp(s*scale - lse) in f32 (not rounded);
//              3. ds = p*(dp - dsum)*scale rounded to bf16 (the TPU
//                 kernel's ds.astype(k.dtype)) straight into A fragments;
//              4. dq += ds.k, k's B fragments from ldmatrix.trans; dq
//                 (64 f32 a lane) stays in registers. 96 KB of shared
//                 memory, two blocks an SM.
//     f32 (flash_dq_kernel, f32 FMA units, full f32): q, dO, k, v and ds
//            tiles as f32 in shared memory, 4x8 dq micro-tiles a thread.
//   K5 (dk, dv): one block per (n, 64-key tile); loops over query tiles:
//            dv += p^T.dO, dk += ds^T.q. Two bodies, chosen by dtype:
//     bf16 (flash_dkv_bf16_kernel, tensor cores): 8 warps; k and v stay in
//            bf16 shared memory for the block's life, q and dO tiles (and
//            their lse, dsum) stream through a two-stage cp.async ring.
//            Per query tile, rows = keys throughout:
//              1. s^T = k.q^T and dp^T = v.dO^T (mma.sync m16n8k16, f32
//                 accumulation), warp w on key rows 16*(w%4) and query
//                 cols 32*(w/4);
//              2. p^T = exp(s^T*scale - lse), ds^T = p^T*(dp^T - dsum)*scale
//                 from the f32 p^T, both rounded to bf16 (the TPU kernel's
//                 p.astype, ds.astype) into swizzled [64][64] tiles;
//              3. dv += p^T.dO and dk += ds^T.q, warp w on key rows
//                 16*(w%4) and head-dim cols 64*(w/4), B fragments of dO
//                 and q from ldmatrix.trans; dk, dv (64 f32 a lane) stay
//                 in registers. 113 KB of shared memory a block.
//     f32 (flash_dkv_kernel, f32 FMA units, full f32): 256 threads, the
//            k, v, q, dO, p and ds tiles as f32 in shared memory, dk/dv
//            accumulators in registers.
//
// Keys >= L get p = 0 and query rows >= L get p = ds = 0 in the kernel
// (their lse/dsum are never read), so ragged L needs no padding in memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; bound with ctypes (plain C entries below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// x rounded to the dtype the pointer argument points to (the input dtype;
// the f32 bodies leave it as it is)
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

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
            round_as(p * (dp[i][j] - row_dsum[i]) * scale, k);
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

// ------------------------------------------------- bf16, tensor cores

namespace tc {

using namespace fgt_mma;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = BT * D;  // bf16 elements of one [64][128] tile
constexpr float kLog2e = 1.4426950408889634f;
// k, v + two stages of (q, dO, lse, dsum) + p^T and ds^T [64][64] tiles
constexpr size_t kStageBytes =
    sizeof(bf16) * 2 * kTile + sizeof(float) * 2 * BT;
constexpr size_t kSmemBytes =
    sizeof(bf16) * 2 * kTile + 2 * kStageBytes + sizeof(bf16) * 2 * BT * BT;

// stage s of the ring: q tile, dO tile, lse[64], dsum[64]
struct Stage {
  bf16* q;
  bf16* dout;
  float* lse;
  float* dsum;
};

__device__ __forceinline__ Stage stage(unsigned char* ring, int s) {
  unsigned char* p = ring + s * kStageBytes;
  bf16* qs = reinterpret_cast<bf16*>(p);
  float* rows = reinterpret_cast<float*>(qs + 2 * kTile);
  return {qs, qs + kTile, rows, rows + BT};
}

// query tile [q0, q0 + 64): q, dO rows and their lse, dsum (zero past L)
__device__ __forceinline__ void load_query_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum, int q0,
    int len, const Stage& st) {
  load_rows_async<BT, kThreads>(q, q0, len, st.q);
  load_rows_async<BT, kThreads>(dout, q0, len, st.dout);
  if (threadIdx.x < 2 * BT) {
    const int i = threadIdx.x & (BT - 1);
    const bool ok = q0 + i < len;
    const float* src = threadIdx.x < BT ? lse : dsum;
    float* dst = threadIdx.x < BT ? st.lse : st.dsum;
    cp_async4(dst + i, ok ? src + q0 + i : src, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int len, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][D] this block's keys
  bf16* vs = ks + kTile;                         // [BT][D]
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kTile);
  // p^T and ds^T of the current query tile, [key][query]
  bf16* p_t = reinterpret_cast<bf16*>(ring + 2 * kStageBytes);
  bf16* ds_t = p_t + BT * BT;

  const int n = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kr = 16 * (warp & 3);  // this warp's 16 key rows
  const int half = warp >> 2;      // query half (step 1), head-dim half (3)
  const size_t base = static_cast<size_t>(n) * len * D;
  const size_t rbase = static_cast<size_t>(n) * len;
  const int ntiles = (len + BT - 1) / BT;
  q += base;
  dout += base;
  lse += rbase;
  dsum += rbase;

  load_rows_async<BT, kThreads>(k + base, k0, len, ks);
  load_rows_async<BT, kThreads>(v + base, k0, len, vs);
  load_query_tile(q, dout, lse, dsum, 0, len, stage(ring, 0));
  cp_async_commit();

  const bool key_edge = k0 + BT > len;
  const float c = scale * kLog2e;
  float acc_k[8][4], acc_v[8][4];  // key rows g, g+8 x 8 tiles of 8 cols
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[j][e] = 0.f;
      acc_v[j][e] = 0.f;
    }

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * BT;
    if (t + 1 < ntiles)
      load_query_tile(q, dout, lse, dsum, q0 + BT, len,
                      stage(ring, (t + 1) & 1));
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and k, v) have landed
    __syncthreads();
    const Stage st = stage(ring, t & 1);

    // 1. s^T = k.q^T, dp^T = v.dO^T: 16 key rows x 32 queries (4 tiles)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, ks + swz<D>(kr + a_row(lane), 2 * kk + a_chunk(lane)));
      ldmatrix_x4(va, vs + swz<D>(kr + a_row(lane), 2 * kk + a_chunk(lane)));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int off = swz<D>(32 * half + 16 * jp + bn_row(lane),
                               2 * kk + bn_chunk(lane));
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, st.q + off);
        ldmatrix_x4(bo, st.dout + off);
        mma_bf16(s[2 * jp], ka, bq[0], bq[1]);
        mma_bf16(s[2 * jp + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * jp], va, bo[0], bo[1]);
        mma_bf16(dp[2 * jp + 1], va, bo[2], bo[3]);
      }
    }

    // 2. p^T and ds^T from the f32 accumulators, rounded to bf16 into
    //    the swizzled [key][query] tiles
    const bool edge = key_edge || q0 + BT > len;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * half + 8 * j + 2 * t4;  // query within the tile
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = col + (e & 1);
        const int key = k0 + kr + g + 8 * (e >> 1);
        float p = exp2f(fmaf(s[j][e], c, -st.lse[qi] * kLog2e));
        if (edge && (key >= len || q0 + qi >= len)) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - st.dsum[qi]) * scale;
      }
      const int chunk = (32 * half + 8 * j) >> 3;
      const int lo = swz<BT>(kr + g, chunk) + 2 * t4;
      const int hi = swz<BT>(kr + g + 8, chunk) + 2 * t4;
      *reinterpret_cast<uint32_t*>(p_t + lo) = pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(p_t + hi) = pack_bf16(s[j][2], s[j][3]);
      *reinterpret_cast<uint32_t*>(ds_t + lo) =
          pack_bf16(dp[j][0], dp[j][1]);
      *reinterpret_cast<uint32_t*>(ds_t + hi) =
          pack_bf16(dp[j][2], dp[j][3]);
    }
    __syncthreads();

    // 3. dv += p^T.dO, dk += ds^T.q: 16 key rows x 64 head-dim cols
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // query steps of 16
      uint32_t pa[4], sa[4];
      const int aoff = swz<BT>(kr + a_row(lane), 2 * kk + a_chunk(lane));
      ldmatrix_x4(pa, p_t + aoff);
      ldmatrix_x4(sa, ds_t + aoff);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int off = swz<D>(16 * kk + bt_row(lane),
                               8 * half + 2 * jp + bt_chunk(lane));
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, st.dout + off);
        ldmatrix_x4_trans(bq, st.q + off);
        mma_bf16(acc_v[2 * jp], pa, bo[0], bo[1]);
        mma_bf16(acc_v[2 * jp + 1], pa, bo[2], bo[3]);
        mma_bf16(acc_k[2 * jp], sa, bq[0], bq[1]);
        mma_bf16(acc_k[2 * jp + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // p^T, ds^T and this stage are rewritten next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + kr + g + 8 * r;
    if (row >= len) continue;
    const size_t at = base + static_cast<size_t>(row) * D + 64 * half + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack_bf16(acc_k[j][2 * r], acc_k[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack_bf16(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
    }
  }
}

// K4: q, dO tiles + two stages of (k, v) tiles
constexpr int kDqThreads = 128;  // 4 warps, 16 query rows each
constexpr size_t kDqSmemBytes = sizeof(bf16) * 6 * kTile;

__global__ void __launch_bounds__(kDqThreads, 2)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, bf16* __restrict__ dq,
                     int len, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BT][D] this block's q
  bf16* dos = qs + kTile;                         // [BT][D] its dO
  bf16* ring = dos + kTile;  // stage s: k at ring + 2*s*kTile, v after it

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int t4 = lane & 3;  // accumulator cols 2*t4, 2*t4 + 1 of each tile
  const size_t base = static_cast<size_t>(n) * len * D;
  const size_t rbase = static_cast<size_t>(n) * len;
  const int ntiles = (len + BT - 1) / BT;

  load_rows_async<BT, kDqThreads>(q + base, q0, len, qs);
  load_rows_async<BT, kDqThreads>(dout + base, q0, len, dos);
  load_rows_async<BT, kDqThreads>(k + base, 0, len, ring);
  load_rows_async<BT, kDqThreads>(v + base, 0, len, ring + kTile);
  cp_async_commit();

  // rows g, g + 8 of this warp: -lse*log2e and dsum (rows >= L: ds = 0)
  bool row_ok[2];
  float nl[2], ds_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    row_ok[r] = row < len;
    nl[r] = row_ok[r] ? -lse[rbase + row] * kLog2e : 0.f;
    ds_row[r] = row_ok[r] ? dsum[rbase + row] : 0.f;
  }
  const bool row_edge = q0 + BT > len;
  const float c = scale * kLog2e;
  float acc[16][4];  // dq rows g, g+8 x 16 tiles of 8 head-dim cols
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      bf16* nxt = ring + ((t + 1) & 1) * 2 * kTile;
      load_rows_async<BT, kDqThreads>(k + base, (t + 1) * BT, len, nxt);
      load_rows_async<BT, kDqThreads>(v + base, (t + 1) * BT, len,
                                      nxt + kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and q, dO) have landed
    __syncthreads();
    const bf16* ks = ring + (t & 1) * 2 * kTile;
    const bf16* vs = ks + kTile;

    // 1. s = q.k^T, dp = dO.v^T: 16 rows x 64 keys (8 tiles of 8 keys)
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int aoff = swz<D>(16 * warp + a_row(lane), 2 * kk + a_chunk(lane));
      uint32_t qa[4], oa[4];
      ldmatrix_x4(qa, qs + aoff);
      ldmatrix_x4(oa, dos + aoff);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int off = swz<D>(16 * jp + bn_row(lane), 2 * kk + bn_chunk(lane));
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, ks + off);
        ldmatrix_x4(bv, vs + off);
        mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * jp], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], oa, bv[2], bv[3]);
      }
    }

    // 2-3. p in f32, then ds (in s's registers) from the unrounded p
    const bool edge = row_edge || (t + 1) * BT > len;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[j][e], c, nl[r]));
        if (edge && (t * BT + 8 * j + 2 * t4 + (e & 1) >= len || !row_ok[r]))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - ds_row[r]) * scale;
      }

    // 4. dq += bf16(ds).k: 4 key steps of 16 x 16 tiles of 8 head-dim cols
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ks + swz<D>(16 * kk + bt_row(lane),
                                         2 * jp + bt_chunk(lane)));
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    bf16* out = dq + base +
                static_cast<size_t>(q0 + 16 * warp + g + 8 * r) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, int n, int len, float scale,
                      cudaStream_t stream) {
  // 16-byte cp.async and 4-byte stores need aligned rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq)) &
      15)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDqSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((len + BT - 1) / BT, n);
  flash_dq_bf16_kernel<<<grid, kDqThreads, kDqSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dsum,
      static_cast<bf16*>(dq), len, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dk, void* dv, int n, int len, float scale,
                       cudaStream_t stream) {
  // 16-byte cp.async and 4-byte stores need aligned rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) &
      15)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((len + BT - 1) / BT, n);
  flash_dkv_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dsum,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), len, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, k, v, dout, dq: [n, len, 128] contiguous (dtype 0 = float32: the f32
// body, 1 = bfloat16: the tensor-core body, rows 16-byte aligned); lse,
// dsum: [n, len] float32. Returns cudaGetLastError().
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
      dtype == 1 ? tc::launch_dq(q, k, v, dout, l, ds, dq, n, len, scale, s)
                 : launch_dq<float>(q, k, v, dout, l, ds, dq, n, len, scale,
                                    s);
  return static_cast<int>(err);
}

// as above, writing dk and dv: [n, len, 128] in the input dtype (0: the
// f32 body; 1: the tensor-core body, rows 16-byte aligned).
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
      dtype == 1 ? tc::launch_dkv(q, k, v, dout, l, ds, dk, dv, n, len, scale,
                                  s)
                 : launch_dkv<float>(q, k, v, dout, l, ds, dk, dv, n, len,
                                     scale, s);
  return static_cast<int>(err);
}
