// Shared tile engine of the port's attention kernels (K1, K4, K5).
//
// One thread block of NT = 256 threads owns up to TM = 64 query rows and
// streams keys through shared memory TN = 64 at a time.  For each key
// tile it runs the flash-attention step of the TPU kernels: scores
// S = (Q K^T) * scale in f32, optional softcap c * tanh(S / c), the
// visibility mask, an online softmax with running (m, l) row statistics,
// and acc = acc * alpha + P V with the accumulator held in registers.
// Rows whose keys are all masked keep m = NEG_INF and l = 0 and are
// written as zeros, exactly like the Pallas kernels.
//
// Shared memory (floats, head dims D, Dv <= DMAX = 128):
//   q  : TM x (D + 1)               query tile, f32
//   kv : TN x (max(D, Dv) + 1)      key tile, then the value tile
//   s  : TM x (TN + 1)              scores, then probabilities
//   m, l, alpha : TM each           row statistics
// The +1 row padding keeps the column-strided reads of the score loop
// free of bank conflicts.  K and V share one buffer (V is loaded after
// the scores are computed), which keeps a block at ~84 KB so that two
// blocks fit on one SM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int DMAX = 128;
constexpr int NT = 256;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Tile {
  float* q;
  float* kv;
  float* s;
  float* m;
  float* l;
  float* alpha;
  int D;
  int Dv;
};

__host__ __device__ inline size_t tile_smem_floats(int D, int Dv) {
  int dmax = D > Dv ? D : Dv;
  return (size_t)TM * (D + 1) + (size_t)TN * (dmax + 1) +
         (size_t)TM * (TN + 1) + 3 * TM;
}

// Carve the tile buffers; returns a pointer just past them (16-byte
// aligned) for the kernel's own metadata arrays.
__device__ inline int* carve(Tile& t, float* base, int D, int Dv) {
  int dmax = D > Dv ? D : Dv;
  t.D = D;
  t.Dv = Dv;
  t.q = base;
  t.kv = t.q + TM * (D + 1);
  t.s = t.kv + TN * (dmax + 1);
  t.m = t.s + TM * (TN + 1);
  t.l = t.m + TM;
  t.alpha = t.l + TM;
  size_t off = tile_smem_floats(D, Dv);
  off = (off + 3) & ~(size_t)3;
  return reinterpret_cast<int*>(base + off);
}

// Load `rows` rows of width `width` into dst (row stride width + 1).
// row_ptr(r) gives the global row or nullptr for a zero row.
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_rows(float* dst, int rows, int width,
                                          RowPtr row_ptr) {
  for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x) {
    int r = idx / width;
    int d = idx - r * width;
    const T* p = row_ptr(r);
    dst[r * (width + 1) + d] = p ? to_f(p[d]) : 0.f;
  }
}

__device__ __forceinline__ void init_stats(Tile& t, float (&acc)[4][8]) {
  for (int r = threadIdx.x; r < TM; r += blockDim.x) {
    t.m[r] = NEG_INF;
    t.l[r] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
}

// S = Q K^T * scale (+ softcap), masked entries set to -inf.  The key
// tile is in t.kv with row stride D + 1.  vis(i, j) decides visibility.
template <typename Vis>
__device__ __forceinline__ void scores(Tile& t, float scale, float softcap,
                                       Vis vis) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int D = t.D;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  const float* q = t.q;
  const float* k = t.kv;
  for (int d = 0; d < D; ++d) {
    float qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = q[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) kb[b] = k[(tx + 16 * b) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qa[a], kb[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int i = ty + 16 * a, j = tx + 16 * b;
      float s = acc[a][b] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      t.s[i * (TN + 1) + j] = vis(i, j) ? s : -__int_as_float(0x7f800000);
    }
  }
}

// Online-softmax update of the row statistics; turns scores into
// probabilities in place.  One warp per 8 rows, two columns per lane.
__device__ __forceinline__ void softmax_update(Tile& t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TM; r += NT / 32) {
    float* row = t.s + r * (TN + 1);
    float s0 = row[lane], s1 = row[lane + 32];
    float mx = fmaxf(fmaxf(s0, s1), NEG_INF);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float m_prev = t.m[r];
    float m_new = fmaxf(m_prev, mx);
    float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);  // -inf -> 0
    row[lane] = p0;
    row[lane + 32] = p1;
    float sum = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      float alpha = expf(m_prev - m_new);
      t.alpha[r] = alpha;
      t.l[r] = t.l[r] * alpha + sum;
      t.m[r] = m_new;
    }
  }
}

// acc = acc * alpha + P V; the value tile is in t.kv with stride Dv + 1.
__device__ __forceinline__ void accumulate_pv(Tile& t, float (&acc)[4][8]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int Dv = t.Dv;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float al = t.alpha[ty + 16 * a];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] *= al;
  }
  const float* v = t.kv;
  for (int j = 0; j < TN; ++j) {
    float p[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = t.s[(ty + 16 * a) * (TN + 1) + j];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int dv = tx + 16 * c;
      float vv = dv < Dv ? v[j * (Dv + 1) + dv] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(p[a], vv, acc[a][c]);
    }
  }
}

// One key tile: the caller has loaded the keys into t.kv (stride D + 1)
// and synchronised.  load_v() fills t.kv with the values (stride Dv + 1).
template <typename Vis, typename LoadV>
__device__ __forceinline__ void step(Tile& t, float (&acc)[4][8],
                                     float scale, float softcap, Vis vis,
                                     LoadV load_v) {
  scores(t, scale, softcap, vis);
  __syncthreads();
  load_v();
  softmax_update(t);
  __syncthreads();
  accumulate_pv(t, acc);
}

// out = acc / l for every row with out_row(i) != nullptr.
template <typename T, typename OutRow>
__device__ __forceinline__ void store(Tile& t, float (&acc)[4][8],
                                      OutRow out_row) {
  __syncthreads();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int i = ty + 16 * a;
    T* o = out_row(i);
    if (!o) continue;
    float l = t.l[i];
    l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int dv = tx + 16 * c;
      if (dv < t.Dv) o[dv] = from_f<T>(acc[a][c] / l);
    }
  }
}

}  // namespace rt
