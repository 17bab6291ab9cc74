// K1: block-diffusion flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/block_diff_attn.py::_kernel
// (launched by _forward's pallas_call).  Same function: attention of
// q (B, Lq, H, D) over k, v (B, Lk, Hkv, D|Dv) under the block-diffusion
// predicate read from per-position metadata [copy, block, step, pos]
// (copy 2 = invalid), with the strict variant, a sliding window and a
// logit softcap; f32 online softmax; rows with no visible key are zero.
//
// Design: one thread block per (q tile of 64 rows, query head, batch
// row).  The TPU grid's sequential kv axis becomes a loop inside the
// block over this q tile's visited kv tiles, read from a CSR list
// (row_ptr over the B * n_q_tiles rows, col_idx = kv tile indices) that
// the wrapper builds from the conservative tile map.  Ragged edges
// (Lq, Lk not multiples of 64) are masked here, so any tile size works.
//
// Bound on the H100: at the serving shapes (prompt prefill, L of a few
// hundred tokens, D = 128) the work is small and the kernel is bound by
// latency and shared-memory traffic of its CUDA-core FMA loops, not by
// HBM bytes or tensor-core FLOPs.  The design keeps every visited tile
// in shared memory once per block and skips invisible tiles entirely;
// wgmma/TMA pipelining is later work.
#include "attn_tile.cuh"

using namespace rt;

namespace {

constexpr int INVALID_COPY = 2;

__device__ __forceinline__ bool bd_visible(const int* qm, const int* km,
                                           int window, int strict) {
  const int qc = qm[0], qb = qm[1], qs = qm[2], qp = qm[3];
  const int kc = km[0], kb = km[1], ks = km[2], kp = km[3];
  const bool k_a = kc == 0, k_b = kc == 1;
  bool vis;
  if (qc == 0) {
    vis = k_a && kb <= qb;
  } else {
    bool ctx, own;
    if (strict) {
      ctx = k_a && kb < qb;
      own = k_b && kb == qb && ks == qs;
    } else {
      ctx = k_a && (kb < qb || (kb == qb && ks < qs));
      own = k_b && kb == qb && ks >= qs;
    }
    vis = ctx || own;
  }
  vis = vis && qc != INVALID_COPY;
  if (window >= 0) vis = vis && (qp - kp) < window;
  return vis;
}

template <typename T>
__global__ void __launch_bounds__(NT)
bda_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ qmeta,
           const int* __restrict__ kmeta, const int* __restrict__ row_ptr,
           const int* __restrict__ col_idx, T* __restrict__ o, int Lq,
           int Lk, int H, int Hkv, int D, int Dv, int nq, float scale,
           float softcap, int window, int strict) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  extern __shared__ float smem[];
  Tile t;
  int* qm_s = carve(t, smem, D, Dv);
  int* km_s = qm_s + TM * 4;

  const int q0 = qt * TM;
  load_rows<T>(t.q, TM, D, [&](int r) -> const T* {
    int gi = q0 + r;
    return gi < Lq ? q + (((size_t)b * Lq + gi) * H + h) * D : nullptr;
  });
  for (int idx = threadIdx.x; idx < TM * 4; idx += blockDim.x) {
    int r = idx >> 2, c = idx & 3, gi = q0 + r;
    qm_s[idx] = gi < Lq ? qmeta[((size_t)b * Lq + gi) * 4 + c]
                        : (c == 0 ? INVALID_COPY : 0);
  }
  float acc[4][8];
  init_stats(t, acc);

  const int row = b * nq + qt;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  for (int e = e0; e < e1; ++e) {
    const int k0 = col_idx[e] * TN;
    __syncthreads();
    load_rows<T>(t.kv, TN, D, [&](int r) -> const T* {
      int gj = k0 + r;
      return gj < Lk ? k + (((size_t)b * Lk + gj) * Hkv + hk) * D : nullptr;
    });
    for (int idx = threadIdx.x; idx < TN * 4; idx += blockDim.x) {
      int r = idx >> 2, c = idx & 3, gj = k0 + r;
      km_s[idx] = gj < Lk ? kmeta[((size_t)b * Lk + gj) * 4 + c]
                          : (c == 0 ? INVALID_COPY : 0);
    }
    __syncthreads();
    step(
        t, acc, scale, softcap,
        [&](int i, int j) {
          return bd_visible(qm_s + 4 * i, km_s + 4 * j, window, strict);
        },
        [&] {
          load_rows<T>(t.kv, TN, Dv, [&](int r) -> const T* {
            int gj = k0 + r;
            return gj < Lk ? v + (((size_t)b * Lk + gj) * Hkv + hk) * Dv
                           : nullptr;
          });
        });
  }
  store<T>(t, acc, [&](int r) -> T* {
    int gi = q0 + r;
    return gi < Lq ? o + (((size_t)b * Lq + gi) * H + h) * Dv : nullptr;
  });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* qm,
           const int* km, const int* row_ptr, const int* col_idx, void* o,
           int B, int Lq, int Lk, int H, int Hkv, int D, int Dv, int nq,
           float scale, float softcap, int window, int strict,
           cudaStream_t stream) {
  auto bytes = [](int d, int dv) {
    return (tile_smem_floats(d, dv) + 4) * sizeof(float) +
           (size_t)(TM + TN) * 4 * sizeof(int);
  };
  static const cudaError_t attr = cudaFuncSetAttribute(
      bda_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes(DMAX, DMAX));
  if (attr != cudaSuccess) return (int)attr;
  size_t smem = bytes(D, Dv);
  dim3 grid(nq, H, B);
  bda_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qm, km, row_ptr, col_idx,
      (T*)o, Lq, Lk, H, Hkv, D, Dv, nq, scale, softcap, window, strict);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window < 0 disables the window,
// softcap <= 0 disables the softcap.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bda_forward(const void* q, const void* k, const void* v,
                           const int* qmeta, const int* kmeta,
                           const int* row_ptr, const int* col_idx, void* o,
                           int B, int Lq, int Lk, int H, int Hkv, int D,
                           int Dv, int nq, float scale, float softcap,
                           int window, int strict, int dtype,
                           void* stream) {
  if (B == 0 || nq == 0 || H == 0) return 0;
  if (D > DMAX || Dv > DMAX || H % Hkv) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, qmeta, kmeta, row_ptr, col_idx, o, B, Lq,
                         Lk, H, Hkv, D, Dv, nq, scale, softcap, window,
                         strict, s);
  return launch<__nv_bfloat16>(q, k, v, qmeta, kmeta, row_ptr, col_idx, o,
                               B, Lq, Lk, H, Hkv, D, Dv, nq, scale, softcap,
                               window, strict, s);
}
