// K4 and K5: attention that reads the shared KV page pool in place.
//
// K4 replaces repro/kernels/paged_attn.py::_kernel (paged_decode_attention):
// one block of n = bsz queries per sequence attends to the pool pages of
// its block table and then to the block's own fresh keys.  Pool keys are
// visible iff table >= 0, pos >= 0 and pos < cache_limit[b]; self keys
// iff pos >= 0; a sliding window and a softcap apply everywhere.
//
// K5 replaces repro/kernels/paged_attn.py::_prefill_kernel
// (paged_prefill_attention): plain-mode attention of suffix queries over
// the hit-prefix pages of context_table and then the suffix's own keys,
// under the block-causal mask k_pos // bsz <= q_pos // bsz with pos >= 0,
// window and softcap.
//
// Design: the GQA group rides one block.  K4 runs one block per
// (kv head, sequence) holding the group * n query rows (16 for SDAR-8B);
// K5 one block per (suffix q tile, kv head, sequence) holding group *
// (64 / group) rows.  The TPU grid's sequential page axis becomes a loop
// inside the block: each step gathers up to 64 / bsz pages (64 keys)
// through the table into shared memory.  Table entries of -1 are never
// read (their keys stay zero and masked) and a step whose keys are all
// invisible is skipped after one block-wide vote, so unallocated and
// not-yet-committed blocks cost no memory traffic.
//
// Bound on the H100: decode reads every visible page once per kv head
// and does ~2 * rows * D FLOPs per key, so it is memory-bound in
// principle (bytes / 3.35 TB/s); at serving batch sizes the pool a slot
// references is small and the kernel is latency-bound.  The page-gather
// loop reads each page from HBM once per block and keeps the whole step
// in shared memory; split-K over pages and wgmma are later work.
#include "attn_tile.cuh"

using namespace rt;

namespace {

// ------------------------------------------------------------ decode (K4)
template <typename T>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const int* __restrict__ pos_pages,
              const int* __restrict__ table, const T* __restrict__ ks,
              const T* __restrict__ vs, const int* __restrict__ positions,
              const int* __restrict__ cache_limit, T* __restrict__ o, int n,
              int H, int Hkv, int D, int Dv, int bsz, int K, float scale,
              float softcap, int window) {
  const int rt_ = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int M = group * n;
  extern __shared__ float smem[];
  Tile t;
  int* qpos_s = carve(t, smem, D, Dv);
  int* kpos_s = qpos_s + TM;
  int* kok_s = kpos_s + TN;
  int* page_s = kok_s + TN;

  const int r0 = rt_ * TM;
  // row r -> (g, i): head hk * group + g, query i of the block
  auto q_row = [&](int r) -> const T* {
    int gr = r0 + r;
    if (gr >= M) return nullptr;
    int g = gr / n, i = gr - g * n;
    return q + (((size_t)b * n + i) * H + hk * group + g) * D;
  };
  load_rows<T>(t.q, TM, D, q_row);
  for (int r = threadIdx.x; r < TM; r += blockDim.x) {
    int gr = r0 + r;
    qpos_s[r] = gr < M ? positions[(size_t)b * n + (gr % n)] : 0;
  }
  float acc[4][8];
  init_stats(t, acc);

  const int lim = cache_limit[b];
  const int ppt = TN / bsz;  // pages per step
  const bool win = window >= 0;
  auto visible = [&](int i, int j) {
    if (r0 + i >= M || !kok_s[j]) return false;
    return !win || (qpos_s[i] - kpos_s[j]) < window;
  };

  for (int c0 = 0; c0 < K; c0 += ppt) {
    __syncthreads();
    if (threadIdx.x < ppt) {
      int j = c0 + threadIdx.x;
      page_s[threadIdx.x] = j < K ? table[(size_t)b * K + j] : -1;
    }
    __syncthreads();
    int ok = 0;
    if (threadIdx.x < TN) {
      int slot = threadIdx.x / bsz, w = threadIdx.x - slot * bsz;
      int pg = slot < ppt ? page_s[slot] : -1;
      int kpos = pg >= 0 ? pos_pages[(size_t)pg * bsz + w] : -1;
      ok = pg >= 0 && kpos >= 0 && kpos < lim;
      kpos_s[threadIdx.x] = kpos;
      kok_s[threadIdx.x] = ok;
    }
    if (!__syncthreads_or(ok)) continue;
    auto page_row = [&](const T* base, int width) {
      return [=](int r) -> const T* {
        if (!kok_s[r]) return nullptr;
        int slot = r / bsz, w = r - slot * bsz;
        return base + (((size_t)page_s[slot] * bsz + w) * Hkv + hk) * width;
      };
    };
    load_rows<T>(t.kv, TN, D, page_row(kp, D));
    __syncthreads();
    step(t, acc, scale, softcap, visible,
         [&] { load_rows<T>(t.kv, TN, Dv, page_row(vp, Dv)); });
  }

  // the block's own keys (bidirectional self block)
  __syncthreads();
  if (threadIdx.x < TN) {
    int r = threadIdx.x;
    int kpos = r < n ? positions[(size_t)b * n + r] : -1;
    kpos_s[r] = kpos;
    kok_s[r] = kpos >= 0;
  }
  __syncthreads();
  auto self_row = [&](const T* base, int width) {
    return [=](int r) -> const T* {
      return kok_s[r] ? base + (((size_t)b * n + r) * Hkv + hk) * width
                      : nullptr;
    };
  };
  load_rows<T>(t.kv, TN, D, self_row(ks, D));
  __syncthreads();
  step(t, acc, scale, softcap, visible,
       [&] { load_rows<T>(t.kv, TN, Dv, self_row(vs, Dv)); });

  store<T>(t, acc, [&](int r) -> T* {
    int gr = r0 + r;
    if (gr >= M) return nullptr;
    int g = gr / n, i = gr - g * n;
    return o + (((size_t)b * n + i) * H + hk * group + g) * Dv;
  });
}

// ------------------------------------------------------ suffix prefill (K5)
template <typename T>
__global__ void __launch_bounds__(NT)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
               const T* __restrict__ vp, const int* __restrict__ pos_pages,
               const int* __restrict__ ctx_table, const T* __restrict__ ks,
               const T* __restrict__ vs, const int* __restrict__ positions,
               T* __restrict__ o, int Tq, int H, int Hkv, int D, int Dv,
               int bsz, int Kp, float scale, float softcap, int window) {
  const int qt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int qc = TM / group;          // query positions per tile
  const int M = group * qc;
  extern __shared__ float smem[];
  Tile t;
  int* qpos_s = carve(t, smem, D, Dv);
  int* kpos_s = qpos_s + TM;
  int* kok_s = kpos_s + TN;
  int* page_s = kok_s + TN;
  int* qbmax_s = page_s + TN;

  // row r -> (g, i): head hk * group + g, suffix query qt * qc + i
  auto q_index = [&](int r) { return qt * qc + (r % qc); };
  auto row_ok = [&](int r) { return r < M && q_index(r) < Tq; };
  load_rows<T>(t.q, TM, D, [&](int r) -> const T* {
    if (!row_ok(r)) return nullptr;
    return q + (((size_t)b * Tq + q_index(r)) * H + hk * group + r / qc) * D;
  });
  for (int r = threadIdx.x; r < TM; r += blockDim.x)
    qpos_s[r] = row_ok(r) ? positions[(size_t)b * Tq + q_index(r)] : -1;
  float acc[4][8];
  init_stats(t, acc);
  __syncthreads();
  if (threadIdx.x == 0) {
    int mx = -1;
    for (int r = 0; r < TM; ++r)
      if (row_ok(r) && qpos_s[r] / bsz > mx) mx = qpos_s[r] / bsz;
    qbmax_s[0] = mx;
  }

  const bool win = window >= 0;
  auto visible = [&](int i, int j) {
    if (!row_ok(i) || !kok_s[j]) return false;
    int kpos = kpos_s[j], qpos = qpos_s[i];
    if (kpos / bsz > qpos / bsz) return false;
    return !win || (qpos - kpos) < window;
  };

  // hit-prefix pages, read in place through the context table
  const int ppt = TN / bsz;
  for (int c0 = 0; c0 < Kp; c0 += ppt) {
    __syncthreads();
    if (threadIdx.x < ppt) {
      int j = c0 + threadIdx.x;
      page_s[threadIdx.x] = j < Kp ? ctx_table[(size_t)b * Kp + j] : -1;
    }
    __syncthreads();
    int ok = 0;
    if (threadIdx.x < TN) {
      int slot = threadIdx.x / bsz, w = threadIdx.x - slot * bsz;
      int pg = slot < ppt ? page_s[slot] : -1;
      int kpos = pg >= 0 ? pos_pages[(size_t)pg * bsz + w] : -1;
      ok = kpos >= 0 && kpos / bsz <= qbmax_s[0];
      kpos_s[threadIdx.x] = kpos;
      kok_s[threadIdx.x] = ok;
    }
    if (!__syncthreads_or(ok)) continue;
    auto page_row = [&](const T* base, int width) {
      return [=](int r) -> const T* {
        if (!kok_s[r]) return nullptr;
        int slot = r / bsz, w = r - slot * bsz;
        return base + (((size_t)page_s[slot] * bsz + w) * Hkv + hk) * width;
      };
    };
    load_rows<T>(t.kv, TN, D, page_row(kp, D));
    __syncthreads();
    step(t, acc, scale, softcap, visible,
         [&] { load_rows<T>(t.kv, TN, Dv, page_row(vp, Dv)); });
  }

  // the suffix's own keys, 64 at a time; tiles wholly in the future of
  // every query of this tile are skipped
  for (int k0 = 0; k0 < Tq; k0 += TN) {
    __syncthreads();
    int ok = 0;
    if (threadIdx.x < TN) {
      int j = k0 + threadIdx.x;
      int kpos = j < Tq ? positions[(size_t)b * Tq + j] : -1;
      ok = kpos >= 0 && kpos / bsz <= qbmax_s[0];
      kpos_s[threadIdx.x] = kpos;
      kok_s[threadIdx.x] = ok;
    }
    if (!__syncthreads_or(ok)) continue;
    auto self_row = [&](const T* base, int width) {
      return [=](int r) -> const T* {
        return kok_s[r]
                   ? base + (((size_t)b * Tq + k0 + r) * Hkv + hk) * width
                   : nullptr;
      };
    };
    load_rows<T>(t.kv, TN, D, self_row(ks, D));
    __syncthreads();
    step(t, acc, scale, softcap, visible,
         [&] { load_rows<T>(t.kv, TN, Dv, self_row(vs, Dv)); });
  }

  store<T>(t, acc, [&](int r) -> T* {
    if (!row_ok(r)) return nullptr;
    return o + (((size_t)b * Tq + q_index(r)) * H + hk * group + r / qc) * Dv;
  });
}

size_t smem_bytes(int D, int Dv) {
  return (tile_smem_floats(D, Dv) + 4) * sizeof(float) +
         (size_t)(TM + 3 * TN + 4) * sizeof(int);
}

template <typename T>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const int* pos_pages, const int* table, const void* ks,
                  const void* vs, const int* positions, const int* limit,
                  void* o, int B, int n, int H, int Hkv, int D, int Dv,
                  int bsz, int K, float scale, float softcap, int window,
                  cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(DMAX, DMAX));
  if (attr != cudaSuccess) return (int)attr;
  size_t smem = smem_bytes(D, Dv);
  int M = (H / Hkv) * n;
  dim3 grid((M + TM - 1) / TM, Hkv, B);
  decode_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, pos_pages, table,
      (const T*)ks, (const T*)vs, positions, limit, (T*)o, n, H, Hkv, D, Dv,
      bsz, K, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prefill(const void* q, const void* kp, const void* vp,
                   const int* pos_pages, const int* ctx, const void* ks,
                   const void* vs, const int* positions, void* o, int B,
                   int Tq, int H, int Hkv, int D, int Dv, int bsz, int Kp,
                   float scale, float softcap, int window,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(DMAX, DMAX));
  if (attr != cudaSuccess) return (int)attr;
  size_t smem = smem_bytes(D, Dv);
  int qc = TM / (H / Hkv);
  dim3 grid((Tq + qc - 1) / qc, Hkv, B);
  prefill_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, pos_pages, ctx,
      (const T*)ks, (const T*)vs, positions, (T*)o, Tq, H, Hkv, D, Dv, bsz,
      Kp, scale, softcap, window);
  return (int)cudaGetLastError();
}

bool bad_shape(int H, int Hkv, int D, int Dv, int bsz) {
  return D > DMAX || Dv > DMAX || Hkv <= 0 || H % Hkv || H / Hkv > TM ||
         bsz <= 0 || bsz > TN;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window < 0 disables the window,
// softcap <= 0 disables the softcap.  Return the launch's cudaError_t.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const int* pos_pages, const int* table,
                            const void* ks, const void* vs,
                            const int* positions, const int* cache_limit,
                            void* o, int B, int n, int H, int Hkv, int D,
                            int Dv, int bsz, int K, float scale,
                            float softcap, int window, int dtype,
                            void* stream) {
  if (B == 0) return 0;
  if (bad_shape(H, Hkv, D, Dv, bsz) || n != bsz)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_decode<float>(q, kp, vp, pos_pages, table, ks, vs,
                                positions, cache_limit, o, B, n, H, Hkv, D,
                                Dv, bsz, K, scale, softcap, window, s);
  return launch_decode<__nv_bfloat16>(q, kp, vp, pos_pages, table, ks, vs,
                                      positions, cache_limit, o, B, n, H,
                                      Hkv, D, Dv, bsz, K, scale, softcap,
                                      window, s);
}

extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const int* pos_pages, const int* ctx_table,
                             const void* ks, const void* vs,
                             const int* positions, void* o, int B, int Tq,
                             int H, int Hkv, int D, int Dv, int bsz, int Kp,
                             float scale, float softcap, int window,
                             int dtype, void* stream) {
  if (B == 0 || Tq == 0) return 0;
  if (bad_shape(H, Hkv, D, Dv, bsz)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_prefill<float>(q, kp, vp, pos_pages, ctx_table, ks, vs,
                                 positions, o, B, Tq, H, Hkv, D, Dv, bsz, Kp,
                                 scale, softcap, window, s);
  return launch_prefill<__nv_bfloat16>(q, kp, vp, pos_pages, ctx_table, ks,
                                       vs, positions, o, B, Tq, H, Hkv, D,
                                       Dv, bsz, Kp, scale, softcap, window,
                                       s);
}
