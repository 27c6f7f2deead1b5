// Fused non-overlap moment chain of Linear CorEx, for Hopper (sm_90a).
//
// Replaces linearcorex_tpu/ops/pallas_moments.py :: ns_chain (Pallas body
// _chain_kernel). For C_xy (p, m), ry (m, m) and sqz (m,), all float32, it
// computes per variable row i
//   rho = clip(C_xy / sqz, ±clip), invrho = 1/(1 − rho²), rr = rho·invrho,
//   qij = rr·ry, S_i = Σ_j rho·rr, Q_i = Σ_j rr·qij,
//   α = 1/(1 + Q_i − S_i²), β = 1/(1 + S_i),
//   AA = α(1 + rho²)invrho²·qij − 2(αS_i + β)·rho·invrho²,
// and over all rows H = (rr·α)ᵀ·rr (m, m), κ = Σ_i AA·rho, μ = Σ_i α·rr·qij,
// Σ_i MI = Σ_i −½·log1p(−rho²) (m each) and Σ_i log(max(N_i·β², 1e-30)).
//
// What bounds it on this card: the two m-deep products, qij = rr·ry and H,
// take p·m² FMAs each (2.6 GFMA each at p=10k, m=512) against one p×m
// read of C_xy and one p×m write of AA (20 MB each at that shape). So it is
// bound by float32 FMA issue, not by device memory.
//
// What the design does about it:
// - The two products are tiled GEMMs on the CUDA cores: 128 x 128 block
//   tiles, 16-deep shared-memory steps, and an 8 x 8 register tile per
//   thread read from shared memory as float4, so each thread issues 64
//   FMAs per 4 shared-memory loads. The next step's slices arrive by
//   cp.async into a second buffer while the current one is multiplied.
//   rr and rr·α are computed once into scratch and read by the products
//   instead of being recomputed per tile.
// - No float atomics, so two runs on the same inputs give bitwise-equal
//   outputs. The TPU kernel accumulated H and the column sums over a
//   sequential grid; here blocks run in any order, so H is split over a
//   fixed number of p ranges (chosen from the shape alone, never from the
//   card), each block writes its partial, and a reduce pass adds the
//   partials in a fixed order; the same holds for κ, μ and MI per row tile.
// - ry (1 MiB at m=512) never has to fit on chip: the TPU kernel kept it
//   resident in VMEM, here it streams through shared memory in 16 x 128
//   tiles like any GEMM operand.
// - Ragged p and m edges are masked in the kernels; nothing is padded.
// - float32 on the CUDA cores: tensor cores (wgmma) with TF32 would not hold
//   the 1e-5 agreement with the reference; a 3xTF32 or bf16x3 split is
//   later work.
//
// Passes: rr → qij GEMM (into the AA buffer) → row pass (S_i, Q_i, α, β,
// AA, rr·α, log v_i, column partials) → H GEMM (partials over p ranges)
// → reduce. Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC (linearcorex_tpu_torch/utils/build.py). The C
// entry points take raw pointers and a cudaStream_t and return a
// cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // every kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;             // GEMM block tile edge
constexpr int kK = 16;                 // GEMM contraction depth per step
constexpr int kLd = kTile + 4;         // padded shared row, float4-aligned
constexpr int kRows = 32;              // rows per row-pass block
constexpr int kHBlocksTarget = 264;    // about two H blocks per SM
constexpr int kElemBlocks = 1056;      // grid of the elementwise rr pass

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
inline long long round_up(long long a, long long b) {
  return ceil_div(a, b) * b;
}

__device__ __forceinline__ float clip_rho(float c, float s, float clip) {
  float r = c / s;
  // comparisons keep a NaN as NaN, as jnp.clip and torch.clamp do
  r = r < -clip ? -clip : r;
  return r > clip ? clip : r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Asynchronous 4-byte copy global -> shared (sm_80+); when `pred` is false
// nothing is read and the shared word is zero-filled.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool pred) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Offset within a 128-wide tile of a thread's i-th row (or column) of its
// 8 x 8 register tile: two groups of 4, 64 apart (t = ty or tx, 0..15).
__device__ __forceinline__ int tile_off(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// acc += a_sᵀ·b_s over one kK-deep step: a_s[k][row], b_s[k][col].
__device__ __forceinline__ void tile_fma(float (*a_s)[kLd], float (*b_s)[kLd],
                                         int ty, int tx, float acc[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a_s[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b_s[kk][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

struct Plan {
  long long pm;         // p*m
  int n_row_tiles;      // row-pass blocks
  int tiles_p, tiles_m; // GEMM tiles along p and m
  int rows_per_split;   // p rows per H block
  int ks;               // H splits of p
};

Plan make_plan(int p, int m) {
  Plan pl;
  pl.pm = (long long)p * m;
  pl.n_row_tiles = (int)ceil_div(p, kRows);
  pl.tiles_p = (int)ceil_div(p, kTile);
  pl.tiles_m = (int)ceil_div(m, kTile);
  // as many p ranges as keep the H grid within one wave of kHBlocksTarget
  long long want = kHBlocksTarget / ((long long)pl.tiles_m * pl.tiles_m);
  const long long max_splits = ceil_div(p, kK);
  if (want > max_splits) want = max_splits;
  if (want < 1) want = 1;
  pl.rows_per_split = (int)round_up(ceil_div(p, want), kK);
  pl.ks = (int)ceil_div(p, pl.rows_per_split);
  return pl;
}

__global__ void __launch_bounds__(kThreads)
chain_rr_kernel(const float* __restrict__ cxy, const float* __restrict__ sqz,
                float clip, long long pm, int m, float* __restrict__ rr) {
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < pm; idx += (long long)gridDim.x * kThreads) {
    const float rho = clip_rho(cxy[idx], sqz[idx % m], clip);
    const float invrho = 1.f / (1.f - rho * rho);
    rr[idx] = rho * invrho;
  }
}

// qij = rr·ry, one 128 x 128 output tile per block; the next kK-deep
// slices of rr and ry stream into the other shared buffer while this one
// is multiplied.
__global__ void __launch_bounds__(kThreads, 2)
chain_qij_kernel(const float* __restrict__ rr, const float* __restrict__ ry,
                 int p, int m, float* __restrict__ qij) {
  __shared__ __align__(16) float a_s[2][kK][kLd];   // rr slice, transposed
  __shared__ __align__(16) float b_s[2][kK][kLd];   // ry slice
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load = [&](int st, int k0) {
    for (int idx = tid; idx < kK * kTile; idx += kThreads) {
      const int r = idx / kK, kk = idx - r * kK;
      const long long gi = row0 + r;
      const int k = k0 + kk;
      const bool ok = gi < p && k < m;
      cp_async4(&a_s[st][kk][r], ok ? rr + gi * m + k : rr, ok);
    }
    for (int idx = tid; idx < kK * kTile; idx += kThreads) {
      const int kk = idx / kTile, c = idx - kk * kTile;
      const int k = k0 + kk, gc = col0 + c;
      const bool ok = k < m && gc < m;
      cp_async4(&b_s[st][kk][c], ok ? ry + (long long)k * m + gc : ry, ok);
    }
    cp_async_commit();
  };

  const int steps = (m + kK - 1) / kK;
  load(0, 0);
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) {
      load(cur ^ 1, (t + 1) * kK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_fma(a_s[cur], b_s[cur], ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gi = row0 + tile_off(ty, i);
    if (gi >= p) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + tile_off(tx, j);
      if (gc < m) qij[gi * m + gc] = acc[i][j];
    }
  }
}

// Per-row scalars and AA over kRows rows; `aa` holds qij on entry.
__global__ void __launch_bounds__(kThreads)
chain_rows_kernel(const float* __restrict__ cxy, const float* __restrict__ sqz,
                  const float* __restrict__ rr, float clip, int p, int m,
                  float* __restrict__ aa, float* __restrict__ rra,
                  float* __restrict__ logv_out, float* __restrict__ col_part) {
  __shared__ float alpha_s[kRows];
  __shared__ float coef_s[kRows];      // α·S_i + β
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kRows;

  // S_i and Q_i, one warp per row, lanes striding over the columns.
  for (int r = warp; r < kRows; r += kWarps) {
    const long long gi = row0 + r;
    float s = 0.f, q = 0.f;
    if (gi < p) {
      for (int c = lane; c < m; c += 32) {
        const float rho = clip_rho(cxy[gi * m + c], sqz[c], clip);
        const float v = rr[gi * m + c];
        s += rho * v;
        q += v * aa[gi * m + c];
      }
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      const float ni = 1.f + q - s * s;
      const float alpha = 1.f / ni;
      const float beta = 1.f / (1.f + s);
      alpha_s[r] = alpha;
      coef_s[r] = alpha * s + beta;
      if (gi < p) {
        float v = ni * beta * beta;
        v = v < 1e-30f ? 1e-30f : v;
        logv_out[gi] = logf(v);
      }
    }
  }
  __syncthreads();

  // AA over qij, rr·α for the H pass, and this block's column partials of
  // κ, μ and MI, summed over its rows in order.
  for (int c = tid; c < m; c += kThreads) {
    const float s_c = sqz[c];
    float kappa = 0.f, mu = 0.f, mi = 0.f;
    for (int r = 0; r < kRows; ++r) {
      const long long gi = row0 + r;
      if (gi >= p) break;
      const float rho = clip_rho(cxy[gi * m + c], s_c, clip);
      const float invrho = 1.f / (1.f - rho * rho);
      const float inv2 = invrho * invrho;
      const float q = aa[gi * m + c];
      const float al = alpha_s[r];
      const float a = al * (1.f + rho * rho) * inv2 * q
                      - 2.f * coef_s[r] * rho * inv2;
      const float v = rr[gi * m + c];
      aa[gi * m + c] = a;
      rra[gi * m + c] = v * al;
      kappa += a * rho;
      mu += al * v * q;
      mi += -0.5f * log1pf(-rho * rho);
    }
    float* part = col_part + (long long)blockIdx.x * 3 * m;
    part[c] = kappa;
    part[m + c] = mu;
    part[2 * m + c] = mi;
  }
}

// Partial H = Σ_i (rr_i·α_i)ᵀ·rr_i over one range of p, one 128 x 128 tile
// per block, double-buffered like the qij pass.
__global__ void __launch_bounds__(kThreads, 2)
chain_hmat_kernel(const float* __restrict__ rra, const float* __restrict__ rr,
                  int p, int m, int rows_per_split,
                  float* __restrict__ h_part) {
  __shared__ __align__(16) float a_s[2][kK][kLd];   // rr[i, a0 + a]·α_i
  __shared__ __align__(16) float b_s[2][kK][kLd];   // rr[i, b0 + b]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;
  const long long i_begin = (long long)blockIdx.z * rows_per_split;
  long long i_end = i_begin + rows_per_split;
  if (i_end > p) i_end = p;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load = [&](int st, long long i0) {
    for (int idx = tid; idx < kK * kTile; idx += kThreads) {
      const int kk = idx / kTile, c = idx - kk * kTile;
      const long long i = i0 + kk;
      const bool ok_a = i < i_end && a0 + c < m;
      const bool ok_b = i < i_end && b0 + c < m;
      cp_async4(&a_s[st][kk][c], ok_a ? rra + i * m + a0 + c : rra, ok_a);
      cp_async4(&b_s[st][kk][c], ok_b ? rr + i * m + b0 + c : rr, ok_b);
    }
    cp_async_commit();
  };

  const int steps = (int)((i_end - i_begin + kK - 1) / kK);
  load(0, i_begin);
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) {
      load(cur ^ 1, i_begin + (long long)(t + 1) * kK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_fma(a_s[cur], b_s[cur], ty, tx, acc);
    __syncthreads();
  }
  float* out = h_part + (long long)blockIdx.z * m * m;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ra = a0 + tile_off(ty, i);
    if (ra >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cb = b0 + tile_off(tx, j);
      if (cb < m) out[(long long)ra * m + cb] = acc[i][j];
    }
  }
}

// Blocks 0 .. gridDim.x-2: one thread per output of H (m*m) and of κ, μ, MI
// (3m). The last block: the tree sum of log v_i over p.
__global__ void __launch_bounds__(kThreads)
chain_reduce_kernel(const float* __restrict__ h_part, int ks,
                    const float* __restrict__ col_part, int n_tiles,
                    const float* __restrict__ logv, int p, int m,
                    float* __restrict__ hmat, float* __restrict__ red) {
  const long long mm = (long long)m * m;
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ float buf[kThreads];
    float s = 0.f;
    for (int i = threadIdx.x; i < p; i += kThreads) s += logv[i];
    buf[threadIdx.x] = s;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0) red[3 * m] = buf[0];
    return;
  }
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx < mm) {
    float s = 0.f;
    for (int z = 0; z < ks; ++z) s += h_part[z * mm + idx];
    hmat[idx] = s;
  } else if (idx < mm + 3 * m) {
    const long long q = idx - mm;
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += col_part[(long long)t * 3 * m + q];
    red[q] = s;
  }
}

}  // namespace

extern "C" {

// Floats of scratch memory lcx_ns_chain needs for a (p, m) problem, or -1
// for an empty shape.
long long lcx_ns_chain_workspace(int p, int m) {
  if (p < 1 || m < 1) return -1;
  const Plan pl = make_plan(p, m);
  return 2 * pl.pm + p + (long long)pl.n_row_tiles * 3 * m
         + (long long)pl.ks * m * m;
}

// Runs the passes on `stream`. Outputs: aa (p, m), hmat (m, m) and
// red (3m + 1) = [κ, μ, Σ MI, Σ log v_i]. `work` holds
// lcx_ns_chain_workspace(p, m) floats. Returns a cudaError_t (0 = success).
int lcx_ns_chain(const float* cxy, const float* ry, const float* sqz,
                 float clip, int p, int m, float* aa, float* hmat, float* red,
                 float* work, int device, void* stream) {
  if (p < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(p, m);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rr = work;
  float* rra = rr + pl.pm;
  float* logv = rra + pl.pm;
  float* col_part = logv + p;
  float* h_part = col_part + (long long)pl.n_row_tiles * 3 * m;

  long long eblocks = ceil_div(pl.pm, kThreads);
  if (eblocks > kElemBlocks) eblocks = kElemBlocks;
  chain_rr_kernel<<<(int)eblocks, kThreads, 0, s>>>(cxy, sqz, clip, pl.pm, m,
                                                     rr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  chain_qij_kernel<<<dim3(pl.tiles_m, pl.tiles_p), kThreads, 0, s>>>(
      rr, ry, p, m, aa);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  chain_rows_kernel<<<pl.n_row_tiles, kThreads, 0, s>>>(
      cxy, sqz, rr, clip, p, m, aa, rra, logv, col_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  chain_hmat_kernel<<<dim3(pl.tiles_m, pl.tiles_m, pl.ks), kThreads, 0, s>>>(
      rra, rr, p, m, pl.rows_per_split, h_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long rblocks = ceil_div((long long)m * m + 3LL * m, kThreads) + 1;
  chain_reduce_kernel<<<(int)rblocks, kThreads, 0, s>>>(
      h_part, pl.ks, col_part, pl.n_row_tiles, logv, p, m, hmat, red);
  return (int)cudaGetLastError();
}

const char* lcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
