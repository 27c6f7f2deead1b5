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
// What bounds it on this card: the two m-deep products, qij = rr·ry
// (2·p·m² flops) and the symmetric H (p·m·(m+1) flops for its distinct
// entries), take 7.87 GFLOP together at p = 10,000, m = 512, against 43 MB
// of compulsory traffic (C_xy and AA 20.5 MB each, ry and H 1 MB each;
// 12.9 us at 3.35 TB/s). In float32 on the CUDA cores (67 TFLOP/s) that is
// 117.5 us; at float32 accuracy on the tensor cores (3xTF32, three TF32
// products per product, 495 TFLOP/s) 47.7 us. The kernel is bound by
// operations.
//
// What the design does about it:
// - Both products run on the tensor cores through wgmma, in 3xTF32: each
//   operand x is split into hi = tf32(x) (cvt.rna) and lo = tf32(x − hi),
//   and a product is lo·hi + hi·lo + hi·hi (lo·lo, ~2^-22 relative, is
//   dropped). The split's representation error is ~2^-22 of an operand;
//   tests/test_torch_chain.py emulates it on the CPU against the 1e-5 bar.
//   bf16x6 (three bf16 pieces, six products) runs at the same peak and
//   would allow MN-major operands, but it needs three copies of every
//   operand in the shared-memory ring and six wgmma per k-step instead of
//   two copies and three, so 3xTF32 was taken.
// - TF32 wgmma reads A and B only K-major (the transpose flags exist for
//   16-bit types only). qij = rr·ry takes rr as stored, (p, m) with m
//   contiguous, and ryᵀ, transposed into scratch (ry is not bitwise
//   symmetric: the caller forms it from W·C_xy in float32). H = (rr·α)ᵀ·rr
//   contracts over p, so rr and rr·α are written transposed, (m, p) with p
//   contiguous, by the elementwise passes that produce them. Those passes
//   write the hi/lo copies, so a GEMM stage is four TMA tiles (A hi, A lo,
//   B hi, B lo) and three groups of wgmma.
// - Loads are TMA (cp.async.bulk.tensor, 128-byte swizzle) into a 3-stage
//   ring of 64 KB stages, completed on mbarriers: one producer thread, two
//   consumer warpgroups of 64 rows each on a 128 x 128 output tile. The
//   scratch operands have leading dimensions padded to 32 floats (TMA
//   needs 16-byte strides; m = 7 or 1030 gives rows of 28 or 4120 bytes);
//   the tensor maps carry the true extents, so TMA zero-fills past the
//   ragged edges and the padding is never read. Zeros are exact here: the
//   JAX kernel pads with zeros for the same reason.
// - Accumulation guard: the tensor cores add into their float32
//   accumulator with truncation, which drifts with the number of adds
//   (cuBLAS's bf16 product on this card was 1.2e-5 to 2.2e-5 of the largest
//   magnitude from exact at K = 10,000). Each 32-deep stage is therefore
//   summed on the tensor cores from zero, small terms first, and then
//   added into a float32 register sum on the CUDA cores (rounded to
//   nearest), so a product is as exact as a CUDA-core GEMM whatever its K.
// - H = (rr·α)ᵀ·rr is symmetric, so only its tiles on and above the
//   diagonal are multiplied (10 of 16 at m = 512) and the reduce pass
//   writes each such entry to its mirror as well.
// - The elementwise work reads each p x m input once and computes rho once
//   per element per pass, in 32 x 64 tiles on a 2-D grid (so any m up to
//   the wrapper's limit runs): a split pass (C_xy → rr hi/lo in both
//   layouts and S_i's partials; ry → ryᵀ hi/lo), Q_i's partial sums in
//   the qij product's epilogue (per 128-column tile, from the product
//   staged through shared memory so every global access is a whole row
//   segment), and a row pass (AA in place over qij, (rr·α)ᵀ hi/lo, the
//   partials of log v_i and of κ, μ and MI).
// - No float atomics, so two runs on the same inputs give bitwise-equal
//   outputs: H is split over a fixed number of p ranges (chosen from the
//   shape alone, never from the card), each block writes its partial, and
//   a reduce pass adds the partials in a fixed order; the same holds for
//   S_i, Q_i, κ, μ, MI and Σ log v_i over their tiles.
//
// Passes: split (rr, rrᵀ, ryᵀ, S_i) → qij GEMM (into the AA buffer, Q_i
// partials) → row pass → H GEMM (partials over p ranges) → reduce.
//
// Restart lanes (lcx_ns_chain_lanes): k independent problems of one shape,
// stored lane after lane, run in one launch per pass. The lane is one more
// grid index (blockIdx.z of the GEMMs, folded with the p ranges in the H
// pass; blockIdx.y of the split, row and reduce passes; the third
// coordinate of every tensor map), and it only offsets each address to
// that lane's slice of the inputs, outputs and scratch. So a block computes
// exactly what it computes in a single-lane launch: lane l's outputs are
// bitwise those of lcx_ns_chain on lane l's inputs, and no value (a NaN of
// a diverged lane included) crosses lanes. lcx_ns_chain is the one-lane
// case.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (linearcorex_tpu_torch/utils/build.py); no library
// beyond the CUDA runtime: the driver's cuTensorMapEncodeTiled is looked up
// at run time. The C entry points take raw pointers and a cudaStream_t and
// return a cudaError_t.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // split, row and reduce passes
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;              // rows per split / row-pass block
constexpr int kCols = 64;              // columns per split / row-pass block
constexpr int kPad = 32;               // scratch leading dims, in floats
constexpr int kBK = 32;                // GEMM stage depth: 128-byte rows
constexpr int kBM = 128;               // GEMM tile rows (two warpgroups)
constexpr int kBN = 128;               // GEMM tile columns
constexpr int kStages = 3;
constexpr int kTileBytes = kBM * kBK * 4;      // 16 KB; kBN == kBM
constexpr int kStageBytes = 4 * kTileBytes;    // A hi, A lo, B hi, B lo
constexpr int kGemmThreads = 384;              // 2 consumer WGs + producer
constexpr int kConsumerWarps = 8;
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + 1 KB alignment
constexpr int kHBlocksTarget = 132;    // H blocks: about one wave
constexpr int kMinSplitRows = 8 * kBK; // fewer, longer H blocks at small m

static_assert(kBM == kBN, "A and B tiles share one TMA box");

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

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// phase that never completes (a lost TMA transfer) traps after ~2^35
// cycles, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// One box {kBK, kBM, 1} of a 3-D tensor map (k, row, lane) into shared
// memory at `dst`, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row,
                                         int lane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k),
         "r"(row), "r"(lane)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand tile written by TMA
// with the 128-byte swizzle: 128-byte rows, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)            // LBO (unused here)
         | (static_cast<uint64_t>(1024 >> 4) << 32)    // SBO: next 8 rows
         | (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

// d (64 x 128, float32) = A (64 x 8) · Bᵀ (8 x 128) + (scale_d ? d : 0),
// A and B TF32 from shared memory. Thread t of the warpgroup holds rows
// 16·(t/32) + (t%32)/4 (+8) and columns 8j + 2·(t%4) (+1), j = 0..15.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving register reads or writes of `d` across
// the asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Scratch of one lane, in floats from its base; every region starts on a
// 128-byte boundary.
struct Plan {
  long long pm;          // p*m
  int ldm, ldp;          // m and p rounded up to kPad
  int n_row_tiles;       // split / row-pass blocks over p
  int ry_tiles;          // split-pass blocks over the rows of ry
  int col_chunks;        // split / row-pass blocks over m
  int tiles_p, tiles_m;  // GEMM tiles along p and m
  int tiles_h;           // H tiles (ta ≤ tb): H is symmetric
  int rows_per_split;    // p rows per H block (a multiple of kBK)
  int ks;                // H splits of p
  long long op_hi, op_lo;    // rr (p, ldm) for qij; then (rr·α)ᵀ (m, ldp)
  long long rrt_hi, rrt_lo;  // rrᵀ (m, ldp)
  long long ryt_hi, ryt_lo;  // ryᵀ (m, ldm)
  long long spart;           // S_i partials (p, col_chunks)
  long long qpart;           // Q_i partials (p, tiles_m)
  long long logv_part;       // Σ log v_i partials (n_row_tiles)
  long long col_part;        // κ, μ, MI partials (n_row_tiles, 3m)
  long long h_part;          // H partials (ks, m, m)
  long long total;           // floats of one lane's scratch
};

Plan make_plan(int p, int m) {
  Plan pl;
  pl.pm = (long long)p * m;
  pl.ldm = (int)round_up(m, kPad);
  pl.ldp = (int)round_up(p, kPad);
  pl.n_row_tiles = (int)ceil_div(p, kRows);
  pl.ry_tiles = (int)ceil_div(m, kRows);
  pl.col_chunks = (int)ceil_div(m, kCols);
  pl.tiles_p = (int)ceil_div(p, kBM);
  pl.tiles_m = (int)ceil_div(m, kBN);
  pl.tiles_h = pl.tiles_m * (pl.tiles_m + 1) / 2;
  // as many p ranges as keep the H grid within about kHBlocksTarget blocks
  long long want = kHBlocksTarget / pl.tiles_h;
  const long long max_splits = ceil_div(p, kMinSplitRows);
  if (want > max_splits) want = max_splits;
  if (want < 1) want = 1;
  pl.rows_per_split = (int)round_up(ceil_div(p, want), kBK);
  pl.ks = (int)ceil_div(p, pl.rows_per_split);

  long long off = 0;
  auto take = [&off](long long n) {
    const long long at = off;
    off += round_up(n, kPad);
    return at;
  };
  const long long op = (long long)p * pl.ldm > (long long)m * pl.ldp
                           ? (long long)p * pl.ldm : (long long)m * pl.ldp;
  pl.op_hi = take(op);
  pl.op_lo = take(op);
  pl.rrt_hi = take((long long)m * pl.ldp);
  pl.rrt_lo = take((long long)m * pl.ldp);
  pl.ryt_hi = take((long long)m * pl.ldm);
  pl.ryt_lo = take((long long)m * pl.ldm);
  pl.spart = take((long long)p * pl.col_chunks);
  pl.qpart = take((long long)p * pl.tiles_m);
  pl.logv_part = take(pl.n_row_tiles);
  pl.col_part = take((long long)pl.n_row_tiles * 3 * m);
  pl.h_part = take((long long)pl.ks * m * m);
  pl.total = off;
  return pl;
}

// Writes the kRows x kCols tile staged in t_hi/t_lo (column-major in
// shared memory) transposed: column c0 + cc goes to dst[(c0 + cc)·ld +
// i0 .. i0 + 31], one 128-byte row segment per warp store.
__device__ __forceinline__ void store_transposed(
    const float (*t_hi)[kRows + 1], const float (*t_lo)[kRows + 1],
    float* __restrict__ dst_hi, float* __restrict__ dst_lo, int ld, int i0,
    int rows, int c0, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (i0 + lane >= rows) return;
#pragma unroll
  for (int j = 0; j < kCols / kWarps; ++j) {
    const int cc = warp * (kCols / kWarps) + j;
    const int col = c0 + cc;
    if (col < cols) {
      const long long at = (long long)col * ld + i0 + lane;
      dst_hi[at] = t_hi[cc][lane];
      dst_lo[at] = t_lo[cc][lane];
    }
  }
}

// One 32 x 64 tile per block: blockIdx.x < n_row_tiles takes rows i0 ..
// i0+31 of C_xy → rho, rr; rr's hi/lo split row-major (A of qij) and
// transposed (B of H); S_i's partial over the tile's columns. From
// n_row_tiles on it takes rows k0 .. k0+31 of ry → ryᵀ's split (B of qij).
// blockIdx.y: column chunk; blockIdx.z: lane.
__global__ void __launch_bounds__(kThreads)
chain_split_kernel(const float* __restrict__ cxy, const float* __restrict__ ry,
                   const float* __restrict__ sqz, float clip, int p, int m,
                   Plan pl, float* __restrict__ work) {
  __shared__ float t_hi[kCols][kRows + 1];
  __shared__ float t_lo[kCols][kRows + 1];
  __shared__ float s_part[kWarps][kRows / 4];
  const int tid = threadIdx.x, cl = tid & (kCols - 1), rq = tid >> 6;
  const int lane = blockIdx.z;
  work += lane * pl.total;
  sqz += (long long)lane * m;
  const bool is_ry = blockIdx.x >= pl.n_row_tiles;
  const int i0 = (is_ry ? blockIdx.x - pl.n_row_tiles : blockIdx.x) * kRows;
  const int c0 = blockIdx.y * kCols;
  const int rows = is_ry ? m : p;
  const float* src = is_ry ? ry + (long long)lane * m * m : cxy + lane * pl.pm;
  const int c = c0 + cl;
  const bool col_ok = c < m;
  const float s_c = (!is_ry && col_ok) ? sqz[c] : 1.f;
  float sacc[kRows / 4];
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const int r = rq + 4 * q, i = i0 + r;
    float hi = 0.f, lo = 0.f;
    sacc[q] = 0.f;
    if (col_ok && i < rows) {
      float v = src[(long long)i * m + c];
      if (!is_ry) {
        const float rho = clip_rho(v, s_c, clip);
        v = rho * (1.f / (1.f - rho * rho));
        sacc[q] = rho * v;
      }
      hi = to_tf32(v);
      lo = to_tf32(v - hi);
      if (!is_ry) {
        const long long at = (long long)i * pl.ldm + c;
        work[pl.op_hi + at] = hi;
        work[pl.op_lo + at] = lo;
      }
    }
    t_hi[cl][r] = hi;
    t_lo[cl][r] = lo;
  }
  __syncthreads();
  store_transposed(t_hi, t_lo, work + (is_ry ? pl.ryt_hi : pl.rrt_hi),
                   work + (is_ry ? pl.ryt_lo : pl.rrt_lo),
                   is_ry ? pl.ldm : pl.ldp, i0, rows, c0, m);
  if (is_ry) return;
  // S_i's partial: row rq + 4q is held by warps 2·rq and 2·rq + 1
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const float v = warp_sum(sacc[q]);
    if ((tid & 31) == 0) s_part[tid >> 5][q] = v;
  }
  __syncthreads();
  if (tid < kRows && i0 + tid < p) {
    const int r4 = tid & 3, q = tid >> 2;
    work[pl.spart + (long long)(i0 + tid) * pl.col_chunks + blockIdx.y] =
        s_part[2 * r4][q] + s_part[2 * r4 + 1][q];
  }
}

struct GemmShape {
  int rows_a;            // valid output rows (A's rows)
  int rows_b;            // valid output columns (B's rows)
  int k_total;           // contraction extent
  int k_split;           // contraction per split (a multiple of kBK)
  int splits;            // blockIdx.z = lane·splits + split
  int out_ld;
  long long out_lane;    // floats between two lanes' outputs
  long long out_split;   // floats between two splits' outputs
};

// What the qij product's epilogue reads to form Q_i's partial sums.
struct QijEpilogue {
  const float* cxy;
  const float* sqz;
  float clip;
  int m;
  long long pm;
  float* qpart;          // lane 0's (p, tiles_m) partials
  long long work_lane;   // floats between two lanes' scratch
  int tiles_m;
};

// out (rows_a x rows_b) = A·Bᵀ over one range of the contraction, A and B
// K-major float32 given as TF32 hi/lo pairs of tensor maps (k, row, lane).
// Warps 0-7 (two warpgroups, 64 tile rows each) multiply; warp 8's first
// thread keeps the TMA loads kStages ahead. kQij (qij = rr·ry): the grid
// covers every tile, and the epilogue also writes Σ_c rr[r, c]·out[r, c]
// over the tile's columns to Q_i's partials. Otherwise (H): only the tiles
// on and above the diagonal, the reduce pass mirrors them.
template <bool kQij>
__global__ void __launch_bounds__(kGemmThreads, 1)
chain_gemm_kernel(const __grid_constant__ CUtensorMap a_hi,
                  const __grid_constant__ CUtensorMap a_lo,
                  const __grid_constant__ CUtensorMap b_hi,
                  const __grid_constant__ CUtensorMap b_lo, GemmShape g,
                  QijEpilogue qe, float* __restrict__ out) {
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int lane_z = blockIdx.z / g.splits;
  const int split = blockIdx.z - lane_z * g.splits;
  int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  if (!kQij) {
    // H is symmetric: blockIdx.x walks the tiles ta ≤ tb, row by row
    int ta = 0, idx = blockIdx.x;
    const int tiles = (g.rows_b + kBN - 1) / kBN;
    while (idx >= tiles - ta) idx -= tiles - ta++;
    row0 = ta * kBM;
    col0 = (ta + idx) * kBN;
  }
  const int k0 = split * g.k_split;
  const int k1 = min(k0 + g.k_split, g.k_total);
  const int steps = (k1 - k0 + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * 128) {
    // producer warpgroup: one thread issues every load
    if (tid == 2 * 128) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          mbar_wait(smem_u32(&empty_bar[s]), ((t / kStages) + 1) & 1);
        const uint32_t bar = smem_u32(&full_bar[s]);
        mbar_expect_tx(bar, kStageBytes);
        const uint32_t st = ring + s * kStageBytes;
        const int k = k0 + t * kBK;
        tma_load(st, &a_hi, bar, k, row0, lane_z);
        tma_load(st + kTileBytes, &a_lo, bar, k, row0, lane_z);
        tma_load(st + 2 * kTileBytes, &b_hi, bar, k, col0, lane_z);
        tma_load(st + 3 * kTileBytes, &b_lo, bar, k, col0, lane_z);
      }
    }
  } else {
    // consumer warpgroups
    const int wg = tid >> 7;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    for (int t = 0; t < steps; ++t) {
      const int s = t % kStages;
      mbar_wait(smem_u32(&full_bar[s]), (t / kStages) & 1);
      const uint32_t st = ring + s * kStageBytes;
      const uint32_t ah = st + wg * (64 * kBK * 4), al = ah + kTileBytes;
      const uint32_t bh = st + 2 * kTileBytes, bl = bh + kTileBytes;
      fence_regs(part);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      // this stage's sum from zero, the small terms first
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        wgmma_tf32(part, gmma_desc(al + 32 * kk), gmma_desc(bh + 32 * kk),
                   kk > 0);
        wgmma_tf32(part, gmma_desc(ah + 32 * kk), gmma_desc(bl + 32 * kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        wgmma_tf32(part, gmma_desc(ah + 32 * kk), gmma_desc(bh + 32 * kk), 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(part);
      if ((tid & 31) == 0) mbar_arrive(smem_u32(&empty_bar[s]));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    // Epilogue through shared memory (the ring is free once every stage
    // is consumed), so that each warp stores whole rows of the tile.
    asm volatile("bar.sync 1, 256;" ::: "memory");
    constexpr int kLdT = kBN + 4;
    float* tile =
        reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
    {
      const int warp = (tid >> 5) & 3, ln = tid & 31;
      const int rl = wg * 64 + warp * 16 + (ln >> 2), cl = 2 * (ln & 3);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(&tile[rl * kLdT + cl + 8 * j]) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(&tile[(rl + 8) * kLdT + cl + 8 * j]) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    const int warp = tid >> 5, ln = tid & 31;
    float* o = out + lane_z * g.out_lane + split * g.out_split;
    const float* cxy = qe.cxy + lane_z * qe.pm;
    float s_c[kBN / 32];
#pragma unroll
    for (int u = 0; u < kBN / 32; ++u) {
      const int c = col0 + ln + 32 * u;
      s_c[u] = (kQij && c < g.rows_b) ? qe.sqz[(long long)lane_z * qe.m + c]
                                      : 1.f;
    }
    // warp w takes rows w, w + 8, ...; every load is issued before any
    // result is used, so the epilogue waits for memory once
    constexpr int kPer = kBM / kConsumerWarps, kU = kBN / 32;
    float x[kPer][kU];
    if (kQij) {
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int r = row0 + warp + kConsumerWarps * v;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = col0 + ln + 32 * u;
          x[v][u] = (r < g.rows_a && c < g.rows_b)
                        ? cxy[(long long)r * qe.m + c] : 0.f;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int rl = warp + kConsumerWarps * v, r = row0 + rl;
      float q = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = col0 + ln + 32 * u;
        if (r < g.rows_a && c < g.rows_b) {
          const float val = tile[rl * kLdT + ln + 32 * u];
          o[(long long)r * g.out_ld + c] = val;
          if (kQij) {
            const float rho = clip_rho(x[v][u], s_c[u], qe.clip);
            q += rho * (1.f / (1.f - rho * rho)) * val;
          }
        }
      }
      if (kQij) {
        q = warp_sum(q);
        if (ln == 0 && r < g.rows_a)
          qe.qpart[lane_z * qe.work_lane + (long long)r * qe.tiles_m
                   + blockIdx.x] = q;
      }
    }
  }
}

// One 32 x 64 tile per block (blockIdx.x: rows i0 .. i0+31; blockIdx.y:
// column chunk; blockIdx.z: lane): α and α·S_i + β of its rows from the
// S_i and Q_i partials; AA in place over qij; (rr·α)ᵀ's hi/lo split (A of
// H); the tile's column partials of κ, μ and MI, summed over its rows in a
// fixed order. The first chunk also writes Σ log v_i over the rows.
__global__ void __launch_bounds__(kThreads)
chain_rows_kernel(const float* __restrict__ cxy, const float* __restrict__ sqz,
                  float clip, int p, int m, Plan pl, float* __restrict__ aa,
                  float* __restrict__ work) {
  __shared__ float alpha_s[kRows];
  __shared__ float coef_s[kRows];      // α·S_i + β
  __shared__ float t_hi[kCols][kRows + 1];
  __shared__ float t_lo[kCols][kRows + 1];
  __shared__ float red[3][kThreads / kCols][kCols];
  const int tid = threadIdx.x, cl = tid & (kCols - 1), rq = tid >> 6;
  const int lane = blockIdx.z;
  const int i0 = blockIdx.x * kRows, c0 = blockIdx.y * kCols;
  cxy += lane * pl.pm;
  aa += lane * pl.pm;
  sqz += (long long)lane * m;
  work += lane * pl.total;

  if (tid < kRows) {
    const int i = i0 + tid;
    float alpha = 0.f, coef = 0.f, logv = 0.f;
    if (i < p) {
      float s = 0.f, q = 0.f;
      for (int t = 0; t < pl.col_chunks; ++t)
        s += work[pl.spart + (long long)i * pl.col_chunks + t];
      for (int t = 0; t < pl.tiles_m; ++t)
        q += work[pl.qpart + (long long)i * pl.tiles_m + t];
      const float ni = 1.f + q - s * s;
      const float beta = 1.f / (1.f + s);
      alpha = 1.f / ni;
      coef = alpha * s + beta;
      float v = ni * beta * beta;
      v = v < 1e-30f ? 1e-30f : v;
      logv = logf(v);
    }
    alpha_s[tid] = alpha;
    coef_s[tid] = coef;
    if (blockIdx.y == 0) {
      logv = warp_sum(logv);
      if (tid == 0) work[pl.logv_part + blockIdx.x] = logv;
    }
  }
  __syncthreads();

  const int c = c0 + cl;
  const bool col_ok = c < m;
  const float s_c = col_ok ? sqz[c] : 1.f;
  float kappa = 0.f, mu = 0.f, mi = 0.f;
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const int r = rq + 4 * q, i = i0 + r;
    float hi = 0.f, lo = 0.f;
    if (col_ok && i < p) {
      const long long at = (long long)i * m + c;
      const float rho = clip_rho(cxy[at], s_c, clip);
      const float invrho = 1.f / (1.f - rho * rho);
      const float inv2 = invrho * invrho;
      const float v = rho * invrho;
      const float qv = aa[at];
      const float al = alpha_s[r];
      const float a = al * (1.f + rho * rho) * inv2 * qv
                      - 2.f * coef_s[r] * rho * inv2;
      aa[at] = a;
      kappa += a * rho;
      mu += al * v * qv;
      mi += -0.5f * log1pf(-rho * rho);
      const float w = v * al;
      hi = to_tf32(w);
      lo = to_tf32(w - hi);
    }
    t_hi[cl][r] = hi;
    t_lo[cl][r] = lo;
  }
  red[0][rq][cl] = kappa;
  red[1][rq][cl] = mu;
  red[2][rq][cl] = mi;
  __syncthreads();
  store_transposed(t_hi, t_lo, work + pl.op_hi, work + pl.op_lo, pl.ldp, i0,
                   p, c0, m);
  if (tid < kCols && col_ok) {
    float* part = work + pl.col_part + (long long)blockIdx.x * 3 * m;
#pragma unroll
    for (int f = 0; f < 3; ++f)
      part[f * m + c] = ((red[f][0][tid] + red[f][1][tid]) + red[f][2][tid])
                        + red[f][3][tid];
  }
}

// blockIdx.x < h_blocks: one thread per entry of H (m*m); H's partials
// exist for the tiles ta ≤ tb, and each such entry is also written to its
// mirror. The next blocks: one warp per output of κ, μ, MI (3m), its lanes
// striding over the row tiles' partials. The last block: the tree sum of
// the log v_i partials. blockIdx.y: lane. Every sum runs in a fixed order.
__global__ void __launch_bounds__(kThreads)
chain_reduce_kernel(int m, int h_blocks, Plan pl,
                    const float* __restrict__ work, float* __restrict__ hmat,
                    float* __restrict__ red) {
  const long long mm = (long long)m * m;
  work += blockIdx.y * pl.total;
  hmat += blockIdx.y * mm;
  red += blockIdx.y * (3LL * m + 1);
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ float buf[kThreads];
    const float* logv = work + pl.logv_part;
    float s = 0.f;
    for (int i = threadIdx.x; i < pl.n_row_tiles; i += kThreads) s += logv[i];
    buf[threadIdx.x] = s;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0) red[3 * m] = buf[0];
    return;
  }
  if ((int)blockIdx.x >= h_blocks) {
    const int q = (blockIdx.x - h_blocks) * kWarps + (threadIdx.x >> 5);
    const int ln = threadIdx.x & 31;
    if (q >= 3 * m) return;
    const float* col_part = work + pl.col_part;
    float s = 0.f;
    for (int t = ln; t < pl.n_row_tiles; t += 32)
      s += col_part[(long long)t * 3 * m + q];
    s = warp_sum(s);
    if (ln == 0) red[q] = s;
    return;
  }
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= mm) return;
  const int a = (int)(idx / m), b = (int)(idx - (long long)a * m);
  if (a / kBM > b / kBN) return;
  const float* h_part = work + pl.h_part;
  float s = 0.f;
#pragma unroll 4
  for (int z = 0; z < pl.ks; ++z) s += h_part[z * mm + idx];
  hmat[idx] = s;
  if (a / kBM < b / kBN) hmat[(long long)b * m + a] = s;
}

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library links against nothing but the CUDA runtime).
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A 3-D tensor map (k, row, lane) over float32 rows `ld` floats apart and
// lanes `lane_stride` floats apart, true extents k_extent x rows x lanes
// (TMA zero-fills past them), box {kBK, kBM, 1}, 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const float* base, long long k_extent,
                     long long rows, int lanes, long long ld,
                     long long lane_stride) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)k_extent, (cuuint64_t)rows,
                              (cuuint64_t)lanes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4,
                                 (cuuint64_t)lane_stride * 4};
  const cuuint32_t box[3] = {kBK, kBM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

// Floats of scratch memory lcx_ns_chain needs for a (p, m) problem, or -1
// for an empty shape. lcx_ns_chain_lanes needs `lanes` times this.
long long lcx_ns_chain_workspace(int p, int m) {
  if (p < 1 || m < 1) return -1;
  return make_plan(p, m).total;
}

// The largest lane count one launch takes for a (p, m) problem (the H
// pass folds lanes and p ranges into gridDim.z, at most 65535), or -1 for
// an empty shape.
int lcx_ns_chain_max_lanes(int p, int m) {
  if (p < 1 || m < 1) return -1;
  return 65535 / make_plan(p, m).ks;
}

// Runs the passes for `lanes` problems of shape (p, m) on `stream`, one
// launch per pass. Lane l reads cxy + l·p·m, ry + l·m·m, sqz + l·m and
// writes aa + l·p·m, hmat + l·m·m, red + l·(3m + 1) = [κ, μ, Σ MI,
// Σ log v_i]; `work` (16-byte aligned) holds lanes ·
// lcx_ns_chain_workspace(p, m) floats. Returns a cudaError_t (0 =
// success).
int lcx_ns_chain_lanes(const float* cxy, const float* ry, const float* sqz,
                       float clip, int lanes, int p, int m, float* aa,
                       float* hmat, float* red, float* work, int device,
                       void* stream) {
  if (p < 1 || m < 1 || lanes < 1 || lanes > lcx_ns_chain_max_lanes(p, m))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(p, m);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // The tensor maps: qij's A = rr (p rows, K = m) and B = ryᵀ (m rows,
  // K = m); H's A = (rr·α)ᵀ (m rows, K = p, written by the row pass over
  // rr's region) and B = rrᵀ.
  const struct {
    long long at, k, rows, ld;
  } specs[8] = {{pl.op_hi, m, p, pl.ldm},  {pl.op_lo, m, p, pl.ldm},
                {pl.ryt_hi, m, m, pl.ldm}, {pl.ryt_lo, m, m, pl.ldm},
                {pl.op_hi, p, m, pl.ldp},  {pl.op_lo, p, m, pl.ldp},
                {pl.rrt_hi, p, m, pl.ldp}, {pl.rrt_lo, p, m, pl.ldp}};
  CUtensorMap map[8];
  for (int i = 0; i < 8; ++i) {
    err = make_map(&map[i], work + specs[i].at, specs[i].k, specs[i].rows,
                   lanes, specs[i].ld, pl.total);
    if (err != cudaSuccess) return (int)err;
  }
  // the GEMMs' shared memory above 48 KB, once per device
  static bool smem_set[kMaxDevices] = {};
  if (device >= kMaxDevices || !smem_set[device]) {
    const void* gemms[] = {(const void*)chain_gemm_kernel<true>,
                           (const void*)chain_gemm_kernel<false>};
    for (const void* fn : gemms) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
      if (err != cudaSuccess) return (int)err;
    }
    if (device < kMaxDevices) smem_set[device] = true;
  }

  chain_split_kernel<<<dim3(pl.n_row_tiles + pl.ry_tiles, pl.col_chunks,
                            lanes), kThreads, 0, s>>>(cxy, ry, sqz, clip, p,
                                                      m, pl, work);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const QijEpilogue qe = {cxy, sqz, clip, m, pl.pm, work + pl.qpart,
                          pl.total, pl.tiles_m};
  const GemmShape gq = {p, m, m, (int)round_up(m, kBK), 1, m, pl.pm, 0};
  chain_gemm_kernel<true><<<dim3(pl.tiles_m, pl.tiles_p, lanes),
                            kGemmThreads, kGemmSmem, s>>>(
      map[0], map[1], map[2], map[3], gq, qe, aa);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  chain_rows_kernel<<<dim3(pl.n_row_tiles, pl.col_chunks, lanes), kThreads,
                      0, s>>>(
      cxy, sqz, clip, p, m, pl, aa, work);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const GemmShape gh = {m, m, p, pl.rows_per_split, pl.ks, m, pl.total,
                        (long long)m * m};
  chain_gemm_kernel<false><<<dim3(pl.tiles_h, 1, pl.ks * lanes),
                             kGemmThreads, kGemmSmem, s>>>(
      map[4], map[5], map[6], map[7], gh, qe, work + pl.h_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int h_blocks = (int)ceil_div((long long)m * m, kThreads);
  const int c_blocks = (int)ceil_div(3LL * m, kWarps);
  chain_reduce_kernel<<<dim3(h_blocks + c_blocks + 1, lanes), kThreads, 0,
                        s>>>(m, h_blocks, pl, work, hmat, red);
  return (int)cudaGetLastError();
}

// One problem: outputs aa (p, m), hmat (m, m) and red (3m + 1) = [κ, μ,
// Σ MI, Σ log v_i]; `work` holds lcx_ns_chain_workspace(p, m) floats.
// Returns a cudaError_t (0 = success).
int lcx_ns_chain(const float* cxy, const float* ry, const float* sqz,
                 float clip, int p, int m, float* aa, float* hmat, float* red,
                 float* work, int device, void* stream) {
  return lcx_ns_chain_lanes(cxy, ry, sqz, clip, 1, p, m, aa, hmat, red, work,
                            device, stream);
}

const char* lcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
