// Σ·V of Linear CorEx's Gram path at float32 accuracy on Hopper's tensor
// cores (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves C = Σ·V to XLA's dot, and
// the port ran it as cuBLAS's float32 GEMM on the CUDA cores. For Σ (p, p)
// and V (p, n), both float32, V with any strides, it computes C (p, n)
// row-major. A fit calls it twice an evaluation: C_xy = Σ·Wᵀ and the
// gradient's Σ·AAᵀ (n = m, or k·m for k restart lanes side by side).
//
// What bounds it on this card: 2·p²·n flops, 1.02e11 at p = 10,000,
// n = 512, against 400 MB of Σ read once (0.12 ms at 3.35 TB/s). On the
// CUDA cores (67 TFLOP/s) that is 1.53 ms; one TF32 pass on the tensor
// cores (495 TFLOP/s) 0.207 ms, but keeps only ~3 decimal digits; float32
// accuracy as three TF32 products (3xTF32) 0.62 ms. The kernel is bound by
// operations.
//
// What the design does about it:
// - 3xTF32 on wgmma: each operand x is split into hi = tf32(x) (cvt.rna)
//   and lo = tf32(x − hi), and a product is lo·hi + hi·lo + hi·hi (lo·lo,
//   ~2^-22 relative, is dropped), as csrc/ns_chain.cu does.
// - A = Σ's rows, which are K-major as they lie. TMA brings the float32
//   tile (128 rows x 32 deep, 128-byte swizzle) into a 4-stage ring; the
//   consumer threads read their wgmma A fragments from it and split them in
//   registers (wgmma's register-A form), so Σ is never copied or split in
//   memory.
// - B = Vᵀ: TF32 wgmma reads B only K-major, from shared memory, so a split
//   pass writes Vᵀ's hi and lo as (n, ldp) rows, p padded to 32 floats
//   (ldp) with zeros. Within each group of 16 along K it permutes the
//   order so that a thread's A fragments of two 8-deep steps are one
//   16-byte load: position 8e + 4s + t of a group holds K index
//   4t + 2e + s, which is where the A fragment layout (row g, columns t and
//   t + 4 of a step) finds the same K in the thread's float4.
// - Accumulation guard: the tensor cores add into their float32
//   accumulator with truncation, which drifts with the number of adds. Each
//   32-deep stage is summed on the tensor cores from zero, the small terms
//   first, and then added into a float32 register sum on the CUDA cores,
//   rounded to nearest, so the product is as exact as a CUDA-core GEMM
//   whatever its depth.
// - One producer warp issues the TMA loads; two consumer warpgroups of 64
//   rows each own a 128 x 128 output tile. The sum, the stage's sum and
//   the split A fragments fit in the 168 registers ptxas gives a thread of
//   this block (167 used, no spills), so the kernel needs no setmaxnreg.
// - Waves: p = 10,000, n = 512 gives 79 x 4 = 316 tiles, 2.4 waves of 132
//   blocks. K is split into a few ranges (chosen from the shape alone, so
//   two cards compute the same bits), each block writes its range's
//   partial product, and a reduce pass adds the partials in a fixed order.
//   The column tiles of one row panel's range are consecutive blocks, so
//   they run together and read that part of Σ from device memory once.
// - No float atomics: two launches on the same inputs give the same bits.
// - Any size: TMA zero-fills past Σ's true extents; Vᵀ's padding is
//   written as zeros; the epilogue stores only rows < p and columns < n.
//   Σ's rows must be 16 bytes apart (its row stride a multiple of 4
//   floats), a TMA rule; the wrapper copies a Σ whose rows are not.
//
// Passes: split (Vᵀ hi/lo) → GEMM (into C, or into the partials) →
// reduce (only when K is split).
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

constexpr int kBK = 32;                 // stage depth: 128-byte rows
constexpr int kBM = 128;                // tile rows (two warpgroups)
constexpr int kBN = 128;                // tile columns
constexpr int kStages = 4;
constexpr int kTileBytes = kBM * kBK * 4;      // 16 KB; kBN == kBM
constexpr int kStageBytes = 3 * kTileBytes;    // Σ, Vᵀ hi, Vᵀ lo
constexpr int kGemmThreads = 288;              // 2 consumer WGs + 1 warp
constexpr int kConsumerWarps = 8;
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + alignment
constexpr int kWave = 132;              // blocks of one wave (one per SM)
constexpr int kMaxSplits = 4;
constexpr int kMinSplitSteps = 8;       // stages a K range holds at least
constexpr int kPad = 32;                // Vᵀ's leading dim, in floats
constexpr int kSplitThreads = 256;      // split pass: 32 x 32 tiles
constexpr int kReduceThreads = 256;

static_assert(kBM == kBN, "the Σ and Vᵀ tiles share one TMA box");

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
inline long long round_up(long long a, long long b) {
  return ceil_div(a, b) * b;
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

// One box {kBK, kBM} of a 2-D tensor map (k, row) into shared memory at
// `dst`, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k),
         "r"(row)
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
// A TF32 from registers, B TF32 from shared memory. Warp w of the
// warpgroup holds A's rows 16w + g and 16w + g + 8 (g = lane / 4) at
// columns t and t + 4 (t = lane % 4): a = {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)}. Its d holds rows 16w + g (+8) and columns 8j + 2t
// (+1), j = 0..15.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving register reads or writes of `d` across
// the asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Keeps the A fragments of a stage in their registers until its wgmma
// have completed (they read them asynchronously).
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// How one (p, n) product is cut: tiles, K ranges, scratch.
struct Plan {
  int ldp;               // p rounded up to kPad: Vᵀ's leading dimension
  int tiles_m, tiles_n;  // output tiles along p and n
  int splits;            // K ranges
  int k_split;           // K per range (a multiple of kBK)
  long long vt_hi, vt_lo;    // Vᵀ hi/lo (n, ldp)
  long long part;            // the ranges' partials (splits, p, n)
  long long total;           // floats of scratch
};

// The share of the last wave's blocks that have work, for `units` blocks.
double wave_fill(long long units) {
  return (double)units / (double)(ceil_div(units, kWave) * kWave);
}

Plan make_plan(int p, int n) {
  Plan pl;
  pl.ldp = (int)round_up(p, kPad);
  pl.tiles_m = (int)ceil_div(p, kBM);
  pl.tiles_n = (int)ceil_div(n, kBN);
  const long long tiles = (long long)pl.tiles_m * pl.tiles_n;
  const long long steps = ceil_div(p, kBK);
  // the fewest K ranges that fill the waves best, each at least
  // kMinSplitSteps stages deep
  pl.splits = 1;
  pl.k_split = (int)(steps * kBK);
  double best = wave_fill(tiles);
  for (int s = 2; s <= kMaxSplits && steps / s >= kMinSplitSteps; ++s) {
    const int k_split = (int)(ceil_div(steps, s) * kBK);
    const int splits = (int)ceil_div(p, k_split);
    const double fill = wave_fill(tiles * splits);
    if (fill > best + 1e-9) {
      best = fill;
      pl.splits = splits;
      pl.k_split = k_split;
    }
  }
  long long off = 0;
  auto take = [&off](long long count) {
    const long long at = off;
    off += round_up(count, kPad);
    return at;
  };
  pl.vt_hi = take((long long)n * pl.ldp);
  pl.vt_lo = take((long long)n * pl.ldp);
  pl.part = pl.splits > 1 ? take((long long)pl.splits * p * n) : 0;
  pl.total = off;
  return pl;
}

// One 32 (K) x 32 (columns) tile of V per block: Vᵀ's hi/lo rows j0 ..
// j0+31, positions k0 .. k0+31, in the permuted order within each group of
// 16 (position 8e + 4s + t holds K index 4t + 2e + s); zeros past p and n.
// blockIdx.x: K tile (over ldp); blockIdx.y: column tile.
__global__ void __launch_bounds__(kSplitThreads)
sigma_gemm_split_kernel(const float* __restrict__ v, long long v_row,
                        long long v_col, int p, int n, int ldp,
                        float* __restrict__ vt_hi, float* __restrict__ vt_lo) {
  __shared__ float tile[32][33];        // [column][K]
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int k0 = blockIdx.x * 32, j0 = blockIdx.y * 32;
  // read along whichever of V's axes is contiguous
  if (v_col == 1) {
#pragma unroll
    for (int r = ty; r < 32; r += kSplitThreads / 32) {
      const int k = k0 + r, j = j0 + tx;
      tile[tx][r] = (k < p && j < n) ? v[k * v_row + j] : 0.f;
    }
  } else {
#pragma unroll
    for (int c = ty; c < 32; c += kSplitThreads / 32) {
      const int k = k0 + tx, j = j0 + c;
      tile[c][tx] = (k < p && j < n) ? v[k * v_row + j * v_col] : 0.f;
    }
  }
  __syncthreads();
  const int pos = tx;
  const int t = pos & 3, s = (pos >> 2) & 1, e = (pos >> 3) & 1;
  const int kl = (pos & 16) + 4 * t + 2 * e + s;
#pragma unroll
  for (int c = ty; c < 32; c += kSplitThreads / 32) {
    const int j = j0 + c;
    if (j < n) {
      const float x = tile[c][kl];
      const float hi = to_tf32(x);
      const long long at = (long long)j * ldp + k0 + pos;
      vt_hi[at] = hi;
      vt_lo[at] = to_tf32(x - hi);
    }
  }
}

struct GemmShape {
  int p, n;              // output rows and columns
  int splits, k_split;   // K ranges and their depth
  int tiles_n;
  long long out_split;   // floats between two ranges' outputs
};

// out (p x n) = Σ·V over one K range, in 3xTF32 with the accumulation
// guard. Block b: column tile b % tiles_n, K range (b / tiles_n) % splits,
// row panel b / (tiles_n · splits). Warps 0-7 (two warpgroups, 64 tile
// rows each) multiply; warp 8's first thread keeps the TMA loads kStages
// ahead.
__global__ void __launch_bounds__(kGemmThreads, 1)
sigma_gemm_kernel(const __grid_constant__ CUtensorMap sigma,
                  const __grid_constant__ CUtensorMap vt_hi,
                  const __grid_constant__ CUtensorMap vt_lo, GemmShape g,
                  float* __restrict__ out) {
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int col0 = (b % g.tiles_n) * kBN;
  b /= g.tiles_n;
  const int split = b % g.splits;
  const int row0 = (b / g.splits) * kBM;
  const int k0 = split * g.k_split;
  const int k1 = min(k0 + g.k_split, g.p);
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
    // producer warp: one thread issues every load
    if (tid == 2 * 128) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          mbar_wait(smem_u32(&empty_bar[s]), ((t / kStages) + 1) & 1);
        const uint32_t bar = smem_u32(&full_bar[s]);
        mbar_expect_tx(bar, kStageBytes);
        const uint32_t st = ring + s * kStageBytes;
        const int k = k0 + t * kBK;
        tma_load(st, &sigma, bar, k, row0);
        tma_load(st + kTileBytes, &vt_hi, bar, k, col0);
        tma_load(st + 2 * kTileBytes, &vt_lo, bar, k, col0);
      }
    }
    return;
  }

  // consumer warpgroups
  const int wg = tid >> 7, warp = (tid >> 5) & 3, ln = tid & 31;
  const int gr = ln >> 2, tc = ln & 3;
  const int r = wg * 64 + warp * 16 + gr;   // tile row of a[0], a[2]
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int s = t % kStages;
    mbar_wait(smem_u32(&full_bar[s]), (t / kStages) & 1);
    const uint32_t st = ring + s * kStageBytes;
    // A fragments of the stage's four 8-deep steps: for the 16-deep half
    // h, the float4 at columns 16h + 4t .. 16h + 4t + 3 of rows r and
    // r + 8 (chunk 4h + t of the row, swizzled by the row's index mod 8,
    // which is gr), split in registers
    uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const uint32_t at =
            st + (r + 8 * rh) * 128 + (((4 * h + tc) ^ gr) << 4);
        float x[4];
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                     : "r"(at) : "memory");
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // step 2h + e; register rh (K index t) or 2 + rh (t + 4)
            const float val = x[2 * e + q];
            const float hi = to_tf32(val);
            a_hi[2 * h + e][2 * q + rh] = __float_as_uint(hi);
            a_lo[2 * h + e][2 * q + rh] = __float_as_uint(to_tf32(val - hi));
          }
        }
      }
    }
    const uint32_t bh = st + kTileBytes, bl = bh + kTileBytes;
    fence_regs(part);
    fence_frags(a_hi);
    fence_frags(a_lo);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    // this stage's sum from zero, the small terms first
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_tf32_rs(part, a_lo[kk], gmma_desc(bh + 32 * kk), kk > 0);
      wgmma_tf32_rs(part, a_hi[kk], gmma_desc(bl + 32 * kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
      wgmma_tf32_rs(part, a_hi[kk], gmma_desc(bh + 32 * kk), 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(part);
    fence_frags(a_hi);
    fence_frags(a_lo);
    if (ln == 0) mbar_arrive(smem_u32(&empty_bar[s]));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  float* o = out + split * g.out_split;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + r + 8 * rh;
    if (row >= g.p) continue;
    float* orow = o + (long long)row * g.n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = col0 + 8 * j + 2 * tc;
      if (c < g.n) orow[c] = acc[4 * j + 2 * rh];
      if (c + 1 < g.n) orow[c + 1] = acc[4 * j + 2 * rh + 1];
    }
  }
}

// out[i] = ((part[0][i] + part[1][i]) + part[2][i]) + ..., i < count.
__global__ void __launch_bounds__(kReduceThreads)
sigma_gemm_reduce_kernel(const float* __restrict__ part, int splits,
                         long long count, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kReduceThreads) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * count + i];
    out[i] = s;
  }
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

// A 2-D tensor map (k, row) over float32 rows `ld` floats apart, true
// extents k_extent x rows (TMA zero-fills past them), box {kBK, kBM},
// 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const float* base, long long k_extent,
                     long long rows, long long ld) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k_extent, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

// Floats of scratch memory lcx_sigma_gemm needs for Σ (p, p) · V (p, n),
// or -1 for an empty shape.
long long lcx_sigma_gemm_workspace(int p, int n) {
  if (p < 1 || n < 1) return -1;
  return make_plan(p, n).total;
}

// out (p, n), row-major = Σ·V on `stream`. Σ: p rows of p floats, row i at
// sigma + i·ld (ld a multiple of 4, sigma 16-byte aligned); V: element
// (k, j) at v + k·v_row + j·v_col; `work` (16-byte aligned) holds
// lcx_sigma_gemm_workspace(p, n) floats. Returns a cudaError_t (0 =
// success).
int lcx_sigma_gemm(const float* sigma, long long ld, int p, const float* v,
                   long long v_row, long long v_col, int n, float* out,
                   float* work, int device, void* stream) {
  if (p < 1 || n < 1 || ld < p || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(sigma) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(p, n);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  CUtensorMap map[3];
  if ((err = make_map(&map[0], sigma, p, p, ld)) != cudaSuccess ||
      (err = make_map(&map[1], work + pl.vt_hi, pl.ldp, n, pl.ldp)) !=
          cudaSuccess ||
      (err = make_map(&map[2], work + pl.vt_lo, pl.ldp, n, pl.ldp)) !=
          cudaSuccess)
    return (int)err;
  // the GEMM's shared memory above 48 KB, once per device
  static bool smem_set[kMaxDevices] = {};
  if (device >= kMaxDevices || !smem_set[device]) {
    err = cudaFuncSetAttribute((const void*)sigma_gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGemmSmem);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) smem_set[device] = true;
  }

  sigma_gemm_split_kernel<<<dim3(pl.ldp / 32, (unsigned)ceil_div(n, 32)),
                            kSplitThreads, 0, s>>>(
      v, v_row, v_col, p, n, pl.ldp, work + pl.vt_hi, work + pl.vt_lo);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long count = (long long)p * n;
  const GemmShape g = {p, n, pl.splits, pl.k_split, pl.tiles_n, count};
  const long long blocks = (long long)pl.tiles_m * pl.splits * pl.tiles_n;
  sigma_gemm_kernel<<<(unsigned)blocks, kGemmThreads, kGemmSmem, s>>>(
      map[0], map[1], map[2], g, pl.splits > 1 ? work + pl.part : out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (pl.splits == 1) return (int)cudaSuccess;

  const long long want = ceil_div(count, kReduceThreads);
  const unsigned grid = (unsigned)(want < 8 * kWave * 8 ? want
                                                        : 8 * kWave * 8);
  sigma_gemm_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      work + pl.part, pl.splits, count, out);
  return (int)cudaGetLastError();
}

const char* lcx_sigma_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
