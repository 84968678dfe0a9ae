// Fused condensed closed-loop rollout (float32, Hopper sm_90a): with the
// per-solve cost in the kernel (K1, which also serves K2) or without it
// (K3, the cost_mode="post" path).
//
// K1 replaces direct_data_driven_mpc_tpu/ops/pallas_rollout.py::
// _make_rollout_from_fused (kernel bodies `kernel_split` and `kernel`):
// the TPU kernel's sequential time axis of the grid becomes a loop
// inside each thread block, and its VMEM scratch carry becomes shared
// memory. Per outer time block t every batch row computes
//
//     sw  = [W_{(t + w_off) mod n_outer} | s]                (D = nw + S)
//     out = sw @ G + bias   columns [s_next | U | Y | Z | q-part]
//     C_k = sum_{d < rank} Z_{k,d}^2 + qpart_k              (k < K)
//     s  <- s_next
//
// G is the unpadded fused operator (no 128-lane column padding; the
// column order of the TPU operator is kept). The segment-sum matrix of
// the TPU kernel is not needed: each solve's cost is summed directly,
// in a fixed order, so costs are deterministic.
//
// What bounds it on the H100: at the four-tank shape (B = 4096, T = 400,
// K = 50, D = 120, 1070 columns) one rollout is ~8.4 GFLOP of float32
// FMA work against ~46 MB of HBM traffic (the noise in, U/Y/C out), so
// it is compute-bound on the float32 FMA pipes (no tensor cores: the
// state, u and y columns must stay at float32 grade, atol 2e-5). The
// design does the work as a SIMT register-tiled GEMM: a block owns
// TB batch rows for the whole rollout with sw resident in shared memory
// (transposed, so a thread's rows load as one float4), and each thread
// accumulates a 4x4 register tile (16 FMAs per two shared-memory float4
// loads). G (0.5 MB, resident in L2 across blocks and steps) is
// streamed through two shared-memory buffers of BN columns: the next
// chunk's cp.async copies are in flight while the current chunk is
// multiplied, so the L2 latency hides behind the FMAs. Outputs go
// straight to global memory in batch-major layout (B, n_outer, width),
// which is what the PyTorch wrapper returns.
//
// Where this version stands (PERF.md has the numbers): the product
// alone reaches ~40% of the float32 peak, held by shared-memory
// bandwidth at a 4x4 tile with one 8-warp block per SM; re-staging G
// every step and the per-chunk cost epilogue add about as much again.
//
// K3 (fused_rollout_nocost_kernel) replaces the same function's body
// `kernel_nocost` (pallas_rollout.py:629, launched at :743 and :760):
// the same recursion with columns [s_next | U | Y] only; the costs are
// rebuilt afterwards from the trajectories (a convolution in the PyTorch
// wrapper, as the JAX package ran it in XLA). At large_plant (a
// 10-state, 10-input, 10-output plant, K = 25: D = 460 rows, 710
// columns, B = 65536, 16 blocks) one rollout is 685 GFLOP against
// 3.15 GB of HBM traffic (noise in; U, Y out), so arithmetic bounds it.
// It runs on the tensor cores at float32 grade, as the TPU kernel ran
// these columns at HIGHEST (a 6-pass bf16 emulation): 3xTF32. Each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi), rounded as
// cvt.rna rounds, and warp-level mma.sync m16n8k8 TF32 products give
// a_lo b_hi, a_hi b_lo, then a_hi b_hi; what is dropped (a_lo b_lo,
// lo's rounding) is ~2^-22 of each product. The bound is 3 x 685 GFLOP
// at 495 TFLOP/s = 4.15 ms; mma.sync itself peaks near two thirds of
// that rate on the H100 (wgmma has the rest).
//
// Design: a thread block owns BM = 64 scenarios for the whole rollout,
// so each block reads G (1.3 MB, resident in L2) once per step for 64
// scenarios. Where that plan does not fit shared memory (at large_plant,
// K > 28 solves per block) the block owns BM = 32 scenarios, which
// reads G twice as often and takes D up to 1200 rows (K <= 99). Its
// [w | s] tile stays in shared memory, row-major with a row stride of
// 4 mod 8 floats so that a warp's fragment loads hit 32 different banks;
// s_next goes to its own buffer and is swapped in after the step's last
// column chunk. G streams through a ring of NC_STAGES tiles of NC_BK
// rows x NC_BN columns filled by cp.async: a thread waits on its own
// copy groups, so one barrier per tile frees the oldest slot and
// publishes the newest. Each chunk of NC_BN output columns keeps its
// float32 accumulators in registers across all D rows (a 32 x 64 tile
// per warp at BM = 64, 32 x 32 at BM = 32; 8 warps). The tensor cores'
// own accumulation truncates, which summed over D rows cost 1.5e-4 on u
// at large_plant, so each 16 x 8 tile sums one ring tile's products from
// zero (small ones first) and adds that to its accumulator in float32.
// The epilogue writes U and Y from the registers, two columns per store.
// G is split as its fragments are loaded rather than once on the host:
// at this warp tile both cost about two other instructions per mma, and
// splitting here keeps the ring, the shared memory and the L2 reads at
// one float per element. Per block at large_plant (K = 25, BM = 64): the
// ring 50.7 KB, [w | s] 119.8 KB, s_next 53.8 KB: 224 KB; at K = 50 the
// 32-row plan takes 170 KB. The wrapper pads G's rows
// to a multiple of 4 floats (16-byte copies). What holds it back
// (PERF.md): the splits, the ring's copies and barriers, and the U, Y
// stores, each 1-2.5 ms beside the mma pipe's own time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_rollout.so fused_rollout.cu

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;        // batch rows per thread block
constexpr size_t SMEM_LIMIT = 232448;  // opt-in shared memory per block
constexpr int BN = 128;       // G columns per shared-memory chunk
constexpr int THREADS = 256;  // (TB / 4) row groups x (BN / 4) col groups
constexpr int LDS = TB + 4;   // row stride of the transposed sw tile
constexpr int LDO = BN + 1;   // row stride of the output stage (odd: a
                              // warp reading one column of 32 rows hits
                              // 32 different banks)
static_assert((TB / 4) * (BN / 4) == THREADS, "thread tiling");
static_assert(THREADS % BN == 0, "chunk copy tiling");

// Start the asynchronous copy of G's columns [j0, j0 + BN) into dst
// (D x BN, zero past the last column) as one cp.async group. Each
// thread copies one column, every (THREADS / BN)-th row, so the loop
// is a pointer walk.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ G,
                                            float* dst, int j0, int D,
                                            int Wtot) {
  constexpr int ROWS = THREADS / BN;  // rows copied per pass
  const int c = threadIdx.x % BN;
  const int i0 = threadIdx.x / BN;
  float* d = dst + i0 * BN + c;
  if (j0 + c < Wtot) {
    const float* src = G + (size_t)i0 * Wtot + j0 + c;
    for (int i = i0; i < D; i += ROWS, d += ROWS * BN, src += ROWS * Wtot)
      __pipeline_memcpy_async(d, src, sizeof(float));
  } else {
    for (int i = i0; i < D; i += ROWS, d += ROWS * BN) *d = 0.f;
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(THREADS)
fused_rollout_kernel(const float* __restrict__ G,     // (D, Wtot)
                     const float* __restrict__ bias,  // (Wtot,)
                     const float* __restrict__ s0,    // (B, S)
                     const float* __restrict__ W,     // (B, n_outer, nw)
                     float* __restrict__ U,           // (B, n_outer, Ku)
                     float* __restrict__ Y,           // (B, n_outer, Kp)
                     float* __restrict__ C,           // (B, n_outer, K)
                     float* __restrict__ s_fin,       // (B, S)
                     int B, int S, int nw, int Ku, int Kp, int K,
                     int rank, int n_outer, int w_off) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = nw + S;
  const int offY = S + Ku;
  const int offZ = offY + Kp;
  const int offQ = offZ + K * rank;
  const int Wtot = offQ + K;
  const int n_chunks = (Wtot + BN - 1) / BN;

  float* swT = smem;                   // (D, LDS): sw transposed
  float* Gbuf[2] = {swT + D * LDS,     // (D, BN) chunk, double-buffered
                    swT + D * LDS + D * BN};
  float* stage = Gbuf[1] + D * BN;     // (TB, LDO) chunk outputs
  float* snext = stage + TB * LDO;     // (TB, S)
  float* cacc = snext + TB * S;        // (K, TB) running costs

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;
  const int cg = tid % (BN / 4);  // column group: columns 4cg .. 4cg+3
  const int rg = tid / (BN / 4);  // row group: rows 4rg .. 4rg+3

  stage_chunk(G, Gbuf[0], 0, D, Wtot);
  // Initial carry; rows past B are zero.
  for (int idx = tid; idx < TB * S; idx += THREADS) {
    const int r = idx / S, j = idx % S;
    const int b = row0 + r;
    swT[(nw + j) * LDS + r] = b < B ? s0[(size_t)b * S + j] : 0.f;
  }
  int g = 0;  // chunks consumed so far; chunk g sits in Gbuf[g & 1]
  for (int t = 0; t < n_outer; ++t) {
    const int tw = (t + w_off) % n_outer;
    for (int idx = tid; idx < TB * nw; idx += THREADS) {
      const int r = idx / nw, i = idx % nw;
      const int b = row0 + r;
      swT[i * LDS + r] =
          b < B ? W[((size_t)b * n_outer + tw) * nw + i] : 0.f;
    }
    for (int idx = tid; idx < TB * K; idx += THREADS) cacc[idx] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch, ++g) {
      const int j0 = ch * BN;
      // Prefetch the next chunk (the first one again at the end of a
      // step: G is the same for every step), then wait for this one.
      // Its buffer was last read before the previous chunk's barrier.
      if (t < n_outer - 1 || ch < n_chunks - 1) {
        stage_chunk(G, Gbuf[(g + 1) & 1], ((ch + 1) % n_chunks) * BN, D,
                    Wtot);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // chunk g, the noise tile and the carry are in

      const float* Gs = Gbuf[g & 1];
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int i = 0; i < D; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            &swT[i * LDS + 4 * rg]);
        const float4 gv4 = *reinterpret_cast<const float4*>(
            &Gs[i * BN + 4 * cg]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float gv[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(av[r], gv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          stage[(4 * rg + r) * LDO + 4 * cg + c] = acc[r][c];
      __syncthreads();  // stage complete

      // State, u and y columns.
      const int jend = min(j0 + BN, offZ);
      for (int idx = tid; j0 < offZ && idx < TB * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN;
        const int j = j0 + c;
        if (j >= jend) continue;
        const float v = stage[r * LDO + c] + bias[j];
        const int b = row0 + r;
        if (j < S) {
          snext[r * S + j] = v;
        } else if (b < B) {
          if (j < offY)
            U[((size_t)b * n_outer + t) * Ku + (j - S)] = v;
          else
            Y[((size_t)b * n_outer + t) * Kp + (j - offY)] = v;
        }
      }
      // Cost columns: one thread per (row, solve), a warp per solve,
      // adds this chunk's squares in column order; the q-part, which
      // comes after every Z column, completes the cost.
      if (j0 + BN > offZ) {
        for (int idx = tid; idx < TB * K; idx += THREADS) {
          const int k = idx / TB, r = idx % TB;
          const int zs = max(offZ + k * rank, j0);
          const int ze = min(offZ + (k + 1) * rank, j0 + BN);
          const int jq = offQ + k;
          const bool has_q = jq >= j0 && jq < j0 + BN;
          if (zs >= ze && !has_q) continue;
          const float* row = stage + r * LDO;  // column j0 + c at row[c]
          float a = cacc[idx];
          for (int j = zs; j < ze; ++j) {
            const float z = row[j - j0] + bias[j];
            a = fmaf(z, z, a);
          }
          if (has_q) {
            const int b = row0 + r;
            a += row[jq - j0] + bias[jq];
            if (b < B) C[((size_t)b * n_outer + t) * K + k] = a;
          }
          cacc[idx] = a;
        }
      }
      // The next chunk's barrier orders these stage and cacc reads
      // before the next writes.
    }
    __syncthreads();  // every epilogue of this step is done

    // s <- s_next; the final carry goes out after the last block.
    for (int idx = tid; idx < TB * S; idx += THREADS) {
      const int r = idx / S, j = idx % S;
      const float v = snext[idx];
      swT[(nw + j) * LDS + r] = v;
      const int b = row0 + r;
      if (t == n_outer - 1 && b < B) s_fin[(size_t)b * S + j] = v;
    }
    // The next step's noise and cost-reset writes touch swT rows < nw
    // and cacc, whose last readers finished before the barrier above.
  }
}

// K3's plan: output columns per chunk, G rows per ring stage and ring
// depth. The scenarios per block, BM, are a template parameter: 64 where
// that plan fits shared memory, else 32 (twice the reads of G, but the
// [w | s] tile is half as large, so D up to 1200 rows fits).
constexpr int NC_BN = 256;
constexpr int NC_BK = 16;
constexpr int NC_STAGES = 3;
constexpr int NC_LDB = NC_BN + 8;  // ring row stride: 8 mod 32 floats, so
                                   // b-fragment loads hit 32 banks
constexpr int NC_THREADS = 256;
constexpr int NC_WARPS = NC_THREADS / 32;
static_assert(NC_BK % 8 == 0, "k8 steps per ring stage");

// The warp grid over a block of BM scenarios: each warp owns 32
// scenarios and NT n8 tiles of each column chunk (BM = 64: 2 x 4 warps,
// 8 tiles; BM = 32: 1 x 8 warps, 4 tiles).
template <int BM>
struct NcGrid {
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = NC_WARPS / WARPS_M;
  static constexpr int NT = NC_BN / (8 * WARPS_N);  // n8 tiles per warp
  static_assert(WARPS_M * WARPS_N == NC_WARPS, "warp grid");
  static_assert(NT * 8 * WARPS_N == NC_BN, "warp columns");
};

// Row stride of the [w | s] tile: D rounded up to whole ring tiles (the
// padding columns stay zero), plus 4, so the stride is 4 mod 8.
__host__ __device__ constexpr int nocost_lda(int D) {
  return (D + NC_BK - 1) / NC_BK * NC_BK + 4;
}

// x rounded to TF32 in float32 bits: cvt.rna.tf32.f32's rounding (to
// nearest, ties away from zero) for finite x, as two integer operations
// (nvcc lowers cvt.rna to four, with a test for infinity).
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative, both TF32 (x - hi is exact).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b for one 16 x 8 x 8 TF32 tile (float32 accumulators).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the asynchronous copy of `width` floats per scenario, from
// src + b * stride for the block's BM scenarios b, into columns
// [0, width) of the block's rows of A (zero past B) as one cp.async group.
template <int BM>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           size_t stride, int width,
                                           float* A, int lda, int row0,
                                           int B) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < BM; r += NC_WARPS) {
    float* a = A + r * lda;
    const float* s = src + (size_t)(row0 + r) * stride;
    for (int i = lane; i < width; i += 32) {
      if (row0 + r < B)
        __pipeline_memcpy_async(a + i, s + i, sizeof(float));
      else
        a[i] = 0.f;
    }
  }
  __pipeline_commit();
}

template <int BM>
__global__ void __launch_bounds__(NC_THREADS, 1)
fused_rollout_nocost_kernel(const float* __restrict__ G,     // (D, ldg)
                            const float* __restrict__ bias,  // (Wtot,)
                            const float* __restrict__ s0,    // (B, S)
                            const float* __restrict__ W,  // (B, n_outer, nw)
                            float* __restrict__ U,  // (B, n_outer, Ku)
                            float* __restrict__ Y,  // (B, n_outer, Kp)
                            float* __restrict__ s_fin,  // (B, S)
                            int B, int S, int nw, int Ku, int Kp, int ldg,
                            int n_outer, int w_off) {
  constexpr int NC_WARPS_N = NcGrid<BM>::WARPS_N;
  constexpr int NC_NT = NcGrid<BM>::NT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = nw + S;
  const int offY = S + Ku;
  const int Wtot = offY + Kp;
  const int n_k = (D + NC_BK - 1) / NC_BK;  // ring tiles per chunk
  const int total = n_k * ((Wtot + NC_BN - 1) / NC_BN) * n_outer;
  const int lda = nocost_lda(D);
  const bool pairs = (S | Ku | Kp) % 2 == 0;  // float2 stores are aligned

  float* ring = smem;                                  // NC_STAGES tiles
  float* A = ring + NC_STAGES * NC_BK * NC_LDB;        // (BM, lda)
  float* snext = A + BM * lda;                         // (BM, S)

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;  // mma fragment row and column
  const int wm = warp / NC_WARPS_N, wn = warp % NC_WARPS_N;
  const int row0 = blockIdx.x * BM;

  // The ring's tiles in order (step, chunk, row tile), each one cp.async
  // group: G's rows [pk, pk + NC_BK) x columns [pj, pj + NC_BN) into
  // slot pm mod NC_STAGES, zero past its D rows and ldg columns; G is
  // the same for every step. Each thread copies 16 bytes at column cc
  // of rows ci, ci + CR, ...; past the last tile, an empty group keeps
  // the count of groups per tile at one.
  constexpr int CV = NC_BN / 4, CR = NC_THREADS / CV, CP = NC_BK / CR;
  static_assert(CP * CR == NC_BK, "ring copies per thread");
  const int ci = threadIdx.x / CV, cc = 4 * (threadIdx.x % CV);
  int pm = 0, pk = 0, pj = 0;
  auto stage = [&]() {
    if (pm < total) {
      float* d = ring + (pm % NC_STAGES) * NC_BK * NC_LDB + ci * NC_LDB + cc;
      const float* s = G + (size_t)(pk + ci) * ldg + pj + cc;
#pragma unroll
      for (int u = 0; u < CP; ++u) {
        if (pj + cc < ldg && pk + ci + u * CR < D)
          __pipeline_memcpy_async(d + u * CR * NC_LDB,
                                  s + (size_t)u * CR * ldg, 16);
        else
          *reinterpret_cast<float4*>(d + u * CR * NC_LDB) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      pk += NC_BK;
      if (pk >= n_k * NC_BK) {
        pk = 0;
        pj += NC_BN;
        if (pj >= Wtot) pj = 0;
      }
    }
    ++pm;
    __pipeline_commit();
  };
  for (int m = 0; m < NC_STAGES - 1; ++m) stage();

  // [w | s | 0] for the first step; rows past B are zero. The noise of
  // a step is row block (t + w_off) mod n_outer of each scenario's W.
  const size_t wstride = (size_t)n_outer * nw;
  stage_rows<BM>(W + (size_t)w_off * nw, wstride, nw, A, lda, row0, B);
  stage_rows<BM>(s0, S, S, A + nw, lda, row0, B);
  for (int r = warp; r < BM; r += NC_WARPS)
    for (int i = D + lane; i < lda; i += 32) A[r * lda + i] = 0.f;
  __pipeline_wait_prior(0);

  int m = 0;  // ring tiles consumed so far
  for (int t = 0; t < n_outer; ++t) {
    for (int j0 = 0; j0 < Wtot; j0 += NC_BN) {
      float acc[2][NC_NT][4] = {};
      for (int kt = 0; kt < n_k; ++kt, ++m) {
        __pipeline_wait_prior(NC_STAGES - 2);  // this thread's copies of
        __syncthreads();  // tile m are in, and everyone's; tile m - 1 is
                          // done, so its slot takes tile m + STAGES - 1
        stage();  // tile m + NC_STAGES - 1
        const float* Gs =
            ring + (m % NC_STAGES) * NC_BK * NC_LDB + wn * NC_NT * 8 + g;
        const float* As = A + (wm * 32 + g) * lda + kt * NC_BK + q;
        // The tile's A fragments, split (KS k8 steps, 2 m16 tiles); then
        // per n8 tile the B fragments. Each 16 x 8 output tile sums the
        // tile's products outside the accumulator, small ones first, and
        // is added to it in float32 (the tensor cores' own accumulation
        // truncates, which over all D rows would cost float32 grade).
        constexpr int KS = NC_BK / 8;
        unsigned ahi[KS][2][4], alo[KS][2][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float* a = As + mi * 16 * lda + 8 * ks;
            split_tf32(a[0], ahi[ks][mi][0], alo[ks][mi][0]);
            split_tf32(a[8 * lda], ahi[ks][mi][1], alo[ks][mi][1]);
            split_tf32(a[4], ahi[ks][mi][2], alo[ks][mi][2]);
            split_tf32(a[8 * lda + 4], ahi[ks][mi][3], alo[ks][mi][3]);
          }
#pragma unroll
        for (int ni = 0; ni < NC_NT; ++ni) {
          unsigned bhi[KS][2], blo[KS][2];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const float* b = Gs + (8 * ks + q) * NC_LDB + ni * 8;
            split_tf32(b[0], bhi[ks][0], blo[ks][0]);
            split_tf32(b[4 * NC_LDB], bhi[ks][1], blo[ks][1]);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            float d[4] = {};
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              mma_tf32(d, alo[ks][mi], bhi[ks][0], bhi[ks][1]);
              mma_tf32(d, ahi[ks][mi], blo[ks][0], blo[ks][1]);
              mma_tf32(d, ahi[ks][mi], bhi[ks][0], bhi[ks][1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[e];
          }
        }
      }
      // Epilogue from the registers: element (2h + e) of tile (mi, ni)
      // is row g + 8h, column 2q + e. The next state goes to shared
      // memory, U and Y to global memory, two columns per store where
      // both fall in U or in Y (every index is then even).
#pragma unroll
      for (int ni = 0; ni < NC_NT; ++ni) {
        const int j = j0 + (wn * NC_NT + ni) * 8 + 2 * q;
        if (j >= Wtot) break;
        const bool two = j + 1 < Wtot;
        const float b0 = __ldg(bias + j), b1 = two ? __ldg(bias + j + 1) : 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mi * 16 + g + 8 * h;
            const int b = row0 + r;
            const float v[2] = {acc[mi][ni][2 * h] + b0,
                                acc[mi][ni][2 * h + 1] + b1};
            float* u = U + ((size_t)b * n_outer + t) * Ku - S;
            float* y = Y + ((size_t)b * n_outer + t) * Kp - offY;
            if (pairs && b < B && j >= S && j + 1 < offY) {
              *reinterpret_cast<float2*>(u + j) = make_float2(v[0], v[1]);
            } else if (pairs && b < B && j >= offY && two) {
              *reinterpret_cast<float2*>(y + j) = make_float2(v[0], v[1]);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int je = j + e;
                if (e && !two) break;
                if (je < S)
                  snext[r * S + je] = v[e];
                else if (b < B)
                  (je < offY ? u : y)[je] = v[e];
              }
            }
          }
      }
    }
    __syncthreads();  // snext is complete; A is no longer read this step

    // The next step's noise is copied in while s <- s_next (the final
    // carry goes out after the last step); the wait covers the copies
    // of this thread, the next tile's barrier everyone's, and orders
    // the snext reads before the next epilogue's writes.
    if (t + 1 < n_outer)
      stage_rows<BM>(W + (size_t)((t + 1 + w_off) % n_outer) * nw, wstride,
                     nw, A, lda, row0, B);
    for (int r = warp; r < BM; r += NC_WARPS) {
      const int b = row0 + r;
      for (int j = lane; j < S; j += 32) {
        const float v = snext[r * S + j];
        A[r * lda + nw + j] = v;
        if (t == n_outer - 1 && b < B) s_fin[(size_t)b * S + j] = v;
      }
    }
    __pipeline_wait_prior(0);
  }
}

// Shared memory of each kernel for a given shape, in bytes.
size_t smem_bytes(int S, int nw, int K) {
  const size_t D = (size_t)nw + S;
  return sizeof(float) * (D * LDS + 2 * D * BN + (size_t)TB * LDO +
                          (size_t)TB * S + (size_t)TB * K);
}
size_t nocost_smem_bytes(int S, int nw, int BM) {
  return sizeof(float) * ((size_t)NC_STAGES * NC_BK * NC_LDB +
                          (size_t)BM * nocost_lda(nw + S) + (size_t)BM * S);
}

// K3's scenarios per block: 64 where that plan fits one block's shared
// memory, else 32, else 0 (the shape does not fit).
int nocost_tile_rows(int S, int nw) {
  for (int BM = 64; BM >= 32; BM /= 2)
    if (nocost_smem_bytes(S, nw, BM) <= SMEM_LIMIT) return BM;
  return 0;
}

template <int BM>
int nocost_launch(const float* G, const float* bias, const float* s0,
                  const float* W, float* U, float* Y, float* s_fin, int B,
                  int S, int nw, int Ku, int Kp, int ldg, int n_outer,
                  int w_off, cudaStream_t stream) {
  const size_t smem = nocost_smem_bytes(S, nw, BM);
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_nocost_kernel<BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BM - 1) / BM);
  fused_rollout_nocost_kernel<BM><<<grid, NC_THREADS, smem, stream>>>(
      G, bias, s0, W, U, Y, s_fin, B, S, nw, Ku, Kp, ldg, n_outer, w_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of a K1 block at this shape, or 0
// when it does not fit one block.
int fused_rollout_smem_bytes(int S, int nw, int K) {
  const size_t b = smem_bytes(S, nw, K);
  return b <= SMEM_LIMIT ? (int)b : 0;
}

// The same for the no-cost kernel (K3), at the plan it launches.
int fused_rollout_nocost_smem_bytes(int S, int nw) {
  const int BM = nocost_tile_rows(S, nw);
  return BM ? (int)nocost_smem_bytes(S, nw, BM) : 0;
}

// Scenarios per K3 block at this shape: 64, 32, or 0 when neither plan
// fits one block.
int fused_rollout_nocost_tile_rows(int S, int nw) {
  return nocost_tile_rows(S, nw);
}

// Launches the rollout on `stream`; returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous float32 arrays
// of the shapes noted at the kernel.
int fused_rollout_launch(const float* G, const float* bias,
                         const float* s0, const float* W, float* U,
                         float* Y, float* C, float* s_fin, int B, int S,
                         int nw, int Ku, int Kp, int K, int rank,
                         int n_outer, int w_off, void* stream) {
  const size_t smem = smem_bytes(S, nw, K);
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB);
  fused_rollout_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      G, bias, s0, W, U, Y, C, s_fin, B, S, nw, Ku, Kp, K, rank, n_outer,
      w_off);
  return (int)cudaGetLastError();
}

// Launches the no-cost rollout (K3) on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when the
// shape does not fit or G's row stride ldg (>= S + Ku + Kp, in floats)
// is not a multiple of 4. G is (nw + S, ldg), 16-byte aligned; U, Y and
// s_fin as for fused_rollout_launch.
int fused_rollout_nocost_launch(const float* G, const float* bias,
                                const float* s0, const float* W, float* U,
                                float* Y, float* s_fin, int B, int S,
                                int nw, int Ku, int Kp, int ldg,
                                int n_outer, int w_off, void* stream) {
  const int BM = nocost_tile_rows(S, nw);
  if (BM == 0 || ldg % 4 || ldg < S + Ku + Kp ||
      reinterpret_cast<size_t>(G) % 16)
    return (int)cudaErrorInvalidValue;
  return (BM == 64 ? nocost_launch<64> : nocost_launch<32>)(
      G, bias, s0, W, U, Y, s_fin, B, S, nw, Ku, Kp, ldg, n_outer, w_off,
      (cudaStream_t)stream);
}

}  // extern "C"
