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
// `kernel_nocost`: the same recursion with columns [s_next | U | Y]
// only; the costs are rebuilt afterwards from the trajectories (a
// convolution in the PyTorch wrapper, as the JAX package ran it in
// XLA). At large_plant (a 10-state, 10-input, 10-output plant, K = 25:
// D = 460 rows, 710 columns, B = 65536, 16 blocks) one rollout is
// 685 GFLOP against 3.15 GB of HBM traffic (noise in; U, Y out), so it
// is bound by the float32 FMA pipes. K1's plan (all D rows of two
// 128-column chunks of G in shared memory, 471 KB here) does not fit
// one block, so K3 tiles the contraction too: G streams through two
// cp.async buffers of BK rows x BN columns (32 KB), each output's
// 4 x 4 register tile accumulates over the row tiles in order (one FMA
// chain per output, as in K1), and the epilogue writes U and Y straight
// from the registers. Per block: sw transposed (D x 36 floats), the
// two G tiles and the next state (TB x S): 126 KB at large_plant.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_rollout.so fused_rollout.cu

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;        // batch rows per thread block
constexpr int BK = 32;        // G rows per shared-memory tile (K3)
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

// Start the asynchronous copy of G's tile [k0, k0 + BK) x [j0, j0 + BN)
// into dst (BK x BN, zero outside G) as one cp.async group.
__device__ __forceinline__ void stage_tile(const float* __restrict__ G,
                                           float* dst, int k0, int j0,
                                           int D, int Wtot) {
  constexpr int ROWS = THREADS / BN;  // rows copied per pass
  const int c = threadIdx.x % BN;
  const int j = j0 + c;
  for (int i = threadIdx.x / BN; i < BK; i += ROWS) {
    const int k = k0 + i;
    float* d = dst + i * BN + c;
    if (k < D && j < Wtot)
      __pipeline_memcpy_async(d, G + (size_t)k * Wtot + j, sizeof(float));
    else
      *d = 0.f;
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(THREADS)
fused_rollout_nocost_kernel(const float* __restrict__ G,     // (D, Wtot)
                            const float* __restrict__ bias,  // (Wtot,)
                            const float* __restrict__ s0,    // (B, S)
                            const float* __restrict__ W,  // (B, n_outer, nw)
                            float* __restrict__ U,  // (B, n_outer, Ku)
                            float* __restrict__ Y,  // (B, n_outer, Kp)
                            float* __restrict__ s_fin,  // (B, S)
                            int B, int S, int nw, int Ku, int Kp,
                            int n_outer, int w_off) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = nw + S;
  const int offY = S + Ku;
  const int Wtot = offY + Kp;
  const int n_chunks = (Wtot + BN - 1) / BN;
  const int n_k = (D + BK - 1) / BK;
  const int per_step = n_chunks * n_k;  // G tiles per time block

  float* swT = smem;                    // (D, LDS): sw transposed
  float* Gbuf[2] = {swT + D * LDS,      // (BK, BN) tile, double-buffered
                    swT + D * LDS + BK * BN};
  float* snext = Gbuf[1] + BK * BN;     // (TB, S)

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;
  const int cg = tid % (BN / 4);  // column group: columns 4cg .. 4cg+3
  const int rg = tid / (BN / 4);  // row group: rows 4rg .. 4rg+3

  stage_tile(G, Gbuf[0], 0, 0, D, Wtot);
  for (int idx = tid; idx < TB * S; idx += THREADS) {
    const int r = idx / S, j = idx % S;
    const int b = row0 + r;
    swT[(nw + j) * LDS + r] = b < B ? s0[(size_t)b * S + j] : 0.f;
  }
  int g = 0;  // tiles consumed so far; tile g sits in Gbuf[g & 1]
  for (int t = 0; t < n_outer; ++t) {
    const int tw = (t + w_off) % n_outer;
    for (int idx = tid; idx < TB * nw; idx += THREADS) {
      const int r = idx / nw, i = idx % nw;
      const int b = row0 + r;
      swT[i * LDS + r] =
          b < B ? W[((size_t)b * n_outer + tw) * nw + i] : 0.f;
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int j0 = ch * BN;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int kc = 0; kc < n_k; ++kc, ++g) {
        // Prefetch the next tile in (step, chunk, row tile) order (the
        // first again after the last: G is the same for every step).
        // Its buffer was last read before the previous tile's second
        // barrier.
        const int nxt = ch * n_k + kc + 1;
        if (t < n_outer - 1 || nxt < per_step) {
          const int m = nxt % per_step;
          stage_tile(G, Gbuf[(g + 1) & 1], (m % n_k) * BK, (m / n_k) * BN,
                     D, Wtot);
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();  // tile g, the noise and the carry are in
        const float* Gs = Gbuf[g & 1];
        const float* a = swT + kc * BK * LDS + 4 * rg;
        const int kend = min(BK, D - kc * BK);
#pragma unroll 4
        for (int i = 0; i < kend; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(a + i * LDS);
          const float4 g4 =
              *reinterpret_cast<const float4*>(&Gs[i * BN + 4 * cg]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(av[r], gv[c], acc[r][c]);
        }
        __syncthreads();  // every thread is done with tile g
      }
      // Epilogue from the registers: the next state to shared memory,
      // U and Y to global memory.
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * cg + c;
        if (j >= Wtot) break;
        const float bj = bias[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * rg + r;
          const int b = row0 + row;
          const float v = acc[r][c] + bj;
          if (j < S)
            snext[row * S + j] = v;
          else if (b < B && j < offY)
            U[((size_t)b * n_outer + t) * Ku + (j - S)] = v;
          else if (b < B)
            Y[((size_t)b * n_outer + t) * Kp + (j - offY)] = v;
        }
      }
    }
    __syncthreads();  // snext is complete; swT is no longer read

    for (int idx = tid; idx < TB * S; idx += THREADS) {
      const int r = idx / S, j = idx % S;
      const float v = snext[idx];
      swT[(nw + j) * LDS + r] = v;
      const int b = row0 + r;
      if (t == n_outer - 1 && b < B) s_fin[(size_t)b * S + j] = v;
    }
    // The next step's first tile barrier orders this copy and the noise
    // writes before the product reads swT.
  }
}

// Shared memory of each kernel for a given shape, in bytes.
size_t smem_bytes(int S, int nw, int K) {
  const size_t D = (size_t)nw + S;
  return sizeof(float) * (D * LDS + 2 * D * BN + (size_t)TB * LDO +
                          (size_t)TB * S + (size_t)TB * K);
}
size_t nocost_smem_bytes(int S, int nw) {
  const size_t D = (size_t)nw + S;
  return sizeof(float) * (D * LDS + 2 * (size_t)BK * BN + (size_t)TB * S);
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of a K1 block at this shape, or 0
// when it does not fit one block.
int fused_rollout_smem_bytes(int S, int nw, int K) {
  const size_t b = smem_bytes(S, nw, K);
  return b <= SMEM_LIMIT ? (int)b : 0;
}

// The same for the no-cost kernel (K3).
int fused_rollout_nocost_smem_bytes(int S, int nw) {
  const size_t b = nocost_smem_bytes(S, nw);
  return b <= SMEM_LIMIT ? (int)b : 0;
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
// shape does not fit. G is (nw + S, S + Ku + Kp); U, Y and s_fin as for
// fused_rollout_launch.
int fused_rollout_nocost_launch(const float* G, const float* bias,
                                const float* s0, const float* W, float* U,
                                float* Y, float* s_fin, int B, int S,
                                int nw, int Ku, int Kp, int n_outer,
                                int w_off, void* stream) {
  const size_t smem = nocost_smem_bytes(S, nw);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_nocost_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB);
  fused_rollout_nocost_kernel<<<grid, THREADS, smem,
                                (cudaStream_t)stream>>>(
      G, bias, s0, W, U, Y, s_fin, B, S, nw, Ku, Kp, n_outer, w_off);
  return (int)cudaGetLastError();
}

}  // extern "C"
