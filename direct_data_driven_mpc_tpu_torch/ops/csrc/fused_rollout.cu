// Fused condensed closed-loop rollout (float32, Hopper sm_90a).
//
// Replaces direct_data_driven_mpc_tpu/ops/pallas_rollout.py::
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_rollout.so fused_rollout.cu

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;        // batch rows per thread block
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

// Shared memory the kernel needs for a given shape, in bytes.
size_t smem_bytes(int S, int nw, int K) {
  const size_t D = (size_t)nw + S;
  return sizeof(float) * (D * LDS + 2 * D * BN + (size_t)TB * LDO +
                          (size_t)TB * S + (size_t)TB * K);
}

}  // namespace

extern "C" {

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

}  // extern "C"
