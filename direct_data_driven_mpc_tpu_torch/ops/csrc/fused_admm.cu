// Fused batched ADMM closed loop (float32, Hopper sm_90a), with a fixed
// penalty (kernel K4, fused_admm_kernel) or the adaptive penalty ladder
// (kernel K5, fused_ladder_kernel).
//
// K4 replaces direct_data_driven_mpc_tpu/ops/pallas_admm.py::
// _make_admm_kernel (its math: _make_block_math, _make_iter_extract,
// _make_plant_step). The TPU kernel's sequential time axis of the grid
// becomes a loop inside each thread block, and its VMEM scratch carry
// becomes shared memory. A block owns TB scenarios for the whole
// rollout; per solve block t it computes
//
//   (adds)   pre += a_pre;  vc += a_vc;  zth += a_z           (tracking)
//   n_iter:  v  = (s - w) @ Vop + vc
//            vh = alpha v + beta s          (beta = 1 - alpha)
//            s' = clip(vh + w, lo, hi);  w' = w + vh - s'
//   extract: m1 = (s - w) @ M1
//            u = clip(pre_u + m1_u, u_lo, u_hi)
//            cost = sum_j (zth_j + m1_z,j)^2 + (pre_q + m1_q)
//            rp = max |v_last - s|,  rd = rho max |s - s_prev|
//   plant:   [s_flat | u | w_noise] @ M2 + b2
//              -> [s_flat' | pre_u' | y | pre_q' | vc' | zth']
//
// The operators are per scenario: the TPU kernel packed 128 / seg
// scenarios per row through block-diagonal operators to fill its
// 128-lane matrix unit, which here would only double the work. All
// products run in float32 FMA; the TPU's bf16 1-pass / 3-pass tiers are
// not ported (the schedule's iteration counts are summed into n_iter).
//
// What bounds it on the H100: at four-tank (nbox = 60, nxi = 76,
// S = 20) a solve is ~96 kFLOP (n_iter = 11 iterations of a 60 x 60
// product, the 60 x 79 extraction and the 24 x 161 plant product)
// against ~28 bytes of HBM traffic (noise in; u, y, cost, rp, rd out),
// so the kernel is bound by the float32 FMA pipes and by how well they
// are fed from shared memory. Every operator (49 KB at four-tank) and
// every scenario's carry stays on the SM for the whole rollout, so
// nothing but the noise and the outputs touches HBM between solves.
//
// The iterations are most of the work, and they are latency-bound, not
// FMA-bound, unless each SM runs many warps and nothing stalls them all
// at once. So both kernels share one body (admm_rollout):
// - Warp-owned scenarios. Warp k owns the block's scenarios 8k .. 8k+7
//   for the whole rollout (4k .. 4k+3 in K4's half-height tile, below);
//   lane l takes rows 4 (l >> 4) .. +3 of them (2 (l >> 4) .. +1)
//   and columns 4 (l & 15) + 64 j .. +3, for j < NT = ceil(nbox / 64).
//   The d = s - w slab is scenario-minor, so a warp reads and writes
//   only its own columns of it: the iteration loop needs no block
//   barrier, only __syncwarp between the product's reads and the
//   epilogue's writes, and one d buffer.
// - Register residency. s and w stay in the owning lanes' registers for
//   the whole rollout (loaded once, stored once), and vc (with K4's
//   tracking add) and the bounds for each solve: an iteration's
//   epilogue touches shared memory only to write d. The residual maxima
//   reduce over the 16 lanes of a row group by shuffles; maxima are
//   exact, so every bit is kept.
// - Two blocks per SM at NT = 1: __launch_bounds__(256, 2) caps a thread
//   at 128 registers, and the block stays under 115,712 bytes (K4 at
//   four_tank_convex: 111,168; K5 at four_tank_ladder: 100,736), so 16
//   warps hide each other's shared-memory and FMA latency.
// - The extraction and the plant step are SIMT register-tiled GEMMs
//   over the block's scenarios (tile_product): the A operand (s - w, or
//   [s | u | w]) is stored scenario-minor, so a thread's four scenarios
//   load as one float4, and each thread accumulates a 4 x 4 tile, its
//   epilogue fusing the extraction or the next solve's maps. Each cost
//   is summed by the row group's 16 lanes and shuffles.
// Each output of a product is one FMA chain over the contraction, from
// zero, in a fixed order, and the elementwise update uses __fmul_rn /
// __fadd_rn so nvcc does not contract it into FMAs: it rounds as the
// plain PyTorch version does, and u, y, the state, s and w are
// bit-equal to it where cuBLAS sums its products as one chain too.
//
// K4's tile is free (each scenario is independent): the largest of 64,
// 32, 16, 8, 4 scenarios whose block fits (64 at four_tank_convex, 32
// at nbox 120), with its snext rows laid over the d slab, which is dead
// from the extraction until the next solve stores d from the registers
// again. Its tracking adds go to pre and zth before the barrier that
// precedes the extraction, and to vc as it enters the registers.
// Where a grid of 32-scenario blocks would put at most one block on
// each SM (ceil(B / 32) <= SMs: B <= 4224 on a 132-SM H100), K4 halves
// its 64-scenario tile: 32 scenarios a block on the same 8 warps, 4 a
// warp, a lane holding 2 rows of the same 4 columns (RL = 2 rows a
// lane), so the grid has twice the blocks and reaches twice the SMs.
// Measured on an H100 at four_tank_convex x 400 steps (K4 alone, ms, the
// 64 tile against the 32): 18.0 / 12.0 at B = 4096, 18.0 / 18.6 at 8192
// (where some SMs hold two 32-blocks), 28.4 / 30.2 at 12288, 28.4 / 37.1
// at 16384. A lane keeps its column group and its row group of 16
// lanes, so every product, maximum and sum is taken in the same order:
// the half-height tile gives the same bits. The tile depends only on B
// and the card. K5 keeps 4 rows a lane at every B (its block is its rung
// group, part of its result), and so does K4's NON_CONVEX mode (its
// alpha_l1 is written for 4 rows).
//
// K4's NON_CONVEX mode (fused_admm_nonconvex_kernel) runs the paper's
// Eq. 6d, ||sigma_pred||_inf <= c eps (1 + ||alpha||_1), as the
// convex-concave fixed point of qp/nonconvex.py, which no TPU kernel
// ran (the JAX package runs it in its generic loop only): each scenario
// clips at its own bound, held in the registers of the lanes that own
// its rows, and a solve runs n_outer blocks of n_iter iterations, each
// block followed by alpha = a_c + [theta; s - w] G, G = [A_theta^T;
// A_s^T] (76 x 367 at four-tank, 113 KB), and bound = c eps (1 +
// ||alpha||_1), then sigma_pred = (s - w) Vop + vc for the feasibility
// of the final iterate. A warp computes alpha for its own scenarios in
// the iterations' layout (lane l: columns 4 (l & 15) + 64 j .. + 3), so
// the update needs no block barrier, and sums |alpha| in a fixed order
// (the lane's columns in turn, then the row group's xor butterfly) that
// the plain version repeats, so the bound, and every clip after it, is
// bit-equal to it. G is read from global memory, where every block
// reads the same bytes, so it comes from L2, and the block stays K4's
// plus a_c (112,640 bytes at four-tank): two blocks share an SM. Measured
// on an H100 at four_tank_nonconvex, 65536 x 400, and not kept: G
// resident beside the operators (224,512 bytes, one block per SM),
// 850-859 ms a call against 788-790.
// What bounds it: the iterations as in K4 (64 a solve), and the alpha
// products, 28 % of the FMAs; the same float32 FMA pipes.
//
// K5 replaces _make_ladder_kernel (with _make_ladder_step). The box
// operator is pre-factorised for R penalties rho_0 < ... < rho_{R-1}; a
// thread block's TB scenarios form one rung group and share one rung
// ri. After the extraction of each solve the block balances the rung on
// its group's maxima (rows past B excluded):
//
//   rp_blk = max rp,  rd_blk = (max rd) / rho_ri,  s_mag = max |s|,
//   w_mag = max |w|,  rp_rel = rp_blk / max(max(s_mag, w_mag), 1e-12),
//   rd_rel = rd_blk / max(w_mag, 1e-12),
//   ri' = ri + [rp_rel > ratio rd_rel and ri < R-1]
//            - [rd_rel > ratio rp_rel and ri > 0]
//
// (maxima keep a NaN, so a non-finite lane never looks converged), and
// on a move rescales the scaled dual w by rho_ri / rho_ri' (the ratio
// rounded to float32 first) and takes the plant step with rung ri''s
// maps. Only the group's current rung is resident in shared memory
// (41 KB at four_tank_ladder, where all seven rungs would be 287 KB):
// the stack stays in global memory, where it lives in L2, and a block
// whose rung moved re-stages Vop, M1, M2 and b2 between the balancer
// and the plant step. The divisions and products of the balancer round
// explicitly, as the plain PyTorch version rounds them in float32. The
// rung moves are discontinuous functions of the group maxima, so any
// change of rounding could flip a rung: K5 is bit-equal to its plain
// version in every rung too. The group, part of the result, is sized by
// rung_group_bytes, the layout both kernels had before their redesigns.
//
// K4w and K5w (fused_admm_wide_kernel, fused_ladder_wide_kernel) are
// the same rollout for the shapes the resident plans refuse: nbox above
// 192 (three 64-column register tiles a lane), or one rung's operators
// too large to sit beside the carry in one block (bench.py's large_plant:
// Vop 300 x 300, M1 300 x 511, M2 230 x 1031, 1.9 MB, against one block's
// 227 KB). Their body, admm_rollout_wide, keeps each scenario's carry in
// shared memory instead (d = s - w with s_next laid over it, [s | u | w],
// pre, vc, zth), s and w in the registers of the thread that owns their
// iteration tile, and streams the operators from global memory, where
// every block reads the same bytes, so they come from L2. The wrapper
// pads each operator row to a multiple of four floats at each launch,
// so every panel row is a 16-byte aligned run. A producer warp walks the
// rollout's panels in the consumers' order and keeps a ring of two large
// stages full: for each panel it waits on the stage's empty mbarrier,
// arms its full mbarrier with the panel's bytes and issues bulk copies
// (cp.async.bulk, one for a panel of whole rows, else one a row). The 16
// consumer warps wait on full, multiply, and arrive on empty: a product
// needs no block barrier per panel, only the barriers that order the
// state between products (two an iteration). A product's columns go in
// windows of whole units of 128 tiles, spread evenly (no narrow tail
// window), each window's 32-tile slots dealt to the warps in turn, so
// every warp runs at most one slot with no divergent tile branch and
// each scheduler partition at most one slot more than another. K5w's
// consumers hand the balancer's rung to the producer through one more
// mbarrier before the plant step's panels. A block of TB scenarios
// (wide_group_rows, the tile rule of the body's first plan, kept because
// K5w's rung group is part of its result: 16 at large_plant with CONVEX
// slack, nbox 300, and 32 on its input box, nbox 200). Every output is
// still one FMA chain over k from zero in order, the elementwise steps
// round as in admm_rollout, and the cost is summed by 16 lanes a row in
// the same order, so the wide body's bits do not depend on its ring or
// tiling, and equal the resident body's wherever both run. What bounds
// it: the float32 FMA pipes (the loads are hidden: cutting them saves
// 1-3 %); the products reach about a third of the card's FMA rate, with
// one block of 16 consumer warps per SM.
// Measured on an H100 and not kept: K4w in clusters of two blocks that
// share each panel (each producer multicasting half of each panel's
// rows into both blocks' rings) took 1.3-1.6x the time of single blocks;
// 3 and 4 smaller stages, 8 consumer warps and a 4-deep k loop were all
// slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_admm.so fused_admm.cu

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_LIMIT = 232448;  // opt-in shared memory per block

__host__ __device__ inline int ceil4(int x) { return (x + 3) & ~3; }

// Sizes of one launch. Operator rows are padded to a multiple of four
// floats (zeros) so a thread's four columns load as one float4.
struct Shape {
  int B, S, nbm, nbp, nbox, nxi, n_blocks, n_iter;
  int Mw, D2, W1, W2;      // pre width, plant input, M1 and M2 widths
  int ldv, ld1, ld2, ldu;  // padded rows of Vop, M1, M2, u bounds
  int TB, LDS;             // scenarios per block, carry row stride
  // K4's NON_CONVEX mode: theta's width (nxi - nbox), alpha's width, the
  // padded row of G and a_c, outer iterations (bound updates) per solve.
  int nth, n_alpha, lda, n_outer;
};

__host__ __device__ inline Shape make_shape(int S, int nbm, int nbp,
                                            int nbox, int nxi, int TB) {
  Shape d{};
  d.S = S;
  d.nbm = nbm;
  d.nbp = nbp;
  d.nbox = nbox;
  d.nxi = nxi;
  d.Mw = nbm + 1;
  d.D2 = S + nbm + nbp;
  d.W1 = d.Mw + nxi;
  d.W2 = S + nbm + nbp + 1 + nbox + nxi;
  d.ldv = ceil4(nbox);
  d.ld1 = ceil4(d.W1);
  d.ld2 = ceil4(d.W2);
  d.ldu = ceil4(nbm);
  d.TB = TB;
  d.LDS = TB + 4;
  return d;
}

// Shared-memory floats of one operator set (Vop, M1, M2, b2) and of the
// bounds, rows padded to a multiple of four floats.
__host__ __device__ inline size_t op_floats(const Shape& d) {
  return (size_t)d.nbox * d.ldv + (size_t)d.nbox * d.ld1 +
         (size_t)d.D2 * d.ld2 + d.ld2 + 2 * (size_t)d.ldv + 2 * (size_t)d.ldu;
}

// The rung-group rule: K5's group of TB scenarios is the largest TB for
// which the layout both kernels had before their redesigns fits one
// block: the operators; the carry rows xin, snext, pre, vc, zth, s, w
// and a double-buffered s - w; TB residual bits each for rp and rd; the
// balancer's four maxima. The groups are part of K5's result, so this
// rule does not follow either kernel's layout.
size_t rung_group_bytes(const Shape& d) {
  const int rows = d.D2 + d.S + d.Mw + d.nbox + d.nxi + 4 * d.nbox;
  return sizeof(float) *
         (op_floats(d) + (size_t)rows * d.LDS + 2 * (size_t)d.TB + 4);
}

// Vop, M1, M2 and b2 point at one operator (K4) or at the ladder's
// stack of R, rung-major (K5).
struct Params {
  const float *Vop, *M1, *M2, *b2, *lo, *hi, *u_lo, *u_hi;
  const float *s0, *pre0, *vc0, *zth0, *sa0, *wa0, *W, *adds;
  float *U, *Y, *C, *RP, *RD, *s_fin, *sa_fin, *wa_fin;
  float alpha, beta, rho;
  // Ladder only: penalties (R), each group's first rung, the per-solve
  // post-balance rung (B, n_blocks), the ladder size, the balance ratio.
  const float* rhos;
  const int* rung0;
  int* RUNG;
  int R;
  float ratio;
  // K4's NON_CONVEX mode: G = [A_theta^T; A_s^T] (nth + nbox, n_alpha),
  // a_c (n_alpha), the base coefficient c_eps, each scenario's bound in
  // (B) and out (bd_fin); per solve (B, n_blocks) the relative step of
  // the last bound update (DL), ||sigma_pred||_inf less the bound (GP)
  // and the bound (BD); counters (4, or null): bound_cycles,
  // kernel_cycles, bound_active, nonconvex_solves.
  const float *G, *a_c, *bd0;
  float *bd_fin, *DL, *GP, *BD;
  unsigned long long* counters;
  float c_eps;
};

// Copy a (rows, width) row-major operator into shared memory with rows
// of ld floats, zero past width.
__device__ void load_op(float* dst, const float* __restrict__ src, int rows,
                        int width, int ld) {
  for (int idx = threadIdx.x; idx < rows * ld; idx += THREADS) {
    const int r = idx / ld, c = idx - r * ld;
    dst[idx] = c < width ? src[(size_t)r * width + c] : 0.f;
  }
}

// Load a batch-major (B, width) carry into scenario-minor rows
// dst[j * LDS + r]; rows past B are zero.
__device__ void load_carry(float* dst, const float* __restrict__ src,
                           int width, int row0, const Shape& d) {
  for (int idx = threadIdx.x; idx < d.TB * width; idx += THREADS) {
    const int r = idx / width, j = idx - r * width;
    const int b = row0 + r;
    dst[j * d.LDS + r] = b < d.B ? src[(size_t)b * width + j] : 0.f;
  }
}

__device__ void store_carry(float* __restrict__ dst, const float* src,
                            int width, int row0, const Shape& d) {
  for (int idx = threadIdx.x; idx < d.TB * width; idx += THREADS) {
    const int r = idx / width, j = idx - r * width;
    const int b = row0 + r;
    if (b < d.B) dst[(size_t)b * width + j] = src[j * d.LDS + r];
  }
}

// out[r][c] = sum_k A[k][r] * Op[k][c] for the block's TB scenarios and
// ncols columns, in 4 x 4 register tiles; epi(r0, c0, acc) consumes a
// tile (scenarios r0..r0+3, columns c0..c0+3, possibly past ncols). A
// thread always gets the same tiles for the same (TB, ncols).
template <class Epi>
__device__ __forceinline__ void tile_product(const float* A, int lda,
                                             const float* Op, int ldo,
                                             int K, int ncols, int TB,
                                             Epi&& epi) {
  const int ncg = (ncols + 3) >> 2;
  const int n_tiles = (TB >> 2) * ncg;
  for (int tile = threadIdx.x; tile < n_tiles; tile += THREADS) {
    const int rg = tile / ncg, cg = tile - rg * ncg;
    const float* a = A + 4 * rg;
    const float* o = Op + 4 * cg;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(a + k * lda);
      const float4 o4 = *reinterpret_cast<const float4*>(o + k * ldo);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], ov[c], acc[r][c]);
    }
    epi(4 * rg, 4 * cg, acc);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// max(a, b) that keeps a NaN, as torch.amax does: a lane that went
// non-finite reports a NaN residual and is never counted converged.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Stage rung ri's operators (K4: ri = 0, the only one).
__device__ __forceinline__ void load_rung(float* Vop, float* M1, float* M2,
                                          float* b2, const Params& P,
                                          const Shape& d, int ri) {
  load_op(Vop, P.Vop + (size_t)ri * d.nbox * d.nbox, d.nbox, d.nbox, d.ldv);
  load_op(M1, P.M1 + (size_t)ri * d.nbox * d.W1, d.nbox, d.W1, d.ld1);
  load_op(M2, P.M2 + (size_t)ri * d.D2 * d.W2, d.D2, d.W2, d.ld2);
  load_op(b2, P.b2 + (size_t)ri * d.W2, 1, d.W2, d.ld2);
}

// The extraction of solve t: (s - w) through M1 over the block's d slab
// tv; u (clipped) into xin's u rows and U, q into pre, z^2 into zth.
__device__ __forceinline__ void extract_step(const float* tv, const float* M1,
                                             const float* ulo,
                                             const float* uhi, float* xin,
                                             float* pre, float* zth,
                                             const Params& P, const Shape& d,
                                             int row0, int t) {
  const int LDS = d.LDS, S = d.S, nbm = d.nbm, Mw = d.Mw;
  tile_product(tv, LDS, M1, d.ld1, d.nbox, d.W1, d.TB,
               [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + c;
      if (col >= d.W1) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = r0 + r;
        if (col < nbm) {
          const float u =
              fminf(fmaxf(__fadd_rn(pre[col * LDS + rr], acc[r][c]),
                          ulo[col]),
                    uhi[col]);
          xin[(S + col) * LDS + rr] = u;
          const int b = row0 + rr;
          if (b < d.B) P.U[((size_t)b * d.n_blocks + t) * nbm + col] = u;
        } else if (col == nbm) {
          pre[col * LDS + rr] = __fadd_rn(pre[col * LDS + rr], acc[r][c]);
        } else {
          float* zp = zth + (col - Mw) * LDS + rr;
          const float z = __fadd_rn(*zp, acc[r][c]);
          *zp = __fmul_rn(z, z);
        }
      }
    }
  });
}

// The plant step of solve t and the next solve's maps: [s_flat | u | w]
// (xin) through M2 + b2 -> s_next, pre, Y, vc, zth.
__device__ __forceinline__ void plant_step(const float* M2, const float* b2,
                                           const float* xin, float* snext,
                                           float* pre, float* vc, float* zth,
                                           const Params& P, const Shape& d,
                                           int row0, int t) {
  const int LDS = d.LDS, S = d.S, nbm = d.nbm, nbp = d.nbp;
  const int oU = S, oY = S + nbm, oQ = S + nbm + nbp, oV = oQ + 1;
  const int oZ = oV + d.nbox;
  tile_product(xin, LDS, M2, d.ld2, d.D2, d.W2, d.TB,
               [&](int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + c;
      if (col >= d.W2) break;
      const float bias = b2[col];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = r0 + r;
        const float v = __fadd_rn(acc[r][c], bias);
        if (col < oU) {
          snext[col * LDS + rr] = v;
        } else if (col < oY) {
          pre[(col - oU) * LDS + rr] = v;
        } else if (col < oQ) {
          const int b = row0 + rr;
          if (b < d.B)
            P.Y[((size_t)b * d.n_blocks + t) * nbp + (col - oY)] = v;
        } else if (col == oQ) {
          pre[nbm * LDS + rr] = v;
        } else if (col < oZ) {
          vc[(col - oV) * LDS + rr] = v;
        } else {
          zth[(col - oZ) * LDS + rr] = v;
        }
      }
    }
  });
}

// ---------------------------------------------------------------------
// The rollout body of both kernels. A lane owns RL rows (4, or 2 in K4's
// half-height tile), a warp WARP_ROWS = 2 RL scenarios of the block;
// lane l owns rows r0 = WARP_ROWS warp + RL (l >> 4) .. r0 + RL - 1
// and, for j < NT, columns 4 (l & 15) + 64 j .. + 3 of v, s and w.
// Register arrays are [tile j][column c][row r].

constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// K4's half-height tile: scenarios a block, rows a lane.
constexpr int SMALL_TB = 32;
constexpr int SMALL_RL = 2;

// RL consecutive floats of a scenario-minor row (16- or 8-byte aligned)
// in one load or store.
template <int RL>
__device__ __forceinline__ void ld_rows(const float* p, float (&v)[RL]) {
  static_assert(RL == 4 || RL == 2, "a lane holds 4 or 2 rows");
  if constexpr (RL == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  }
}

template <int RL>
__device__ __forceinline__ void st_rows(float* p, const float (&v)[RL]) {
  if constexpr (RL == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// A block's shared-memory floats: the operators (K5: one rung's), the
// carry rows xin, pre, vc, zth and d = s - w (s and w live in
// registers). K5 adds its own snext rows and four group maxima per warp;
// K4 lays snext over d, which is dead from the extraction until the
// next solve, so d takes max(nbox, S) rows.
template <bool LADDER>
size_t kernel_smem_bytes(const Shape& d) {
  const int rows = d.D2 + d.Mw + d.nbox + d.nxi;
  const size_t floats =
      LADDER ? op_floats(d) + (size_t)(rows + d.S + d.nbox) * d.LDS + 4 * WARPS
             : op_floats(d) + (size_t)(rows + std::max(d.nbox, d.S)) * d.LDS;
  return sizeof(float) * floats;
}

// K4's NON_CONVEX mode adds a_c (lda floats) after the d slab
// (max(nbox, S) rows); it reads G from global memory.
size_t nonconvex_smem_bytes(const Shape& d) {
  return kernel_smem_bytes<false>(d) + sizeof(float) * d.lda;
}

// x maximised (nan_max) over the 16 lanes of the caller's row group.
__device__ __forceinline__ float row_group_max(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x = nan_max(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// x summed over the 16 lanes of the caller's row group by the xor
// butterfly (offsets 8, 4, 2, 1): every lane gets the same sum, in the
// order the plain version takes it.
__device__ __forceinline__ float row_group_sum(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// ||alpha||_1 of the lane's four rows, alpha = a_c + [theta; t] G: each
// alpha one FMA chain over theta's nth rows (th, xin's) then t's nbox
// rows (dcol, the d slab) from zero, plus a_c; the lane sums |alpha| of
// its columns 4 cg + 64 j + c in the order (j, c), and the row group sums
// the 16 partial sums (row_group_sum). G is read through the read-only
// cache from L2.
__device__ __forceinline__ void alpha_l1(const float* th, const float* dcol,
                                         int LDS, const float* G,
                                         const float* ac, const Shape& d,
                                         int cg, float (&l1)[4]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  const int nj = (d.n_alpha + 63) >> 6;
  for (int j = 0; j < nj; ++j) {
    const int col0 = 4 * cg + 64 * j;
    const float* g = G + min(col0, d.lda - 4);  // clamped inside the row
    float acc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d.nth; ++k) {
      const float4 a4 = ld4(th + k * LDS);
      const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + k * d.lda));
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c][r] = fmaf(av[r], gv[c], acc[c][r]);
    }
    g += d.nth * d.lda;
#pragma unroll 4
    for (int k = 0; k < d.nbox; ++k) {
      const float4 a4 = ld4(dcol + k * LDS);
      const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + k * d.lda));
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c][r] = fmaf(av[r], gv[c], acc[c][r]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (col0 + c >= d.n_alpha) break;
      const float a = ac[col0 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        part[r] = __fadd_rn(part[r], fabsf(__fadd_rn(acc[c][r], a)));
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) l1[r] = row_group_sum(part[r]);
}

// acc[j][c][r] = sum_k d[k][r0 + r] Vop[k][oc[j] + c], one FMA chain per
// output over k = 0 .. nbox-1 from zero, as tile_product sums it. dcol is
// d + r0; oc[j] is clamped inside the row, so a lane past nbox reads
// valid memory and its sums are discarded.
template <int NT, int RL>
__device__ __forceinline__ void warp_product(const float* dcol, int LDS,
                                             const float* Vop, int ldv,
                                             int nbox, const int (&oc)[NT],
                                             float (&acc)[NT][4][RL]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < RL; ++r) acc[j][c][r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < nbox; ++k) {
    float av[RL];
    if constexpr (RL == 4) {
      const float4 a4 = ld4(dcol + k * LDS);
      av[0] = a4.x;
      av[1] = a4.y;
      av[2] = a4.z;
      av[3] = a4.w;
    } else {
      ld_rows<RL>(dcol + k * LDS, av);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 o4 = ld4(Vop + k * ldv + oc[j]);
      const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < RL; ++r)
          acc[j][c][r] = fmaf(av[r], ov[c], acc[j][c][r]);
    }
  }
}

// K4 (LADDER = false: fixed penalty P.rho, optional tracking adds) or K5
// (LADDER = true: the block is a rung group, balanced after each solve).
// K4's NON_CONVEX mode (NC = true, no tracking):
// each scenario clips at +-its own bound, and a solve runs n_outer blocks
// of n_iter iterations, each followed by the bound update
//   bound = c_eps (1 + ||a_c + [theta; t] G||_1),  t = s - w
// (alpha_l1), then sigma_pred = t @ Vop + vc, whose max |.| less the
// bound judges the final iterate's feasibility. RL: rows a lane (2 only
// in K4's half-height tile). Where a statement differs by RL, the RL = 4
// branch keeps the 4-row body's own statements: written through the RL
// helpers, nvcc compiled the NON_CONVEX instantiation into other code
// (more spills, 5 % slower on an H100, its clock64 reads around the bound
// update folded together).
template <int NT, bool LADDER, bool NC = false, int RL = 4>
__device__ __forceinline__ void admm_rollout(const Params& P,
                                             const Shape& d) {
  static_assert(RL == 4 || (!LADDER && !NC), "K5 and NON_CONVEX: 4 rows");
  constexpr int WARP_ROWS = 2 * RL;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int LDS = d.LDS, TB = d.TB;
  const int S = d.S, nbm = d.nbm, nbp = d.nbp, nbox = d.nbox, nxi = d.nxi;
  const int Mw = d.Mw;
  const int row0 = blockIdx.x * TB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Operators.
  float* Vop = sm;
  float* M1 = Vop + nbox * d.ldv;
  float* M2 = M1 + nbox * d.ld1;
  float* b2 = M2 + d.D2 * d.ld2;
  float* lo = b2 + d.ld2;
  float* hi = lo + d.ldv;
  float* ulo = hi + d.ldv;
  float* uhi = ulo + d.ldu;
  // Per-scenario carry, scenario-minor rows of LDS floats.
  float* xin = uhi + d.ldu;  // (D2): [s_flat | u | w_noise]
  float* pre = xin + (d.D2 + (LADDER ? S : 0)) * LDS;  // (Mw): [u_theta | q]
  float* vc = pre + Mw * LDS;         // (nbox)
  float* zth = vc + nbox * LDS;       // (nxi)
  float* dbuf = zth + nxi * LDS;      // (nbox): s - w
  float* snext = LADDER ? xin + d.D2 * LDS : dbuf;  // (S)
  float* part = dbuf + nbox * LDS;    // K5: (WARPS, 4): max rp, rd, |s|, |w|
  float* acs = dbuf + max(nbox, S) * LDS;  // NC: a_c (lda)

  // The lane's share, rows lr0 .. lr0 + RL - 1: warp-uniform `owner`,
  // lane-level `mine`.
  const bool owner = WARP_ROWS * warp < TB;
  const int lr0 = WARP_ROWS * warp + RL * (lane >> 4);
  const bool mine = owner && lr0 < TB;
  const int cg = lane & 15;
  int oc[NT];  // the product's column offsets, clamped inside the row
#pragma unroll
  for (int j = 0; j < NT; ++j) oc[j] = min(4 * cg + 64 * j, d.ldv - 4);
  // Column c of tile j is 4 cg + 64 j + c; it exists below nbox.
  auto col_of = [&](int j, int c) { return 4 * cg + 64 * j + c; };
  float* drow = dbuf + lr0;

  int ri = 0;  // K5: the group's rung
  float rho = P.rho;
  if (LADDER) {
    ri = P.rung0[blockIdx.x];
    rho = P.rhos[ri];
  }
  load_rung(Vop, M1, M2, b2, P, d, ri);
  load_op(lo, P.lo, 1, nbox, d.ldv);
  load_op(hi, P.hi, 1, nbox, d.ldv);
  load_op(ulo, P.u_lo, 1, nbm, d.ldu);
  load_op(uhi, P.u_hi, 1, nbm, d.ldu);
  load_carry(xin, P.s0, S, row0, d);
  load_carry(pre, P.pre0, Mw, row0, d);
  load_carry(vc, P.vc0, nbox, row0, d);
  load_carry(zth, P.zth0, nxi, row0, d);
  if (NC) load_op(acs, P.a_c, 1, d.lda, d.lda);
  // NC: each row's bound, and the counters' cycles and counts.
  float bnd[RL] = {};
  if (NC) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const int b = row0 + lr0 + r;
      bnd[r] = mine && b < d.B ? P.bd0[b] : 0.f;
    }
  }
  const bool counting = NC && P.counters != nullptr;
  const long long cyc_start = counting ? clock64() : 0;
  long long cyc_bound = 0;
  unsigned long long n_active = 0;
  // s and w into the owning lanes' registers (zero past B and nbox).
  float s[NT][4][RL], w[NT][4][RL];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int col = col_of(j, c), b = row0 + lr0 + r;
        const bool ok = mine && col < nbox && b < d.B;
        const size_t o = (size_t)b * nbox + col;
        s[j][c][r] = ok ? P.sa0[o] : 0.f;
        w[j][c][r] = ok ? P.wa0[o] : 0.f;
      }
  __syncthreads();
  float lor[NT][4], hir[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col_of(j, c);
      lor[j][c] = col < nbox ? lo[col] : 0.f;
      hir[j][c] = col < nbox ? hi[col] : 0.f;
    }
  // d = s - w, the lane's columns.
  auto store_d = [&]() {
    if (!mine) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col_of(j, c);
        if constexpr (RL == 4) {
          if (col < nbox)
            *reinterpret_cast<float4*>(drow + col * LDS) = make_float4(
                __fsub_rn(s[j][c][0], w[j][c][0]),
                __fsub_rn(s[j][c][1], w[j][c][1]),
                __fsub_rn(s[j][c][2], w[j][c][2]),
                __fsub_rn(s[j][c][3], w[j][c][3]));
        } else if (col < nbox) {
          float dv[RL];
#pragma unroll
          for (int r = 0; r < RL; ++r)
            dv[r] = __fsub_rn(s[j][c][r], w[j][c][r]);
          st_rows<RL>(drow + col * LDS, dv);
        }
      }
  };
  if (LADDER) store_d();
  const int Wadd = Mw + nbox + nxi;

  for (int t = 0; t < d.n_blocks; ++t) {
    // This block's noise lands in xin's w rows while the iterations run.
    for (int idx = tid; idx < TB * nbp; idx += THREADS) {
      const int r = idx / nbp, i = idx - r * nbp;
      const int b = row0 + r;
      float* dst = xin + (S + nbm + i) * LDS + r;
      if (b < d.B)
        __pipeline_memcpy_async(
            dst, P.W + ((size_t)b * d.n_blocks + t) * nbp + i, sizeof(float));
      else
        *dst = 0.f;
    }
    __pipeline_commit();
    // K4's tracking adds: pre and zth take theirs here (the extraction
    // reads them after the barrier that ends the iterations), vc as it
    // is loaded into the registers.
    const float* add = nullptr;
    if (!LADDER) {
      if (P.adds != nullptr) {
        add = P.adds + (size_t)t * Wadd;
        for (int idx = tid; idx < (Mw + nxi) * TB; idx += THREADS) {
          const int j = idx / TB, r = idx - j * TB;
          // pre, vc and zth are consecutive rows, as the adds are laid.
          const int row = j < Mw ? j : j + nbox;
          pre[row * LDS + r] = __fadd_rn(pre[row * LDS + r], add[row]);
        }
      }
      __syncwarp();  // the warp's snext has left d for xin
      store_d();
    }

    // ADMM iterations, each warp on its own scenarios, no block barrier.
    // rpm, rdm: the last iteration's residual maxima per row.
    float rpm[RL] = {}, rdm[RL] = {};
    // NC: the last bound update's relative step, max |sigma_pred| less
    // the bound.
    float dl[RL] = {}, gp[RL] = {};
    if (owner) {
      float vcr[NT][4][RL];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = col_of(j, c);
          float (&v)[RL] = vcr[j][c];
          if constexpr (RL == 4) {
            float4 v4 = mine && col < nbox ? ld4(vc + col * LDS + lr0)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
            if (!LADDER && add != nullptr && mine && col < nbox) {
              const float a = add[Mw + col];
              v4 = make_float4(__fadd_rn(v4.x, a), __fadd_rn(v4.y, a),
                               __fadd_rn(v4.z, a), __fadd_rn(v4.w, a));
            }
            v[0] = v4.x;
            v[1] = v4.y;
            v[2] = v4.z;
            v[3] = v4.w;
          } else {
            if (mine && col < nbox) {
              ld_rows<RL>(vc + col * LDS + lr0, v);
            } else {
#pragma unroll
              for (int r = 0; r < RL; ++r) v[r] = 0.f;
            }
            if (!LADDER && add != nullptr && mine && col < nbox) {
              const float a = add[Mw + col];
#pragma unroll
              for (int r = 0; r < RL; ++r) v[r] = __fadd_rn(v[r], a);
            }
          }
        }
      const int n_out = NC ? d.n_outer : 1;
      for (int o = 0; o < n_out; ++o) {
      for (int it = 0; it < d.n_iter; ++it) {
        const bool last = it == d.n_iter - 1 && o == n_out - 1;
        float acc[NT][4][RL];
        __syncwarp();  // the warp's d writes are in
        warp_product<NT, RL>(drow, LDS, Vop, d.ldv, nbox, oc, acc);
        __syncwarp();  // every lane has read d
        if (!mine) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = col_of(j, c);
            if (col >= nbox) continue;
            float dnv[RL];
#pragma unroll
            for (int r = 0; r < RL; ++r) {
              const float v = __fadd_rn(acc[j][c][r], vcr[j][c][r]);
              const float sv = s[j][c][r], wv = w[j][c][r];
              const float vh =
                  __fadd_rn(__fmul_rn(P.alpha, v), __fmul_rn(P.beta, sv));
              const float sn =
                  NC ? fminf(fmaxf(__fadd_rn(vh, wv), -bnd[r]), bnd[r])
                     : fminf(fmaxf(__fadd_rn(vh, wv), lor[j][c]), hir[j][c]);
              const float wn = __fsub_rn(__fadd_rn(wv, vh), sn);
              dnv[r] = __fsub_rn(sn, wn);
              if (last) {
                rpm[r] = nan_max(rpm[r], fabsf(__fsub_rn(v, sn)));
                rdm[r] = nan_max(rdm[r], fabsf(__fsub_rn(sn, sv)));
              }
              s[j][c][r] = sn;
              w[j][c][r] = wn;
            }
            if constexpr (RL == 4)
              *reinterpret_cast<float4*>(drow + col * LDS) =
                  make_float4(dnv[0], dnv[1], dnv[2], dnv[3]);
            else
              st_rows<RL>(drow + col * LDS, dnv);
          }
      }
      if (NC) {  // the bound update, on the d the iterations left
        const long long c0 = counting ? clock64() : 0;
        __syncwarp();  // the warp's d writes are in
        float l1[4];
        alpha_l1(xin + (S - d.nth) * LDS + lr0, drow, LDS, P.G, acs, d, cg,
                 l1);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          const float bn = __fmul_rn(P.c_eps, __fadd_rn(1.f, l1[r]));
          dl[r] = __fdiv_rn(fabsf(__fsub_rn(bn, bnd[r])),
                            __fadd_rn(P.c_eps, bn));
          bnd[r] = bn;
        }
        if (counting) cyc_bound += clock64() - c0;
      }
      }
      if (NC) {  // sigma_pred of the final t, against the final bound
        float acc[NT][4][RL];
        warp_product<NT, RL>(drow, LDS, Vop, d.ldv, nbox, oc, acc);
        float sig[RL] = {};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (col_of(j, c) >= nbox) continue;
#pragma unroll
            for (int r = 0; r < RL; ++r)
              sig[r] = nan_max(sig[r],
                               fabsf(__fadd_rn(acc[j][c][r], vcr[j][c][r])));
          }
#pragma unroll
        for (int r = 0; r < RL; ++r)
          gp[r] = __fsub_rn(row_group_max(sig[r]), bnd[r]);
      }
      // Per row: the residuals (and, for K5 or when n_iter = 0, max |s|;
      // for K5 max |w|) over the nbox lanes (a row group's 16 lanes).
      // K5 then takes the warp's maxima over its rows before B, as one
      // slot of the group maxima.
      const bool need_smag = LADDER || d.n_iter == 0;
      float smag[RL] = {}, wmag[RL] = {};
      if (need_smag) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < RL; ++r) {  // zero past nbox and TB
              smag[r] = nan_max(smag[r], fabsf(s[j][c][r]));
              if (LADDER) wmag[r] = nan_max(wmag[r], fabsf(w[j][c][r]));
            }
      }
      float g[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        if (need_smag) smag[r] = row_group_max(smag[r]);
        if (LADDER) wmag[r] = row_group_max(wmag[r]);
        if (d.n_iter == 0) {  // v_last = s_prev = 0: both are max |s|
          rpm[r] = rdm[r] = smag[r];
        } else {
          rpm[r] = row_group_max(rpm[r]);
          rdm[r] = row_group_max(rdm[r]);
        }
        if (LADDER && mine && row0 + lr0 + r < d.B) {
          g[0] = nan_max(g[0], rpm[r]);
          g[1] = nan_max(g[1], __fmul_rn(rho, rdm[r]));
          g[2] = nan_max(g[2], smag[r]);
          g[3] = nan_max(g[3], wmag[r]);
        }
      }
      if (LADDER) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = nan_max(g[i], __shfl_xor_sync(FULL, g[i], 16));
          if (lane == 0) part[4 * warp + i] = g[i];
        }
      }
    } else if (LADDER && lane < 4) {
      part[4 * warp + lane] = 0.f;
    }
    __syncthreads();  // every warp's d (and K5's maxima) are in

    // Extraction: t = s - w through M1.
    extract_step(dbuf, M1, ulo, uhi, xin, pre, zth, P, d, row0, t);
    __pipeline_wait_prior(0);
    __syncthreads();  // u, z^2, q and the noise are in

    // Cost and residuals of the warp's scenarios: each lane sums every
    // 16th z^2 of its rows, the row group sums the 16 partial sums.
    if (owner) {
      float cs[RL] = {};
      for (int j = cg; mine && j < nxi; j += 16) {
        if constexpr (RL == 4) {
          const float4 z4 = ld4(zth + j * LDS + lr0);
          cs[0] = __fadd_rn(cs[0], z4.x);
          cs[1] = __fadd_rn(cs[1], z4.y);
          cs[2] = __fadd_rn(cs[2], z4.z);
          cs[3] = __fadd_rn(cs[3], z4.w);
        } else {
          float z[RL];
          ld_rows<RL>(zth + j * LDS + lr0, z);
#pragma unroll
          for (int r = 0; r < RL; ++r) cs[r] = __fadd_rn(cs[r], z[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RL; ++r) {
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
          cs[r] = __fadd_rn(cs[r], __shfl_xor_sync(FULL, cs[r], off));
        const int b = row0 + lr0 + r;
        if (mine && cg == r && b < d.B) {
          const size_t o = (size_t)b * d.n_blocks + t;
          P.C[o] = __fadd_rn(cs[r], pre[nbm * LDS + lr0 + r]);
          P.RP[o] = rpm[r];
          P.RD[o] = __fmul_rn(rho, rdm[r]);
          if (NC) {
            P.DL[o] = dl[r];
            P.GP[o] = gp[r];
            P.BD[o] = bnd[r];
            n_active += fabsf(gp[r]) <= __fmul_rn(1e-4f, bnd[r]);
          }
        }
      }
    }
    __syncthreads();  // zth, pre and d are read before M2 overwrites them

    // K5: balance the group's rung; every thread reaches the same ri'.
    if (LADDER) {
      float red[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < WARPS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) red[i] = nan_max(red[i], part[4 * k + i]);
      const float tiny = 1e-12f;
      const float s_mag = red[2], w_mag = red[3];
      const float rp_rel =
          __fdiv_rn(red[0], nan_max(nan_max(s_mag, w_mag), tiny));
      const float rd_rel =
          __fdiv_rn(__fdiv_rn(red[1], rho), nan_max(w_mag, tiny));
      const bool up = rp_rel > __fmul_rn(P.ratio, rd_rel) && ri < P.R - 1;
      const bool down = rd_rel > __fmul_rn(P.ratio, rp_rel) && ri > 0;
      const int rn = ri + (int)up - (int)down;
      if (mine) {
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          const int b = row0 + lr0 + r;
          if (cg == r && b < d.B) P.RUNG[(size_t)b * d.n_blocks + t] = rn;
        }
      }
      if (rn != ri) {
        // The unscaled dual rho w is rung-invariant; s - w feeds the
        // next solve's first iteration.
        const float fac = __fdiv_rn(P.rhos[ri], P.rhos[rn]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < RL; ++r) w[j][c][r] = __fmul_rn(w[j][c][r], fac);
        store_d();
        load_rung(Vop, M1, M2, b2, P, d, rn);
        ri = rn;
        rho = P.rhos[rn];
        __syncthreads();  // the new rung's operators are in
      }
    }

    // Plant step and the next solve's maps: [s_flat | u | w] through M2.
    plant_step(M2, b2, xin, snext, pre, vc, zth, P, d, row0, t);
    __syncthreads();
    if (LADDER) {
      for (int idx = tid; idx < S * LDS; idx += THREADS) xin[idx] = snext[idx];
    } else if (mine) {
      // K4: each warp moves its own scenarios' snext out of d, so the
      // next solve may store d over it after a __syncwarp.
      for (int i = cg; i < S; i += 16) {
        if constexpr (RL == 4) {
          *reinterpret_cast<float4*>(xin + i * LDS + lr0) =
              ld4(snext + i * LDS + lr0);
        } else {
          float v[RL];
          ld_rows<RL>(snext + i * LDS + lr0, v);
          st_rows<RL>(xin + i * LDS + lr0, v);
        }
      }
    }
    // The barrier after the next solve's iterations orders this copy
    // before M2 reads xin again.
  }
  __syncthreads();
  store_carry(P.s_fin, xin, S, row0, d);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int col = col_of(j, c), b = row0 + lr0 + r;
        if (mine && col < nbox && b < d.B) {
          P.sa_fin[(size_t)b * nbox + col] = s[j][c][r];
          P.wa_fin[(size_t)b * nbox + col] = w[j][c][r];
        }
      }
  if (NC) {
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const int b = row0 + lr0 + r;
      if (mine && cg == r && b < d.B) P.bd_fin[b] = bnd[r];
    }
  }
  if (counting && owner) {  // one warp's share of the counters
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      n_active += __shfl_xor_sync(FULL, n_active, off);
    if (lane == 0) {
      const int rows = max(0, min(min(WARP_ROWS, TB - WARP_ROWS * warp),
                                  d.B - row0 - WARP_ROWS * warp));
      atomicAdd(P.counters, (unsigned long long)cyc_bound);
      atomicAdd(P.counters + 1,
                (unsigned long long)(clock64() - cyc_start));
      atomicAdd(P.counters + 2, n_active);
      atomicAdd(P.counters + 3, (unsigned long long)rows * d.n_blocks);
    }
  }
}

// At NT = 1, two blocks share an SM: at most 128 registers a thread. RL:
// rows a lane (4, or SMALL_RL in the half-height tile).
template <int NT, int RL>
__global__ void __launch_bounds__(THREADS, NT == 1 ? 2 : 1)
fused_admm_kernel(const Params P, const Shape d) {
  admm_rollout<NT, false, false, RL>(P, d);
}

template <int NT>
__global__ void __launch_bounds__(THREADS, NT == 1 ? 2 : 1)
fused_ladder_kernel(const Params P, const Shape d) {
  admm_rollout<NT, true>(P, d);
}

// K4's NON_CONVEX mode: two blocks share an SM at NT = 1, as in K4.
template <int NT>
__global__ void __launch_bounds__(THREADS, NT == 1 ? 2 : 1)
fused_admm_nonconvex_kernel(const Params P, const Shape d) {
  admm_rollout<NT, false, true>(P, d);
}

using RolloutKernel = void (*)(const Params, const Shape);

// K4's instantiation for nbox box lanes (NT = ceil(nbox / 64) column
// tiles per lane) at RL rows a lane, or null beyond three.
template <int RL>
RolloutKernel admm_kernel_for(int nbox) {
  if (nbox <= 64) return fused_admm_kernel<1, RL>;
  if (nbox <= 128) return fused_admm_kernel<2, RL>;
  if (nbox <= 192) return fused_admm_kernel<3, RL>;
  return nullptr;
}

// The instantiation for nbox box lanes (K4's at 4 rows a lane), or null
// beyond three column tiles.
template <bool LADDER>
RolloutKernel kernel_for(int nbox) {
  if (!LADDER) return admm_kernel_for<4>(nbox);
  if (nbox <= 64) return fused_ladder_kernel<1>;
  if (nbox <= 128) return fused_ladder_kernel<2>;
  if (nbox <= 192) return fused_ladder_kernel<3>;
  return nullptr;
}

// Give `kernel` its dynamic shared memory, with the SM's carveout at
// its largest so two blocks of the NT = 1 instantiation fit.
cudaError_t prepare(RolloutKernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Blocks of `kernel` resident per SM with `bytes` of dynamic shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), 0 without a
// kernel, or minus a CUDA error.
int occupancy(RolloutKernel kernel, size_t bytes) {
  if (kernel == nullptr) return 0;
  cudaError_t err = prepare(kernel, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The current device's SMs (cudaDevAttrMultiProcessorCount), read once
// per device; 0 where it cannot be read.
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

constexpr int TILES[] = {64, 32, 16, 8, 4};

// K4's tile: TB scenarios a block (0: none fits), RL rows a lane.
struct AdmmTile {
  int TB, RL;
};

// K4's tile for a batch of B scenarios (B < 1: a batch that fills the
// card): the largest of TILES whose block fits in shared memory (the
// most warps owning scenarios), 4 rows a lane, or none when no tile fits
// or nbox is above 192; where that is 64 scenarios and a grid of
// SMALL_TB-scenario blocks would put at most one on each SM of the
// current device, the half-height tile: SMALL_TB scenarios, SMALL_RL
// rows a lane, twice the blocks on the same 8 warps each.
AdmmTile admm_tile(int S, int nbm, int nbp, int nbox, int nxi, int B) {
  if (kernel_for<false>(nbox) == nullptr) return {0, 4};
  for (int TB : TILES) {
    if (kernel_smem_bytes<false>(make_shape(S, nbm, nbp, nbox, nxi, TB)) >
        SMEM_LIMIT)
      continue;
    if (TB == 64 && B > 0 &&
        ((long long)B + SMALL_TB - 1) / SMALL_TB <= sm_count())
      return {SMALL_TB, SMALL_RL};
    return {TB, 4};
  }
  return {0, 4};
}

RolloutKernel admm_kernel(const AdmmTile& tile, int nbox) {
  return tile.RL == SMALL_RL ? admm_kernel_for<SMALL_RL>(nbox)
                             : admm_kernel_for<4>(nbox);
}

// K5's rung group: the largest of TILES whose group rule fits, or 0.
int rung_group_rows(int S, int nbm, int nbp, int nbox, int nxi) {
  for (int TB : TILES)
    if (rung_group_bytes(make_shape(S, nbm, nbp, nbox, nxi, TB)) <=
        SMEM_LIMIT)
      return TB;
  return 0;
}

// K4's NON_CONVEX instantiation for nbox box lanes, or null beyond three
// column tiles.
RolloutKernel nonconvex_kernel_for(int nbox) {
  if (nbox <= 64) return fused_admm_nonconvex_kernel<1>;
  if (nbox <= 128) return fused_admm_nonconvex_kernel<2>;
  if (nbox <= 192) return fused_admm_nonconvex_kernel<3>;
  return nullptr;
}

// The NON_CONVEX sizes: theta is nxi - nbox wide (no tracking features).
Shape nonconvex_shape(int S, int nbm, int nbp, int nbox, int nxi,
                      int n_alpha, int TB) {
  Shape d = make_shape(S, nbm, nbp, nbox, nxi, TB);
  d.nth = nxi - nbox;
  d.n_alpha = n_alpha;
  d.lda = ceil4(n_alpha);
  return d;
}

// The NON_CONVEX mode's scenarios per block: the largest of TILES whose
// block fits, or 0.
int nonconvex_tile_rows(int S, int nbm, int nbp, int nbox, int nxi,
                        int n_alpha) {
  if (nonconvex_kernel_for(nbox) == nullptr || n_alpha < 1 ||
      nxi < nbox || S < nxi - nbox)
    return 0;
  for (int TB : TILES)
    if (nonconvex_smem_bytes(
            nonconvex_shape(S, nbm, nbp, nbox, nxi, n_alpha, TB)) <=
        SMEM_LIMIT)
      return TB;
  return 0;
}

// Launches `kernel` on `stream` with `smem` bytes of dynamic shared
// memory, ceil(B / TB) blocks of THREADS; the launch's error, or
// cudaErrorInvalidValue without a kernel.
int launch(RolloutKernel kernel, size_t smem, const Params& P,
           const Shape& d, void* stream) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.B + d.TB - 1) / d.TB);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(P, d);
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread of `kernel`
// (cudaFuncGetAttributes); returns the CUDA error, or
// cudaErrorInvalidValue without a kernel.
int kernel_attributes(RolloutKernel kernel, int* registers,
                      int* local_bytes) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// ---------------------------------------------------------------------
// The wide body (K4w, K5w): state in shared memory, operators streamed
// through an mbarrier ring that a producer warp fills.

constexpr int WIDE_WARPS = 16;                     // consumer warps
constexpr int WIDE_CONSUMERS = 32 * WIDE_WARPS;    // consumer threads
constexpr int WIDE_THREADS = WIDE_CONSUMERS + 32;  // + the producer warp
constexpr int WIDE_TILES = 512;  // 4 x 4 tiles of a window, at most
constexpr int WIDE_SLOTS = WIDE_TILES / 32 / WIDE_WARPS;  // slots a warp
constexpr int WIDE_UNIT = 4 * 32;  // tiles of one slot on each partition
constexpr int WIDE_MIN_PANEL = 4;  // rows of the widest window a stage holds
// Ring stages: measured on an H100, two large stages beat three and
// four smaller ones in the same bytes (each panel costs a wait and an
// arrive a warp, and the loads are hidden at two).
constexpr int WIDE_STAGES = 2;
// Head of the block: full and empty mbarriers of each stage, the rung
// barrier and the rung word (K5w), in 128 bytes.
constexpr int WIDE_HEAD_FLOATS = 32;

__host__ __device__ inline int ceil32(size_t x) {
  return (int)((x + 31) & ~(size_t)31);
}

// Columns of the widest window: WIDE_TILES tiles over the block's TB / 4
// row groups. It sizes the frozen tile rule below and the widest panel.
__host__ __device__ inline int wide_window_cols(int TB) {
  return 4 * (WIDE_TILES / (TB >> 2));
}

// Floats of the wide state as first laid out (s and w in shared memory),
// which sizes the frozen tile rule below:
// lo, hi, the u bounds; the carry rows xin (D2), pre (Mw), vc (nbox),
// zth (nxi), s and w (nbox each), d = s - w with s_next laid over it
// (max(nbox, S)); the row maxima rp, rd, |s|, |w|.
size_t wide_state_floats(const Shape& d) {
  const int rows = d.D2 + d.Mw + d.nxi + 3 * d.nbox + std::max(d.nbox, d.S);
  return 2 * (size_t)d.ldv + 2 * (size_t)d.ldu + (size_t)rows * d.LDS +
         4 * (size_t)d.TB;
}

// Floats of the wide body's state as it is laid out now: the same
// without s and w, which live in the consumers' registers.
__host__ __device__ inline size_t wide_layout_floats(const Shape& d) {
  const int rows =
      d.D2 + d.Mw + d.nxi + d.nbox + (d.nbox > d.S ? d.nbox : d.S);
  return 2 * (size_t)d.ldv + 2 * (size_t)d.ldu + (size_t)rows * d.LDS +
         4 * (size_t)d.TB;
}

// The widest window of the three products (padded to four floats).
int wide_widest(const Shape& d) {
  const int ww = wide_window_cols(d.TB);
  return std::max(ceil4(std::min(d.nbox, ww)),
                  std::max(ceil4(std::min(d.W1, ww)),
                           ceil4(std::min(d.W2, ww))));
}

// The wide tile rule, frozen as the body's first plan had it because
// K5w's rung group is part of its result: the largest of TILES whose
// iteration product is one window and whose state leaves two ring stages
// of at least
// WIDE_MIN_PANEL rows of the widest window; 0 if none. K4w keeps the
// same tile.
int wide_group_rows(int S, int nbm, int nbp, int nbox, int nxi) {
  const size_t limit = SMEM_LIMIT / sizeof(float);
  for (int TB : TILES) {
    const Shape d = make_shape(S, nbm, nbp, nbox, nxi, TB);
    if (d.ldv > wide_window_cols(TB)) continue;
    const size_t state = wide_state_floats(d);
    if (state >= limit) continue;
    const int stage = (int)((limit - state) / 2) & ~3;
    if (stage >= WIDE_MIN_PANEL * wide_widest(d)) return TB;
  }
  return 0;
}

struct WidePlan {
  int TB;        // scenarios per block (0: none fits)
  int stage;     // floats of one ring stage
  size_t bytes;  // dynamic shared memory of a block
};

// The tile of wide_group_rows; after the head and the state (s and w
// moved to registers), WIDE_STAGES stages that share the rest, each a
// multiple of 128 bytes and holding WIDE_MIN_PANEL rows of the widest
// window.
WidePlan wide_plan(int S, int nbm, int nbp, int nbox, int nxi) {
  const int TB = wide_group_rows(S, nbm, nbp, nbox, nxi);
  if (TB == 0) return {0, 0, 0};
  const Shape d = make_shape(S, nbm, nbp, nbox, nxi, TB);
  const size_t limit = SMEM_LIMIT / sizeof(float);
  const size_t head = WIDE_HEAD_FLOATS + ceil32(wide_layout_floats(d));
  if (head >= limit) return {0, 0, 0};
  const int stage = (int)((limit - head) / WIDE_STAGES) & ~31;
  if (stage < WIDE_MIN_PANEL * wide_widest(d)) return {0, 0, 0};
  return {TB, stage, sizeof(float) * (head + (size_t)WIDE_STAGES * stage)};
}

// Windows of a product of N columns over RG row groups: whole units of
// WIDE_UNIT tiles (one 32-tile slot on each of the SM's four scheduler
// partitions), at most WIDE_TILES tiles a window, the units spread evenly
// over the fewest windows (the first windows one unit more), so no
// window is a narrow tail. Window i covers column groups
// [cg0(i), cg0(i + 1)) of 4 columns, the last ending at ceil(N / 4).
struct Windows {
  int ncg, unit, n, base, extra;
  __device__ __forceinline__ Windows(int N, int RG) {
    ncg = (N + 3) >> 2;
    unit = WIDE_UNIT / RG;
    const int units = (ncg + unit - 1) / unit;
    const int per = WIDE_TILES / WIDE_UNIT;
    n = (units + per - 1) / per;
    base = units / n;
    extra = units - base * n;
  }
  __device__ __forceinline__ int cg0(int i) const {
    return min(ncg, unit * (i * base + min(i, extra)));
  }
};

// Shared-memory mbarriers (PTX), by 32-bit shared address.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy (TMA, 1-D) of `bytes` from global memory into this
// block's shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The consumer warps' own block barrier (the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WIDE_CONSUMERS) : "memory");
}

// The ring: WIDE_STAGES stages of `stage` floats, each with a full
// barrier (the producer's expect_tx, then the copies' bytes) and an empty
// barrier (one arrival per consumer warp). A position walks the stages in
// order; its parity flips at each wrap.
struct Ring {
  float* buf;
  uint64_t* full;
  uint64_t* empty;
  int stage;
};

struct RingPos {
  int s = 0, ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == WIDE_STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
};

// acc[j][r][c] += sum_k a[k LDS + r] pan[k wl + co[j] + c] over the
// panel's rows, for the thread's NS tiles (one row group).
template <int NS>
__device__ __forceinline__ void wide_accumulate(
    const float* a, int LDS, const float* pan, int wl, int rows,
    const int (&co)[WIDE_SLOTS], float (&acc)[WIDE_SLOTS][4][4]) {
#pragma unroll 8
  for (int k = 0; k < rows; ++k) {
    const float4 a4 = ld4(a + k * LDS);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float4 o4 = ld4(pan + k * wl + co[j]);
      const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[j][r][c] = fmaf(av[r], ov[c], acc[j][r][c]);
    }
  }
}

// Consumer side of out[r][c] = sum_k A[k][r] Op[k][c] for the block's TB
// scenarios: A is scenario-minor in shared memory (row k at A + k LDS),
// Op (K, N) streams through the ring window by window (Windows), a
// window's K rows in panels of min(K, stage / wl) rows. A window of nt
// tiles has ceil(nt / 32) slots of 32 tiles; slot i goes to warp i %
// WIDE_WARPS, so a warp takes up to WIDE_SLOTS slots, the same count for
// all its lanes (no divergent tile branch), and each partition at most
// one slot more than another. Lane l of a slot takes tile 32 i + l: row
// group l % RG, column group (32 i + l) / RG, so a thread's tiles share
// one float4 of A. epi(j, r0, c0, acc) consumes slot j's tile; with
// `epi_writes_a` the warps first wait for each other, so an epilogue may
// write A. Each output is one FMA chain over k = 0 .. K-1 from zero, as
// tile_product and warp_product sum it.
template <class Epi>
__device__ __forceinline__ void consume_product(const float* A, int LDS, int K,
                                                int N, int TB,
                                                const Ring& ring,
                                                RingPos& pos, bool epi_writes_a,
                                                Epi&& epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int RG = TB >> 2;
  const float* a = A + 4 * (lane % RG);
  const Windows win(N, RG);
  for (int i = 0; i < win.n; ++i) {
    const int g0 = win.cg0(i), ng = win.cg0(i + 1) - g0;
    const int wl = 4 * ng, nt = RG * ng;
    const int slots = (nt + 31) >> 5;
    const int mine = warp < slots ? (slots - warp + WIDE_WARPS - 1) / WIDE_WARPS
                                  : 0;
    int co[WIDE_SLOTS];
    bool ok[WIDE_SLOTS];
#pragma unroll
    for (int j = 0; j < WIDE_SLOTS; ++j) {
      const int tile = 32 * (warp + WIDE_WARPS * j) + lane;
      ok[j] = j < mine && tile < nt;
      co[j] = 4 * min(tile / RG, ng - 1);  // inside the panel if not ok
    }
    const int kp = min(K, ring.stage / wl);
    float acc[WIDE_SLOTS][4][4];
#pragma unroll
    for (int j = 0; j < WIDE_SLOTS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kp) {
      const int rows = min(kp, K - k0);
      mbar_wait(ring.full + pos.s, pos.ph);
      const float* pan = ring.buf + (size_t)pos.s * ring.stage;
      if (WIDE_SLOTS == 2 && mine == 2)
        wide_accumulate<WIDE_SLOTS>(a + (size_t)k0 * LDS, LDS, pan, wl, rows,
                                    co, acc);
      else if (mine >= 1)
        wide_accumulate<1>(a + (size_t)k0 * LDS, LDS, pan, wl, rows, co, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty + pos.s);
      pos.next();
    }
    if (epi_writes_a) consumer_sync();
    const int r0 = 4 * (lane % RG);
#pragma unroll
    for (int j = 0; j < WIDE_SLOTS; ++j)
      if (ok[j]) epi(j, r0, 4 * g0 + co[j], acc[j]);
  }
}

// Producer side of the same product: for each panel, lane 0 waits until
// every consumer warp has left the stage, arms the full barrier with the
// panel's bytes, and the copies follow: one bulk copy where the window is
// the whole padded row (the panel is contiguous), else one a row, spread
// over the warp's lanes.
__device__ __forceinline__ void produce_product(const float* __restrict__ Op,
                                                int K, int N, int ld, int TB,
                                                const Ring& ring,
                                                RingPos& pos) {
  const int lane = threadIdx.x & 31;
  const Windows win(N, TB >> 2);
  for (int i = 0; i < win.n; ++i) {
    const int g0 = win.cg0(i), wl = 4 * (win.cg0(i + 1) - g0);
    const int kp = min(K, ring.stage / wl);
    for (int k0 = 0; k0 < K; k0 += kp) {
      const int rows = min(kp, K - k0);
      if (lane == 0) {
        mbar_wait(ring.empty + pos.s, pos.ph ^ 1);
        mbar_expect(ring.full + pos.s, (uint32_t)(rows * wl * sizeof(float)));
      }
      __syncwarp();
      float* dst = ring.buf + (size_t)pos.s * ring.stage;
      const float* src = Op + (size_t)k0 * ld + 4 * g0;
      if (wl == ld) {
        if (lane == 0)
          bulk_copy(dst, src, (uint32_t)(rows * wl * sizeof(float)),
                    ring.full + pos.s);
      } else {
        for (int r = lane; r < rows; r += 32)
          bulk_copy(dst + (size_t)r * wl, src + (size_t)r * ld,
                    (uint32_t)(wl * sizeof(float)), ring.full + pos.s);
      }
      pos.next();
    }
  }
}

// The producer warp: every panel of the rollout, in the consumers'
// order. K5w's plant step takes the rung the balancer picks, which the
// consumers hand over through the rung barrier.
template <bool LADDER>
__device__ __forceinline__ void wide_producer(const Params& P, const Shape& d,
                                              const Ring& ring,
                                              uint64_t* rung_bar,
                                              const int* rung_word) {
  RingPos pos;
  int ri = LADDER ? P.rung0[blockIdx.x] : 0;
  for (int t = 0; t < d.n_blocks; ++t) {
    for (int it = 0; it < d.n_iter; ++it)
      produce_product(P.Vop + (size_t)ri * d.nbox * d.ldv, d.nbox, d.nbox,
                      d.ldv, d.TB, ring, pos);
    produce_product(P.M1 + (size_t)ri * d.nbox * d.ld1, d.nbox, d.W1, d.ld1,
                    d.TB, ring, pos);
    if (LADDER) {
      if ((threadIdx.x & 31) == 0) mbar_wait(rung_bar, t & 1);
      __syncwarp();
      ri = *(volatile const int*)rung_word;
    }
    produce_product(P.M2 + (size_t)ri * d.D2 * d.ld2, d.D2, d.W2, d.ld2,
                    d.TB, ring, pos);
  }
}

// K4w (LADDER = false) or K5w (LADDER = true): admm_rollout's math with
// the carry in shared memory, s and w in the registers of the consumer
// that owns their iteration tile, and the operators (rows padded to ldv,
// ld1, ld2) streamed by the producer warp through a ring of WIDE_STAGES
// stages of `stage` floats.
template <bool LADDER>
__device__ __forceinline__ void admm_rollout_wide(const Params& P,
                                                  const Shape& d, int stage) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int LDS = d.LDS, TB = d.TB;
  const int S = d.S, nbm = d.nbm, nbp = d.nbp, nbox = d.nbox, nxi = d.nxi;
  const int Mw = d.Mw, D2 = d.D2, W1 = d.W1, W2 = d.W2;
  const int row0 = blockIdx.x * TB;
  const int tid = threadIdx.x;

  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + WIDE_STAGES;
  uint64_t* rung_bar = empty + WIDE_STAGES;
  int* rung_word = reinterpret_cast<int*>(rung_bar + 1);
  float* lo = sm + WIDE_HEAD_FLOATS;
  float* hi = lo + d.ldv;
  float* ulo = hi + d.ldv;
  float* uhi = ulo + d.ldu;
  // Scenario-minor rows of LDS floats.
  float* xin = uhi + d.ldu;       // (D2): [s_flat | u | w_noise]
  float* pre = xin + D2 * LDS;    // (Mw): [u_theta | q]
  float* vc = pre + Mw * LDS;     // (nbox)
  float* zth = vc + nbox * LDS;   // (nxi)
  float* dbuf = zth + nxi * LDS;  // (max(nbox, S)): s - w, or s_next
  float* snext = dbuf;
  float* rpr = dbuf + max(nbox, S) * LDS;  // (TB) row maxima
  float* rdr = rpr + TB;
  float* smag = rdr + TB;
  float* wmag = smag + TB;
  const Ring ring{sm + WIDE_HEAD_FLOATS + ceil32(wide_layout_floats(d)),
                  full, empty, stage};

  if (tid == 0) {
    for (int i = 0; i < WIDE_STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WIDE_WARPS);
    }
    mbar_init(rung_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int ri = 0;  // K5: the group's rung
  float rho = P.rho;
  if (LADDER) {
    ri = P.rung0[blockIdx.x];
    rho = P.rhos[ri];
  }
  if (tid < THREADS) {  // the loaders stride THREADS
    load_op(lo, P.lo, 1, nbox, d.ldv);
    load_op(hi, P.hi, 1, nbox, d.ldv);
    load_op(ulo, P.u_lo, 1, nbm, d.ldu);
    load_op(uhi, P.u_hi, 1, nbm, d.ldu);
    load_carry(xin, P.s0, S, row0, d);
    load_carry(pre, P.pre0, Mw, row0, d);
    load_carry(vc, P.vc0, nbox, row0, d);
    load_carry(zth, P.zth0, nxi, row0, d);
  }
  __syncthreads();

  if (tid >= WIDE_CONSUMERS) {
    wide_producer<LADDER>(P, d, ring, rung_bar, rung_word);
    return;
  }

  // This thread's iteration tiles (the iteration product is one window,
  // dealt as consume_product deals it): rows r0 .. r0 + 3, columns
  // c0[j] .. c0[j] + 3 of slot j, whose s and w it holds for the whole
  // rollout (zero past B and past nbox).
  const int warp = tid >> 5, lane = tid & 31, RG = TB >> 2;
  const int r0 = 4 * (lane % RG);
  int c0[WIDE_SLOTS];
  bool own[WIDE_SLOTS];
  {
    const int nt = RG * ((nbox + 3) >> 2), slots = (nt + 31) >> 5;
    const int mine =
        warp < slots ? (slots - warp + WIDE_WARPS - 1) / WIDE_WARPS : 0;
#pragma unroll
    for (int j = 0; j < WIDE_SLOTS; ++j) {
      const int tile = 32 * (warp + WIDE_WARPS * j) + lane;
      own[j] = j < mine && tile < nt;
      c0[j] = 4 * (tile / RG);
    }
  }
  float s[WIDE_SLOTS][4][4], w[WIDE_SLOTS][4][4];
#pragma unroll
  for (int j = 0; j < WIDE_SLOTS; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = row0 + r0 + r, col = c0[j] + c;
        const bool in = own[j] && b < d.B && col < nbox;
        s[j][r][c] = in ? P.sa0[(size_t)b * nbox + col] : 0.f;
        w[j][r][c] = in ? P.wa0[(size_t)b * nbox + col] : 0.f;
      }

  RingPos pos;
  const int Wadd = Mw + nbox + nxi;
  const float alpha = P.alpha, beta = P.beta;

  // The iteration's epilogue on slot j's tile: v = acc + vc, the
  // over-relaxed step, the clip, d; on the last iteration the tile's row
  // maxima of |v - s'| and |s' - s| go to rpr, rdr (non-negative or NaN
  // floats order as their bits, so an integer max keeps a NaN).
  bool last = false;
  auto iter_epi = [&](int j, int rr0, int cc0, float (&acc)[4][4]) {
    float pm[4] = {0.f, 0.f, 0.f, 0.f}, dm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = cc0 + c;
      if (col >= nbox) break;
      const int o = col * LDS + rr0;
      const float4 v4 = ld4(vc + o);
      const float vcv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float lc = lo[col], hc = hi[col];
      float dn[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sv = s[j][r][c], wv = w[j][r][c];
        const float v = __fadd_rn(acc[r][c], vcv[r]);
        const float vh = __fadd_rn(__fmul_rn(alpha, v), __fmul_rn(beta, sv));
        const float sn = fminf(fmaxf(__fadd_rn(vh, wv), lc), hc);
        const float wn = __fsub_rn(__fadd_rn(wv, vh), sn);
        dn[r] = __fsub_rn(sn, wn);
        if (last) {
          pm[r] = nan_max(pm[r], fabsf(__fsub_rn(v, sn)));
          dm[r] = nan_max(dm[r], fabsf(__fsub_rn(sn, sv)));
        }
        s[j][r][c] = sn;
        w[j][r][c] = wn;
      }
      *reinterpret_cast<float4*>(dbuf + o) =
          make_float4(dn[0], dn[1], dn[2], dn[3]);
    }
    if (last) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        atomicMax(reinterpret_cast<int*>(rpr + rr0 + r), __float_as_int(pm[r]));
        atomicMax(reinterpret_cast<int*>(rdr + rr0 + r), __float_as_int(dm[r]));
      }
    }
  };

  for (int t = 0; t < d.n_blocks; ++t) {
    // This block's noise into xin's w rows.
    for (int idx = tid; idx < TB * nbp; idx += WIDE_CONSUMERS) {
      const int r = idx / nbp, i = idx - r * nbp;
      const int b = row0 + r;
      xin[(S + nbm + i) * LDS + r] =
          b < d.B ? P.W[((size_t)b * d.n_blocks + t) * nbp + i] : 0.f;
    }
    // K4's tracking adds, to pre, vc and zth.
    if (!LADDER && P.adds != nullptr) {
      const float* add = P.adds + (size_t)t * Wadd;
      for (int idx = tid; idx < Wadd * TB; idx += WIDE_CONSUMERS) {
        const int j = idx / TB, r = idx - j * TB;
        pre[j * LDS + r] = __fadd_rn(pre[j * LDS + r], add[j]);
      }
    }
    // d = s - w (s_next has left it for xin), the row maxima from zero.
#pragma unroll
    for (int j = 0; j < WIDE_SLOTS; ++j) {
      if (!own[j]) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c0[j] + c >= nbox) break;
        *reinterpret_cast<float4*>(dbuf + (c0[j] + c) * LDS + r0) =
            make_float4(__fsub_rn(s[j][0][c], w[j][0][c]),
                        __fsub_rn(s[j][1][c], w[j][1][c]),
                        __fsub_rn(s[j][2][c], w[j][2][c]),
                        __fsub_rn(s[j][3][c], w[j][3][c]));
      }
    }
    for (int r = tid; r < TB; r += WIDE_CONSUMERS)
      rpr[r] = rdr[r] = smag[r] = wmag[r] = 0.f;
    consumer_sync();  // xin, pre, vc, zth, d and the maxima are in

    for (int it = 0; it < d.n_iter; ++it) {
      last = it == d.n_iter - 1;
      consume_product(dbuf, LDS, nbox, nbox, TB, ring, pos, true, iter_epi);
      consumer_sync();  // d (and the residual maxima) are in
    }

    // Per row: max |s| (K5, or n_iter = 0, where v_last = s_prev = 0 make
    // both residuals max |s|) and max |w| (K5), from each owner's tile.
    if (LADDER || d.n_iter == 0) {
#pragma unroll
      for (int j = 0; j < WIDE_SLOTS; ++j) {
        if (!own[j]) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float smx = 0.f, wmx = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c0[j] + c >= nbox) break;
            smx = nan_max(smx, fabsf(s[j][r][c]));
            wmx = nan_max(wmx, fabsf(w[j][r][c]));
          }
          atomicMax(reinterpret_cast<int*>(smag + r0 + r), __float_as_int(smx));
          if (LADDER)
            atomicMax(reinterpret_cast<int*>(wmag + r0 + r),
                      __float_as_int(wmx));
          if (d.n_iter == 0) {
            atomicMax(reinterpret_cast<int*>(rpr + r0 + r),
                      __float_as_int(smx));
            atomicMax(reinterpret_cast<int*>(rdr + r0 + r),
                      __float_as_int(smx));
          }
        }
      }
    }

    // Extraction: t = s - w through M1.
    consume_product(
        dbuf, LDS, nbox, W1, TB, ring, pos, false,
        [&](int, int rr0, int cc0, float (&acc)[4][4]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = cc0 + c;
            if (col >= W1) break;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int rr = rr0 + r;
              if (col < nbm) {
                const float u = fminf(
                    fmaxf(__fadd_rn(pre[col * LDS + rr], acc[r][c]),
                          ulo[col]),
                    uhi[col]);
                xin[(S + col) * LDS + rr] = u;
                const int b = row0 + rr;
                if (b < d.B)
                  P.U[((size_t)b * d.n_blocks + t) * nbm + col] = u;
              } else if (col == nbm) {
                pre[col * LDS + rr] = __fadd_rn(pre[col * LDS + rr], acc[r][c]);
              } else {
                float* zp = zth + (col - Mw) * LDS + rr;
                const float z = __fadd_rn(*zp, acc[r][c]);
                *zp = __fmul_rn(z, z);
              }
            }
          }
        });
    consumer_sync();  // u, z^2, q and the row maxima are in

    // Cost and residuals, 16 lanes a row: each lane sums every 16th z^2
    // of the row, the lanes' sums by shuffles (admm_rollout's order).
    for (int r = tid >> 4; r < TB; r += WIDE_CONSUMERS >> 4) {
      const int cg = tid & 15;
      float cs = 0.f;
      for (int j = cg; j < nxi; j += 16) cs = __fadd_rn(cs, zth[j * LDS + r]);
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        cs = __fadd_rn(cs, __shfl_xor_sync(FULL, cs, off));
      const int b = row0 + r;
      if (cg == 0 && b < d.B) {
        const size_t o = (size_t)b * d.n_blocks + t;
        P.C[o] = __fadd_rn(cs, pre[nbm * LDS + r]);
        P.RP[o] = rpr[r];
        P.RD[o] = __fmul_rn(rho, rdr[r]);
      }
    }

    // K5: balance the group's rung on its rows before B; every thread
    // reaches the same ri', and thread 0 hands it to the producer.
    if (LADDER) {
      float red[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < TB && row0 + r < d.B; ++r) {
        red[0] = nan_max(red[0], rpr[r]);
        red[1] = nan_max(red[1], __fmul_rn(rho, rdr[r]));
        red[2] = nan_max(red[2], smag[r]);
        red[3] = nan_max(red[3], wmag[r]);
      }
      const float tiny = 1e-12f;
      const float s_mag = red[2], w_mag = red[3];
      const float rp_rel =
          __fdiv_rn(red[0], nan_max(nan_max(s_mag, w_mag), tiny));
      const float rd_rel =
          __fdiv_rn(__fdiv_rn(red[1], rho), nan_max(w_mag, tiny));
      const bool up = rp_rel > __fmul_rn(P.ratio, rd_rel) && ri < P.R - 1;
      const bool down = rd_rel > __fmul_rn(P.ratio, rp_rel) && ri > 0;
      const int rn = ri + (int)up - (int)down;
      if (tid == 0) {
        *rung_word = rn;
        mbar_arrive(rung_bar);
      }
      for (int r = tid; r < TB; r += WIDE_CONSUMERS)
        if (row0 + r < d.B) P.RUNG[(size_t)(row0 + r) * d.n_blocks + t] = rn;
      if (rn != ri) {
        // The unscaled dual rho w is rung-invariant; the next solve
        // takes d = s - w from the scaled w.
        const float fac = __fdiv_rn(P.rhos[ri], P.rhos[rn]);
#pragma unroll
        for (int j = 0; j < WIDE_SLOTS; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) w[j][r][c] = __fmul_rn(w[j][r][c], fac);
        ri = rn;
        rho = P.rhos[rn];
      }
    }
    consumer_sync();  // the cost's reads of pre, zth and the maxima are done

    // Plant step and the next solve's maps: [s_flat | u | w] through M2.
    const float* b2 = P.b2 + (size_t)ri * W2;
    const int oU = S, oY = S + nbm, oQ = S + nbm + nbp, oV = oQ + 1;
    const int oZ = oV + nbox;
    consume_product(
        xin, LDS, D2, W2, TB, ring, pos, false,
        [&](int, int rr0, int cc0, float (&acc)[4][4]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = cc0 + c;
            if (col >= W2) break;
            const float bias = b2[col];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int rr = rr0 + r;
              const float v = __fadd_rn(acc[r][c], bias);
              if (col < oU) {
                snext[col * LDS + rr] = v;
              } else if (col < oY) {
                pre[(col - oU) * LDS + rr] = v;
              } else if (col < oQ) {
                const int b = row0 + rr;
                if (b < d.B)
                  P.Y[((size_t)b * d.n_blocks + t) * nbp + (col - oY)] = v;
              } else if (col == oQ) {
                pre[nbm * LDS + rr] = v;
              } else if (col < oZ) {
                vc[(col - oV) * LDS + rr] = v;
              } else {
                zth[(col - oZ) * LDS + rr] = v;
              }
            }
          }
        });
    consumer_sync();  // s_next is in
    for (int idx = tid; idx < S * TB; idx += WIDE_CONSUMERS) {
      const int j = idx / TB, r = idx - j * TB;
      xin[j * LDS + r] = snext[j * LDS + r];
    }
    consumer_sync();  // xin has s_next before d is stored over it
  }
  if (tid < THREADS) store_carry(P.s_fin, xin, S, row0, d);
#pragma unroll
  for (int j = 0; j < WIDE_SLOTS; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = row0 + r0 + r, col = c0[j] + c;
        if (own[j] && b < d.B && col < nbox) {
          P.sa_fin[(size_t)b * nbox + col] = s[j][r][c];
          P.wa_fin[(size_t)b * nbox + col] = w[j][r][c];
        }
      }
}

__global__ void __launch_bounds__(WIDE_THREADS, 1)
fused_admm_wide_kernel(const Params P, const Shape d, int stage) {
  admm_rollout_wide<false>(P, d, stage);
}

__global__ void __launch_bounds__(WIDE_THREADS, 1)
fused_ladder_wide_kernel(const Params P, const Shape d, int stage) {
  admm_rollout_wide<true>(P, d, stage);
}

using WideKernel = void (*)(const Params, const Shape, int);

template <bool LADDER>
constexpr WideKernel wide_kernel() {
  return LADDER ? fused_ladder_wide_kernel : fused_admm_wide_kernel;
}

// Launches the wide body on `stream` at its plan for d's sizes (d.B,
// d.n_blocks and d.n_iter set), ceil(B / TB) blocks; the launch's error,
// or cudaErrorInvalidValue when no tile fits.
template <bool LADDER>
int launch_wide(const Params& P, Shape d, void* stream) {
  const WidePlan plan = wide_plan(d.S, d.nbm, d.nbp, d.nbox, d.nxi);
  if (plan.TB == 0) return (int)cudaErrorInvalidValue;
  const Shape w = make_shape(d.S, d.nbm, d.nbp, d.nbox, d.nxi, plan.TB);
  d.TB = w.TB;
  d.LDS = w.LDS;
  const WideKernel kernel = wide_kernel<LADDER>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.B + d.TB - 1) / d.TB);
  kernel<<<grid, WIDE_THREADS, plan.bytes, (cudaStream_t)stream>>>(P, d,
                                                                   plan.stage);
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// Scenarios per block the fixed-penalty kernel uses for these sizes and
// a batch of B scenarios on the current device (B < 1: a batch that
// fills the card; admm_tile), or 0 when none fits.
int fused_admm_tile_rows(int S, int nbm, int nbp, int nbox, int nxi, int B) {
  return admm_tile(S, nbm, nbp, nbox, nxi, B).TB;
}

// Dynamic shared memory, in bytes, of a K4 block at those sizes and B (0
// when none fits).
int fused_admm_smem_bytes(int S, int nbm, int nbp, int nbox, int nxi,
                          int B) {
  const int TB = admm_tile(S, nbm, nbp, nbox, nxi, B).TB;
  return TB ? (int)kernel_smem_bytes<false>(
                  make_shape(S, nbm, nbp, nbox, nxi, TB))
            : 0;
}

// K4 blocks resident per SM at those sizes and B, 0 when none fits, or
// minus a CUDA error.
int fused_admm_blocks_per_sm(int S, int nbm, int nbp, int nbox, int nxi,
                             int B) {
  const AdmmTile tile = admm_tile(S, nbm, nbp, nbox, nxi, B);
  if (tile.TB == 0) return 0;
  return occupancy(admm_kernel(tile, nbox),
                   kernel_smem_bytes<false>(
                       make_shape(S, nbm, nbp, nbox, nxi, tile.TB)));
}

// Registers and local (spill) bytes per thread of the K4 instantiation
// for nbox box lanes with warp_rows scenarios a warp (8, or 4 in the
// half-height tile); 0, a CUDA error, or cudaErrorInvalidValue.
int fused_admm_kernel_attributes(int nbox, int warp_rows, int* registers,
                                 int* local_bytes) {
  if (warp_rows != 8 && warp_rows != 2 * SMALL_RL)
    return (int)cudaErrorInvalidValue;
  return kernel_attributes(admm_kernel({0, warp_rows / 2}, nbox), registers,
                           local_bytes);
}

// Scenarios per block of the ladder kernel, its rung group: the largest
// tile that fits the group rule (rung_group_bytes), or 0.
int fused_ladder_tile_rows(int S, int nbm, int nbp, int nbox, int nxi) {
  return rung_group_rows(S, nbm, nbp, nbox, nxi);
}

// Dynamic shared memory, in bytes, of a K5 block of that group (0 when
// no group fits).
int fused_ladder_smem_bytes(int S, int nbm, int nbp, int nbox, int nxi) {
  const int TB = rung_group_rows(S, nbm, nbp, nbox, nxi);
  return TB ? (int)kernel_smem_bytes<true>(
                  make_shape(S, nbm, nbp, nbox, nxi, TB))
            : 0;
}

// K5 blocks resident per SM at those sizes, 0 when none fits, or minus
// a CUDA error.
int fused_ladder_blocks_per_sm(int S, int nbm, int nbp, int nbox, int nxi) {
  const int TB = rung_group_rows(S, nbm, nbp, nbox, nxi);
  return TB ? occupancy(kernel_for<true>(nbox),
                        kernel_smem_bytes<true>(
                            make_shape(S, nbm, nbp, nbox, nxi, TB)))
            : 0;
}

// Registers and local (spill) bytes per thread of the K5 instantiation
// for nbox box lanes; 0, a CUDA error, or cudaErrorInvalidValue.
int fused_ladder_kernel_attributes(int nbox, int* registers,
                                   int* local_bytes) {
  return kernel_attributes(kernel_for<true>(nbox), registers, local_bytes);
}

// Launches the rollout on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue when the sizes do not fit. Pointers
// are device pointers to contiguous float32 arrays: operators Vop
// (nbox, nbox), M1 (nbox, nbm+1+nxi), M2 (S+nbm+nbp, W2), b2 (W2), lo,
// hi (nbox), u_lo, u_hi (nbm); carries s0 (B, S), pre0 (B, nbm+1), vc0,
// sa0, wa0 (B, nbox), zth0 (B, nxi); noise W (B, n_blocks, nbp); adds
// (n_blocks, nbm+1+nbox+nxi) or null; outputs U (B, n_blocks, nbm),
// Y (B, n_blocks, nbp), C, RP, RD (B, n_blocks), s_fin (B, S), sa_fin,
// wa_fin (B, nbox).
int fused_admm_launch(const float* Vop, const float* M1, const float* M2,
                      const float* b2, const float* lo, const float* hi,
                      const float* u_lo, const float* u_hi, const float* s0,
                      const float* pre0, const float* vc0, const float* zth0,
                      const float* sa0, const float* wa0, const float* W,
                      const float* adds, float* U, float* Y, float* C,
                      float* RP, float* RD, float* s_fin, float* sa_fin,
                      float* wa_fin, int B, int S, int nbm, int nbp,
                      int nbox, int nxi, int n_blocks, int n_iter,
                      float alpha, float beta, float rho, void* stream) {
  if (B < 1 || n_blocks < 1 || n_iter < 0) return (int)cudaErrorInvalidValue;
  const AdmmTile tile = admm_tile(S, nbm, nbp, nbox, nxi, B);
  if (tile.TB == 0) return (int)cudaErrorInvalidValue;
  Shape d = make_shape(S, nbm, nbp, nbox, nxi, tile.TB);
  d.B = B;
  d.n_blocks = n_blocks;
  d.n_iter = n_iter;
  const Params P{Vop,   M1,   M2,   b2,      lo,      hi,     u_lo, u_hi,
                 s0,    pre0, vc0,  zth0,    sa0,     wa0,    W,    adds,
                 U,     Y,    C,    RP,      RD,      s_fin,  sa_fin,
                 wa_fin, alpha, beta, rho,   nullptr, nullptr, nullptr,
                 1,     0.f};
  return launch(admm_kernel(tile, nbox), kernel_smem_bytes<false>(d), P, d,
                stream);
}

// K4's NON_CONVEX mode: scenarios per block (0 when no block fits), the
// block's dynamic shared memory in bytes (0 likewise), blocks resident
// per SM (0, or minus a CUDA error), and the registers and local bytes
// per thread of the nbox instantiation (returns the CUDA error, or
// cudaErrorInvalidValue).
int fused_admm_nonconvex_tile_rows(int S, int nbm, int nbp, int nbox, int nxi,
                                   int n_alpha) {
  return nonconvex_tile_rows(S, nbm, nbp, nbox, nxi, n_alpha);
}

int fused_admm_nonconvex_smem_bytes(int S, int nbm, int nbp, int nbox,
                                    int nxi, int n_alpha) {
  const int TB = nonconvex_tile_rows(S, nbm, nbp, nbox, nxi, n_alpha);
  return TB ? (int)nonconvex_smem_bytes(
                  nonconvex_shape(S, nbm, nbp, nbox, nxi, n_alpha, TB))
            : 0;
}

int fused_admm_nonconvex_blocks_per_sm(int S, int nbm, int nbp, int nbox,
                                       int nxi, int n_alpha) {
  const int bytes =
      fused_admm_nonconvex_smem_bytes(S, nbm, nbp, nbox, nxi, n_alpha);
  return bytes ? occupancy(nonconvex_kernel_for(nbox), bytes) : 0;
}

int fused_admm_nonconvex_kernel_attributes(int nbox, int* registers,
                                           int* local_bytes) {
  return kernel_attributes(nonconvex_kernel_for(nbox), registers,
                           local_bytes);
}

// Launches K4's NON_CONVEX rollout on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue when the sizes do not
// fit. As fused_admm_launch without adds (lo and hi
// are not read), plus: G (nxi - nbox + nbox, lda) with lda = n_alpha
// rounded up to a multiple of 4, zero past n_alpha; a_c (lda); bd0 (B),
// each scenario's bound at the start; outputs DL, GP, BD (B, n_blocks),
// bd_fin (B); counters (4 unsigned 64-bit, added to) or null. n_iter
// and n_outer at least 1.
int fused_admm_nonconvex_launch(
    const float* Vop, const float* M1, const float* M2, const float* b2,
    const float* lo, const float* hi, const float* u_lo, const float* u_hi,
    const float* s0, const float* pre0, const float* vc0, const float* zth0,
    const float* sa0, const float* wa0, const float* W, const float* G,
    const float* a_c, const float* bd0, float* U, float* Y, float* C,
    float* RP, float* RD, float* s_fin, float* sa_fin, float* wa_fin,
    float* DL, float* GP, float* BD, float* bd_fin,
    unsigned long long* counters, int B, int S, int nbm, int nbp, int nbox,
    int nxi, int n_blocks, int n_iter, int n_alpha, int n_outer,
    float alpha, float beta, float rho, float c_eps, void* stream) {
  const int TB = nonconvex_tile_rows(S, nbm, nbp, nbox, nxi, n_alpha);
  if (TB == 0 || B < 1 || n_blocks < 1 || n_iter < 1 || n_outer < 1)
    return (int)cudaErrorInvalidValue;
  Shape d = nonconvex_shape(S, nbm, nbp, nbox, nxi, n_alpha, TB);
  d.B = B;
  d.n_blocks = n_blocks;
  d.n_iter = n_iter;
  d.n_outer = n_outer;
  Params P{Vop,    M1,   M2,   b2,    lo,    hi,    u_lo,  u_hi,
           s0,     pre0, vc0,  zth0,  sa0,   wa0,   W,     nullptr,
           U,      Y,    C,    RP,    RD,    s_fin, sa_fin,
           wa_fin, alpha, beta, rho,  nullptr, nullptr, nullptr,
           1,      0.f};
  P.G = G;
  P.a_c = a_c;
  P.bd0 = bd0;
  P.bd_fin = bd_fin;
  P.DL = DL;
  P.GP = GP;
  P.BD = BD;
  P.counters = counters;
  P.c_eps = c_eps;
  return launch(nonconvex_kernel_for(nbox), nonconvex_smem_bytes(d), P, d,
                stream);
}

// Launches the ladder rollout (kernel K5) on `stream`, one block per
// rung group of TB = fused_ladder_tile_rows(...) scenarios; returns
// cudaGetLastError(), or cudaErrorInvalidValue when the sizes do not
// fit (nbox above 192 included). As fused_admm_launch without adds, plus: Vop (R, nbox, nbox), M1
// (R, nbox, nbm+1+nxi), M2 (R, S+nbm+nbp, W2), b2 (R, W2) stacked
// rung-major; rhos (R); rung0 (ceil(B / TB)) int32, each group's first
// rung; RUNG (B, n_blocks) int32, the post-balance rung of every solve.
int fused_ladder_launch(const float* Vop, const float* M1, const float* M2,
                        const float* b2, const float* lo, const float* hi,
                        const float* u_lo, const float* u_hi,
                        const float* rhos, const int* rung0, const float* s0,
                        const float* pre0, const float* vc0,
                        const float* zth0, const float* sa0,
                        const float* wa0, const float* W, float* U, float* Y,
                        float* C, float* RP, float* RD, int* RUNG,
                        float* s_fin, float* sa_fin, float* wa_fin, int B,
                        int S, int nbm, int nbp, int nbox, int nxi,
                        int n_blocks, int n_iter, int R, float alpha,
                        float beta, float ratio, void* stream) {
  const int TB = rung_group_rows(S, nbm, nbp, nbox, nxi);
  if (TB == 0 || B < 1 || n_blocks < 1 || n_iter < 0 || R < 1)
    return (int)cudaErrorInvalidValue;
  Shape d = make_shape(S, nbm, nbp, nbox, nxi, TB);
  d.B = B;
  d.n_blocks = n_blocks;
  d.n_iter = n_iter;
  const Params P{Vop,    M1,   M2,   b2,    lo,    hi,    u_lo,  u_hi,
                 s0,     pre0, vc0,  zth0,  sa0,   wa0,   W,     nullptr,
                 U,      Y,    C,    RP,    RD,    s_fin, sa_fin,
                 wa_fin, alpha, beta, 0.f,  rhos,  rung0, RUNG,
                 R,      ratio};
  return launch(kernel_for<true>(nbox), kernel_smem_bytes<true>(d), P, d,
                stream);
}


// Scenarios per block of the wide kernels (K4w, and K5w, whose tile is its
// rung group) for these sizes: wide_group_rows, the largest tile whose
// state leaves a ring of at least four rows of the widest window, with
// the iteration one window; or 0.
int fused_wide_tile_rows(int S, int nbm, int nbp, int nbox, int nxi) {
  return wide_group_rows(S, nbm, nbp, nbox, nxi);
}

// Dynamic shared memory, in bytes, of a K4w or K5w block at those sizes
// (0 when no tile fits).
int fused_wide_smem_bytes(int S, int nbm, int nbp, int nbox, int nxi) {
  return (int)wide_plan(S, nbm, nbp, nbox, nxi).bytes;
}

// Floats of one of the WIDE_STAGES ring stages of a K4w or K5w block at
// those sizes (0 when no tile fits).
int fused_wide_stage_floats(int S, int nbm, int nbp, int nbox, int nxi) {
  return wide_plan(S, nbm, nbp, nbox, nxi).stage;
}

// Registers and local (spill) bytes per thread of K4w (ladder = 0) or
// K5w (ladder = 1); 0 or a CUDA error.
int fused_wide_kernel_attributes(int ladder, int* registers,
                                 int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, ladder ? wide_kernel<true>() : wide_kernel<false>());
  if (err != cudaSuccess) return (int)err;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Launches K4w on `stream`, with the arguments of fused_admm_launch but
// Vop, M1 and M2 rows padded to a multiple of four floats (nbox, nbm+1+nxi
// and W2 rounded up, the padding zero), one block per
// fused_wide_tile_rows scenarios; returns the launch's error, or
// cudaErrorInvalidValue when no tile fits.
int fused_admm_wide_launch(const float* Vop, const float* M1,
                           const float* M2, const float* b2, const float* lo,
                           const float* hi, const float* u_lo,
                           const float* u_hi, const float* s0,
                           const float* pre0, const float* vc0,
                           const float* zth0, const float* sa0,
                           const float* wa0, const float* W,
                           const float* adds, float* U, float* Y, float* C,
                           float* RP, float* RD, float* s_fin, float* sa_fin,
                           float* wa_fin, int B, int S, int nbm, int nbp,
                           int nbox, int nxi, int n_blocks, int n_iter,
                           float alpha, float beta, float rho, void* stream) {
  if (B < 1 || n_blocks < 1 || n_iter < 0) return (int)cudaErrorInvalidValue;
  Shape d = make_shape(S, nbm, nbp, nbox, nxi, 4);
  d.B = B;
  d.n_blocks = n_blocks;
  d.n_iter = n_iter;
  const Params P{Vop,   M1,   M2,   b2,      lo,      hi,     u_lo, u_hi,
                 s0,    pre0, vc0,  zth0,    sa0,     wa0,    W,    adds,
                 U,     Y,    C,    RP,      RD,      s_fin,  sa_fin,
                 wa_fin, alpha, beta, rho,   nullptr, nullptr, nullptr,
                 1,     0.f};
  return launch_wide<false>(P, d, stream);
}

// Launches K5w on `stream`, with the arguments of fused_ladder_launch but
// every rung's Vop, M1 and M2 rows padded as for fused_admm_wide_launch,
// one block per rung group of fused_wide_tile_rows scenarios (rung0 has
// one entry per group); returns the launch's error, or
// cudaErrorInvalidValue when no tile fits.
int fused_ladder_wide_launch(const float* Vop, const float* M1,
                             const float* M2, const float* b2,
                             const float* lo, const float* hi,
                             const float* u_lo, const float* u_hi,
                             const float* rhos, const int* rung0,
                             const float* s0, const float* pre0,
                             const float* vc0, const float* zth0,
                             const float* sa0, const float* wa0,
                             const float* W, float* U, float* Y, float* C,
                             float* RP, float* RD, int* RUNG, float* s_fin,
                             float* sa_fin, float* wa_fin, int B, int S,
                             int nbm, int nbp, int nbox, int nxi,
                             int n_blocks, int n_iter, int R, float alpha,
                             float beta, float ratio, void* stream) {
  if (B < 1 || n_blocks < 1 || n_iter < 0 || R < 1)
    return (int)cudaErrorInvalidValue;
  Shape d = make_shape(S, nbm, nbp, nbox, nxi, 4);
  d.B = B;
  d.n_blocks = n_blocks;
  d.n_iter = n_iter;
  const Params P{Vop,    M1,   M2,   b2,    lo,    hi,    u_lo,  u_hi,
                 s0,     pre0, vc0,  zth0,  sa0,   wa0,   W,     nullptr,
                 U,      Y,    C,    RP,    RD,    s_fin, sa_fin,
                 wa_fin, alpha, beta, 0.f,  rhos,  rung0, RUNG,
                 R,      ratio};
  return launch_wide<true>(P, d, stream);
}

}  // extern "C"
