// Fused condensed closed-loop rollout (float32, Hopper sm_90a): with the
// per-solve cost in the kernel (K1, which also serves K2) or without it
// (K3, the cost_mode="post" path).
//
// K1 replaces direct_data_driven_mpc_tpu/ops/pallas_rollout.py::
// _make_rollout_from_fused (kernel bodies `kernel_split` and `kernel`).
// Per outer time block t every scenario computes
//
//     sw  = [W_{(t + w_off) mod n_outer} | s_t]              (D = nw + S)
//     out = sw @ G + bias   columns [s_{t+1} | U | Y | Z | q-part]
//     C_k = sum_{d < rank} Z_{k,d}^2 + qpart_k              (k < K)
//
// What bounds it on the H100: at the four-tank shape (B = 4096, T = 400,
// K = 50, D = 120, 1070 columns) one rollout is ~8.4 GFLOP of float32
// FMA work against ~46 MB of HBM traffic (the noise in, U/Y/C out), so
// it is compute-bound on the float32 FMA pipes. No tensor cores: U, Y
// and the state are bit-equal to the plain version's one FMA chain.
//
// The TPU ran all 1070 columns of a block as one 128-lane contraction
// per grid step, in series over t. Only the S = 20 state columns carry
// from one block to the next; the other 1050 of row (b, t) are a pure
// function of that row's [w | s_t]. So K1 is two kernels on one stream:
//
// 1. fused_rollout_state_kernel, the recursion alone: s_{t+1} = [w | s_t]
//    @ G[:, :S] + bias[:S], 1.9 % of the work, a chain of n_outer x D
//    dependent FMAs per output, so it wants many scenarios in flight: 16
//    per block (256 blocks at the main shape), each warp 16 scenarios x
//    2 groups of 4 state columns. Its two transposed [w | s] tiles (row
//    stride 17: fills and reads hit 32 banks) take turns: step t + 1's
//    noise arrives by cp.async while step t computes into the other
//    tile. G's state columns sit in shared memory, in chunks of 64. The
//    pass also assembles the product's rows [w | s_t | 0] (the noise
//    rotation applied), (B, n_outer, D rounded up to 8) floats, written
//    coalesced: 15.7 MB at the main shape, read back from L2, and a flag
//    per row (below).
// 2. fused_rollout_product_kernel, every other column of all B x n_outer
//    rows (b, t) as one product: 32768 x 120 times 120 x 1050 at the main
//    shape, 256 row tiles x 8 column tiles = 2048 blocks of 128 threads,
//    two per SM. A thread owns 8 rows x one slot of 17 columns (136 FMAs
//    per 7 shared-memory loads); a warp is 4 row groups x 8 slots, whose
//    rows lie 12 floats apart and whose slot columns 20, so its 16-byte
//    loads hit 32 banks. The rows and the tile's packed columns stream
//    through a 6-stage cp.async ring of 8-row slices of D (71,424 B a
//    block, whatever D is; a pass's last slice also brings its bias),
//    all 16-byte copies. A slot either stores 16
//    columns of U or of Y (16-byte stores where the widths allow), or
//    holds one solve's Z columns and its q column (rank 16 + 1 = 17 at
//    the main shape), so the cost is summed in its registers: no
//    cross-thread or cross-block sum, no atomics, and Z (800 of the 1070
//    columns) is never stored. The wrapper packs G's columns into slots
//    once per operator (the slot table and packed copies are cached with
//    it); a solve with more than 17 such columns takes several passes
//    over D, its cost carried in registers from pass to pass.
//
// The zero band. Solve k of a block sees only the noise of the steps
// before it: control/linear_engine.py starts every tracked quantity with
// zero noise columns and writes step t's p columns at step t (`Wj`), and
// the cost factor mixes columns within one solve only. So solve k's U, Z
// and q columns are exact zeros in the noise rows from 2k on (p = 2), its
// Y columns from 2k + 2; a tracking map's setpoint rows, after the noise,
// are not, so the band is a gap in the middle of D. The wrapper orders
// the slots by how many slices of D their columns touch (how far back
// their noise reaches), so a tile holds neighbouring solves, and reads
// from the packed operator, per tile and pass, the list of slices that
// hold a nonzero entry. The ring stages and the FMA loop run over that
// list alone, in ascending order; its length is the same for the whole
// block. At the four-tank shape (8 tiles of 15 slices) the tiles stream
// 5, 7, 8, 10, 11, 13, 15 and 15 slices: 70.0 % of the product's slices
// (77.5 % at the 24-row slices of before: 8 rows paid for their extra
// barriers on the H100, and a 6-deep ring for its shared memory).
//
// Each s, U and Y value is fmaf over i = 0 .. D-1 in order from 0, then
// __fadd_rn(., bias): the previous kernel's chain and, at the main shape,
// cuBLAS's, so all three stay bit-equal. A skipped term is fmaf(a, 0,
// acc) = acc for finite a, so skipping keeps the chain and the bits.
// Each cost sums its squares in column order and then its q-part, as
// before. A value that is not finite makes its skipped terms NaN, so the
// state pass flags each row [w | s_t] that holds one, and a product
// block with a flagged row streams the other slices too, after the
// listed ones. Its finite rows add only zeros then, and keep their bits;
// a flagged row's outputs are NaN or +-inf just as the full chain's,
// whatever the order (NaN absorbs every term, an infinity every finite
// one): NaN wherever the plain version's are.
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

constexpr size_t SMEM_LIMIT = 232448;  // opt-in shared memory per block

// K1's plan. The state pass: ST_ROWS scenarios per block, so a warp
// takes ST_GPW column groups of 4 (at most ST_WARPS warps), two [w | s]
// tiles (step t's and step t + 1's) and G's state columns in chunks of
// ST_GC (all of them at once when they fit one chunk).
constexpr int ST_ROWS = 16;
constexpr int ST_GPW = 32 / ST_ROWS;
constexpr int ST_LDS = ST_ROWS + 1;  // row stride of a transposed tile
constexpr int ST_WARPS = 8;
constexpr int ST_GC = 4 * ST_GPW * ST_WARPS;
static_assert(32 % ST_ROWS == 0 && ST_LDS % 2 == 1, "lanes and banks");
// The product: PR_BM rows (b, t) x PR_SLOTS slots of PR_NC columns per
// block, PR_TM rows per thread; slots lie PR_LDC floats apart in the
// packed operator and in shared memory; a ring of PR_STAGES slices of
// PR_BK rows of D (A's rows at a stride of PR_LDA floats).
constexpr int PR_BM = 128;
constexpr int PR_SLOTS = 8;
constexpr int PR_NC = 17;
constexpr int PR_LDC = 20;
constexpr int PR_BN = PR_SLOTS * PR_LDC;
constexpr int PR_TM = 8;
constexpr int PR_BK = 8;
constexpr int PR_LDA = PR_BK + 4;
constexpr int PR_STAGES = 6;
constexpr int PR_THREADS = 128;
// A stage: A's rows, the operator's slice and the pass's bias.
constexpr int PR_STAGE_FLOATS = PR_BM * PR_LDA + (PR_BK + 1) * PR_BN;
static_assert((PR_THREADS / 32) * (32 / PR_SLOTS) * PR_TM == PR_BM,
              "warps x row groups x rows per thread");
static_assert(PR_THREADS == PR_BM, "a thread reads one row's flag");
static_assert(PR_LDC % 4 == 0 && PR_LDC >= PR_NC, "slot stride");
static_assert(PR_BK % 8 == 0 && PR_LDA % 8 == 4,
              "16-byte copies; 4 consecutive rows in 4 bank groups");

// A slot's work in one pass (int4 {kind, a, n, flags}): kind 1 stores
// columns [a, a + n) of [U | Y] (n <= 16, within U or within Y, a - 0 or
// a - Ku a multiple of 16); kind 2 adds the squares of n Z columns of
// solve a to its cost (flags & 1: the solve's first chunk, so the cost
// starts from 0; flags & 2: column n is its q column, which completes
// the cost, and C is stored); kind 0 is empty.
enum SlotKind { SLOT_EMPTY = 0, SLOT_STORE = 1, SLOT_COST = 2 };

__host__ __device__ constexpr int state_groups(int S) { return (S + 3) / 4; }
__host__ __device__ constexpr int state_threads(int S) {
  return 32 * ((state_groups(S) + ST_GPW - 1) / ST_GPW < ST_WARPS
                   ? (state_groups(S) + ST_GPW - 1) / ST_GPW
                   : ST_WARPS);
}
// Row stride of the product's rows [w | s | 0]: D rounded up to PR_BK.
__host__ __device__ constexpr int row_stride(int D) {
  return (D + PR_BK - 1) / PR_BK * PR_BK;
}
// The state pass's two transposed tiles, in floats, rounded up to whole
// 16-byte pieces: G's state columns after them take 16-byte copies and
// loads, whatever the parity of D.
__host__ __device__ constexpr int state_tiles_floats(int D) {
  return (2 * D * ST_LDS + 3) / 4 * 4;
}
size_t state_smem_bytes(int S, int nw) {
  return sizeof(float) *
         ((size_t)state_tiles_floats(nw + S) +
          (size_t)(nw + S) * (4 * state_groups(S) < ST_GC
                                  ? 4 * state_groups(S)
                                  : ST_GC));
}
constexpr size_t product_smem_bytes() {
  return sizeof(float) * PR_STAGES * PR_STAGE_FLOATS;
}

// Start the copy of scenario rows row0 .. row0 + ST_ROWS - 1 of `src`
// (width floats each, `stride` apart) into rows [0, width) of the
// transposed tile dst (zero past B), 4 bytes a copy: a warp takes one
// scenario's consecutive columns, so the reads coalesce and the writes
// (row stride ST_LDS) hit 32 banks.
__device__ __forceinline__ void stage_state_rows(const float* __restrict__ src,
                                                 size_t stride, int width,
                                                 float* dst, int row0,
                                                 int B) {
  const int lane = threadIdx.x % 32;
  for (int rr = threadIdx.x / 32; rr < ST_ROWS; rr += blockDim.x / 32) {
    const float* s = src + (size_t)(row0 + rr) * stride;
    for (int i = lane; i < width; i += 32) {
      if (row0 + rr < B)
        __pipeline_memcpy_async(dst + i * ST_LDS + rr, s + i, sizeof(float));
      else
        dst[i * ST_LDS + rr] = 0.f;
    }
  }
}

// Start the copy of G's state columns [j0, j0 + width) (from the packed
// Gs, ldgs floats a row) into gsm (D rows of `width` floats), 16 bytes a
// copy.
__device__ __forceinline__ void stage_state_columns(
    const float* __restrict__ Gs, int ldgs, int D, int j0, int width,
    float* gsm) {
  for (int i = threadIdx.x / 32; i < D; i += blockDim.x / 32)
    for (int c = threadIdx.x % 32; c < width / 4; c += 32)
      __pipeline_memcpy_async(gsm + i * width + 4 * c,
                              Gs + (size_t)i * ldgs + j0 + 4 * c, 16);
}

__global__ void __launch_bounds__(32 * ST_WARPS)
fused_rollout_state_kernel(const float* __restrict__ Gs,  // (D, ldgs)
                           const float* __restrict__ bs,  // (ldgs,)
                           const float* __restrict__ s0,  // (B, S)
                           const float* __restrict__ W,   // (B, n, nw)
                           float* __restrict__ A,      // (B, n, row_stride)
                           int* __restrict__ flags,    // (B, n)
                           float* __restrict__ s_fin,  // (B, S)
                           int B, int S, int nw, int n_outer, int w_off) {
  extern __shared__ float4 smem4[];
  const int D = nw + S, lda = row_stride(D);
  const int ldgs = 4 * state_groups(S);
  const int gc = ldgs < ST_GC ? ldgs : ST_GC;  // columns per chunk of G
  const int n_chunks = (ldgs + gc - 1) / gc;
  float* tiles = reinterpret_cast<float*>(smem4);  // 2 x (D, ST_LDS)
  const int tile_floats = D * ST_LDS;
  float* gsm = tiles + state_tiles_floats(D);      // (D, gc)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const int r = lane % ST_ROWS;                  // this thread's scenario
  const int gl = warp * ST_GPW + lane / ST_ROWS;  // and group in a chunk
  const int row0 = blockIdx.x * ST_ROWS;
  const int b = row0 + r;
  const size_t wstride = (size_t)n_outer * nw;

  stage_state_rows(W + (size_t)w_off * nw, wstride, nw, tiles, row0, B);
  stage_state_rows(s0, S, S, tiles + nw * ST_LDS, row0, B);
  if (n_chunks == 1) stage_state_columns(Gs, ldgs, D, 0, gc, gsm);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int t = 0; t < n_outer; ++t) {
    const float* cur = tiles + (t & 1) * tile_floats;
    float* nxt = tiles + ((t + 1) & 1) * tile_floats;  // read in step t - 1
    // Step t + 1's noise is in flight while step t runs.
    if (t + 1 < n_outer)
      stage_state_rows(W + (size_t)((t + 1 + w_off) % n_outer) * nw,
                       wstride, nw, nxt, row0, B);
    __pipeline_commit();
    // Row (b, t) of the product, [w | s_t | 0], a warp per row, and its
    // flag: 1 where a value of the row is not finite.
    for (int rr = warp; rr < ST_ROWS && row0 + rr < B; rr += n_warps) {
      const size_t row = (size_t)(row0 + rr) * n_outer + t;
      float* a = A + row * lda;
      bool bad = false;
      for (int k = lane; k < lda; k += 32) {
        const float v = k < D ? cur[k * ST_LDS + rr] : 0.f;
        a[k] = v;
        bad |= !isfinite(v);
      }
      const int any_bad = __any_sync(0xffffffffu, bad);
      if (lane == 0) flags[row] = any_bad;
    }
    // s_{t+1} = [w | s_t] @ G[:, :S] + bias[:S] into the next tile, one
    // chunk of G's state columns at a time.
    for (int ch = 0; ch < n_chunks; ++ch) {
      if (n_chunks > 1) {
        __syncthreads();  // the previous chunk's reads are done
        stage_state_columns(Gs, ldgs, D, ch * gc, gc, gsm);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      const int g = ch * (gc / 4) + gl;  // this thread's column group
      if (gl < gc / 4 && g < state_groups(S)) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float* gp = gsm + 4 * gl;
#pragma unroll 8
        for (int i = 0; i < D; ++i) {
          const float a = cur[i * ST_LDS + r];
          const float4 gv = *reinterpret_cast<const float4*>(gp + i * gc);
          acc[0] = fmaf(a, gv.x, acc[0]);
          acc[1] = fmaf(a, gv.y, acc[1]);
          acc[2] = fmaf(a, gv.z, acc[2]);
          acc[3] = fmaf(a, gv.w, acc[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * g + c;
          if (j >= S) break;
          const float v = __fadd_rn(acc[c], __ldg(bs + j));
          nxt[(nw + j) * ST_LDS + r] = v;
          if (t + 1 == n_outer && b < B) s_fin[(size_t)b * S + j] = v;
        }
      }
    }
    __pipeline_wait_prior(0);  // this thread's noise copies are in
    __syncthreads();  // everyone's, and s_{t+1}; step t's tile is free
  }
}

__global__ void __launch_bounds__(PR_THREADS, 2)
fused_rollout_product_kernel(
    const float* __restrict__ Gp,   // (n_tiles, n_pass, D_pad, PR_BN)
    const float* __restrict__ bp,   // (n_tiles, n_pass, PR_BN), aligned
    const int4* __restrict__ slots,  // (n_tiles, n_pass, PR_SLOTS)
    const int* __restrict__ slices,  // (n_tiles, n_pass, n_k + 1)
    const float* __restrict__ A,    // (R, lda): rows [w | s_t | 0]
    const int* __restrict__ flags,  // (R,): 1 where a row is not finite
    float* __restrict__ U,          // (R, Ku)
    float* __restrict__ Y,          // (R, Kp)
    float* __restrict__ C,          // (R, K)
    int R, int D, int Ku, int Kp, int K, int n_pass) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lda = row_stride(D);
  const int n_k = lda / PR_BK;
  const int tile = blockIdx.y;
  const int row0 = blockIdx.x * PR_BM;
  // Pass p of this tile streams the slices of D its list names (a count,
  // then every slice: the listed ones in ascending order, then the
  // others), and the others too where a row of the block holds a value
  // that is not finite (the skipped terms would be NaN). The rows' flags
  // are read now and voted on only when the ring first needs the vote,
  // so the read overlaps the first copies.
  const int flag = row0 + (int)threadIdx.x < R
                       ? __ldg(flags + row0 + threadIdx.x) : 0;
  int dense = -1;
  const int* list = slices + (size_t)tile * n_pass * (n_k + 1);
  auto listed = [&](int p) { return __ldg(list + (size_t)p * (n_k + 1)); };
  auto count = [&](int p) {
    if (dense < 0) dense = __syncthreads_or(flag);
    return dense ? n_k : listed(p);
  };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slot = lane % PR_SLOTS;
  // This thread's rows: m0 + 4 r (r < PR_TM), so a warp's 4 row groups
  // read 4 consecutive rows of A, which lie in 4 different bank groups.
  const int m0 = warp * 32 + lane / PR_SLOTS;
  // U and Y take 16-byte stores where rows keep them aligned.
  const bool vec_u = Ku % 4 == 0 && reinterpret_cast<size_t>(U) % 16 == 0;
  const bool vec_y = Kp % 4 == 0 && reinterpret_cast<size_t>(Y) % 16 == 0;

  const float4* gsrc = reinterpret_cast<const float4*>(
      Gp + (size_t)tile * n_pass * lda * PR_BN);
  // Ring slices staged: pm in all; the next is entry si of pass sp, whose
  // list has sl entries, slice kt (each read a stage ahead of its use).
  int pm = 0, sp = 0, si = 0, sl = listed(0), kt = __ldg(list + 1);
  auto stage = [&]() {
    if (sp < n_pass) {
      float* As = smem + (pm % PR_STAGES) * PR_STAGE_FLOATS;
      float* Gsm = As + PR_BM * PR_LDA;
      const int k0 = kt * PR_BK;
      // A: each row's PR_BK floats as 16-byte copies (zero past R).
      for (int c = threadIdx.x; c < PR_BM * PR_BK / 4; c += PR_THREADS) {
        const int m = c / (PR_BK / 4), h = c % (PR_BK / 4);
        float* d = As + m * PR_LDA + 4 * h;
        if (row0 + m < R)
          __pipeline_memcpy_async(d, A + (size_t)(row0 + m) * lda + k0 + 4 * h,
                                  16);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4* src =
          gsrc + ((size_t)sp * n_k + kt) * (PR_BK * PR_BN / 4);
      for (int v = threadIdx.x; v < PR_BK * PR_BN / 4; v += PR_THREADS)
        __pipeline_memcpy_async(Gsm + 4 * v, src + v, 16);
      // A pass's last slice brings its bias, read by the epilogue; the
      // vote is needed only once the list's end is reached.
      const bool last = si + 1 >= sl && si + 1 == count(sp);
      if (last) {
        const float4* bsrc = reinterpret_cast<const float4*>(
            bp + ((size_t)tile * n_pass + sp) * PR_BN);
        for (int v = threadIdx.x; v < PR_BN / 4; v += PR_THREADS)
          __pipeline_memcpy_async(Gsm + PR_BK * PR_BN + 4 * v, bsrc + v,
                                  16);
        si = 0;
        if (++sp < n_pass) sl = listed(sp);
      } else {
        ++si;
      }
      if (sp < n_pass) kt = __ldg(list + (size_t)sp * (n_k + 1) + 1 + si);
    }
    ++pm;
    __pipeline_commit();
  };
  for (int s = 0; s < PR_STAGES - 1; ++s) stage();

  float part[PR_TM];  // this slot's running cost per row
#pragma unroll
  for (int r = 0; r < PR_TM; ++r) part[r] = 0.f;
  int m = 0;  // ring slices consumed
  for (int p = 0; p < n_pass; ++p) {
    float acc[PR_TM][PR_NC];
#pragma unroll
    for (int r = 0; r < PR_TM; ++r)
#pragma unroll
      for (int c = 0; c < PR_NC; ++c) acc[r][c] = 0.f;
    const int n = count(p);  // the same for the whole block
    for (int i = 0; i < n; ++i, ++m) {
      __pipeline_wait_prior(PR_STAGES - 2);  // this thread's copies of
      __syncthreads();  // slice m are in, and everyone's; slice m - 1 is
                        // done, so its slot takes slice m + STAGES - 1
      stage();
      const float* As = smem + (m % PR_STAGES) * PR_STAGE_FLOATS;
      const float* Gsm = As + PR_BM * PR_LDA + slot * PR_LDC;
#pragma unroll
      for (int h = 0; h < PR_BK / 4; ++h) {
        float4 av[PR_TM];
#pragma unroll
        for (int r = 0; r < PR_TM; ++r)
          av[r] = *reinterpret_cast<const float4*>(
              As + (m0 + 4 * r) * PR_LDA + 4 * h);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a[PR_TM];
#pragma unroll
          for (int r = 0; r < PR_TM; ++r)
            a[r] = e == 0 ? av[r].x : e == 1 ? av[r].y
                 : e == 2 ? av[r].z : av[r].w;
          const float* g = Gsm + (4 * h + e) * PR_BN;
#pragma unroll
          for (int c4 = 0; c4 < PR_NC / 4; ++c4) {
            const float4 gv = *reinterpret_cast<const float4*>(g + 4 * c4);
            const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int r = 0; r < PR_TM; ++r)
                acc[r][4 * c4 + q] = fmaf(a[r], gg[q], acc[r][4 * c4 + q]);
          }
#pragma unroll
          for (int c = PR_NC / 4 * 4; c < PR_NC; ++c) {
            const float gc = g[c];
#pragma unroll
            for (int r = 0; r < PR_TM; ++r)
              acc[r][c] = fmaf(a[r], gc, acc[r][c]);
          }
        }
      }
    }

    // Epilogue from the registers; the bias is in the pass's last slice,
    // whose ring slot is next written after the next barrier.
    const size_t tp = (size_t)tile * n_pass + p;
    const int4 d = __ldg(slots + tp * PR_SLOTS + slot);
    const float* bias = smem + ((m - 1) % PR_STAGES) * PR_STAGE_FLOATS +
                        PR_BM * PR_LDA + PR_BK * PR_BN + slot * PR_LDC;
    if (d.x == SLOT_STORE) {
      const bool in_u = d.y < Ku;
      float* out = in_u ? U + d.y : Y + (d.y - Ku);
      const int ld = in_u ? Ku : Kp;
      const bool vec = in_u ? vec_u : vec_y;
      float bc[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) bc[c] = bias[c];
#pragma unroll
      for (int r = 0; r < PR_TM; ++r) {
        const int row = row0 + m0 + 4 * r;
        if (row >= R) break;
        float* o = out + (size_t)row * ld;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * e >= d.z) break;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = __fadd_rn(acc[r][4 * e + q], bc[4 * e + q]);
          if (vec && 4 * e + 4 <= d.z) {
            *reinterpret_cast<float4*>(o + 4 * e) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (4 * e + q < d.z) o[4 * e + q] = v[q];
          }
        }
      }
    } else if (d.x == SLOT_COST) {
      const int qc = (d.w & 2) ? d.z : -1;  // the q column, if here
      if (d.w & 1)
#pragma unroll
        for (int r = 0; r < PR_TM; ++r) part[r] = 0.f;
#pragma unroll
      for (int c = 0; c < PR_NC; ++c) {
        if (c > d.z || (c == d.z && qc < 0)) break;
        const float bc = bias[c];
#pragma unroll
        for (int r = 0; r < PR_TM; ++r) {
          const float z = __fadd_rn(acc[r][c], bc);
          part[r] = c < d.z ? fmaf(z, z, part[r]) : __fadd_rn(part[r], z);
        }
      }
      if (qc >= 0)
#pragma unroll
        for (int r = 0; r < PR_TM; ++r)
          if (row0 + m0 + 4 * r < R)
            C[(size_t)(row0 + m0 + 4 * r) * K + d.y] = part[r];
    }
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

// Shared memory of K3 for a given shape, in bytes.
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

// K1's plan at a state of S and nw noise rows, as 7 ints: scenarios per
// block of the state pass, its threads and shared memory in bytes; rows
// (b, t) per block of the product, its slots, columns per slot and
// shared memory. Returns 1 when both fit a block, else 0.
int fused_rollout_plan(int S, int nw, int* plan) {
  const size_t st = state_smem_bytes(S, nw);
  const int v[7] = {ST_ROWS, state_threads(S), (int)st, PR_BM, PR_SLOTS,
                    PR_NC, (int)product_smem_bytes()};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return st <= SMEM_LIMIT ? 1 : 0;
}

// Blocks per SM of K1's state pass (which = 0) or product (which = 1) at
// this shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor), 0 when the
// plan does not fit, or minus a CUDA error.
int fused_rollout_blocks_per_sm(int S, int nw, int which) {
  const size_t st = state_smem_bytes(S, nw);
  if (st > SMEM_LIMIT) return 0;
  const void* kernel = which ? (const void*)fused_rollout_product_kernel
                             : (const void*)fused_rollout_state_kernel;
  const size_t bytes = which ? product_smem_bytes() : st;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, which ? PR_THREADS : state_threads(S), bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Registers and local (spill) bytes per thread of K1's state pass
// (which = 0) or product (which = 1) (cudaFuncGetAttributes); returns 0
// or the CUDA error.
int fused_rollout_kernel_attributes(int which, int* registers,
                                    int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, which ? (const void*)fused_rollout_product_kernel
                : (const void*)fused_rollout_state_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Launches K1 on `stream`, the state pass and then the product; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when the
// plan does not fit or a packed operand is not 16-byte aligned. Device
// pointers to contiguous arrays: the packed operator of the state pass
// Gs (nw + S, 4 ceil(S/4)) and bs (4 ceil(S/4)); of the product Gp
// (n_tiles, n_pass, D_pad, 160) with D_pad = nw + S rounded up to 8, bp
// (n_tiles, n_pass, 160), the slot table (n_tiles, n_pass, 8, 4) and the
// slice lists (n_tiles, n_pass, D_pad / 8 + 1; a count of at least 1,
// then every slice, the listed ones first, each part ascending) of int32; s0 (B, S), W (B, n_outer,
// nw), the scratch A (B, n_outer, D_pad) of the product's rows
// [w | s_t | 0] and int32 flags (B, n_outer);
// outputs U (B, n_outer, Ku), Y (B, n_outer, Kp), C (B, n_outer, K) and
// s_fin (B, S). All float32 but the tables and the flags.
int fused_rollout_launch(const float* Gs, const float* bs, const float* Gp,
                         const float* bp, const int* slots,
                         const int* slices, const float* s0, const float* W,
                         float* A, int* flags, float* U, float* Y, float* C,
                         float* s_fin, int B, int S, int nw,
                         int Ku, int Kp, int K, int n_outer, int w_off,
                         int n_tiles, int n_pass, void* stream) {
  const size_t st = state_smem_bytes(S, nw);
  const size_t R = (size_t)B * n_outer;
  if (st > SMEM_LIMIT || n_tiles < 1 || n_tiles > 65535 || n_pass < 1 ||
      R > 0x7fffffff ||
      (reinterpret_cast<size_t>(Gs) | reinterpret_cast<size_t>(Gp) |
       reinterpret_cast<size_t>(bp) | reinterpret_cast<size_t>(slots) |
       reinterpret_cast<size_t>(A)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_state_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)st);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_rollout_product_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)product_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  fused_rollout_state_kernel<<<(B + ST_ROWS - 1) / ST_ROWS,
                               state_threads(S), st, s>>>(
      Gs, bs, s0, W, A, flags, s_fin, B, S, nw, n_outer, w_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + PR_BM - 1) / PR_BM), n_tiles);
  fused_rollout_product_kernel<<<grid, PR_THREADS, product_smem_bytes(),
                                 s>>>(
      Gp, bp, reinterpret_cast<const int4*>(slots), slices, A, flags, U, Y,
      C, (int)R, nw + S, Ku, Kp, K, n_pass);
  return (int)cudaGetLastError();
}

// Dynamic shared memory, in bytes, of the no-cost kernel (K3) at the
// plan it launches, or 0 when no plan fits.
int fused_rollout_nocost_smem_bytes(int S, int nw) {
  const int BM = nocost_tile_rows(S, nw);
  return BM ? (int)nocost_smem_bytes(S, nw, BM) : 0;
}

// Scenarios per K3 block at this shape: 64, 32, or 0 when neither plan
// fits one block.
int fused_rollout_nocost_tile_rows(int S, int nw) {
  return nocost_tile_rows(S, nw);
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
