// Batched fused descriptor matcher for Hopper (sm_90a): TMA-fed wgmma
// products, top-2 reductions straight from the accumulator registers.
//
// Replaces the Pallas kernel `_match_batch_kernel` behind
// `match_pairs_fused` (eacham_tpu/ops/match_kernel.py). For every frame
// pair p = (i, j) it computes sim = d_i . d_j^T (bf16 operands, fp32
// accumulation) with dead keypoints masked, and reduces it to the packed
// row-wise top-2 (best, argmax, second) over all columns and the packed
// column-wise top-2 over 128-row tiles, merged across tiles with the
// reference's rule. The similarity matrix never leaves the SM.
//
// Packing (exactly the reference's): q = round_half_even(sim * 16384);
// row entries pack (q << cbits) | column, column entries pack
// (q << 7) | row-within-the-128-row-tile; dead entries are IMIN = -2^30;
// the second best is the max over entries != top. Packed values are
// unique within a row and within a tile's column, so partial top-2
// summaries merge exactly, in any order: top = max(a, b), sec = max(sec_a,
// sec_b, min(a, b)). Across 128-row tiles the reference's merge is applied
// as written: take_new = ctop > prev, sec = max(prev_sec, csec,
// min(prev, ctop)).
//
// What bounds it on this card. At the bench's shapes (N=100, Kp=512,
// P=5120) the products are 6.9e11 FLOP, 0.69 ms at the 989 TFLOP/s of the
// bf16 tensor cores, over 26 MB of unique descriptor bytes (8 us): bound by
// operations. The reductions are as heavy as the products: every one of
// the Kp^2 similarities is quantized, packed twice and pushed into two
// top-2 summaries, about ten instructions each, most of them integer
// minima and maxima, which this card issues at half the fp32 rate. Per
// 128 x 128 tile a warp's reductions take longer than the tensor cores need
// for the tile's products, so the design has to keep both pipes busy at
// once, keep the similarities in registers, and count instructions.
//
// Design: one block per pair, three warpgroups, one block per SM.
// - A producer warp drives the TMA: frame i's 128-row tile (64 KB, four
//   boxes of 128 rows x 64 bf16 in the 128-byte swizzle) is loaded once per
//   row tile and stays; frame j's 128-column tiles (64 KB each) stream
//   through a ring of two stages. Both come straight from the
//   [N * Kp, 256] table through one 2-D tensor map: each block reads its
//   own pair indices, there is no [P, K, D] gather. mbarriers (full /
//   empty per buffer) carry the hand-over; the producer warpgroup gives
//   its registers away (setmaxnreg 40), the consumers take 232.
// - Two consumer warpgroups take turns on the column tiles (tile T goes to
//   warpgroup T % 2, which owns ring stage T % 2). Each computes the whole
//   128 x 128 tile as two wgmma.m64n128k16 chains (rows 0-63, 64-127; A and
//   B both K-major from shared memory, 16 k-steps) into 128 accumulator
//   registers a thread, then reduces it from those registers while the
//   other warpgroup's products run on the tensor cores: this is where the
//   epilogue overlaps the products. A pair of named barriers hands the
//   tensor cores from one warpgroup to the other; left to themselves both
//   multiply at once and reduce at once. No similarity tile in shared
//   memory.
// - Epilogue, per accumulator: quantize with one FMA against 1.5 * 2^23
//   (round half to even, exact for |q| < 2^22; the float's bits are
//   q + 0x4B400000) and pack twice with one integer multiply-add each, the
//   constant folded into the addends; a dead row is folded into the
//   multiplier and addend of its column packing (0 and IMIN), a tile
//   without a dead column takes a path without the select. Row top-2: the
//   thread's two values of a column pair are pushed together into the
//   running summary of their row (five instructions with the three-input
//   maximum, a DPX instruction), which lives in registers across the whole
//   row tile; merged over the quad and the two warpgroups once per row
//   tile. Column top-2: over the thread's four rows (seven instructions),
//   then over the 8 lanes that share a column pair by a reduce-scatter
//   with shuffles (three steps that halve the slots a lane keeps: 28
//   merges a thread where a butterfly takes 96; redux.sync on lane subsets
//   is far slower than either), then over the warpgroup's 4 warps
//   through 8 KB of shared memory, then the cross-tile rule against the
//   column state (3 x Kp int32 in shared memory, which bounds Kp: see
//   match_pairs_max_kp).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;            // descriptor width
constexpr int TR = 128;           // row tile (the reference's ROW_TILE)
constexpr int RBITS = 7;          // bit_length(TR - 1)
constexpr int TC = 128;           // column tile
constexpr int BOX_K = 64;         // bf16 per TMA box row: 128 bytes, the swizzle's width
constexpr int KCHUNKS = D / BOX_K;
constexpr int BOX_BYTES = TR * BOX_K * 2;         // 16 KB: 128 rows of 128 bytes
constexpr int TILE_BYTES = KCHUNKS * BOX_BYTES;   // 64 KB: a 128 x 256 bf16 tile
constexpr int STAGES = 2;         // column-tile ring, one stage per consumer warpgroup
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int IMIN = -(1 << 30);
constexpr float QSCALE = 16384.0f;
constexpr float QMAGIC = 12582912.0f;             // 1.5 * 2^23
constexpr int QMAGIC_BITS = 0x4B400000;
constexpr float NEG = -1e30f;
constexpr int SMEM_LIMIT = 227 * 1024;

// shared-memory layout past the 1024-byte aligned tiles
struct Layout {
  int col_state, col_buf, row_buf, live, bars, total;
};

__host__ __device__ inline Layout layout(int Kp) {
  Layout l;
  l.col_state = (1 + STAGES) * TILE_BYTES;        // top, arg, sec: 3 x Kp int32
  l.col_buf = l.col_state + 3 * Kp * 4;           // [2 warpgroups][2][4 warps][TC] int2
  l.row_buf = l.col_buf + 2 * 2 * 4 * TC * 8;     // [2][2 warpgroups][TR] int2
  l.live = l.row_buf + 2 * 2 * TR * 8;            // live bits of frame i, frame j
  l.bars = l.live + 2 * (Kp / 32) * 4;            // 2 + 2 * STAGES mbarriers
  l.total = l.bars + (2 + 2 * STAGES) * 8 + 1024; // + slack to align the base
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one 128-row x 64-bf16 box of the table at (row, k) into swizzled smem
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int k, int row,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// a 128 x 256 tile of the table, rows row .. row + 127, as four boxes
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int row,
                                         uint32_t bar) {
  mbar_expect_tx(bar, TILE_BYTES);
#pragma unroll
  for (int kc = 0; kc < KCHUNKS; ++kc)
    tma_box(dst + kc * BOX_BYTES, map, kc * BOX_K, row, bar);
}

// K-major operand in the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32)
         | (uint64_t(1) << 62);
}

// d (+)= A . B^T for one 64-row half: A [64, 16] and B [128, 16], both K-major
// in shared memory behind their descriptors; d = A . B^T when !accumulate
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// the non-blocking half of a named barrier: count this thread in and go on
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// merge two (top, second) summaries of disjoint sets of unique values
__device__ __forceinline__ void merge(int& top, int& sec, int otop, int osec) {
  int s = __vimax3_s32(sec, osec, min(top, otop));
  top = max(top, otop);
  sec = s;
}

// push two values at once: five instructions with the three-input maximum
// (a DPX instruction on this card) where two single pushes take six
__device__ __forceinline__ void push2(int a, int b, int& top, int& sec) {
  const int mx = max(a, b), mn = min(a, b);
  sec = __vimax3_s32(sec, mn, min(top, mx));
  top = max(top, mx);
}

__device__ __forceinline__ float unpack(int v, int bits) {
  return v == IMIN ? NEG : float(v >> bits) / QSCALE;
}

// top-2 of four values: two compare-exchanges, then the winners and the rest
__device__ __forceinline__ void top2_of4(int a, int b, int c, int d, int& top, int& sec) {
  const int m1 = max(a, b), n1 = min(a, b), m2 = max(c, d), n2 = min(c, d);
  top = max(m1, m2);
  sec = __vimax3_s32(min(m1, m2), n1, n2);
}

// One step of the reduction of column summaries over the 8 lanes that share
// a column pair: the lane keeps the slots of its side (`upper`), hands the
// others to its partner `lane ^ xor_lanes`, and merges what it gets back.
template <int N>
__device__ __forceinline__ void scatter_merge(int (&top)[2 * N][2], int (&sec)[2 * N][2],
                                              int (&otop)[N][2], int (&osec)[N][2],
                                              int step, bool upper, int xor_lanes) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // slots a and b differ in the bit of the slot number that this step settles
    const int a = (k / step) * 2 * step + (k % step), b = a + step;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int give_t = upper ? top[a][c] : top[b][c], give_s = upper ? sec[a][c] : sec[b][c];
      int keep_t = upper ? top[b][c] : top[a][c], keep_s = upper ? sec[b][c] : sec[a][c];
      merge(keep_t, keep_s, __shfl_xor_sync(0xffffffffu, give_t, xor_lanes),
            __shfl_xor_sync(0xffffffffu, give_s, xor_lanes));
      otop[k][c] = keep_t;
      osec[k][c] = keep_s;
    }
  }
}

// The reductions of one 128 x 128 tile from the warpgroup's accumulators:
// pushes every similarity into the thread's running row summaries, and
// writes the warp's column summaries (over its 32 rows) to `cb`.
// `all_live`: no column of the tile is dead, so no select is needed.
template <bool all_live>
__device__ __forceinline__ void reduce_tile(const float (&acc)[2][64], int (&rtop)[2][2],
                                            int (&rsec)[2][2], const int (&mul_r)[2][2],
                                            const int (&add_r)[2][2], const uint32_t (&cm)[TC / 32],
                                            int mul_c, int add_c, int2* cb, int lane) {
  int vtop[TC / 8][2], vsec[TC / 8][2];
#pragma unroll
  for (int n = 0; n < TC / 8; ++n) {
    int rp[2][2][2], cp[2][2][2];      // [c][h][r]
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool col_alive = all_live || ((cm[n >> 2] >> (8 * (n & 3) + c)) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the float's bits are q + QMAGIC_BITS, q = round_half_even(sim * 16384);
          // the constant is folded into both packings' addends
          const int fb = __float_as_int(fmaf(acc[h][4 * n + 2 * r + c], QSCALE, QMAGIC));
          const int packed = int(unsigned(fb) * unsigned(mul_c)) + (add_c + 8 * n + c);
          rp[c][h][r] = col_alive ? packed : IMIN;                  // (q << cbits) | column
          cp[c][h][r] = int(unsigned(fb) * unsigned(mul_r[h][r])) + add_r[h][r];   // (q << 7) | row
        }
      top2_of4(cp[c][0][0], cp[c][0][1], cp[c][1][0], cp[c][1][1], vtop[n][c], vsec[n][c]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) push2(rp[0][h][r], rp[1][h][r], rtop[h][r], rsec[h][r]);
  }
  // over the 8 lanes (g = 0..7) that share the column pair: slot n ends on lane g = n % 8
  int t8[8][2], s8[8][2], t4[4][2], s4[4][2], t2[2][2], s2[2][2];
  scatter_merge<8>(vtop, vsec, t8, s8, 4, lane & 16, 16);
  scatter_merge<4>(t8, s8, t4, s4, 2, lane & 8, 8);
  scatter_merge<2>(t4, s4, t2, s2, 1, lane & 4, 4);

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)     // columns 8 (8 i + g) + 2 t, + 1
    *reinterpret_cast<int4*>(cb + 64 * i + 8 * g + 2 * t) =
        make_int4(t2[i][0], s2[i][0], t2[i][1], s2[i][1]);
}

__global__ void __launch_bounds__(THREADS, 1)
match_pairs_kernel(const __grid_constant__ CUtensorMap table,   // [N * Kp, D] bf16
                   const uint8_t* __restrict__ mask,            // [N, Kp]
                   const int* __restrict__ pairs,               // [P, 2]
                   int Kp, int cbits,
                   float* __restrict__ b1, int* __restrict__ a1, float* __restrict__ s1,
                   float* __restrict__ b2, int* __restrict__ a2, float* __restrict__ s2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay = layout(Kp);
  int* col_top = reinterpret_cast<int*>(smem + lay.col_state);
  int* col_arg = col_top + Kp;
  int* col_sec = col_arg + Kp;
  int2* col_buf = reinterpret_cast<int2*>(smem + lay.col_buf);
  int2* row_buf = reinterpret_cast<int2*>(smem + lay.row_buf);
  uint32_t* live_i = reinterpret_cast<uint32_t*>(smem + lay.live);
  uint32_t* live_j = live_i + Kp / 32;
  const uint32_t tile_a = smem_u32(smem);
  const uint32_t tile_b = tile_a + TILE_BYTES;            // + stage * TILE_BYTES
  const uint32_t bars = smem_u32(smem + lay.bars);
  const uint32_t full_a = bars, empty_a = bars + 8;
  const uint32_t full_b = bars + 16, empty_b = bars + 16 + 8 * STAGES;   // + 8 * stage

  const int p = blockIdx.x;
  const int fi = pairs[2 * p];
  const int fj = pairs[2 * p + 1];
  const size_t out = size_t(p) * Kp;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nrt = Kp / TR;       // row tiles
  const int nct = Kp / TC;       // column tiles per row tile

  if (tid == 0) {
    mbar_init(full_a, 1);
    mbar_init(empty_a, CONSUMERS / 32);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer warpgroup: one thread feeds the TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS) {
      for (int rt = 0; rt < nrt; ++rt) {
        for (int ct = 0; ct < nct; ++ct) {
          const int T = rt * nct + ct, s = T % STAGES, round = T / STAGES;
          mbar_wait(empty_b + 8 * s, (round & 1) ^ 1);
          tma_tile(tile_b + s * TILE_BYTES, &table, fj * Kp + ct * TC, full_b + 8 * s);
          if (ct == 0) {   // the row tile after its first column tile: that one was free earlier
            mbar_wait(empty_a, (rt & 1) ^ 1);
            tma_tile(tile_a, &table, fi * Kp + rt * TR, full_a);
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, taking turns on the column tiles ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // one bit per keypoint of either frame, while the first tiles are on their way
    for (int w = warp; w < 2 * (Kp / 32); w += CONSUMERS / 32) {
      const int f = w < Kp / 32 ? fi : fj;
      const int k = (w < Kp / 32 ? w : w - Kp / 32) * 32 + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, mask[size_t(f) * Kp + k] != 0);
      if (lane == 0) live_i[w] = bits;
    }
    named_barrier(1, CONSUMERS);
    const int wg = warp >> 2;          // warpgroup, and its ring stage
    const int wq = warp & 3;           // warp within the warpgroup: rows 16 wq .. 16 wq + 15
    const int ctid = tid & 127;        // thread within the warpgroup
    const int g = lane >> 2;           // accumulator row within 8
    const int t = lane & 3;            // accumulator column pair within 8
    int2* my_col_buf = col_buf + wg * (2 * 4 * TC);
    const int mul_c = 1 << cbits;
    // The tensor cores go to one warpgroup at a time, in turns: a warpgroup
    // waits for the other's products to be issued (barrier 4 + wg), issues
    // its own, hands over (barrier 4 + other) and reduces its tile while the
    // other's products run. Without the turns both warpgroups multiply at
    // once and reduce at once, and nothing overlaps.
    if (wg == 1) named_barrier_arrive(4, CONSUMERS);     // warpgroup 0 goes first
    int tiles_done = 0;                // of this warpgroup: parity of its stage and buffers

    for (int rt = 0; rt < nrt; ++rt) {
      // the thread's four rows of the tile: 64 h + 16 wq + 8 r + g
      int mul_r[2][2], add_r[2][2], rtop[2][2], rsec[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * h + 16 * wq + 8 * r + g;
          const bool alive = (live_i[rt * (TR / 32) + (row >> 5)] >> (row & 31)) & 1;
          mul_r[h][r] = alive ? TR : 0;        // a dead row packs to IMIN in every column
          add_r[h][r] = alive ? int(unsigned(row) - unsigned(QMAGIC_BITS) * TR) : IMIN;   // less the float's bias
          rtop[h][r] = IMIN;
          rsec[h][r] = IMIN;
        }

      mbar_wait(full_a, rt & 1);
      int last = -1;                   // this warpgroup's last column tile of the row tile
      for (int ct = 0; ct < nct; ++ct)
        if ((rt * nct + ct) % STAGES == wg) last = ct;
      if (last < 0 && lane == 0) mbar_arrive(empty_a);

      for (int ct = 0; ct < nct; ++ct) {
        if ((rt * nct + ct) % STAGES != wg) continue;
        mbar_wait(full_b + 8 * wg, tiles_done & 1);
        named_barrier(4 + wg, CONSUMERS);

        float acc[2][64];
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k16 = 0; k16 < D / 16; ++k16) {
          // 64 bf16 a box: box k16 / 4, 32 bytes a k-step inside its 128-byte rows
          const uint32_t koff = (k16 >> 2) * BOX_BYTES + (k16 & 3) * 32;
          const uint64_t db = wgmma_desc(tile_b + wg * TILE_BYTES + koff);
          wgmma_m64n128k16(acc[0], wgmma_desc(tile_a + koff), db, k16 != 0);
          wgmma_m64n128k16(acc[1], wgmma_desc(tile_a + koff + 64 * 128), db, k16 != 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        named_barrier_arrive(4 + (wg ^ 1), CONSUMERS);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (lane == 0) {
          mbar_arrive(empty_b + 8 * wg);
          if (ct == last) mbar_arrive(empty_a);
        }

        // ---- the epilogue, from the accumulators ----
        uint32_t cm[TC / 32];            // live bits of the thread's columns 8 n + 2 t + c
        bool all_live = true;
#pragma unroll
        for (int w = 0; w < TC / 32; ++w) {
          const uint32_t bits = live_j[ct * (TC / 32) + w];
          all_live = all_live && bits == 0xffffffffu;
          cm[w] = bits >> (2 * t);
        }
        int2* cb = my_col_buf + (tiles_done & 1) * (4 * TC) + wq * TC;
        const int add_c = int(unsigned(ct * TC + 2 * t) - unsigned(QMAGIC_BITS) * unsigned(mul_c));
        if (all_live)
          reduce_tile<true>(acc, rtop, rsec, mul_r, add_r, cm, mul_c, add_c, cb, lane);
        else
          reduce_tile<false>(acc, rtop, rsec, mul_r, add_r, cm, mul_c, add_c, cb, lane);
        named_barrier(2 + wg, 128);      // the four warps' column summaries are written
        {
          const int gc = ct * TC + ctid;
          int top = IMIN, sec = IMIN;
          if ((live_j[gc >> 5] >> (gc & 31)) & 1) {
            const int2* src = my_col_buf + (tiles_done & 1) * (4 * TC) + ctid;
#pragma unroll
            for (int w = 0; w < 4; ++w) merge(top, sec, src[w * TC].x, src[w * TC].y);
          }
          const int carg = (top & (TR - 1)) + rt * TR;
          if (rt == 0) {
            col_top[gc] = top;
            col_arg[gc] = carg;
            col_sec[gc] = sec;
          } else {
            const int prev = col_top[gc];
            col_sec[gc] = max(max(col_sec[gc], sec), min(prev, top));
            if (top > prev) {
              col_top[gc] = top;
              col_arg[gc] = carg;
            }
          }
        }
        ++tiles_done;
      }

      // rows: over the quad, then over the two warpgroups
      int2* rb = row_buf + (rt & 1) * (2 * TR);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int sh = 1; sh <= 2; sh <<= 1)
            merge(rtop[h][r], rsec[h][r], __shfl_xor_sync(0xffffffffu, rtop[h][r], sh),
                  __shfl_xor_sync(0xffffffffu, rsec[h][r], sh));
          if (t == 0) rb[wg * TR + 64 * h + 16 * wq + 8 * r + g] = make_int2(rtop[h][r], rsec[h][r]);
        }
      // also orders this row tile's column-state updates before the next one's
      named_barrier(1, CONSUMERS);
      if (wg == 0) {
        const int row = ctid;
        int top = IMIN, sec = IMIN;
        if ((live_i[rt * (TR / 32) + (row >> 5)] >> (row & 31)) & 1) {
          top = rb[row].x;
          sec = rb[row].y;
          merge(top, sec, rb[TR + row].x, rb[TR + row].y);
        }
        b1[out + rt * TR + row] = unpack(top, cbits);
        a1[out + rt * TR + row] = top & ((1 << cbits) - 1);
        s1[out + rt * TR + row] = unpack(sec, cbits);
      }
    }

    for (int c = tid; c < Kp; c += CONSUMERS) {
      b2[out + c] = unpack(col_top[c], RBITS);
      a2[out + c] = col_arg[c];
      s2[out + c] = unpack(col_sec[c], RBITS);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time in the loaded libcuda (which is not linked)
EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

}  // namespace

extern "C" {

// Largest padded keypoint count one block's shared memory can hold.
int match_pairs_max_kp() {
  int kp = TR;
  while (layout(kp + TR).total <= SMEM_LIMIT) kp += TR;
  return kp;
}

// Launches the matcher on `stream`; returns the cudaError_t of the launch.
// `desc` is the [N, Kp, 256] bf16 table, 16-byte aligned; the tensor map
// over it is encoded here, for this call only.
int match_pairs_launch(const void* desc, const void* mask, const void* pairs,
                       int N, int P, int Kp, int cbits,
                       void* b1, void* a1, void* s1, void* b2, void* a2, void* s2,
                       void* stream) {
  if (P <= 0) return int(cudaSuccess);
  const Layout lay = layout(Kp);
  if (Kp <= 0 || Kp % TR || lay.total > SMEM_LIMIT || N <= 0
      || reinterpret_cast<uintptr_t>(desc) % 16)
    return int(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (!encode) return int(cudaErrorNotSupported);
  CUtensorMap table;
  const cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(N) * cuuint64_t(Kp)};
  const cuuint64_t strides[1] = {cuuint64_t(D) * 2};
  const cuuint32_t box[2] = {cuuint32_t(BOX_K), cuuint32_t(TR)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&table, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(desc), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
      != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      match_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return int(err);
  match_pairs_kernel<<<P, THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const uint8_t*>(mask), static_cast<const int*>(pairs), Kp, cbits,
      static_cast<float*>(b1), static_cast<int*>(a1), static_cast<float*>(s1),
      static_cast<float*>(b2), static_cast<int*>(a2), static_cast<float*>(s2));
  return int(cudaGetLastError());
}

const char* match_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
