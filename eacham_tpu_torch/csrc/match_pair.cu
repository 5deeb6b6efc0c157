// Single-pair fused descriptor matcher for Hopper (sm_90a), fp32, one launch.
//
// Replaces the Pallas kernel `_match_kernel` behind `match_pair_fused`
// (eacham_tpu/ops/match_kernel.py). For d1 [K1, 256] and d2 [K2, 256]
// (fp32, K1 != K2 allowed) it computes sim = d1 . d2^T with fp32 operands
// and fp32 FMAs (the reference runs this kernel under its "highest"
// matmul policy), masks dead keypoints, and reduces sim to the packed
// row-wise top-2 over all columns and the packed column-wise top-2 over
// 128-row tiles, merged across tiles with the reference's rule. The
// similarity matrix never reaches device memory.
//
// Packing, as in match_pairs.cu: q = round_half_even(sim * 16384); row
// entries pack (q << cbits) | column with cbits from the unpadded K2,
// column entries pack (q << 7) | row-within-the-128-row-tile; dead entries
// are IMIN = -2^30; the second best is the max over entries != top. Rows
// at or past K1 (the reference pads K1 to a multiple of 128 with masked
// rows) are treated as dead in the kernel: nothing is padded outside.
//
// What bounds it. One pair is only 2 * K1 * K2 * 256 FLOP (0.54 GFLOP at
// K = 1024: 8 us at the H100's 67 TFLOP/s fp32 rate, against 0.7 us for
// its 2.1 MB of descriptors at 3.35 TB/s, so operations bound it), and at
// that size a second launch and every stall that nothing hides is a large
// share of the whole. What the design does about it:
//
// - The grid runs over (64-row block, 64-column tile), 128 threads a block,
//   so that an SM holds two or three blocks and one block's barrier or load
//   hides behind another's FMAs. A 64-row block is half of a 128-row
//   packing tile: its column summaries carry the row index within the
//   128-row tile, and the two halves of a tile merge exactly (packed values
//   are unique within a tile).
// - The descriptor width arrives in four 64-wide slabs through `cp.async`
//   into two stages: slab s + 1 is in flight while slab s is multiplied.
//   Each thread owns 8 rows x 4 columns and sums the width in order, so the
//   similarities do not depend on the tiling.
// - One launch. Each block writes its partial summaries to scratch (per
//   row the top-2 over its 64 columns, per column the top-2 over its 64
//   rows), fences, and adds one to the arrival counter of its row block and
//   of its column tile. The block that arrives last for a row block merges
//   that block's rows across column tiles (exact in any order, packed
//   values being unique within a row); the one that arrives last for a
//   column tile merges its columns across row tiles in tile order with the
//   reference's rule (take_new = ctop > prev, second = max(prev second,
//   csec, min(prev, ctop))). The last arrival sets its counter back to 0,
//   so the counters, zero before the first launch, need no memset between
//   launches on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;          // descriptor width
constexpr int DS = 64;          // slab of the width held in shared memory
constexpr int NSLAB = D / DS;
constexpr int TR = 128;         // packing row tile (the reference's ROW_TILE)
constexpr int RBITS = 7;        // bit_length(TR - 1)
constexpr int RB = 64;          // rows of one block: half a packing tile
constexpr int TC = 64;          // column tile
constexpr int LD = DS + 4;      // smem row stride in floats: conflict-free float4 reads
constexpr int LDSIM = TC + 1;   // smem row stride of the similarity tile
constexpr int THREADS = 128;    // 8 x 16; each thread owns 8 rows x 4 columns
constexpr int STAGE = (RB + TC) * LD;   // floats of one stage (d1 rows, then d2 rows)
constexpr int MAX_TILES = 4096; // arrival counters per direction
constexpr int IMIN = -(1 << 30);
constexpr float QSCALE = 16384.0f;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM = size_t(2 * STAGE) * 4 + RB + TC;

static_assert(RB * LDSIM <= STAGE, "the similarity tile reuses stage 0");

__device__ __forceinline__ int pack(float s, int bits, int idx) {
  int q = __float2int_rn(s * QSCALE);  // round half to even, as jnp.round
  return int((unsigned(q) << bits) | unsigned(idx));
}

__device__ __forceinline__ void push(int v, int& top, int& sec) {
  if (v > top) {
    sec = top;
    top = v;
  } else if (v > sec) {
    sec = v;
  }
}

// merge two (top, second) summaries of disjoint sets of unique values
__device__ __forceinline__ void merge(int& top, int& sec, int otop, int osec) {
  int s = max(max(sec, osec), min(top, otop));
  top = max(top, otop);
  sec = s;
}

__device__ __forceinline__ float unpack(int v, int bits) {
  return v == IMIN ? NEG : float(v >> bits) / QSCALE;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16 bytes global -> shared without passing through registers; with
// src_bytes 0 the destination is filled with zeros and src is not read
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one DS-wide slab of 64 descriptor rows into smem, asynchronously; rows at
// or past `limit` (> 0) become zeros
__device__ __forceinline__ void load_slab(float* dst, const float* src, int first, int limit,
                                          int d0, int tid) {
#pragma unroll
  for (int e = tid; e < 64 * (DS / 4); e += THREADS) {
    const int r = e / (DS / 4), c = e % (DS / 4);
    const bool ok = first + r < limit;
    const int row = ok ? first + r : limit - 1;
    cp_async16(dst + r * LD + c * 4, src + size_t(row) * D + d0 + c * 4, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
match_pair_fused_kernel(const float* __restrict__ d1,      // [K1, D]
                        const float* __restrict__ d2,      // [K2, D]
                        const uint8_t* __restrict__ m1,    // [K1]
                        const uint8_t* __restrict__ m2,    // [K2]
                        int K1, int K2, int K1p, int cbits,
                        int* row_top,                      // [col tiles, K1p]
                        int* row_sec,
                        int* col_top,                      // [row blocks, K2]
                        int* col_sec,
                        int* cnt_row,                      // [row blocks], zero on entry
                        int* cnt_col,                      // [col tiles], zero on entry
                        float* __restrict__ b1, int* __restrict__ a1, float* __restrict__ s1,
                        float* __restrict__ b2, int* __restrict__ a2, float* __restrict__ s2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [2][RB + TC][LD]
  float* Ss = stage;                              // [RB][LDSIM], after the last slab
  uint8_t* live_r = reinterpret_cast<uint8_t*>(stage + 2 * STAGE);
  uint8_t* live_c = live_r + RB;
  __shared__ int last_flags;

  const int rb = blockIdx.x, ct = blockIdx.y;
  const int nrb = gridDim.x, nct = gridDim.y;
  const int r0 = rb * RB, c0 = ct * TC;
  const int rbase = r0 & (TR - 1);                // first row within its packing tile
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  load_slab(stage, d1, r0, K1, 0, tid);
  load_slab(stage + RB * LD, d2, c0, K2, 0, tid);
  cp_async_commit();

  if (tid < RB) live_r[tid] = (r0 + tid < K1) ? m1[r0 + tid] : 0;
  if (tid < TC) live_c[tid] = (c0 + tid < K2) ? m2[c0 + tid] : 0;

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;

  for (int s = 0; s < NSLAB; ++s) {
    cp_async_wait_all();
    __syncthreads();   // slab s has landed; everyone is done with slab s - 1
    if (s + 1 < NSLAB) {
      float* nxt = stage + ((s + 1) & 1) * STAGE;
      load_slab(nxt, d1, r0, K1, (s + 1) * DS, tid);
      load_slab(nxt + RB * LD, d2, c0, K2, (s + 1) * DS, tid);
      cp_async_commit();
    }
    const float* As = stage + (s & 1) * STAGE;
    const float* Bs = As + RB * LD;
#pragma unroll 2
    for (int d4 = 0; d4 < DS / 4; ++d4) {
      float4 a[8], b[4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = *reinterpret_cast<const float4*>(As + (ty + 8 * u) * LD + d4 * 4);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        b[w] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * w) * LD + d4 * 4);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = dot4(a[u], b[w], acc[u][w]);
    }
  }
  // the last slab sat in stage 1, and every thread left stage 0 before the
  // last barrier: the similarity tile may overwrite stage 0
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) Ss[(ty + 8 * u) * LDSIM + tx + 16 * w] = acc[u][w];
  __syncthreads();

  {  // rows: two threads per row, 32 columns each, merged with the partner lane
    const int r = tid >> 1, h = tid & 1;
    int top = IMIN, sec = IMIN;
    if (live_r[r]) {
      for (int c = h * 32; c < h * 32 + 32; ++c)
        push(live_c[c] ? pack(Ss[r * LDSIM + c], cbits, c0 + c) : IMIN, top, sec);
    }
    merge(top, sec, __shfl_xor_sync(FULL, top, 1), __shfl_xor_sync(FULL, sec, 1));
    if (h == 0) {
      row_top[size_t(ct) * K1p + r0 + r] = top;
      row_sec[size_t(ct) * K1p + r0 + r] = sec;
    }
  }
  {  // columns: two threads per column, 32 interleaved rows each
    const int c = tid >> 1, h = tid & 1;
    int top = IMIN, sec = IMIN;
    if (live_c[c]) {
      for (int i = 0; i < RB / 2; ++i) {
        const int r = i * 2 + h;
        push(live_r[r] ? pack(Ss[r * LDSIM + c], RBITS, rbase + r) : IMIN, top, sec);
      }
    }
    merge(top, sec, __shfl_xor_sync(FULL, top, 1), __shfl_xor_sync(FULL, sec, 1));
    if (h == 0 && c0 + c < K2) {
      col_top[size_t(rb) * K2 + c0 + c] = top;
      col_sec[size_t(rb) * K2 + c0 + c] = sec;
    }
  }

  // arrival: the partial summaries are visible device-wide before the counts move
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int seen_r = atomicAdd(&cnt_row[rb], 1);
    const int seen_c = atomicAdd(&cnt_col[ct], 1);
    int flags = 0;
    if (seen_r == nct - 1) {
      flags |= 1;
      cnt_row[rb] = 0;   // every block of this row block has arrived
    }
    if (seen_c == nrb - 1) {
      flags |= 2;
      cnt_col[ct] = 0;
    }
    __threadfence();
    last_flags = flags;
  }
  __syncthreads();
  const int flags = last_flags;

  if (flags & 1) {  // last of this row block: its rows across all column tiles
    const int r = tid >> 1, h = tid & 1;
    int top = IMIN, sec = IMIN;
    for (int t = h; t < nct; t += 2)
      merge(top, sec, __ldcg(row_top + size_t(t) * K1p + r0 + r),
            __ldcg(row_sec + size_t(t) * K1p + r0 + r));
    merge(top, sec, __shfl_xor_sync(FULL, top, 1), __shfl_xor_sync(FULL, sec, 1));
    if (h == 0 && r0 + r < K1) {
      b1[r0 + r] = unpack(top, cbits);
      a1[r0 + r] = top & ((1 << cbits) - 1);
      s1[r0 + r] = unpack(sec, cbits);
    }
  }
  if ((flags & 2) && tid < TC && c0 + tid < K2) {
    // last of this column tile: its columns across the row tiles, in order;
    // the two 64-row halves of a packing tile merge exactly first
    const int c = c0 + tid;
    int cmax = IMIN, csec = IMIN, carg = 0;
    for (int t = 0; 2 * t < nrb; ++t) {
      int top = __ldcg(col_top + size_t(2 * t) * K2 + c);
      int sec = __ldcg(col_sec + size_t(2 * t) * K2 + c);
      if (2 * t + 1 < nrb)
        merge(top, sec, __ldcg(col_top + size_t(2 * t + 1) * K2 + c),
              __ldcg(col_sec + size_t(2 * t + 1) * K2 + c));
      if (t == 0) {
        cmax = top;
        csec = sec;
        carg = top & (TR - 1);
      } else {
        const int prev = cmax;
        csec = max(max(csec, sec), min(prev, top));
        if (top > prev) {
          cmax = top;
          carg = (top & (TR - 1)) + t * TR;
        }
      }
    }
    b2[c] = unpack(cmax, RBITS);
    a2[c] = carg;
    s2[c] = unpack(csec, RBITS);
  }
}

}  // namespace

extern "C" {

// Number of int32 arrival counters the launch needs: a buffer that is zero
// before its first launch and is left zero by every launch.
int match_pair_counter_ints() { return 2 * MAX_TILES; }

// Number of int32 values of scratch the launch needs (contents do not matter).
long long match_pair_scratch_ints(int K1, int K2) {
  const long long rb = (K1 + RB - 1) / RB, ct = (K2 + TC - 1) / TC;
  return 2 * (ct * rb * RB + rb * K2);
}

// Launches the kernel, once, on `stream`; returns the cudaError_t of the launch.
int match_pair_launch(const void* d1, const void* d2, const void* m1, const void* m2,
                      int K1, int K2, int cbits, void* counters, void* scratch,
                      void* b1, void* a1, void* s1, void* b2, void* a2, void* s2,
                      void* stream) {
  if (K1 <= 0 || K2 <= 0) return int(cudaSuccess);
  const int rb = (K1 + RB - 1) / RB, ct = (K2 + TC - 1) / TC;
  if (rb > MAX_TILES || ct > MAX_TILES) return int(cudaErrorInvalidValue);
  const int K1p = rb * RB;
  int* row_top = static_cast<int*>(scratch);
  int* row_sec = row_top + size_t(ct) * K1p;
  int* col_top = row_sec + size_t(ct) * K1p;
  int* col_sec = col_top + size_t(rb) * K2;
  int* cnt_row = static_cast<int*>(counters);
  int* cnt_col = cnt_row + MAX_TILES;
  cudaError_t err = cudaFuncSetAttribute(
      match_pair_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  match_pair_fused_kernel<<<dim3(rb, ct), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d1), static_cast<const float*>(d2),
      static_cast<const uint8_t*>(m1), static_cast<const uint8_t*>(m2),
      K1, K2, K1p, cbits, row_top, row_sec, col_top, col_sec, cnt_row, cnt_col,
      static_cast<float*>(b1), static_cast<int*>(a1), static_cast<float*>(s1),
      static_cast<float*>(b2), static_cast<int*>(a2), static_cast<float*>(s2));
  return int(cudaGetLastError());
}

const char* match_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
