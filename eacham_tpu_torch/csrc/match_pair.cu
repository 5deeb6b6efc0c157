// Single-pair fused descriptor matcher for Hopper (sm_90a), fp32.
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
// Layout. One pair is only 2 * K1 * K2 * 256 FLOP (0.54 GFLOP at
// K = 1024: 8 us at the H100's 67 TFLOP/s fp32 rate, against 0.7 us for
// its 2.1 MB of descriptors at 3.35 TB/s, so operations bound it), and a
// single block looping over row tiles would leave 131 of 132 SMs idle. So
// the grid runs over (128-row tile, 64-column tile): each block computes
// one 128 x 64 similarity tile, looping over the descriptor width in
// 64-wide slabs, and writes its partial summaries to scratch: per row the
// (top, second) over its 64 columns, per column the (top, second) over its
// 128 rows. A second, small kernel merges them: rows across column tiles
// (exact in any order, packed values being unique within a row), columns
// across row tiles in order with the reference's rule (take_new =
// ctop > prev, second = max(prev second, csec, min(prev, ctop))).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;          // descriptor width
constexpr int DS = 64;          // slab of the width held in shared memory
constexpr int TR = 128;         // row tile (the reference's ROW_TILE)
constexpr int RBITS = 7;        // bit_length(TR - 1)
constexpr int TC = 64;          // column tile
constexpr int LD = DS + 4;      // smem row stride in floats: conflict-free float4 reads
constexpr int LDSIM = TC + 1;   // smem row stride of the similarity tile
constexpr int THREADS = 256;    // 16 x 16; each thread owns 8 rows x 4 columns
constexpr int IMIN = -(1 << 30);
constexpr float QSCALE = 16384.0f;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM = size_t(TR + TC) * LD * 4 + size_t(TR) * LDSIM * 4 + TR + TC;

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

// one DS-wide slab of `rows` descriptor rows into smem; rows past `limit` are zeros
__device__ __forceinline__ void load_slab(float* dst, const float* src, int rows, int first,
                                          int limit, int d0, int tid) {
  for (int e = tid; e < rows * (DS / 4); e += THREADS) {
    const int r = e / (DS / 4), c = e % (DS / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < limit)
      val = *reinterpret_cast<const float4*>(src + size_t(first + r) * D + d0 + c * 4);
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
match_pair_tiles(const float* __restrict__ d1,      // [K1, D]
                 const float* __restrict__ d2,      // [K2, D]
                 const uint8_t* __restrict__ m1,    // [K1]
                 const uint8_t* __restrict__ m2,    // [K2]
                 int K1, int K2, int K1p, int cbits,
                 int* __restrict__ row_top,         // [col tiles, K1p]
                 int* __restrict__ row_sec,
                 int* __restrict__ col_top,         // [row tiles, K2]
                 int* __restrict__ col_sec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);     // [TR][LD]
  float* Bs = As + TR * LD;                       // [TC][LD]
  float* Ss = Bs + TC * LD;                       // [TR][LDSIM]
  uint8_t* live_r = reinterpret_cast<uint8_t*>(Ss + TR * LDSIM);
  uint8_t* live_c = live_r + TR;

  const int rt = blockIdx.x, ct = blockIdx.y;
  const int r0 = rt * TR, c0 = ct * TC;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  if (tid < TR) live_r[tid] = (r0 + tid < K1) ? m1[r0 + tid] : 0;
  if (tid < TC) live_c[tid] = (c0 + tid < K2) ? m2[c0 + tid] : 0;

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DS) {
    if (d0) __syncthreads();   // the previous slab's reads are done
    load_slab(As, d1, TR, r0, K1, d0, tid);
    load_slab(Bs, d2, TC, c0, K2, d0, tid);
    __syncthreads();
#pragma unroll 2
    for (int d4 = 0; d4 < DS / 4; ++d4) {
      float4 a[8], b[4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = *reinterpret_cast<const float4*>(As + (ty + 16 * u) * LD + d4 * 4);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        b[w] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * w) * LD + d4 * 4);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = dot4(a[u], b[w], acc[u][w]);
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) Ss[(ty + 16 * u) * LDSIM + tx + 16 * w] = acc[u][w];
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
  {  // columns: four threads per column, 32 interleaved rows each
    const int c = tid >> 2, qd = tid & 3;
    int top = IMIN, sec = IMIN;
    if (live_c[c]) {
      for (int i = 0; i < TR / 4; ++i) {
        const int r = i * 4 + qd;
        push(live_r[r] ? pack(Ss[r * LDSIM + c], RBITS, r) : IMIN, top, sec);
      }
    }
    merge(top, sec, __shfl_xor_sync(FULL, top, 1), __shfl_xor_sync(FULL, sec, 1));
    merge(top, sec, __shfl_xor_sync(FULL, top, 2), __shfl_xor_sync(FULL, sec, 2));
    if (qd == 0 && c0 + c < K2) {
      col_top[size_t(rt) * K2 + c0 + c] = top;
      col_sec[size_t(rt) * K2 + c0 + c] = sec;
    }
  }
}

__global__ void match_pair_merge(const int* __restrict__ row_top, const int* __restrict__ row_sec,
                                 const int* __restrict__ col_top, const int* __restrict__ col_sec,
                                 int K1, int K2, int K1p, int cbits, int row_tiles, int col_tiles,
                                 float* __restrict__ b1, int* __restrict__ a1, float* __restrict__ s1,
                                 float* __restrict__ b2, int* __restrict__ a2, float* __restrict__ s2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < K1) {
    int top = IMIN, sec = IMIN;
    for (int ct = 0; ct < col_tiles; ++ct)
      merge(top, sec, row_top[size_t(ct) * K1p + t], row_sec[size_t(ct) * K1p + t]);
    b1[t] = unpack(top, cbits);
    a1[t] = top & ((1 << cbits) - 1);
    s1[t] = unpack(sec, cbits);
  }
  if (t < K2) {
    int cmax = col_top[t];
    int csec = col_sec[t];
    int carg = cmax & (TR - 1);
    for (int rt = 1; rt < row_tiles; ++rt) {
      const int top = col_top[size_t(rt) * K2 + t];
      const int prev = cmax;
      csec = max(max(csec, col_sec[size_t(rt) * K2 + t]), min(prev, top));
      if (top > prev) {
        cmax = top;
        carg = (top & (TR - 1)) + rt * TR;
      }
    }
    b2[t] = unpack(cmax, RBITS);
    a2[t] = carg;
    s2[t] = unpack(csec, RBITS);
  }
}

}  // namespace

extern "C" {

// Number of int32 values of scratch the launch needs.
long long match_pair_scratch_ints(int K1, int K2) {
  const long long rt = (K1 + TR - 1) / TR, ct = (K2 + TC - 1) / TC;
  return 2 * (ct * rt * TR + rt * K2);
}

// Launches both kernels on `stream`; returns the cudaError_t of the launches.
int match_pair_launch(const void* d1, const void* d2, const void* m1, const void* m2,
                      int K1, int K2, int cbits, void* scratch,
                      void* b1, void* a1, void* s1, void* b2, void* a2, void* s2,
                      void* stream) {
  if (K1 <= 0 || K2 <= 0) return int(cudaSuccess);
  const int rt = (K1 + TR - 1) / TR, ct = (K2 + TC - 1) / TC;
  const int K1p = rt * TR;
  int* row_top = static_cast<int*>(scratch);
  int* row_sec = row_top + size_t(ct) * K1p;
  int* col_top = row_sec + size_t(ct) * K1p;
  int* col_sec = col_top + size_t(rt) * K2;
  cudaError_t err = cudaFuncSetAttribute(
      match_pair_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  match_pair_tiles<<<dim3(rt, ct), THREADS, SMEM, st>>>(
      static_cast<const float*>(d1), static_cast<const float*>(d2),
      static_cast<const uint8_t*>(m1), static_cast<const uint8_t*>(m2),
      K1, K2, K1p, cbits, row_top, row_sec, col_top, col_sec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n = K1 > K2 ? K1 : K2;
  match_pair_merge<<<(n + 255) / 256, 256, 0, st>>>(
      row_top, row_sec, col_top, col_sec, K1, K2, K1p, cbits, rt, ct,
      static_cast<float*>(b1), static_cast<int*>(a1), static_cast<float*>(s1),
      static_cast<float*>(b2), static_cast<int*>(a2), static_cast<float*>(s2));
  return int(cudaGetLastError());
}

const char* match_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
