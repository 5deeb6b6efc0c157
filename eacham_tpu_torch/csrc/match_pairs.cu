// Batched fused descriptor matcher for Hopper (sm_90a).
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
// summaries merge exactly: top = max(a, b), sec = max(sec_a, sec_b,
// min(a, b)). Across 128-row tiles the reference's merge is applied as
// written: take_new = ctop > prev, sec = max(prev_sec, csec, min(prev, ctop)).
//
// Layout: one thread block per pair, a loop over 128-row tiles inside the
// block (this replaces the TPU's sequential grid axis), so the column
// state (best, arg, second: 3 x Kp int32) stays in shared memory with no
// second pass. Each block reads its pair's frame indices itself and
// streams both frames' descriptors straight from the [N, Kp, 256] table:
// no [P, K, D] gather. Products run on the tensor cores via
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the 128 x 64 similarity
// tile is staged in shared memory for the row and column reductions.
//
// Bound on the card, at the bench's shapes (N=100, K=512, P=5120):
// 2 * 5120 * 512^2 * 256 = 6.9e11 FLOP, about 0.7 ms at the H100's
// 989 TFLOP/s bf16 dense rate; the unique descriptor bytes are 26 MB
// (~8 us at 3.35 TB/s), so the kernel is bound by operations. This first
// version uses synchronous tile loads and mma.sync; wgmma/TMA pipelining
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;          // descriptor width
constexpr int TR = 128;         // row tile (the reference's ROW_TILE)
constexpr int RBITS = 7;        // bit_length(TR - 1)
constexpr int TC = 64;          // column tile
constexpr int LDS = D + 8;      // smem row stride in bf16 (528 B): conflict-free fragments
constexpr int LDSIM = TC + 1;   // smem row stride of the fp32 similarity tile
constexpr int THREADS = 256;    // 8 warps: 4 (rows) x 2 (cols) of 32 x 32 warp tiles
constexpr int IMIN = -(1 << 30);
constexpr float QSCALE = 16384.0f;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr size_t smem_bytes(int Kp) {
  return size_t(TR) * LDS * 2 + size_t(TC) * LDS * 2 + size_t(TR) * LDSIM * 4
         + size_t(2 * TR) * 4 + size_t(3) * Kp * 4 + TR + TC;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

__global__ void __launch_bounds__(THREADS)
match_pairs_kernel(const __nv_bfloat16* __restrict__ desc,   // [N, Kp, D]
                   const uint8_t* __restrict__ mask,         // [N, Kp]
                   const int* __restrict__ pairs,            // [P, 2]
                   int Kp, int cbits,
                   float* __restrict__ b1, int* __restrict__ a1, float* __restrict__ s1,
                   float* __restrict__ b2, int* __restrict__ a2, float* __restrict__ s2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + TR * LDS;
  float* Ss = reinterpret_cast<float*>(Bs + TC * LDS);
  int* row_top = reinterpret_cast<int*>(Ss + TR * LDSIM);
  int* row_sec = row_top + TR;
  int* col_top = row_sec + TR;
  int* col_arg = col_top + Kp;
  int* col_sec = col_arg + Kp;
  uint8_t* live_r = reinterpret_cast<uint8_t*>(col_sec + Kp);
  uint8_t* live_c = live_r + TR;

  const int p = blockIdx.x;
  const int fi = pairs[2 * p];
  const int fj = pairs[2 * p + 1];
  const __nv_bfloat16* di = desc + size_t(fi) * Kp * D;
  const __nv_bfloat16* dj = desc + size_t(fj) * Kp * D;
  const uint8_t* mi = mask + size_t(fi) * Kp;
  const uint8_t* mj = mask + size_t(fj) * Kp;
  const size_t out = size_t(p) * Kp;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;       // fragment group id
  const int t4 = lane & 3;       // thread in group
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  const int cmask = (1 << cbits) - 1;
  constexpr int VEC = D / 8;     // 16-byte vectors per descriptor row

  for (int rt = 0; rt < Kp / TR; ++rt) {
    for (int e = tid; e < TR * VEC; e += THREADS) {
      const int r = e / VEC, c = e % VEC;
      *reinterpret_cast<uint4*>(As + r * LDS + c * 8) =
          *reinterpret_cast<const uint4*>(di + size_t(rt * TR + r) * D + c * 8);
    }
    if (tid < TR) {
      live_r[tid] = mi[rt * TR + tid];
      row_top[tid] = IMIN;
      row_sec[tid] = IMIN;
    }

    for (int ct = 0; ct < Kp / TC; ++ct) {
      for (int e = tid; e < TC * VEC; e += THREADS) {
        const int r = e / VEC, c = e % VEC;
        *reinterpret_cast<uint4*>(Bs + r * LDS + c * 8) =
            *reinterpret_cast<const uint4*>(dj + size_t(ct * TC + r) * D + c * 8);
      }
      if (tid < TC) live_c[tid] = mj[ct * TC + tid];
      __syncthreads();

      float acc[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.0f;

#pragma unroll 4
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const __nv_bfloat16* a = As + (wm + m * 16 + g) * LDS + k0 + t4 * 2;
          af[m][0] = ld32(a);
          af[m][1] = ld32(a + 8 * LDS);
          af[m][2] = ld32(a + 8);
          af[m][3] = ld32(a + 8 * LDS + 8);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const __nv_bfloat16* b = Bs + (wn + n * 8 + g) * LDS + k0 + t4 * 2;
          bfr[n][0] = ld32(b);
          bfr[n][1] = ld32(b + 8);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], af[m], bfr[n]);
      }

#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int r = wm + m * 16 + g;
          const int c = wn + n * 8 + t4 * 2;
          Ss[r * LDSIM + c] = acc[m][n][0];
          Ss[r * LDSIM + c + 1] = acc[m][n][1];
          Ss[(r + 8) * LDSIM + c] = acc[m][n][2];
          Ss[(r + 8) * LDSIM + c + 1] = acc[m][n][3];
        }
      __syncthreads();

      {  // rows: two threads per row, 32 columns each, merged with the partner lane
        const int r = tid >> 1, h = tid & 1;
        int top = IMIN, sec = IMIN;
        if (live_r[r]) {
          for (int c = h * 32; c < h * 32 + 32; ++c)
            push(live_c[c] ? pack(Ss[r * LDSIM + c], cbits, ct * TC + c) : IMIN, top, sec);
        }
        merge(top, sec, __shfl_xor_sync(FULL, top, 1), __shfl_xor_sync(FULL, sec, 1));
        if (h == 0) {
          int rtop = row_top[r], rsec = row_sec[r];
          merge(rtop, rsec, top, sec);
          row_top[r] = rtop;
          row_sec[r] = rsec;
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
        if (qd == 0) {
          const int gc = ct * TC + c;
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
      }
      __syncthreads();  // Bs, Ss and live_c are refilled by the next column tile
    }

    if (tid < TR) {
      const int top = row_top[tid], sec = row_sec[tid];
      b1[out + rt * TR + tid] = unpack(top, cbits);
      a1[out + rt * TR + tid] = top & cmask;
      s1[out + rt * TR + tid] = unpack(sec, cbits);
    }
  }

  for (int c = tid; c < Kp; c += THREADS) {
    b2[out + c] = unpack(col_top[c], RBITS);
    a2[out + c] = col_arg[c];
    s2[out + c] = unpack(col_sec[c], RBITS);
  }
}

}  // namespace

extern "C" {

// Largest padded keypoint count one block's shared memory can hold.
int match_pairs_max_kp() {
  int kp = TR;
  while (smem_bytes(kp + TR) <= 227 * 1024) kp += TR;
  return kp;
}

// Launches the matcher on `stream`; returns the cudaError_t of the launch.
int match_pairs_launch(const void* desc, const void* mask, const void* pairs,
                       int P, int Kp, int cbits,
                       void* b1, void* a1, void* s1, void* b2, void* a2, void* s2,
                       void* stream) {
  if (P <= 0) return int(cudaSuccess);
  const size_t smem = smem_bytes(Kp);
  cudaError_t err = cudaFuncSetAttribute(
      match_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  match_pairs_kernel<<<P, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(desc), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(pairs), Kp, cbits,
      static_cast<float*>(b1), static_cast<int*>(a1), static_cast<float*>(s1),
      static_cast<float*>(b2), static_cast<int*>(a2), static_cast<float*>(s2));
  return int(cudaGetLastError());
}

const char* match_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
