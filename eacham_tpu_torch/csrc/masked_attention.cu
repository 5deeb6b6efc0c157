// Masked multi-head attention for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas kernel `_attn_kernel` behind `masked_attention`
// (eacham_tpu/ops/attention.py). For q [B, H, Nq, 64], k, v [B, H, Nk, 64]
// and a key mask [B, Nk] it computes softmax(q k^T / sqrt(64)) v over the
// live keys only; a query row with no live key returns exact zeros. The
// [Nq, Nk] score matrix never reaches device memory.
//
// The TPU kernel holds the whole K and V of one (batch, head) and a full
// [128, Nk] score tile in VMEM (512 KB of K and V at Nk = 1024). A Hopper
// block has 227 KB, so here one block owns a 64-row query tile of one
// (batch, head) and loops over 64-key tiles with a running maximum,
// denominator and output accumulator (online softmax). Masked keys are
// skipped, not pushed to a large negative logit: they enter neither the
// maximum nor the sums, a key tile without a live key is not computed at
// all, and while a row has seen no live key its maximum stays -inf and an
// explicit guard keeps exp(-inf - -inf) out. Ragged edges (Nq, Nk not
// multiples of 64) are masked in the kernel; nothing is padded outside.
//
// Arithmetic is fp32 FMAs on the CUDA cores (the repo-wide fp32 policy:
// TF32 or bf16 tensor-core products do not meet the 1e-5 the forward is
// held to). 256 threads form a 16 x 16 grid; each owns a 4 x 4 micro-tile
// of the 64 x 64 scores (rows ty + 16u, keys tx + 16v, so that float4
// reads of K rows at stride 68 floats hit every bank once) and a 4 x 4
// micro-tile of the output (same rows, columns 4tx..4tx+3). The 16 lanes
// that share a row reduce its maximum and sum with shuffles, so each keeps
// its rows' running statistics in registers.
//
// Bound on the card at the deep path's shape [B, 4, 1024, 64]:
// 4 * B * 4 * 1024 * 1024 * 64 = 1.07e9 * B FLOP, 16 us per batch entry at
// the H100's 67 TFLOP/s fp32 rate; q, k, v and the output are 4.2 MB per
// batch entry (1.3 us at 3.35 TB/s), so the kernel is bound by operations.
// Each 64-FMA step of a thread needs 8 shared-memory float4 reads, which
// keeps this version at a fraction of the FMA rate; larger micro-tiles or
// 3xTF32 tensor-core products are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head width
constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int LD = D + 4;      // smem row stride in floats (272 B)
constexpr int THREADS = 256;   // 16 x 16
constexpr size_t SMEM = size_t(2 * BM + 2 * BN) * LD * 4 + BN;

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows x 64 floats from global (row stride 64) into smem (row stride LD);
// rows at or past `limit` are zero-filled
__device__ __forceinline__ void load_tile(float* dst, const float* src, int first,
                                          int limit, int tid) {
  for (int e = tid; e < BM * (D / 4); e += THREADS) {
    const int r = e / (D / 4), c = e % (D / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + r < limit)
      val = *reinterpret_cast<const float4*>(src + size_t(first + r) * D + c * 4);
    *reinterpret_cast<float4*>(dst + r * LD + c * 4) = val;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
masked_attention_kernel(const float* __restrict__ q,      // [B*H, Nq, D]
                        const float* __restrict__ k,      // [B*H, Nk, D]
                        const float* __restrict__ v,      // [B*H, Nk, D]
                        const uint8_t* __restrict__ mask, // [B, Nk]
                        float* __restrict__ out,          // [B*H, Nq, D]
                        int H, int Nq, int Nk, int q_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [BM][LD]
  float* Ks = Qs + BM * LD;                     // [BN][LD]
  float* Vs = Ks + BN * LD;                     // [BN][LD]
  float* Ps = Vs + BN * LD;                     // [BM][LD] (BN == D)
  uint8_t* live = reinterpret_cast<uint8_t*>(Ps + BM * LD);   // [BN]

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const float* qb = q + size_t(bh) * Nq * D;
  const float* kb = k + size_t(bh) * Nk * D;
  const float* vb = v + size_t(bh) * Nk * D;
  const uint8_t* mb = mask + size_t(bh / H) * Nk;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float scale = 0.125f;   // 1 / sqrt(64), exact

  load_tile(Qs, qb, q0, Nq, tid);

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m[u] = -INFINITY;
    l[u] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[u][c] = 0.f;
  }

  for (int k0 = 0; k0 < Nk; k0 += BN) {
    int alive = 0;
    if (tid < BN) {
      alive = (k0 + tid < Nk) ? (mb[k0 + tid] != 0) : 0;
      live[tid] = uint8_t(alive);
    }
    // also the barrier between the previous tile's reads of Ks, Vs, Ps and
    // this tile's writes (and, on the first tile, after the Q load)
    if (!__syncthreads_or(alive)) continue;   // no live key in this tile

    load_tile(Ks, kb, k0, Nk, tid);
    load_tile(Vs, vb, k0, Nk, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * u) * LD + d4 * 4);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        b[w] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * w) * LD + d4 * 4);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) s[u][w] = dot4(a[u], b[w], s[u][w]);
    }

    bool lv[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) lv[w] = live[tx + 16 * w] != 0;

#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float mt = -INFINITY;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        s[u][w] *= scale;
        if (lv[w]) mt = fmaxf(mt, s[u][w]);
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, sh));
      const float m_new = fmaxf(m[u], mt);
      float alpha = 1.f, rs = 0.f;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      if (m_new != -INFINITY) {          // the row has seen a live key
        alpha = expf(m[u] - m_new);      // 0 when this tile holds its first
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          p[w] = lv[w] ? expf(s[u][w] - m_new) : 0.f;
          rs += p[w];
        }
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, sh);
      l[u] = l[u] * alpha + rs;
      m[u] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[u][c] *= alpha;
#pragma unroll
      for (int w = 0; w < 4; ++w) Ps[(ty + 16 * u) * LD + tx + 16 * w] = p[w];
    }
    __syncthreads();

#pragma unroll 4
    for (int j4 = 0; j4 < BN / 4; ++j4) {
      float4 p4[4], vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        p4[u] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * u) * LD + j4 * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vv[j] = *reinterpret_cast<const float4*>(Vs + (j4 * 4 + j) * LD + tx * 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pj[4] = {p4[u].x, p4[u].y, p4[u].z, p4[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[u][0] = fmaf(pj[j], vv[j].x, o[u][0]);
          o[u][1] = fmaf(pj[j], vv[j].y, o[u][1]);
          o[u][2] = fmaf(pj[j], vv[j].z, o[u][2]);
          o[u][3] = fmaf(pj[j], vv[j].w, o[u][3]);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = q0 + ty + 16 * u;
    if (row >= Nq) continue;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);   // no live key: exact zeros
    if (l[u] > 0.f) r = make_float4(o[u][0] / l[u], o[u][1] / l[u], o[u][2] / l[u], o[u][3] / l[u]);
    *reinterpret_cast<float4*>(out + (size_t(bh) * Nq + row) * D + tx * 4) = r;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers must be 16-byte aligned; tensors contiguous.
int masked_attention_launch(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int B, int H, int Nq, int Nk, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0) return int(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  const int q_tiles = (Nq + BM - 1) / BM;
  masked_attention_kernel<<<B * H * q_tiles, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, Nq, Nk, q_tiles);
  return int(cudaGetLastError());
}

const char* masked_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
