// Masked multi-head attention for Hopper (sm_90a): fp32 in, fp32 out, both
// matrix products on the tensor cores as split-fp32 ("3xTF32") products.
//
// Replaces the Pallas kernel `_attn_kernel` behind `masked_attention`
// (eacham_tpu/ops/attention.py). For q [B, H, Nq, 64], k, v [B, H, Nk, 64]
// and a key mask [B, Nk] it computes softmax(q k^T / sqrt(64)) v over the
// live keys only; a query row with no live key returns exact zeros. The
// [Nq, Nk] score matrix never reaches device memory.
//
// What bounds it on this card. At the deep path's [32, 4, 1024, 64] the
// function is 3.4e10 FLOP over 0.13 GB, so operations bound it: 0.51 ms at
// the 67 TFLOP/s of fp32 FMAs on the CUDA cores, where a register-tiled
// loop is held further back by one shared-memory read per 8 FMAs. A TF32
// tensor-core product alone keeps 11 bits of each operand, which does not
// hold the 1e-5 the forward is held to. Splitting every fp32 operand into
// hi = tf32(x) and lo = x - hi and summing lo*hi + hi*lo + hi*hi in the
// fp32 accumulator keeps 21 bits of each operand at three tensor-core
// instructions a product: 495 / 3 = 165 TFLOP/s of fp32-class arithmetic,
// a bound of 0.21 ms at that shape.
//
// Design (the shape of FlashAttention-2):
// - A block of 4 warps owns 128 query rows of one (batch, head), a warp 32
//   of them as two 16-row fragments, and loops over 32-key tiles with a
//   running maximum, denominator and output accumulator (online softmax).
//   The scores are the accumulator fragments of mma.sync.m16n8k8.tf32, the
//   softmax runs on those fragments with shuffles over the 4 lanes that
//   share a row, and the probabilities go into the second product as its
//   A operand straight from registers: no score or probability tile in
//   shared memory, no barrier between the two products. The accumulator
//   layout holds key columns (2t, 2t+1) of each 8-key group where the A
//   operand wants k-slots (t, t+4); a sum over keys does not care about
//   their order, so k-slot t is key 2t and k-slot t+4 is key 2t+1, and
//   the B operand reads V's rows in that order.
// - Two fragments per warp, because every B fragment (K or V) read from
//   shared memory and split then feeds six tensor-core instructions and
//   not three: with one fragment per warp the kernel was bound by
//   shared-memory reads (each warp reads all of K and V for 16 rows). The
//   price is registers, so the query rows (pre-scaled by 1/8, exact) stay
//   in shared memory and are read as A fragments per tile.
// - K and V tiles (and Q) arrive by cp.async, 16 bytes a thread, into a
//   ring of two stages: tile i+1 is in flight while tile i is multiplied,
//   with one barrier per tile. Rows at stride 68 floats make every
//   fragment read of Q ([row g][d t]), K ([key g][d t]) and V
//   ([key 2t (+1)][d g]) hit the 32 banks once.
// - The hi/lo split of K and V is done on the way from shared memory to
//   the fragments, not by a pass that writes hi and lo tiles: such tiles
//   would double the shared-memory reads per product, which are the
//   scarcer resource, to save three integer/float instructions per
//   element. hi is rounded to TF32 with an integer add and mask (the
//   cvt.rna.tf32 instruction does the same at a fraction of the rate, and
//   with it the conversions, not the products, set the pace); lo = x - hi
//   is exact in fp32 and the tensor core reads its upper 19 bits.
// - Tensor-core accumulation rounds toward zero, so long accumulation
//   chains drift: with the running output as the accumulator of p . v over
//   all 32 key tiles the error grows several times over, to the edge of
//   the limits the kernel is held to.
//   The chains are kept short: a score sums 8 k-steps, and each key tile's
//   p . v is summed from zero, 16 output columns at a time, then added to
//   the rescaled running output with one fp32 FMA on the CUDA cores.
// - Masked keys are skipped, not pushed to a large negative logit: they
//   enter neither the maximum nor the sums; a key tile without a live key
//   is neither loaded nor computed; while a row has seen no live key its
//   maximum stays -inf and an explicit guard keeps exp(-inf - -inf) out.
//   Ragged edges (Nq, Nk not multiples of the tiles) are masked in the
//   kernel; nothing is padded outside. expf and a true division.
// - 167 registers and 69.6 KB of shared memory: three blocks per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                  // head width
constexpr int BN = 32;                 // keys per tile: one word of live bits
constexpr int NJ = BN / 8;             // 8-key groups per tile
constexpr int LD = D + 4;              // smem row stride in floats (272 B)
constexpr int WARPS = 4;
constexpr int WM = 32;                 // query rows per warp: two 16-row fragments
constexpr int BM = WM * WARPS;         // query rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;          // blocks per SM the register budget is held to
constexpr int TILE = BN * LD;          // floats of one K or V tile
constexpr int STAGES = 2;
constexpr int PVW = 2;                 // 8-column groups of the output per p . v pass
constexpr unsigned FULL = 0xffffffffu;
static_assert(BN == 32, "a key tile's live bits are one 32-bit word");

__host__ __device__ constexpr size_t smem_bytes(int n_tiles) {
  return size_t(BM * LD + STAGES * 2 * TILE) * 4 + size_t(n_tiles) * 4;
}

// x = hi + lo exactly; hi is x rounded to TF32 (to nearest, ties away), and
// the tensor core reads the upper 19 bits of lo: 21 bits of x in all
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[mt] += a[mt] * b to fp32 accuracy for both 16-row fragments of the
// warp: one split of b serves both, the two small terms go first
__device__ __forceinline__ void mma_3x(float (*c)[4], const uint32_t (*ah)[4],
                                       const uint32_t (*al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    mma_tf32(c[mt], al[mt], bh0, bh1);
    mma_tf32(c[mt], ah[mt], bl0, bl1);
    mma_tf32(c[mt], ah[mt], bh0, bh1);
  }
}

// `rows` x 64 floats from global (row stride 64) into smem (row stride LD),
// asynchronously; rows at or past `limit` are zero-filled
template <int rows>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int first,
                                                int limit, int tid) {
#pragma unroll
  for (int e = tid; e < rows * (D / 4); e += THREADS) {
    const int r = e >> 4, c = e & 15;
    const bool ok = first + r < limit;
    const float* g = src + size_t(ok ? first + r : 0) * D + c * 4;
    const uint32_t s = uint32_t(__cvta_generic_to_shared(dst + r * LD + c * 4));
    const int bytes = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(bytes) : "memory");
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
masked_attention_kernel(const float* __restrict__ q,      // [B*H, Nq, D]
                        const float* __restrict__ k,      // [B*H, Nk, D]
                        const float* __restrict__ v,      // [B*H, Nk, D]
                        const uint8_t* __restrict__ mask, // [B, Nk]
                        float* __restrict__ out,          // [B*H, Nq, D]
                        int H, int Nq, int Nk, int q_tiles, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                // [BM][LD]
  float* tiles = Qs + BM * LD;                               // [STAGES][K, V][BN][LD]
  uint32_t* live = reinterpret_cast<uint32_t*>(tiles + STAGES * 2 * TILE);  // [n_tiles]

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const float* qb = q + size_t(bh) * Nq * D;
  const float* kb = k + size_t(bh) * Nk * D;
  const float* vb = v + size_t(bh) * Nk * D;
  const uint8_t* mb = mask + size_t(bh / H) * Nk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;       // fragment row within 8
  const int t = lane & 3;        // thread within the quad that shares a row

  load_rows_async<BM>(Qs, qb, q0, Nq, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // one bit per key, dead past Nk
  for (int w = warp; w < n_tiles; w += WARPS) {
    const int key = w * BN + lane;
    const unsigned bits = __ballot_sync(FULL, key < Nk && mb[key] != 0);
    if (lane == 0) live[w] = bits;
  }
  __syncthreads();

  int cur = 0;
  while (cur < n_tiles && live[cur] == 0) ++cur;
  if (cur < n_tiles) {
    load_rows_async<BN>(tiles, kb, cur * BN, Nk, tid);
    load_rows_async<BN>(tiles + TILE, vb, cur * BN, Nk, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // scale the query rows by 1 / sqrt(64) (a power of two: exact) in place:
  // each thread the chunks it copied itself, visible to it after the wait
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#pragma unroll
  for (int e = tid; e < BM * (D / 4); e += THREADS) {
    float4* p = reinterpret_cast<float4*>(Qs + (e >> 4) * LD + (e & 15) * 4);
    float4 x = *p;
    *p = make_float4(0.125f * x.x, 0.125f * x.y, 0.125f * x.z, 0.125f * x.w);
  }

  float m[2][2], l[2][2], o[8][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dn][mt][i] = 0.f;
  }
  // rows 32 warp + 16 mt + g (+ 8) of the block
  const float* qw = Qs + (warp * WM + g) * LD + t;

  int stage = 0;
  while (cur < n_tiles) {
    // this tile has arrived, and every warp is done with the stage that the
    // next tile goes into (and, the first time, the scaled Q is written)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    int nxt = cur + 1;
    while (nxt < n_tiles && live[nxt] == 0) ++nxt;
    if (nxt < n_tiles) {
      float* dst = tiles + ((stage + 1) % STAGES) * 2 * TILE;
      load_rows_async<BN>(dst, kb, nxt * BN, Nk, tid);
      load_rows_async<BN>(dst + TILE, vb, nxt * BN, Nk, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const float* Ks = tiles + stage * 2 * TILE;
    const float* Vs = Ks + TILE;

    // scores: s[j][mt] = q . k^T for keys 8j .. 8j+7
    float s[NJ][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][mt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(qw[(16 * mt + 8 * (i & 1)) * LD + 8 * ks + 4 * (i >> 1)], ah[mt][i], al[mt][i]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kp = Ks + (8 * j + g) * LD + 8 * ks + t;
        mma_3x(s[j], ah, al, kp[0], kp[4]);
      }
    }

    // the thread's keys of group j are 8j + 2t and 8j + 2t + 1
    uint32_t lv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      lv[j] = (live[cur] >> (8 * j + 2 * t)) & 3u;

    // online softmax on the fragments: elements 0, 1 are row g, 2, 3 row g + 8
    float alpha[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if ((lv[j] >> c) & 1) mx = fmaxf(mx, s[j][mt][2 * r + c]);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx);
        const bool seen = m_new != -INFINITY;             // the row has seen a live key
        alpha[mt][r] = seen ? expf(m[mt][r] - m_new) : 1.f;   // 0 at its first live tile
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool alive = seen && ((lv[j] >> c) & 1);
            const float p = alive ? expf(s[j][mt][2 * r + c] - m_new) : 0.f;
            s[j][mt][2 * r + c] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(FULL, rs, 1);
        rs += __shfl_xor_sync(FULL, rs, 2);
        l[mt][r] = l[mt][r] * alpha[mt][r] + rs;
        m[mt][r] = m_new;
      }

    // this tile's p . v: k-slot t is key 2t, k-slot t + 4 is key 2t + 1
#pragma unroll
    for (int h = 0; h < 8 / PVW; ++h) {
      float pv[PVW][2][4];
#pragma unroll
      for (int dn = 0; dn < PVW; ++dn)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[dn][mt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          split(s[kk][mt][0], ah[mt][0], al[mt][0]);   // (row g,     key 2t)
          split(s[kk][mt][2], ah[mt][1], al[mt][1]);   // (row g + 8, key 2t)
          split(s[kk][mt][1], ah[mt][2], al[mt][2]);   // (row g,     key 2t + 1)
          split(s[kk][mt][3], ah[mt][3], al[mt][3]);   // (row g + 8, key 2t + 1)
        }
#pragma unroll
        for (int dn = 0; dn < PVW; ++dn) {
          const float* vp = Vs + (8 * kk + 2 * t) * LD + 8 * (PVW * h + dn) + g;
          mma_3x(pv[dn], ah, al, vp[0], vp[LD]);
        }
      }
#pragma unroll
      for (int dn = 0; dn < PVW; ++dn)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[PVW * h + dn][mt][i] =
                fmaf(o[PVW * h + dn][mt][i], alpha[mt][i >> 1], pv[dn][mt][i]);
    }

    cur = nxt;
    stage = (stage + 1) % STAGES;
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * WM + 16 * mt + 8 * r + g;
      if (row >= Nq) continue;
      const float den = l[mt][r];
      float* dst = out + (size_t(bh) * Nq + row) * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        float2 val = make_float2(0.f, 0.f);           // no live key: exact zeros
        if (den > 0.f) val = make_float2(o[dn][mt][2 * r] / den, o[dn][mt][2 * r + 1] / den);
        *reinterpret_cast<float2*>(dst + 8 * dn) = val;
      }
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// All pointers must be 16-byte aligned; tensors contiguous.
int masked_attention_launch(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int B, int H, int Nq, int Nk, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nk <= 0) return int(cudaMemsetAsync(out, 0, size_t(B) * H * Nq * D * 4, st));
  const int n_tiles = (Nk + BN - 1) / BN;
  const size_t smem = smem_bytes(n_tiles);
  if (smem > 227 * 1024) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int q_tiles = (Nq + BM - 1) / BM;
  masked_attention_kernel<<<B * H * q_tiles, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, Nq, Nk, q_tiles, n_tiles);
  return int(cudaGetLastError());
}

const char* masked_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
