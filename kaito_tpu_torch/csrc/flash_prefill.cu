// Flash attention over a prefill chunk for Hopper (sm_90a), in two mask
// modes selected by a template parameter:
//
//   PACKED = false replaces the Pallas TPU kernel
//     kaito_tpu/engine/ops/flash_prefill.py::flash_prefill_attention
//     (body _flash_kernel): causal attention over a fresh chunk, masked
//     by true_len, a sliding window and an optional tanh softcap;
//   PACKED = true replaces
//     kaito_tpu/engine/ops/flash_prefill.py::flash_prefill_packed
//     (body _flash_packed_kernel): many prompts packed into one row, a
//     key visible to a query only within the same segment (seg_q ==
//     seg_k, seg_q >= 0), causally on within-segment positions, inside
//     the window.  Pads carry segment id -1.
//
// q is pre-scaled in q's dtype, scores and the online softmax are fp32,
// and P is rounded to the input dtype before the PV product, as in the
// Pallas kernels; the output is normalised by max(l, 1e-30).  Masked
// scores are the finite NEG_INF, so fully masked leading key tiles heal:
// their partials are scaled by alpha = exp(NEG_INF - m_new) = 0 once a
// valid key lands.
//
// Bound on the H100: bytes at the serving path's shapes.  With GQA the
// causal chunk does about 2 * T^2 * H * D flops against (2 H + 2 Hkv) *
// T * D * 2 bytes of q, k, v and out, a ratio of about T * H / (2 (H +
// Hkv)) = 0.4 T flop/byte for 32 query and 8 KV heads.  That passes the
// card's ~295 (989 TFLOP/s over 3.35 TB/s) only above ~740 tokens: at
// T = 512 the bound is 10.5 MB in 3.13 us against 2.15 GFLOP in 2.17 us.
// Either way the kernel has to keep both products on the tensor cores
// and its loads off the critical path to come near it.
//
// bf16 (the serving path): one CTA per (batch, query head, 64-row query
// tile), the tiles with the most key tiles launched first, two CTAs to
// an SM.  Warp 4 produces: one lane starts the Q tile's TMA copy at
// once, then keeps 2-stage rings of 64-key K and V tiles full with TMA
// tensor copies (cp.async.bulk.tensor into the 128-byte swizzle, 64-byte
// for D = 32; mbarrier completion; rows past T arrive as zeros); in
// packed mode the whole warp also stages the keys' segment ids and
// positions.  Warpgroup 0 consumes: S = Q K^T by wgmma from shared
// memory (both K-major), softmax on the fp32 accumulator fragment, P
// converted in registers to the bf16 A fragment of O += P V, with V read
// from the same swizzled tile as an MN-major operand (the transpose
// bit), so no pass transposes it.  S of tile j is taken while P_{j-1} V
// runs, and the softmax of tile j overlaps that product.  K and V have
// rings of their own, so a K stage is refilled as soon as its scores are
// taken.  The producer is one warp, not a warpgroup: ptxas budgets every
// thread against the launch bound, so setmaxnreg could not hand the
// consumer more than the 128 registers that 256 threads at two CTAs per
// SM allow (the pipelined loop spilled there); 160 threads allow 168.
// Key tiles past the causal diagonal, below the sliding window (fresh
// mode) or before the segment of the tile's first valid row (packed
// mode, found from seg_ids alone) are never loaded; only the tiles that
// cut the mask (diagonal, window, segment and true_len edges) evaluate
// it per element.  The schedule mirrors key_tile_range /
// tile_fully_visible in engine/ops/flash_prefill.py.  Times against the
// bound and SDPA are in PERF.md.
//
// fp32 (the goldens, not on the bf16 serving path) keeps the CUDA-core
// design: TF32 tensor cores would cost the goldens digits.  One CTA per
// (batch, query head, 64-row query tile); 64-key K/V tiles staged in
// shared memory in fp32; each of 256 threads owns a 4x4 block of the
// score tile and a 4 x D/16 block of the output; the dot products run on
// the FMA units.  Both designs mask the ragged tail (rows and keys at or
// past T) themselves, so T need not be a multiple of the tile.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace kaito {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FL_BQ = 64;
constexpr int FL_BK = 64;
constexpr int FL_THREADS = 256;   // 16 x 16 thread grid over the 64 x 64 tile

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)FL_BQ * (D + 1) + (size_t)FL_BK * (D + 1) +
                          (size_t)FL_BK * D + (size_t)FL_BQ * (FL_BK + 1)) +
         sizeof(int) * 2 * FL_BK;
}

template <typename T, int D, bool PACKED>
__global__ void __launch_bounds__(FL_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const int* __restrict__ true_len,   // [B]     (fresh mode)
             const int* __restrict__ seg_ids,    // [B, T]  (packed mode)
             const int* __restrict__ positions,  // [B, T]  (packed mode)
             int T_, int H, int Hkv, int window, float scale, float softcap) {
  constexpr int DP = D + 1;
  constexpr int PP = FL_BK + 1;
  constexpr int DJ = D / 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q_start = qt * FL_BQ;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [BQ][DP]
  float* k_s = q_s + FL_BQ * DP;        // [BK][DP]
  float* v_s = k_s + FL_BK * DP;        // [BK][D]
  float* p_s = v_s + FL_BK * D;         // [BQ][PP]
  int* segk_s = reinterpret_cast<int*>(p_s + FL_BQ * PP);   // [BK]
  int* posk_s = segk_s + FL_BK;                              // [BK]

  const size_t qrow = (size_t)H * D, krow = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * T_ * qrow + (size_t)h * D;
  const T* kb = k + (size_t)b * T_ * krow + (size_t)hk * D;
  const T* vb = v + (size_t)b * T_ * krow + (size_t)hk * D;

  for (int i = tid; i < FL_BQ * D; i += FL_THREADS) {
    const int r = i / D, d = i % D, t = q_start + r;
    q_s[r * DP + d] = t < T_ ? round_to<T>(to_f(qb[(size_t)t * qrow + d]) * scale) : 0.f;
  }

  // per-row state of this thread's four rows ty + 16 * i
  int qpos[4], qseg[4];
  float m[4], l[4], acc[4][DJ];
  const int tl = PACKED ? T_ : min(true_len[b], T_);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q_start + ty + 16 * i;
    if (PACKED) {
      const bool in = t < T_;
      qpos[i] = in ? positions[(size_t)b * T_ + t] : 0;
      qseg[i] = in ? seg_ids[(size_t)b * T_ + t] : -1;
    } else {
      qpos[i] = t;
      qseg[i] = 0;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal tile skip: no key past this query tile's last row is visible
  // (segments are contiguous and ordered within a packed row)
  const int k_end = min(q_start + FL_BQ, tl);
  const int n_tiles = (k_end + FL_BK - 1) / FL_BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k_start = kt * FL_BK;
    __syncthreads();   // previous tile's k_s/v_s/p_s reads are done
    for (int i = tid; i < FL_BK * D; i += FL_THREADS) {
      const int c = i / D, d = i % D, t = k_start + c;
      const bool in = t < T_;
      k_s[c * DP + d] = in ? to_f(kb[(size_t)t * krow + d]) : 0.f;
      v_s[c * D + d] = in ? to_f(vb[(size_t)t * krow + d]) : 0.f;
    }
    if (PACKED) {
      for (int c = tid; c < FL_BK; c += FL_THREADS) {
        const int t = k_start + c;
        const bool in = t < T_;
        segk_s[c] = in ? seg_ids[(size_t)b * T_ + t] : -2;
        posk_s[c] = in ? positions[(size_t)b * T_ + t] : 0;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k_start + c;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool valid;
        if (PACKED) {
          const int sk = segk_s[c], pk = posk_s[c];
          valid = sk == qseg[i] && qseg[i] >= 0 && pk <= qpos[i] &&
                  pk > qpos[i] - window;
        } else {
          valid = kpos < tl && kpos <= qpos[i] && kpos > qpos[i] - window;
        }
        s[i][j] = valid ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp: xor offsets < 16
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FL_BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = out + (size_t)b * T_ * qrow + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q_start + ty + 16 * i;
    if (t >= T_) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)t * qrow + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D, bool PACKED>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out,
                         const int* true_len, const int* seg_ids,
                         const int* positions, int B, int T_, int H, int Hkv,
                         int window, float scale, float softcap,
                         cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  auto kern = flash_kernel<T, D, PACKED>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + FL_BQ - 1) / FL_BQ, H, B);
  kern<<<grid, FL_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), true_len, seg_ids, positions, T_, H, Hkv, window, scale,
      softcap);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (sm_90a)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;        // query rows of the one consumer warpgroup
constexpr int TC_BK = 64;        // keys per K/V tile
constexpr int TC_STAGES = 2;     // depth of the K ring and of the V ring
// warpgroup 0 consumes, warp 4 produces.  Two CTAs of 160 threads (ten
// warps over an SM's four register-file partitions) leave each thread
// 168 registers: the consumer's O, S and two P fragments fit.
constexpr int TC_THREADS = 160;
constexpr unsigned FULL_MASK = 0xffffffffu;

// One TMA box of a 4-D [B, T, heads, D] tensor map into shared memory;
// completion lands on `bar` as transaction bytes.  Rows past T arrive as
// zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ void reg_fence(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (+)= A * B^T, A [64 x 16] and B [64 x 16] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P * V: P [64 x 16] bf16 from registers, V [16 x N] MN-major in shared
// memory (the transpose bit set), fp32 accumulators
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                                         const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                                         const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                                         const uint32_t (&a)[4],
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared-memory layout of one head-dim D.  A tile of 64 rows x D bf16 is
// stored as D / PW panels of [64 rows][PW] in the TMA swizzle (PW = 64
// elements = 128 bytes for D >= 64, all of D = 64 bytes for D = 32), so
// the same bytes serve as a K-major operand (Q, K) and as an MN-major one
// (V).  K and V have rings of their own: a K tile is free once its
// scores are taken, a V tile once its product has landed.
template <int D>
struct TcLayout {
  static constexpr int PW = D < 64 ? D : 64;           // panel width, elements
  static constexpr int ROW = PW * 2;                    // bytes per panel row
  static constexpr int PANEL = TC_BK * ROW;             // bytes per panel
  static constexpr int ATOM = 8 * ROW;                  // 8-row swizzle atom
  static constexpr uint32_t SWIZZLE = D < 64 ? 2 : 1;   // 64 B : 128 B
  static constexpr int TILE = TC_BK * D * 2;            // bytes of one tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = TILE;
  static constexpr int V_OFF = K_OFF + TC_STAGES * TILE;
  // packed: the keys' seg ids and positions beside each K stage
  static constexpr int SEG_OFF = V_OFF + TC_STAGES * TILE;
  // full/empty barriers of K and V, Q's barrier, the tile range; + 1024
  // to align the tiles to the swizzle atom
  static constexpr int BAR_OFF = SEG_OFF + TC_STAGES * 2 * TC_BK * 4;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (4 * TC_STAGES + 1) + 16;

  // Q or K as the K-major operand of S = Q K^T, k-step kk (16 of D)
  __device__ static uint64_t kmajor(uint32_t tile, int kk) {
    const int d0 = 16 * kk;
    return smem_desc(tile + (d0 / PW) * PANEL + (d0 % PW) * 2, 16, ATOM, SWIZZLE);
  }
  // V as the MN-major operand of O += P V, k-step kk (16 of 64 keys):
  // LBO steps across panels of D, SBO across 8-key atoms
  __device__ static uint64_t mnmajor(uint32_t tile, int kk) {
    return smem_desc(tile + kk * 16 * ROW, PANEL, ATOM, SWIZZLE);
  }
};

// The tile schedule (mirrors key_tile_range / tile_fully_visible in
// engine/ops/flash_prefill.py, which the CPU tests hold against the
// dense masks).  Fresh mode: keys from the first row's window start up
// to min(last row, true_len - 1).
__device__ __forceinline__ void fresh_range(int q_start, int T_, int tl, int window,
                                            int& first, int& last) {
  const int q_end = min(q_start + TC_BQ, T_);
  const int lo = max(0, q_start - window + 1);
  const int hi = min(q_end, tl);
  if (hi <= lo) {
    first = 0, last = -1;
  } else {
    first = lo / TC_BK, last = (hi - 1) / TC_BK;
  }
}

// Packed mode, run by one whole warp: keys from the first token of the
// segment of the tile's first valid row (found from seg_ids alone) up to
// its last valid row; no tiles when the tile holds only pads.  Each step
// issues all its loads at once, so a segment start within 256 tokens
// costs one load latency.
__device__ __forceinline__ void packed_range(const int* __restrict__ sg, int q_start,
                                             int T_, int lane, int& first, int& last) {
  static_assert(TC_BQ == 64, "two rows per lane");
  const int q_end = min(q_start + TC_BQ, T_);
  const int ta = q_start + lane, tb = ta + 32;
  const unsigned ma = __ballot_sync(FULL_MASK, ta < q_end && sg[ta] >= 0);
  const unsigned mb = __ballot_sync(FULL_MASK, tb < q_end && sg[tb] >= 0);
  first = 0, last = -1;
  if (!(ma | mb)) return;
  const int r0 = ma ? q_start + __ffs(ma) - 1 : q_start + 32 + __ffs(mb) - 1;
  const int rl = mb ? q_start + 63 - __clz(mb) : q_start + 31 - __clz(ma);
  const int s0 = sg[r0];
  int lo = r0;
  while (lo > 0) {   // back to the first token of segment s0, 256 at a time
    int hb = 0;
    bool found = false;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = lo - 256 + 8 * lane + e;
      if (t < 0 || sg[t] != s0) hb = t, found = true;
    }
    const unsigned m = __ballot_sync(FULL_MASK, found);
    if (m) {
      lo = __shfl_sync(FULL_MASK, hb, 31 - __clz(m)) + 1;
      break;
    }
    lo -= 256;
  }
  first = max(lo, 0) / TC_BK, last = rl / TC_BK;
}

// One key tile's softmax step on the fp32 score fragment `sc` (row
// row0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + cq + (i & 1)):
// softcap, mask (only on a tile that cuts it), running max m, the
// factor alpha that rescales the earlier partials, this thread's share
// of l, and P as the bf16 A fragments of the four PV k-steps.
template <bool PACKED>
__device__ __forceinline__ void softmax_step(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&pa)[4][4], bool full_vis, int k0, int cq, const int (&qpos)[2],
    const int (&qseg)[2], const int* kseg_s, const int* kpos_s, int tl, int window,
    float softcap) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = sc[i];
    if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
    if (!full_vis) {
      const int c = 8 * (i >> 2) + cq + (i & 1);
      bool valid;
      if (PACKED) {
        const int sk = kseg_s[c], pk = kpos_s[c];
        valid = sk == qseg[r] && qseg[r] >= 0 && pk <= qpos[r] && pk > qpos[r] - window;
      } else {
        const int kp = k0 + c;
        valid = kp < tl && kp <= qpos[r] && kp > qpos[r] - window;
      }
      x = valid ? x : NEG_INF;
    }
    sc[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the four threads of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = __expf(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];   // this thread's share of the row sum
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = __expf(sc[i] - m[r]), p1 = __expf(sc[i + 1] - m[r]);
    l[r] += p0 + p1;
    pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
  }
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ out,
                const int* __restrict__ true_len,   // [B]     (fresh mode)
                const int* __restrict__ seg_ids,    // [B, T]  (packed mode)
                const int* __restrict__ positions,  // [B, T]  (packed mode)
                int T_, int H, int Hkv, int window, float scale, float softcap) {
  using L = TcLayout<D>;
  constexpr int NO = D / 2;   // O accumulator registers per thread
  constexpr int S = TC_STAGES;
  const int h = blockIdx.x, b = blockIdx.z;
  // the longest query tiles (most key tiles under the causal skip) first
  const int q_start = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid % 32;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t q_tile = base + L::Q_OFF;
  int* seg_s = reinterpret_cast<int*>(sm + L::SEG_OFF);   // [S][2][BK]
  const uint32_t bars = base + L::BAR_OFF;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto empty_k = [&](int s) { return bars + 8 * (S + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 * S + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * S + s); };
  const uint32_t q_bar = bars + 8 * 4 * S;
  int* range = reinterpret_cast<int*>(sm + L::BAR_OFF + 8 * (4 * S + 1));

  const int* sg = PACKED ? seg_ids + (size_t)b * T_ : nullptr;
  const int* ps = PACKED ? positions + (size_t)b * T_ : nullptr;
  const int tl = PACKED ? T_ : min(true_len[b], T_);
  // One thread sets up the barriers and starts Q's copy at once; then the
  // producer warp and consumer warp 0 each work out the tile range.
  if (tid == 128) {
    for (int s = 0; s < S; ++s) {
      // packed: the 32 producer lanes also arrive once their seg/pos are in
      mbar_init(full_k(s), PACKED ? 33 : 1);
      mbar_init(empty_k(s), 128);
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_bar, L::TILE);
#pragma unroll
    for (int p = 0; p < D / L::PW; ++p)
      tma_load(q_tile + p * L::PANEL, &qmap, q_bar, p * L::PW, h, q_start, b);
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warp: one lane issues the TMA copies; in packed mode
    // all 32 stage the keys' seg ids and positions, a tile ahead ----
    int first, last;
    if (PACKED) {
      packed_range(sg, q_start, T_, lane, first, last);
    } else {
      fresh_range(q_start, T_, tl, window, first, last);
    }
    const int n_tiles = last - first + 1;
    const bool issuer = tid == 128;
    int kseg[TC_BK / 32], kpos[TC_BK / 32];
    auto fetch = [&](int j) {   // tile j's seg ids and positions
#pragma unroll
      for (int e = 0; e < TC_BK / 32; ++e) {
        const int t = (first + j) * TC_BK + 32 * e + lane;
        kseg[e] = t < T_ ? sg[t] : -2;
        kpos[e] = t < T_ ? ps[t] : 0;
      }
    };
    if (PACKED && n_tiles > 0) fetch(0);
    if (n_tiles > 0 && (issuer || PACKED)) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S, parity = ((j / S) - 1) & 1;
        const int t0 = (first + j) * TC_BK;
        if (j >= S) mbar_wait(empty_k(s), parity);
        if (issuer) {
          mbar_expect_tx(full_k(s), L::TILE);
#pragma unroll
          for (int p = 0; p < D / L::PW; ++p)
            tma_load(base + L::K_OFF + s * L::TILE + p * L::PANEL, &kmap, full_k(s),
                     p * L::PW, hk, t0, b);
        }
        if (PACKED) {
          int* dst = seg_s + s * 2 * TC_BK;
#pragma unroll
          for (int e = 0; e < TC_BK / 32; ++e) {
            dst[32 * e + lane] = kseg[e];
            dst[TC_BK + 32 * e + lane] = kpos[e];
          }
          mbar_arrive(full_k(s));
          if (j + 1 < n_tiles) fetch(j + 1);
        }
        if (issuer) {
          if (j >= S) mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), L::TILE);
#pragma unroll
          for (int p = 0; p < D / L::PW; ++p)
            tma_load(base + L::V_OFF + s * L::TILE + p * L::PANEL, &vmap, full_v(s),
                     p * L::PW, hk, t0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows, two per thread ----
    const int w = tid / 32;
    int first = 0, last = -1;
    if (PACKED) {
      if (w == 0) {
        packed_range(sg, q_start, T_, lane, first, last);
        if (lane == 0) range[0] = first, range[1] = last;
      }
    } else {
      fresh_range(q_start, T_, tl, window, first, last);
    }
    const int row0 = q_start + 16 * w + lane / 4;   // and row0 + 8
    const int cq = 2 * (lane % 4);                  // first column of a quad
    const int q_last = min(q_start + TC_BQ, T_) - 1;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    int qpos[2], qseg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      qpos[r] = PACKED ? (t < T_ ? ps[t] : 0) : t;
      qseg[r] = PACKED ? (t < T_ ? sg[t] : -1) : 0;
    }
    // the query tile's ends, for the fully-visible test of packed tiles
    const int sq = PACKED ? sg[q_start] : -1;
    const bool q_one_seg = PACKED && sq >= 0 && sg[q_last] == sq;
    const int pq_first = PACKED ? ps[q_start] : 0;
    const int pq_last = PACKED ? ps[q_last] : 0;

    auto fully_visible = [&](int j) {   // tile_fully_visible
      const int k0 = (first + j) * TC_BK;
      if (PACKED) {
        const int* ks = seg_s + (j % S) * 2 * TC_BK;
        const int* kp = ks + TC_BK;
        return k0 + TC_BK <= T_ && q_one_seg && ks[0] == sq && ks[TC_BK - 1] == sq &&
               kp[TC_BK - 1] <= pq_first && kp[0] > pq_last - window;
      }
      return k0 + TC_BK - 1 <= q_start && k0 + TC_BK <= tl && k0 > q_last - window;
    };
    auto take_scores = [&](float (&sc)[32], int j) {   // S = Q K_j^T, async
      const uint32_t k_tile = base + L::K_OFF + (j % S) * L::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, L::kmajor(q_tile, kk), L::kmajor(k_tile, kk), kk > 0);
      wg_commit();
    };
    auto multiply_v = [&](const uint32_t (&pa)[4][4], int j) {   // O += P V_j, async
      const uint32_t v_tile = base + L::V_OFF + (j % S) * L::TILE;
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], L::mnmajor(v_tile, kk));
      wg_commit();
    };
    auto softmax = [&](float (&sc)[32], int j, float (&alpha)[2],
                       uint32_t (&pa)[4][4]) {
      const int* ks = seg_s + (j % S) * 2 * TC_BK;
      softmax_step<PACKED>(sc, m, l, alpha, pa, fully_visible(j), (first + j) * TC_BK,
                           cq, qpos, qseg, ks, ks + TC_BK, tl, window, softcap);
    };

    // Q lands even when no key tile is visible: the CTA outlives its copy.
    // q pre-scaled in bf16 in place (layout-blind), then handed to the
    // async proxy that wgmma reads through
    mbar_wait(q_bar, 0);
    {
      uint4* qv = reinterpret_cast<uint4*>(sm + L::Q_OFF);
      for (int i = tid; i < L::TILE / 16; i += 128) {
        uint4 x = qv[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 f = __bfloat1622float2(e[c]);
          e[c] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        qv[i] = x;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");   // Q and the range
    }
    if (PACKED) first = range[0], last = range[1];
    const int n_tiles = last - first + 1;   // 0 when nothing is visible
    if (n_tiles > 0) {
      // S_j is taken while O += P_{j-1} V_{j-1} runs, and the softmax of
      // tile j overlaps that product: P_j goes to a second fragment
      float sc[32], alpha[2];
      uint32_t pa[4][4], pn[4][4];
      mbar_wait(full_k(0), 0);
      wg_fence();
      take_scores(sc, 0);
      wg_wait_all();
      reg_fence(sc);
      softmax(sc, 0, alpha, pa);   // O is still zero: alpha has nothing to scale
      mbar_arrive(empty_k(0));
      for (int j = 1; j < n_tiles; ++j) {
        mbar_wait(full_k(j % S), (j / S) & 1);
        mbar_wait(full_v((j - 1) % S), ((j - 1) / S) & 1);
        reg_fence(o);
        wg_fence();
        take_scores(sc, j);
        multiply_v(pa, j - 1);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");   // S_j
        reg_fence(sc);
        softmax(sc, j, alpha, pn);
        mbar_arrive(empty_k(j % S));
        wg_wait_all();   // O += P_{j-1} V_{j-1} has landed
        reg_fence(o);
        reg_fence(pa);   // read by that product until now
        mbar_arrive(empty_v((j - 1) % S));
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) pa[kk][x] = pn[kk][x];
      }
      const int j = n_tiles - 1;
      mbar_wait(full_v(j % S), (j / S) & 1);
      reg_fence(o);
      wg_fence();
      multiply_v(pa, j);
      wg_wait_all();
      reg_fence(o);
      reg_fence(pa);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
      l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int r = (i >> 1) & 1;
      const int t = row0 + 8 * r;
      if (t < T_) {
        const int col = 8 * (i >> 2) + cq;
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * T_ + t) * H + h) * D + col) =
            __floats2bfloat162_rn(o[i] * inv[r], o[i + 1] * inv[r]);
      }
    }
  }
}

// [B, T, heads, D] bf16 as a 4-D tensor map whose box is one head's
// 64 rows x PW columns, in the swizzle the wgmma descriptors read
template <int D>
static bool make_map(CUtensorMap* map, const void* ptr, int B, int T_, int heads) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T_,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)T_ * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)TcLayout<D>::PW, 1, TC_BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool PACKED>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v, void* out,
                            const int* true_len, const int* seg_ids,
                            const int* positions, int B, int T_, int H, int Hkv,
                            int window, float scale, float softcap,
                            cudaStream_t stream) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<D>(&qmap, q, B, T_, H) || !make_map<D>(&kmap, k, B, T_, Hkv) ||
      !make_map<D>(&vmap, v, B, T_, Hkv))
    return cudaErrorInvalidValue;
  constexpr size_t smem = TcLayout<D>::SMEM;
  auto kern = flash_tc_kernel<D, PACKED>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (T_ + TC_BQ - 1) / TC_BQ, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(qmap, kmap, vmap,
                                           static_cast<__nv_bfloat16*>(out), true_len,
                                           seg_ids, positions, T_, H, Hkv, window,
                                           scale, softcap);
  return cudaGetLastError();
}

template <bool PACKED>
int dispatch_flash(const void* q, const void* k, const void* v, void* out,
                   const int* true_len, const int* seg_ids, const int* positions,
                   int B, int T_, int H, int Hkv, int D, int window, float scale,
                   float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KAITO_FLASH_TC(DD)                                                         \
  return (int)launch_flash_tc<DD, PACKED>(q, k, v, out, true_len, seg_ids,         \
                                          positions, B, T_, H, Hkv, window, scale, \
                                          softcap, s)
#define KAITO_FLASH_F32(DD)                                                        \
  return (int)launch_flash<float, DD, PACKED>(q, k, v, out, true_len, seg_ids,     \
                                              positions, B, T_, H, Hkv, window,    \
                                              scale, softcap, s)
  if (dtype == 1) {
    if (D == 32) KAITO_FLASH_TC(32);
    if (D == 64) KAITO_FLASH_TC(64);
    if (D == 128) KAITO_FLASH_TC(128);
  } else if (dtype == 0) {
    if (D == 32) KAITO_FLASH_F32(32);
    if (D == 64) KAITO_FLASH_F32(64);
    if (D == 128) KAITO_FLASH_F32(128);
  }
#undef KAITO_FLASH_TC
#undef KAITO_FLASH_F32
  return (int)cudaErrorInvalidValue;
}

}  // namespace kaito

// q [B, T, H, D]; k, v [B, T, Hkv, D]; out [B, T, H, D]; true_len [B] int32.
// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 disables it.
// Returns the CUDA error of the launch (0 = success).
extern "C" int kaito_flash_prefill(const void* q, const void* k, const void* v,
                                   void* out, const int* true_len, int B, int T,
                                   int H, int Hkv, int D, int window, float scale,
                                   float softcap, int dtype, void* stream) {
  return kaito::dispatch_flash<false>(q, k, v, out, true_len, nullptr, nullptr, B, T,
                                      H, Hkv, D, window, scale, softcap, dtype, stream);
}

// As kaito_flash_prefill for segment-packed rows: seg_ids and positions
// are [B, T] int32 (segment -1 = pad, positions within the segment).
extern "C" int kaito_flash_prefill_packed(const void* q, const void* k, const void* v,
                                          void* out, const int* seg_ids,
                                          const int* positions, int B, int T, int H,
                                          int Hkv, int D, int window, float scale,
                                          float softcap, int dtype, void* stream) {
  return kaito::dispatch_flash<true>(q, k, v, out, nullptr, seg_ids, positions, B, T,
                                     H, Hkv, D, window, scale, softcap, dtype, stream);
}
