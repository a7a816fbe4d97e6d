// Fused dequant matmul for Hopper (sm_90a): K4 (int8), K5 (int4) and
// K6 (either, with the next layer's slab prefetched into L2).
//
// Replaces the Pallas TPU kernel
// kaito_tpu/engine/ops/quant_matmul.py::quant_matmul (bodies _int8_kernel
// and _int4_kernel, and their prefetch variants _int8_kernel_pf and
// _int4_kernel_pf with _prefetch_touch): out[rows, N] = x[rows, K] @ W
// for a weight-only quantized QTensor W (kaito_tpu_torch/engine/quant.py),
// rows <= 256.
//   int8: W = q8 [K, N] int8, scale [N] fp32; the per-column scale folds
//         after the whole fp32-accumulated dot.
//   int4: W = q4 [K/2, N] int8, byte i holding in-rows 2i (low nibble) and
//         2i+1 (high nibble), each biased by +8; scale [G, N] fp32 over
//         groups of K/G in-rows; each group's scale folds after that
//         group's fp32 partial dot.
// The codes and the int4 scales are read through explicit row strides
// (ldw, lds, in elements), so a column chunk of a wider plane (the ring
// of engine/ops/overlap_collectives.py) is used in place.  The output is
// [rows, N] contiguous, cast once, at the end, to x's dtype (fp32 or
// bf16).
//
// Bound on the H100: bytes at decode sizes (a weight byte feeds 2 x rows
// flops, far below the ~295 flop/byte where bf16 tensor-core compute
// binds), operations from a few hundred rows up.  The HBM stream is the
// quantized bytes: codes arrive as int8 and are widened on the SM, and the
// bf16 weight is never materialised.  The Pallas version's even/odd split
// of x outside the kernel (a Mosaic workaround) is not needed: the int4
// byte of in-rows 2i and 2i+1 is widened into both rows of the tile.
//
// Two paths, chosen from what the call gives them:
// - Tensor cores, for bf16 x with K a multiple of 64, N of 128, int4
//   groups of whole 64-row stages and 16-byte aligned code rows (every
//   Llama projection and its ring chunks).  A CTA of 4 warps owns 128
//   columns and 16 (decode) or 64 rows; per 64-row stage the 8 KB of
//   codes (4 KB int4) are loaded into registers with 16-byte loads while
//   the previous stage computes, widened to bf16 into shared memory as a
//   [k][n] tile (int8 through the mantissa of 2^23 in fp32, int4 through
//   the mantissa of 128 in bf16: exact), and read back as B fragments
//   with ldmatrix.trans; x is staged the same way, and mma.sync
//   m16n8k16 sums bf16 products in fp32.
// - CUDA cores, for fp32 x and any other shape: a CTA owns 256 columns,
//   up to 8 rows of x (in shared memory, fp32) and a slice of K; its 8
//   warps walk interleaved rows of the slice with 8-byte loads, each
//   thread keeping 8 rows x 8 columns of fp32 sums, and the warps' sums
//   are added through shared memory.  Tails of K and N are masked, and
//   rows not a multiple of 8 bytes take byte loads.
// In both, K is split into slices so a launch fills the 132 SMs (the k/v
// projections have few column tiles); the slices' fp32 partial outputs
// are summed by a second kernel.  Not yet done: TMA and a warp-specialised
// pipeline, which the int4 path needs to reach its bound.
//
// K6 (template flag PF, entry kaito_quant_matmul_pf) is the same kernel
// with two more pointers: the next layer's codes and scales, in the same
// layout and strides.  The Pallas kernel carries them as two more input
// streams read under a runtime-false predicate, only so that Mosaic keeps
// their HBM->VMEM DMA; here a prefetch is a hint that never reaches
// registers, so no predicate is needed.  Each CTA computes exactly what
// K4/K5 compute for its tile (same plan, same split-K, same reduction
// order: the output is bitwise K4/K5's) and, over its k-loop, asks L2 for
// the rows of the next slab that the same tile reads in the next layer's
// call (cp.async.bulk.prefetch.L2, one row segment per instruction,
// issued stage by stage beside the live loads, so the prefetches do not
// crowd the live stream at its start), plus its scale rows.  Nothing goes
// to shared memory or registers.  The wrapper engages K6 only for a slab
// of at most 16 MiB (engine/ops/quant_matmul.py, PREFETCH_L2_BUDGET): the
// live chunk and the prefetched one must both sit in the 50 MB L2, beside
// the activations, for the prefetch to survive to its use; the Pallas
// kernel's 4 MiB VMEM budget plays that part on the TPU.
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace kaito {

// ---------------------------------------------------------------------------
// CUDA-core path (fp32 x, and shapes off the tensor-core tiles)
// ---------------------------------------------------------------------------

constexpr int QM_THREADS = 256;
constexpr int QM_LANES = QM_THREADS / 32;   // warps, each on its own rows of K
constexpr int QM_COLS = 8;                  // columns per thread: one 8-byte load
constexpr int QM_TN = 32 * QM_COLS;         // columns per CTA
constexpr int QM_UNROLL = 4;                // weight loads in flight per thread
constexpr int QM_TARGET_CTAS = 264;         // two CTAs for each of the 132 SMs
constexpr int QM_X_MAX = 1024;              // x values per row kept in shared memory
static_assert(QM_THREADS == QM_TN, "the reduction maps one thread to a column");

// Launch shape.  A k-step is one row of the code array: an in-row for
// int8, a packed row (two in-rows) for int4.
struct QmPlan {
  int rt;        // rows of x per CTA: 1, 4 or 8
  int n_split;   // K slices, one CTA each per tile
  int kc;        // k-steps per slice, a multiple of QM_LANES
};

inline QmPlan qm_plan(int rows, int K, int N, bool int4) {
  const int rt = rows <= 1 ? 1 : rows <= 4 ? 4 : 8;
  const int ks = int4 ? K / 2 : K;
  const int vps = int4 ? 2 : 1;
  const int tiles = ((rows + rt - 1) / rt) * ((N + QM_TN - 1) / QM_TN);
  int n_split = (QM_TARGET_CTAS + tiles - 1) / tiles;
  n_split = std::min(n_split, std::max(1, ks / QM_LANES));
  n_split = std::max(n_split, (ks * vps + QM_X_MAX - 1) / QM_X_MAX);
  int kc = (ks + n_split - 1) / n_split;
  kc = (kc + QM_LANES - 1) / QM_LANES * QM_LANES;
  return {rt, (ks + kc - 1) / kc, kc};
}

// Eight codes of one row, columns col..col+7; zeros past N or when !ok.
__device__ __forceinline__ uint2 qm_load(const int8_t* p, bool ok, int col, int N,
                                         bool vec) {
  uint2 v = make_uint2(0u, 0u);
  if (!ok || col >= N) return v;
  if (vec) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < QM_COLS; ++c)
    if (col + c < N) word[c / 4] |= (uint32_t)(uint8_t)p[c] << (8 * (c % 4));
  return make_uint2(word[0], word[1]);
}

__device__ __forceinline__ int qm_byte(const uint2& v, int c) {
  const uint32_t word = c < 4 ? v.x : v.y;
  return (int)(int8_t)(uint8_t)(word >> (8 * (c % 4)));
}

// Ask L2 for `bytes` (a multiple of 16) at the 16-byte aligned global
// address p; a hint: nothing is loaded into the SM.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .u64 g;\n\tcvta.to.global.u64 g, %0;\n\t"
      "cp.async.bulk.prefetch.L2.global [g], %1;\n\t}\n" ::"l"(p),
      "r"(bytes)
      : "memory");
}

// Prefetch row `r` of a plane, columns [col, min(col + 128, N)) of
// element size `es`, cut down to whole 16-byte pieces.
__device__ __forceinline__ void prefetch_row(const void* base, size_t ld, int r,
                                             int col, int N, int es) {
  if (col >= N) return;
  const uint32_t bytes = (uint32_t)(min(128, N - col) * es) & ~15u;
  if (bytes)
    prefetch_l2(static_cast<const char*>(base) + ((size_t)r * ld + col) * es, bytes);
}

// acc += part * scale(group row), part = 0.
template <int R>
__device__ __forceinline__ void qm_fold(float (&acc)[R][QM_COLS],
                                        float (&part)[R][QM_COLS],
                                        const float* __restrict__ s_row, int col,
                                        int N) {
#pragma unroll
  for (int c = 0; c < QM_COLS; ++c) {
    const float s = col + c < N ? s_row[col + c] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][c] = fmaf(part[r][c], s, acc[r][c]);
      part[r][c] = 0.f;
    }
  }
}

template <typename T, bool INT4, int R, bool PF>
__global__ void __launch_bounds__(QM_THREADS)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    float* __restrict__ part_out, int rows, int K, int N, int gk,
                    int kc, int n_split, bool vec, int ldw, int lds,
                    const int8_t* __restrict__ nw, const float* __restrict__ ns) {
  constexpr int VPS = INT4 ? 2 : 1;          // x values per k-step
  const int ks = INT4 ? K / 2 : K;
  const int row0 = blockIdx.x * R, n0 = blockIdx.y * QM_TN, split = blockIdx.z;
  const int k_lo = split * kc, k_hi = min(ks, k_lo + kc);
  const int tid = threadIdx.x, lane_k = tid / 32;
  const int col = n0 + (tid % 32) * QM_COLS;

  extern __shared__ float smem[];
  float* x_s = smem;                          // [kc * VPS][R]
  float* red = smem + (size_t)kc * VPS * R;   // [QM_LANES][QM_TN]

  // x[row0 + r][k_lo * VPS + j] -> x_s[j * R + r]; neighbouring threads
  // read neighbouring x values of one row
  const int nx = (k_hi - k_lo) * VPS;
  for (int i = tid; i < nx * R; i += QM_THREADS) {
    const int r = i / nx, j = i % nx, row = row0 + r;
    x_s[j * R + r] = row < rows ? to_f(x[(size_t)row * K + (size_t)k_lo * VPS + j])
                                : 0.f;
  }
  __syncthreads();

  float acc[R][QM_COLS], part[R][QM_COLS];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < QM_COLS; ++c) acc[r][c] = part[r][c] = 0.f;
  int g_cur = min(k_lo + lane_k, ks - 1) / gk;
  // K6: the first row tile prefetches the scale rows of its slice (two
  // 128-column segments of fp32 each)
  if (PF && blockIdx.x == 0) {
    const int g_lo = k_lo / gk, g_hi = (k_hi - 1) / gk;
    for (int i = tid; i < (g_hi - g_lo + 1) * 2; i += QM_THREADS)
      prefetch_row(ns, lds, g_lo + i / 2, n0 + (i % 2) * 128, N, 4);
  }

  for (int kb = k_lo + lane_k; kb < k_hi; kb += QM_LANES * QM_UNROLL) {
    uint2 wv[QM_UNROLL];
#pragma unroll
    for (int u = 0; u < QM_UNROLL; ++u) {
      const int k = kb + u * QM_LANES;
      wv[u] = qm_load(w + (size_t)k * ldw + col, k < k_hi, col, N, vec);
    }
    if (PF && blockIdx.x == 0 && tid % 32 < 2 * QM_UNROLL) {
      // this warp's rows of the next slab: two 128-column segments each
      const int k = kb + (tid % 32 / 2) * QM_LANES;
      if (k < k_hi) prefetch_row(nw, ldw, k, n0 + (tid % 2) * 128, N, 1);
    }
#pragma unroll
    for (int u = 0; u < QM_UNROLL; ++u) {
      const int k = kb + u * QM_LANES;
      if (k >= k_hi) continue;
      const int g = k / gk;
      if (g != g_cur) {            // a thread's rows only move forward
        qm_fold<R>(acc, part, scale + (size_t)g_cur * lds, col, N);
        g_cur = g;
      }
      const float* xr = x_s + (size_t)(k - k_lo) * VPS * R;
      float xa[R], xb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xa[r] = xr[r];
        xb[r] = INT4 ? xr[R + r] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < QM_COLS; ++c) {
        const int b = qm_byte(wv[u], c);
        if constexpr (INT4) {
          const int p = b & 0xFF;
          const float lo = (float)((p & 0xF) - 8), hi = (float)((p >> 4) - 8);
#pragma unroll
          for (int r = 0; r < R; ++r)
            part[r][c] = fmaf(xb[r], hi, fmaf(xa[r], lo, part[r][c]));
        } else {
          const float v = (float)b;
#pragma unroll
          for (int r = 0; r < R; ++r) part[r][c] = fmaf(xa[r], v, part[r][c]);
        }
      }
    }
  }
  qm_fold<R>(acc, part, scale + (size_t)g_cur * lds, col, N);

  // add the 8 warps' sums, one row at a time; thread tid owns column n0 + tid
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < QM_COLS; ++c)
      red[lane_k * QM_TN + (tid % 32) * QM_COLS + c] = acc[r][c];
    __syncthreads();
    const int row = row0 + r, n = n0 + tid;
    if (row < rows && n < N) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < QM_LANES; ++l) s += red[l * QM_TN + tid];
      if (n_split == 1)
        out[(size_t)row * N + n] = from_f<T>(s);
      else
        part_out[((size_t)split * rows + row) * N + n] = s;
    }
    __syncthreads();
  }
}

// out[i] = sum over the K slices of their fp32 partial outputs.
template <typename T>
__global__ void quant_matmul_reduce_kernel(const float* __restrict__ part,
                                           T* __restrict__ out, long long total,
                                           int n_split) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) s += part[k * total + i];
    out[i] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 x): mma.sync m16n8k16, bf16 operands, fp32 sums.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;        // 4 warps, 32 columns each
constexpr int TC_TN = 128;             // columns per CTA
constexpr int TC_TK = 64;              // in-rows per pipeline stage
constexpr int TC_WS = TC_TN + 8;       // W tile row stride (bf16): 272 B, ldmatrix conflict-free
constexpr int TC_XS = TC_TK + 8;       // x tile row stride (bf16): 36 words, fragment reads conflict-free
constexpr int TC_TARGET_CTAS = 528;    // four CTAs for each of the 132 SMs

// The tensor-core path takes bf16 x with whole stages and whole column
// tiles, and int4 groups of whole stages (the Llama projections all fit).
inline bool tc_fits(int K, int N, int gk, bool bf16) {
  return bf16 && K % TC_TK == 0 && N % TC_TN == 0 && gk % TC_TK == 0;
}

// mt: m16 tiles per CTA (1 for up to 16 rows, else 4); kc: in-rows per K
// slice, whole stages (and, for int4, whole groups).
struct TcPlan {
  int mt;
  int n_split;
  int kc;
};

inline TcPlan tc_plan(int rows, int K, int N, int gk, bool int4) {
  const int mt = rows <= 16 ? 1 : 4;
  const int unit = int4 ? gk : TC_TK;
  const int tiles = ((rows + 16 * mt - 1) / (16 * mt)) * (N / TC_TN);
  const int n_units = K / unit;
  const int n_split = std::min(n_units, std::max(1, (TC_TARGET_CTAS + tiles - 1) / tiles));
  const int kc = (n_units + n_split - 1) / n_split * unit;
  return {mt, (K + kc - 1) / kc, kc};
}

// Two int8 codes (bytes `lo` and `hi` of `word`) as a bf16x2: the biased
// byte sits in the mantissa of 2^23 and the bias is subtracted in fp32,
// both exact for |code| <= 128.
__device__ __forceinline__ uint32_t tc_i8x2(uint32_t word, int lo, int hi) {
  const uint32_t biased = word ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7640 | lo)) -
                  8388736.f;
  const float b = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7640 | hi)) -
                  8388736.f;
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Nibbles at bit `shift` of bytes `lo` and `hi` of `word` (biased by +8)
// as a bf16x2 of the codes: 128 + nibble is a bf16 with the nibble in its
// mantissa, and 136 is subtracted in bf16, exactly.
__device__ __forceinline__ uint32_t tc_i4x2(uint32_t word, int shift, int lo, int hi) {
  const uint32_t nib = (word >> shift) & 0x0F0F0F0Fu;
  // bytes: [nib lo, 0x43, nib hi, 0x43]
  const uint32_t bits = __byte_perm(nib, 0x43u, (lo) | (4 << 4) | (hi << 8) | (4 << 12));
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void tc_mma(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tc_ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// One CTA: rows [row0, row0 + 16 MT) x columns [n0, n0 + 128) over the K
// slice [k_lo, k_hi).  Each stage of 64 in-rows: the codes (and x) for the
// stage are already in registers; they are widened to bf16 into shared
// memory (W as [k][n], read back as B fragments with ldmatrix.trans), the
// next stage's loads are issued, and the stage's 4 k16 steps run on the
// tensor cores.  A group's partial sums fold into the fp32 accumulators
// with its scales when the group ends (int8: once, at the slice's end).
template <bool INT4, int MT, bool PF>
__global__ void __launch_bounds__(TC_THREADS)
quant_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part_out, int rows, int K, int N, int gk,
                       int kc, int n_split, int ldw, int lds,
                       const int8_t* __restrict__ nw, const float* __restrict__ ns) {
  constexpr int W_CHUNKS = (INT4 ? TC_TK / 2 : TC_TK) * TC_TN / 16 / TC_THREADS;
  constexpr int X_CHUNKS = 16 * MT * TC_TK / 8 / TC_THREADS;   // 16-byte pieces
  static_assert(W_CHUNKS >= 1 && 16 * MT * TC_TK / 8 % TC_THREADS == 0, "stage split");
  __shared__ __align__(16) __nv_bfloat16 ws[TC_TK * TC_WS];        // [k][n]
  __shared__ __align__(16) __nv_bfloat16 xs[16 * MT * TC_XS];      // [row][k]

  const int row0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * TC_TN, split = blockIdx.z;
  const int k_lo = split * kc, k_hi = min(K, k_lo + kc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int code_rows = INT4 ? K / 2 : K;   // rows of the code array

  uint4 wr[W_CHUNKS], xr[X_CHUNKS];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int j = 0; j < W_CHUNKS; ++j) {
      const int c = tid + j * TC_THREADS;              // 8 chunks of 16 B per row
      const int r = (INT4 ? k0 / 2 : k0) + c / 8;
      wr[j] = __ldg(reinterpret_cast<const uint4*>(
                  w + (size_t)min(r, code_rows - 1) * ldw + n0) + c % 8);
    }
#pragma unroll
    for (int j = 0; j < X_CHUNKS; ++j) {
      const int c = tid + j * TC_THREADS;              // 8 chunks of 8 values per row
      const int row = row0 + c / 8;
      xr[j] = row < rows ? __ldg(reinterpret_cast<const uint4*>(
                               x + (size_t)row * K + k0) + c % 8)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_stage = [&]() {
#pragma unroll
    for (int j = 0; j < W_CHUNKS; ++j) {
      const int c = tid + j * TC_THREADS;
      const int r = c / 8, col = (c % 8) * 16;
      const uint32_t in[4] = {wr[j].x, wr[j].y, wr[j].z, wr[j].w};
      if constexpr (INT4) {
        // packed row r holds in-rows 2r (low nibbles) and 2r + 1 (high)
        uint4* lo = reinterpret_cast<uint4*>(ws + (2 * r) * TC_WS + col);
        uint4* hi = reinterpret_cast<uint4*>(ws + (2 * r + 1) * TC_WS + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          lo[h] = make_uint4(tc_i4x2(in[2 * h], 0, 0, 1), tc_i4x2(in[2 * h], 0, 2, 3),
                             tc_i4x2(in[2 * h + 1], 0, 0, 1),
                             tc_i4x2(in[2 * h + 1], 0, 2, 3));
          hi[h] = make_uint4(tc_i4x2(in[2 * h], 4, 0, 1), tc_i4x2(in[2 * h], 4, 2, 3),
                             tc_i4x2(in[2 * h + 1], 4, 0, 1),
                             tc_i4x2(in[2 * h + 1], 4, 2, 3));
        }
      } else {
        uint4* dst = reinterpret_cast<uint4*>(ws + r * TC_WS + col);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dst[h] = make_uint4(tc_i8x2(in[2 * h], 0, 1), tc_i8x2(in[2 * h], 2, 3),
                              tc_i8x2(in[2 * h + 1], 0, 1), tc_i8x2(in[2 * h + 1], 2, 3));
      }
    }
#pragma unroll
    for (int j = 0; j < X_CHUNKS; ++j) {
      const int c = tid + j * TC_THREADS;
      *reinterpret_cast<uint4*>(xs + (c / 8) * TC_XS + (c % 8) * 8) = xr[j];
    }
  };

  float acc[MT][4][4], part[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = part[m][n][e] = 0.f;
  const int colw = n0 + warp * 32;   // this warp's first column

  // K6: the first row tile prefetches the scale rows of its slice (one
  // 128-column segment of fp32 each)
  if (PF && blockIdx.x == 0) {
    const int g_lo = k_lo / gk, g_hi = (k_hi - 1) / gk;
    for (int i = tid; i <= g_hi - g_lo; i += TC_THREADS)
      prefetch_row(ns, lds, g_lo + i, n0, N, 4);
  }

  load_stage(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += TC_TK) {
    __syncthreads();                 // the previous stage's reads are done
    store_stage();
    __syncthreads();
    if (k0 + TC_TK < k_hi) load_stage(k0 + TC_TK);
    // K6: this stage's code rows of the next slab, one 128-byte row
    // segment per thread
    constexpr int STAGE_ROWS = INT4 ? TC_TK / 2 : TC_TK;
    if (PF && blockIdx.x == 0 && tid < STAGE_ROWS)
      prefetch_row(nw, ldw, (INT4 ? k0 / 2 : k0) + tid, n0, N, 1);
#pragma unroll
    for (int kk = 0; kk < TC_TK; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        tc_ldmatrix_x4_trans(
            r, ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_WS + (colw - n0) +
                   p * 16 + (lane >> 4) * 8);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const __nv_bfloat16* xa = xs + (m * 16 + g) * TC_XS + kk + 2 * t;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(xa),
                               *reinterpret_cast<const uint32_t*>(xa + 8 * TC_XS),
                               *reinterpret_cast<const uint32_t*>(xa + 8),
                               *reinterpret_cast<const uint32_t*>(xa + 8 * TC_XS + 8)};
#pragma unroll
        for (int n = 0; n < 4; ++n) tc_mma(part[m][n], a, b[n][0], b[n][1]);
      }
    }
    if ((k0 + TC_TK) % gk == 0 || k0 + TC_TK >= k_hi) {
      // the group of in-rows [k0 + 64 - gk, k0 + 64) is complete
      const float* s_row = scale + (size_t)(k0 / gk) * lds;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 sc = *reinterpret_cast<const float2*>(s_row + colw + n * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][n][0] = fmaf(part[m][n][0], sc.x, acc[m][n][0]);
          acc[m][n][1] = fmaf(part[m][n][1], sc.y, acc[m][n][1]);
          acc[m][n][2] = fmaf(part[m][n][2], sc.x, acc[m][n][2]);
          acc[m][n][3] = fmaf(part[m][n][3], sc.y, acc[m][n][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
        }
      }
    }
  }

  // C fragment: elements (row g, cols 2t, 2t+1) and (row g + 8, same cols)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + m * 16 + g + 8 * h, col = colw + n * 8 + 2 * t;
        if (row >= rows) continue;
        const float v0 = acc[m][n][2 * h], v1 = acc[m][n][2 * h + 1];
        if (n_split == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(part_out + ((size_t)split * rows + row) * N + col) =
              make_float2(v0, v1);
        }
      }
}

// The plane pointers and strides of one call: the live weight and, for
// K6, the next layer's (nw, ns; null for K4/K5).
struct QmArgs {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* work;
  int rows, K, N, groups, ldw, lds;
  const int8_t* nw;
  const float* ns;
};

template <bool INT4, int MT, bool PF>
cudaError_t launch_quant_matmul_tc(const QmArgs& a, int gk, const TcPlan& pl,
                                   cudaStream_t stream) {
  const dim3 grid((a.rows + 16 * MT - 1) / (16 * MT), a.N / TC_TN, pl.n_split);
  quant_matmul_tc_kernel<INT4, MT, PF><<<grid, TC_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.w, a.scale,
      static_cast<__nv_bfloat16*>(a.out), a.work, a.rows, a.K, a.N, gk, pl.kc,
      pl.n_split, a.ldw, a.lds, a.nw, a.ns);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pl.n_split == 1) return err;
  const long long total = (long long)a.rows * a.N;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 1024);
  quant_matmul_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
      a.work, static_cast<__nv_bfloat16*>(a.out), total, pl.n_split);
  return cudaGetLastError();
}

template <typename T, bool INT4, int R, bool PF>
cudaError_t launch_quant_matmul(const QmArgs& a, const QmPlan& pl, cudaStream_t stream) {
  const int ks = INT4 ? a.K / 2 : a.K;
  const bool vec = a.N % QM_COLS == 0 && a.ldw % QM_COLS == 0 &&
                   reinterpret_cast<uintptr_t>(a.w) % 8 == 0;
  const size_t smem =
      ((size_t)pl.kc * (INT4 ? 2 : 1) * R + (size_t)QM_LANES * QM_TN) * sizeof(float);
  auto kernel = quant_matmul_kernel<T, INT4, R, PF>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.rows + R - 1) / R, (a.N + QM_TN - 1) / QM_TN, pl.n_split);
  kernel<<<grid, QM_THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), a.w, a.scale, static_cast<T*>(a.out), a.work, a.rows,
      a.K, a.N, ks / a.groups, pl.kc, pl.n_split, vec, a.ldw, a.lds, a.nw, a.ns);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.n_split == 1) return err;
  const long long total = (long long)a.rows * a.N;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 1024);
  quant_matmul_reduce_kernel<T><<<blocks, 256, 0, stream>>>(a.work, static_cast<T*>(a.out),
                                                            total, pl.n_split);
  return cudaGetLastError();
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, bool INT4, bool PF>
cudaError_t dispatch_rows(const QmArgs& a, cudaStream_t stream) {
  const int gk = a.K / a.groups;   // in-rows per scale group
  // the tensor-core path reads 16-byte code pieces and float2 scales
  if (tc_fits(a.K, a.N, gk, std::is_same<T, __nv_bfloat16>::value) && aligned(a.x, 16) &&
      aligned(a.w, 16) && a.ldw % 16 == 0 && aligned(a.scale, 8) && a.lds % 2 == 0 &&
      aligned(a.out, 16)) {
    const TcPlan tp = tc_plan(a.rows, a.K, a.N, gk, INT4);
    if (tp.mt == 1) return launch_quant_matmul_tc<INT4, 1, PF>(a, gk, tp, stream);
    return launch_quant_matmul_tc<INT4, 4, PF>(a, gk, tp, stream);
  }
  const QmPlan pl = qm_plan(a.rows, a.K, a.N, INT4);
  if (pl.rt == 1) return launch_quant_matmul<T, INT4, 1, PF>(a, pl, stream);
  if (pl.rt == 4) return launch_quant_matmul<T, INT4, 4, PF>(a, pl, stream);
  return launch_quant_matmul<T, INT4, 8, PF>(a, pl, stream);
}

template <bool PF>
int dispatch(const QmArgs& a, int int4, int dtype, cudaStream_t s) {
  if (a.rows < 1 || a.K < 1 || a.N < 1 || a.groups < 1 || (int4 && a.K % 2) ||
      a.ldw < a.N || (int4 && a.groups > 1 && a.lds < a.N)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    return int4 ? (int)dispatch_rows<__nv_bfloat16, true, PF>(a, s)
                : (int)dispatch_rows<__nv_bfloat16, false, PF>(a, s);
  }
  if (dtype == 0) {
    return int4 ? (int)dispatch_rows<float, true, PF>(a, s)
                : (int)dispatch_rows<float, false, PF>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace kaito

// x [rows, K] (dtype 0 = float32, 1 = bfloat16); w: int8 codes [K, N]
// (int4 = 0) or packed nibbles [K/2, N] (int4 = 1), rows ldw elements
// apart; scale fp32 [groups, N] (groups = 1 for int8), rows lds elements
// apart; out [rows, N] contiguous in x's dtype.  work: fp32 scratch of
// kaito_quant_matmul_workspace_floats(...) floats (none when that is 0).
// Returns the CUDA error of the launches (0 = success).
extern "C" int kaito_quant_matmul(const void* x, const void* w, const float* scale,
                                  void* out, float* work, int rows, int K, int N,
                                  int groups, int int4, int dtype, int ldw, int lds,
                                  void* stream) {
  const kaito::QmArgs a{x, static_cast<const int8_t*>(w), scale, out, work, rows, K, N,
                        groups, ldw, lds, nullptr, nullptr};
  return kaito::dispatch<false>(a, int4, dtype, static_cast<cudaStream_t>(stream));
}

// K6: kaito_quant_matmul, and the same tiles of the next layer's codes
// (next_w) and scales (next_scale), in w's and scale's shapes and strides
// and 16-byte aligned, prefetched into L2.  The output is bitwise
// kaito_quant_matmul's.
extern "C" int kaito_quant_matmul_pf(const void* x, const void* w, const float* scale,
                                     const void* next_w, const float* next_scale,
                                     void* out, float* work, int rows, int K, int N,
                                     int groups, int int4, int dtype, int ldw, int lds,
                                     void* stream) {
  if (!kaito::aligned(next_w, 16) || !kaito::aligned(next_scale, 16) || ldw % 16 ||
      (int4 && groups > 1 && lds % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const kaito::QmArgs a{x, static_cast<const int8_t*>(w), scale, out, work, rows, K, N,
                        groups, ldw, lds, static_cast<const int8_t*>(next_w), next_scale};
  return kaito::dispatch<true>(a, int4, dtype, static_cast<cudaStream_t>(stream));
}

// fp32 scratch kaito_quant_matmul needs: one [rows, N] partial output per K
// slice when K is split, else nothing (the larger of the two paths' needs).
extern "C" long long kaito_quant_matmul_workspace_floats(int rows, int K, int N,
                                                         int groups, int int4,
                                                         int dtype) {
  using namespace kaito;
  int n_split = qm_plan(rows, K, N, int4 != 0).n_split;
  if (groups >= 1 && tc_fits(K, N, K / groups, dtype == 1))
    n_split = std::max(n_split, tc_plan(rows, K, N, K / groups, int4 != 0).n_split);
  return n_split > 1 ? (long long)n_split * rows * N : 0;
}
