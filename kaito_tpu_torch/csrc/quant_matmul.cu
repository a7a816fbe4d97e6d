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
// binds), operations at prefill sizes (200 rows: 400 flop per int8 code
// byte, 800 per int4 byte).  The HBM stream is the quantized bytes: codes
// arrive as int8 and are widened on the SM, exactly (int8 through the
// mantissa of 2^23 in fp32, int4 through the mantissa of 128 in bf16),
// and the bf16 weight is never materialised.  The Pallas version's
// even/odd split of x outside the kernel (a Mosaic workaround) is not
// needed: the int4 byte of in-rows 2i and 2i+1 is widened into both rows
// of the tile.
//
// Three paths, chosen from what the call gives them (pick_path):
// - Wide (bf16 x, 17-256 rows, K a multiple of 64, N of 128, int4 groups
//   of whole 64-row stages, 16-byte aligned planes: every Llama
//   projection and its ring chunks at prefill rows).  The product runs
//   transposed, out^T = W^T x^T, so that the widened weight is the wgmma
//   A operand, which may come from registers: a CTA owns 128 columns of W
//   for nt rows of x (64, 128 or 256: all of the call's; int4 at most
//   128, two CTAs per column tile over that), and each code byte is read
//   once and widened once, in registers, for all those rows, never going
//   back to shared memory.  256 threads (two warpgroups), one CTA per SM
//   (two for int8 up to 128 rows and int4 up to 64); threads 0 and 128
//   keep a ring of x stages ([nt rows][64 k] bf16 in the 128-byte
//   swizzle, from L2: the K-major B operand) and a ring of up to 8 code
//   stages ([64 k][128] int8 or [32][128] int4 bytes in the 128-byte
//   swizzle, from HBM, each also asked of L2 a ring ahead) in flight by
//   TMA with mbarrier completion.  Warpgroup w owns the tile's columns 64
//   w .. 64 w + 63 as the M of wgmma m64 n nt k16: each stage it reads
//   its columns' codes with 16-byte loads (the swizzle keeps them free of
//   bank conflicts), widens them into the A fragments of the stage's four
//   k-steps (int8 through the mantissa of 2^23 in fp32, int4 through the
//   mantissa of 128 in bf16: exact), frees the code slot, issues the
//   stage's wgmmas and waits for them.  Nothing runs between the issue
//   and the wait, so the A registers the wgmmas read asynchronously stay
//   untouched; the two warpgroups share the tensor cores, so one widens
//   while the other's products run.  The fp32 accumulator holds one int4
//   group's partial dot; at the group's end it folds into a second fp32
//   accumulator with the scales, staged in shared memory at the start
//   (int8 folds once, at the end): that second accumulator is why int4
//   stops at 128 rows a CTA.  K is split only where the tiles leave SMs
//   idle (split = the most CTAs that stay one wave: q/o, down and k/v,
//   not gate/up).  The plan mirrors wide_plan in
//   engine/ops/quant_matmul.py, which the CPU tests hold.
// - Decode rows (bf16 x, 1-16 rows, K and int4 groups in whole 64-row
//   (int8) or 128-row (int4) stages: every decode step's projections and
//   the TP ring's chunks).  Bound by bytes: a code byte feeds 2-32 flops,
//   and a call must stream every code once (gate/up int8 at 8 rows: 58.7
//   MB, 17.6 us at 3.35 TB/s).  One launch, whose grid is one CTA per
//   128-column tile and K slice, the split a function of N, K, the SM
//   count and the rows' n8 tiles, never of the pointers (decode_plan).
//   Each CTA's 128 threads keep a ring of 4 stages of 64 code rows (8 KB,
//   for int4 128 in-rows) and their x rows in shared memory, filled by
//   16-byte cp.asyncs in one commit group a stage, so three stages are in
//   flight while one is read; rows are padded so every read below is
//   free of bank conflicts.  The product runs transposed, out^T = W^T
//   x^T, on mma.sync m16n8k16: the weight's columns on M (a warp owns 32
//   as two m16 tiles) and the rows of x on N (one n8 tile, two for 9-16
//   rows), so no product is spent on rows the call lacks.  Within a k16
//   step a lane's k are chosen so that it reads its codes as whole words
//   and widens them straight into the A fragments (int8: two prmt, two
//   fadd and a prmt a pair; int4: a prmt, a lop3 and an hsub2), and x as
//   whole words; no bf16 copy of the weight exists anywhere.  int4's
//   scales fold per group, int8's once per slice.  Where K is split, each
//   warp writes its fp32 partials to the card's workspace and the last
//   warp of a 32-column block to arrive (a fence, then an atomicAdd on a
//   counter of the workspace) sums every slice's in slice order, casts
//   once and resets the counter: deterministic, no atomics on the output,
//   and the next call (or a CUDA graph's replay) finds every counter at
//   zero.  The workspace is sized once per card
//   (kaito_quant_matmul_decode_workspace) and every launch parameter is a
//   pointer or an int, so a captured call replays after its inputs change
//   and after larger calls.  What holds it (H100, PERF.md): the stream
//   of 128-byte row segments, which the card serves at ~2.3-2.7 TB/s
//   here; a fixed ~3 us of launch and ramp; the split merge's three
//   round trips at the end (~2-3 us); int4's widening, which overlaps the
//   stream only in part.
// - CUDA cores, for fp32 x (the goldens), more than 256 rows, and any
//   other shape: a CTA owns 256 columns, up to 8 rows of x (in shared
//   memory, fp32) and a slice of K; its 8 warps walk interleaved rows of
//   the slice with 8-byte loads, each thread keeping 8 rows x 8 columns
//   of fp32 sums, and the warps' sums are added through shared memory.
//   Tails of K and N are masked, and rows not a multiple of 8 bytes take
//   byte loads.
// On the wide and CUDA-core paths, where K is split, the slices' fp32
// partial outputs go to a workspace of the call and a second kernel sums
// them in slice order: the output is the same from run to run, and no
// atomics are used.
//
// K6 (template flag PF, entry kaito_quant_matmul_pf) is the same kernels
// with two more pointers: the next layer's codes and scales, in the same
// layout and strides.  The Pallas kernel carries them as two more input
// streams read under a runtime-false predicate, only so that Mosaic keeps
// their HBM->VMEM DMA; here a prefetch is a hint that never reaches
// registers, so no predicate is needed.  Each CTA computes exactly what
// K4/K5 compute for its tile (same path, plan and reduction order: the
// output is bitwise K4/K5's) and, over its k-loop, asks L2 for the rows
// of the next slab that the same tile reads in the next layer's call,
// stage by stage beside the live loads, so the prefetches do not crowd
// the live stream at its start, plus its scale rows: on the decode-row
// path a prefetch.global.L2 per 32-byte sector (a bulk prefetch per row
// queues on the SM's TMA unit), on the other paths
// cp.async.bulk.prefetch.L2 per row segment.  Nothing goes to shared
// memory or registers.  The wrapper engages K6 only for a slab of at most
// 16 MiB (engine/ops/quant_matmul.py, PREFETCH_L2_BUDGET): the live chunk
// and the prefetched one must both sit in the 50 MB L2, beside the
// activations, for the prefetch to survive to its use; the Pallas
// kernel's 4 MiB VMEM budget plays that part on the TPU.
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// Prefetch row `r` of a plane, columns [col, min(col + n, N)) of element
// size `es`, cut down to whole 16-byte pieces.
__device__ __forceinline__ void prefetch_span(const void* base, size_t ld, int r,
                                              int col, int n, int N, int es) {
  if (col >= N) return;
  const uint32_t bytes = (uint32_t)(min(n, N - col) * es) & ~15u;
  if (bytes)
    prefetch_l2(static_cast<const char*>(base) + ((size_t)r * ld + col) * es, bytes);
}

__device__ __forceinline__ void prefetch_row(const void* base, size_t ld, int r,
                                             int col, int N, int es) {
  prefetch_span(base, ld, r, col, 128, N, es);
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
// Decode-row path (bf16 x, up to 16 rows): mma.sync m16n8k16 with the
// weight's columns on M and the rows of x on N, the codes streamed through
// a cp.async ring and widened straight into the A fragments; one launch.
// ---------------------------------------------------------------------------

constexpr int DQ_THREADS = 128;        // 4 warps, 32 columns each
constexpr int DQ_TN = 128;             // columns per CTA
constexpr int DQ_CROWS = 64;           // code rows per stage: 8 KB
constexpr int DQ_MAX_ROWS = 16;        // two n8 tiles
constexpr int DQ_CTAS_PER_SM = 3;      // grid target: one wave of up to this many CTAs an SM
constexpr int DQ_RING = 4;             // stages a CTA holds: three in flight while one is read
constexpr int DQ_MIN_STAGES = 4;       // stages of a K slice in a wave of several CTAs an SM
constexpr int TC_STAGE = 64;           // the unit of tc_fits: a wide-path stage

// in-rows per decode-row stage: 64 int8 rows, or 64 packed int4 rows
constexpr int dq_stage(bool int4) { return int4 ? 2 * DQ_CROWS : DQ_CROWS; }

// The tensor-core paths take bf16 x with whole stages and whole column
// tiles, and int4 groups of whole stages (the Llama projections all fit).
inline bool tc_fits(int K, int N, int gk, bool bf16) {
  return bf16 && K % TC_STAGE == 0 && N % DQ_TN == 0 && gk % TC_STAGE == 0;
}

// The decode-row path's shapes: whole stages, whole column tiles, int4
// groups of whole stages.
inline bool decode_fits(int K, int N, int gk, bool int4) {
  const int ks = dq_stage(int4);
  return K % ks == 0 && N % DQ_TN == 0 && gk % ks == 0;
}

// Launch plan of the decode-row path (mirrored by decode_plan in
// engine/ops/quant_matmul.py, which the CPU tests hold): nt n8 tiles of
// rows (1 up to 8 rows, else 2); one CTA per 128-column tile and K slice,
// K cut into n_split slices of kc in-rows (whole stages; for int4 whole
// groups).  The split is the larger of two: one CTA an SM with slices of
// at least 2 stages (small planes, where each CTA's latency chain sets
// the time), and one wave of DQ_CTAS_PER_SM CTAs an SM (2 for nt = 2,
// whose merge moves twice the partials) with slices of at least
// DQ_MIN_STAGES stages (large planes, where the stream does); none where
// the tiles fill that wave.  A function of N, K, the SM count and nt,
// never of the pointers.
struct DecodePlan {
  int nt, n_split, kc;
};

inline DecodePlan decode_plan(int rows, int K, int N, int gk, bool int4, int sms) {
  const int nt = rows <= 8 ? 1 : 2;
  const int ks = dq_stage(int4);
  const int unit = int4 ? gk : ks;
  const int n_units = K / unit;
  const int tiles = N / DQ_TN;
  sms = std::max(sms, 1);
  const int slots = (nt == 1 ? DQ_CTAS_PER_SM : DQ_CTAS_PER_SM - 1) * sms;
  const int per_sm = std::min(sms / tiles, K / (ks * 2));
  const int wave = tiles >= slots ? 1 : std::min(slots / tiles, K / (ks * DQ_MIN_STAGES));
  const int split = std::max(1, std::min(std::max(per_sm, wave), n_units));
  const int kc = (n_units + split - 1) / split * unit;
  return {nt, (K + kc - 1) / kc, kc};
}

// The per-card workspace that holds every split call's partials and
// merge counters: a split plan has at most `slots` CTAs of 128 columns,
// each with at most 16 rows of fp32 partials and 4 counters (one per
// warp's 32 columns).
inline long long decode_workspace_floats(int sms) {
  return (long long)DQ_CTAS_PER_SM * std::max(sms, 1) * DQ_TN * DQ_MAX_ROWS;
}
inline long long decode_workspace_counters(int sms) {
  return (long long)DQ_CTAS_PER_SM * std::max(sms, 1) * (DQ_TN / 32);
}

// Dynamic shared memory of one CTA: a ring of DQ_RING stages, each the
// stage's 64 code rows (128 bytes each, CS apart) and its x rows (KS bf16,
// XS apart; rows past the call's zeroed once).  The padding keeps every
// read conflict-free: a lane's four 4-byte code reads of a k16 step come
// from rows whose 36-word offsets put the four t's 8 banks apart, and its
// x reads from rows 4 (int8, 4-byte reads) or 8 (int4, 8-byte reads)
// banks apart.
template <bool INT4>
struct DqLayout {
  static constexpr int KS = dq_stage(INT4);
  static constexpr int CS = DQ_TN + 16;
  static constexpr int XS = 2 * KS + (INT4 ? 32 : 16);
  static constexpr int CODES = DQ_CROWS * CS;
  static constexpr int SLOT = CODES + DQ_MAX_ROWS * XS;
  static constexpr int SMEM = DQ_RING * SLOT;
};

// Ask L2 for the 32-byte sector at p, through the load/store unit: a
// hint, nothing reaches the SM.  (A bulk prefetch per 128-byte row costs
// the SM's TMA unit a request each, which queued behind one another when
// one CTA an SM issues them.)
__device__ __forceinline__ void prefetch_sector(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two int8 codes, byte c of the biased words lo (k) and hi (k + 1), as a
// bf16x2: each byte sits in the mantissa of 2^23 and the bias goes in
// fp32, exact for |code| <= 128, whose fp32 then has bf16's bits in its
// upper half.
__device__ __forceinline__ uint32_t dq_i8(uint32_t lo, uint32_t hi, int c) {
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7640 | c)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7640 | c)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// The packed int4 byte c of word w (in-rows 2i low nibble, 2i + 1 high,
// each biased by +8), with wh = w >> 4, as a bf16x2 of its two codes:
// 128 + nibble is a bf16 with the nibble in its mantissa, and 136 is
// subtracted in bf16, exactly.
__device__ __forceinline__ uint32_t dq_i4(uint32_t w, uint32_t wh, int c) {
  const uint32_t bits = (__byte_perm(w, wh, c | ((c + 4) << 8)) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void dq_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA: columns [n0, n0 + 128) for every row of the call, over the K
// slice [k_lo, k_hi) (grid: x the column tile, y the slice).  All 128
// threads copy each stage's code rows and x rows into a ring of DQ_RING
// slots with 16-byte cp.asyncs, one commit group a stage; each stage
// starts with a wait for its group and a barrier, after which the slot of
// the stage before takes the stage DQ_RING - 1 on, so DQ_RING - 1 stages
// are in flight while one is read.  Warp w owns columns 32 w .. 32 w + 31 as two
// m16 tiles: lane (g, t) = (lane / 4, lane % 4) holds the 4 columns
// 32 w + 4 g .. + 3, m-tile mt taking column 2 mt (as row g of A) and
// 2 mt + 1 (row g + 8), and reads them as one word of each code row it
// needs.  int8: the lane's logical k (2t, 2t + 1, 2t + 8, 2t + 9) of a
// k16 step are those in-rows, x as two words; int4: they are the in-rows
// 4t .. 4t + 3, i.e. the packed rows 2t and 2t + 1, x as one 8-byte piece
// x[row][4t .. 4t + 3].  A group's partial sums fold into fp32
// accumulators with its scales when the group ends (int8: once, at the
// slice's end).  Unsplit, the warp casts and stores its columns; split,
// it stores its fp32 partials and the last warp of the column block to
// arrive (a counter per 32 columns, after a fence) sums every slice's in
// slice order, casts once, and resets the counter.
template <bool INT4, int NT, bool PF>
__global__ void __launch_bounds__(DQ_THREADS, DQ_CTAS_PER_SM)
quant_matmul_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ part_out, int* __restrict__ counters, int rows,
                           int K, int N, int gk, int kc, int n_split, int ldw, int lds,
                           const int8_t* __restrict__ nw, const float* __restrict__ ns) {
  using L = DqLayout<INT4>;
  constexpr int S = DQ_RING, KS = L::KS;
  extern __shared__ __align__(128) unsigned char ring[];

  const int n0 = blockIdx.x * DQ_TN, split = blockIdx.y;
  const int k_lo = split * kc, k_hi = min(K, k_lo + kc);
  const int n_st = (k_hi - k_lo) / KS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t ring_s = smem_addr(ring);
  auto code_row = [&](int j) { return (INT4 ? k_lo / 2 : k_lo) + j * DQ_CROWS; };

  // every thread: its 16-byte pieces of stage j's code rows and x rows
  auto issue = [&](int j) {
    const uint32_t slot = ring_s + (j % S) * L::SLOT;
    const int r0 = code_row(j);
#pragma unroll
    for (int q = tid; q < DQ_CROWS * 8; q += DQ_THREADS)
      cp_async16(slot + q / 8 * L::CS + 16 * (q % 8),
                 w + (size_t)(r0 + q / 8) * ldw + n0 + 16 * (q % 8));
    for (int q = tid; q < rows * (KS / 8); q += DQ_THREADS)
      cp_async16(slot + L::CODES + q / (KS / 8) * L::XS + 16 * (q % (KS / 8)),
                 x + (size_t)(q / (KS / 8)) * K + k_lo + j * KS + 8 * (q % (KS / 8)));
    cp_async_commit();
  };

  // x rows past the call's are zeros in every slot (no copy writes them)
  constexpr int XP = KS / 8;   // 16-byte pieces of an x row
  for (int i = tid; i < S * (8 * NT - rows) * XP; i += DQ_THREADS) {
    const int per_slot = (8 * NT - rows) * XP;
    const int r = rows + i % per_slot / XP;
    *reinterpret_cast<uint4*>(ring + i / per_slot * L::SLOT + L::CODES + r * L::XS +
                              16 * (i % XP)) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_st)
      issue(j);
    else
      cp_async_commit();
  }

  const int cw = 32 * warp + 4 * g;   // the lane's first column in the tile
  // K6: the next slab's scale rows of this tile's slice (128 columns of
  // fp32, 16 sectors each)
  if (PF) {
    const int g_lo = k_lo / gk, n_sec = ((k_hi - 1) / gk - g_lo + 1) * 16;
    for (int i = tid; i < n_sec; i += DQ_THREADS)
      prefetch_sector(ns + (size_t)(g_lo + i / 16) * lds + n0 + 8 * (i % 16));
  }

  float acc[2][NT][4], part[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = part[m][n][e] = 0.f;
  // the scales of the lane's 4 columns: int8 the slice's one row, int4
  // the current group's row (loaded at the group's start, used at its end)
  float sc[4];
  auto load_scale = [&](int gr) {
    const float* s_row = scale + (size_t)gr * lds + n0 + cw;
    const float2 lo = *reinterpret_cast<const float2*>(s_row);
    const float2 hi = *reinterpret_cast<const float2*>(s_row + 2);
    sc[0] = lo.x, sc[1] = lo.y, sc[2] = hi.x, sc[3] = hi.y;
  };
  if (!INT4) load_scale(0);

  for (int j = 0; j < n_st; ++j) {
    const int k0 = k_lo + j * KS;
    if (INT4 && k0 % gk == 0) load_scale(k0 / gk);
    // stage j has landed (this thread's pieces, then everyone's), and every
    // warp is done with stage j - 1, whose slot takes stage j + S - 1
    cp_async_wait<S - 2>();
    __syncthreads();
    if (j + S - 1 < n_st)
      issue(j + S - 1);
    else
      cp_async_commit();
    const unsigned char* codes = ring + (j % S) * L::SLOT;
    const unsigned char* xs = codes + L::CODES;
    // the word of code row r holding the lane's 4 columns
    auto word = [&](int r) {
      return *reinterpret_cast<const uint32_t*>(codes + r * L::CS + cw);
    };
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t b[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const unsigned char* xr = xs + (8 * n + g) * L::XS + 32 * kk;
        if constexpr (INT4) {
          const uint2 v = *reinterpret_cast<const uint2*>(xr + 8 * t);
          b[n][0] = v.x, b[n][1] = v.y;
        } else {
          b[n][0] = *reinterpret_cast<const uint32_t*>(xr + 4 * t);
          b[n][1] = *reinterpret_cast<const uint32_t*>(xr + 16 + 4 * t);
        }
      }
      uint32_t a[2][4];
      if constexpr (INT4) {
        const uint32_t w0 = word(8 * kk + 2 * t), w1 = word(8 * kk + 2 * t + 1);
        const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = dq_i4(w0, h0, 2 * m);
          a[m][1] = dq_i4(w0, h0, 2 * m + 1);
          a[m][2] = dq_i4(w1, h1, 2 * m);
          a[m][3] = dq_i4(w1, h1, 2 * m + 1);
        }
      } else {
        uint32_t wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = word(16 * kk + 2 * t + (i & 1) + 8 * (i >> 1)) ^ 0x80808080u;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = dq_i8(wv[0], wv[1], 2 * m);
          a[m][1] = dq_i8(wv[0], wv[1], 2 * m + 1);
          a[m][2] = dq_i8(wv[2], wv[3], 2 * m);
          a[m][3] = dq_i8(wv[2], wv[3], 2 * m + 1);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) dq_mma(part[m][n], a[m], b[n][0], b[n][1]);
    }
    // K6: this stage's code rows of the next slab, a 32-byte sector per
    // request, two a thread
    if (PF) {
#pragma unroll
      for (int q = tid; q < DQ_CROWS * 4; q += DQ_THREADS)
        prefetch_sector(nw + (size_t)(code_row(j) + q / 4) * ldw + n0 + 32 * (q % 4));
    }
    if (INT4 && ((k0 + KS) % gk == 0 || j + 1 == n_st)) {
      // the group is complete: C element e of m-tile m is column 2 m + e / 2
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][n][e] = fmaf(part[m][n][e], sc[2 * m + e / 2], acc[m][n][e]);
            part[m][n][e] = 0.f;
          }
    }
  }
  if (!INT4) {
    // int8: the per-column scale folds once, after the slice's whole dot
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = part[m][n][e] * sc[2 * m + e / 2];
  }

  // the lane's outputs: rows 8 n + 2 t + h (h = C element e % 2), its
  // columns n0 + cw .. + 3 in order (m-tile m, e / 2)
  auto vals = [&](int n, int h) {
    return make_float4(acc[0][n][h], acc[0][n][2 + h], acc[1][n][h], acc[1][n][2 + h]);
  };
  auto store = [&](int row, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 bits;
    bits.x = *reinterpret_cast<uint32_t*>(&lo);
    bits.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + (size_t)row * N + n0 + cw) = bits;
  };
  if (n_split == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * n + 2 * t + h;
        if (row < rows) store(row, vals(n, h));
      }
    return;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 8 * n + 2 * t + h;
      if (row < rows)
        *reinterpret_cast<float4*>(part_out + ((size_t)split * rows + row) * N + n0 + cw) =
            vals(n, h);
    }
  // arrival of the warp's slice: each lane's partials are ordered before
  // lane 0's add by the fence and the warp barrier
  __threadfence();
  __syncwarp();
  int* counter = counters + (n0 + 32 * warp) / 32;
  int last = 0;
  if (lane == 0) last = atomicAdd(counter, 1) == n_split - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();   // every other slice's partials are visible now
  // the lane's 2 NT rows, CHUNK slices of each loaded at once, summed in
  // slice order
  constexpr int CHUNK = 8 / NT;
  const size_t step = (size_t)rows * N / 4;   // one slice, in float4s
  const float4* p = reinterpret_cast<const float4*>(part_out + n0 + cw);
  float4 sum[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) sum[n][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n_split; s0 += CHUNK) {
    float4 v[NT][2][CHUNK];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
          const int row = 8 * n + 2 * t + h;
          if (row < rows && s0 + i < n_split)
            v[n][h][i] = __ldcg(p + (s0 + i) * step + (size_t)row * N / 4);
        }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
          if (s0 + i < n_split) {
            sum[n][h].x += v[n][h][i].x;
            sum[n][h].y += v[n][h][i].y;
            sum[n][h].z += v[n][h][i].z;
            sum[n][h].w += v[n][h][i].w;
          }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 8 * n + 2 * t + h;
      if (row < rows) store(row, sum[n][h]);
    }
  if (lane == 0) *counter = 0;   // every slice of this call has arrived
}

// ---------------------------------------------------------------------------
// Wide path (bf16 x, 17-256 rows): wgmma + TMA, one widened weight tile
// per stage for all of the call's rows.
// ---------------------------------------------------------------------------

constexpr int WD_STAGE = 64;            // in-rows per stage
constexpr int WD_CRING_MAX = 8;         // code stages in flight, at most
constexpr int WD_SMEM_MAX = 232448;     // shared memory a block may use
// two warpgroups, threads 0 and 128 also issuing the copies: a ninth,
// producer warp would cap every thread at 168 registers, short of int8's
// 256-row accumulator and int4's two
constexpr int WD_THREADS = 256;
constexpr int WD_SMS = 132;             // the H100's SMs
constexpr int WD_MAX_ROWS = 256;        // the widest wgmma N
constexpr int WD_TN = 128;              // columns per CTA
constexpr int WD_SCALE_GROUPS = 64;     // int4 scale rows a CTA stages in shared memory

// CTAs a wide-path SM holds: two where a thread needs under 128
// registers (int8 up to 128 rows, int4 up to 64), so four warpgroups
// hide each other's widening; else one (int8's 256-row accumulator,
// int4's second accumulator at 128 rows).
constexpr int wd_ctas_per_sm(bool int4, int nt) { return nt <= (int4 ? 64 : 128) ? 2 : 1; }

// Launch plan of the wide path (mirrored by wide_plan in
// engine/ops/quant_matmul.py, which the CPU tests hold): nt rows of x
// per CTA (the wgmma N: 64, 128 or 256; int4, whose group fold keeps a
// second accumulator, at most 128) in row_blocks CTAs per 128-column tile,
// K cut into n_split slices of kc in-rows (whole stages; for int4 whole
// groups, at most WD_SCALE_GROUPS of them): the smallest split that keeps
// one wave of CTAs on the SMs, none where the tiles fill them.
struct WidePlan {
  int nt, row_blocks, n_split, kc;
};

inline WidePlan wide_plan(int rows, int K, int N, int gk, bool int4) {
  const int nt = rows <= 64 ? 64 : rows <= 128 || int4 ? 128 : 256;
  const int row_blocks = (rows + nt - 1) / nt;
  const int unit = int4 ? gk : WD_STAGE;
  const int n_units = K / unit;
  const int tiles = N / WD_TN * row_blocks;
  int split = tiles >= WD_SMS ? 1
                              : std::max(1, std::min(n_units, WD_SMS * wd_ctas_per_sm(int4, nt) / tiles));
  if (int4) split = std::max(split, (n_units + WD_SCALE_GROUPS - 1) / WD_SCALE_GROUPS);
  const int kc = (n_units + split - 1) / split * unit;
  return {nt, row_blocks, (K + kc - 1) / kc, kc};
}

// Shared memory of one instance: a ring of x stages ([NT rows][64 k]
// bf16 in the 128-byte swizzle: the K-major B operand), int4's scale
// rows and, in what is left of the CTA's share of the SM, a deeper ring
// of code stages ([rows of codes][128] bytes in the 128-byte swizzle:
// the HBM stream, whose latency the depth covers); then the full and
// empty barriers.
template <bool INT4, int NT>
struct WdLayout {
  static constexpr int CTAS = wd_ctas_per_sm(INT4, NT);
  static constexpr int XRING = CTAS == 2 ? 3 : 5;   // x stages in flight
  static constexpr int BUDGET = (WD_SMEM_MAX + 1024) / CTAS - 1024;
  static constexpr int CROWS = INT4 ? WD_STAGE / 2 : WD_STAGE;   // code rows per stage
  static constexpr int CODES = CROWS * WD_TN;
  static constexpr int XST = NT * WD_STAGE * 2;
  static constexpr int X_OFF = 0;
  static constexpr int S_OFF = X_OFF + XRING * XST;
  static constexpr int C_OFF = S_OFF + (INT4 ? WD_SCALE_GROUPS * WD_TN * 4 : 0);
  static constexpr int BARS = 2 * (XRING + WD_CRING_MAX) * 8;
  static constexpr int CRING_FIT = (BUDGET - 1024 - BARS - C_OFF) / CODES;
  static constexpr int CRING = CRING_FIT < WD_CRING_MAX ? CRING_FIT : WD_CRING_MAX;
  static constexpr int BAR_OFF = C_OFF + CRING * CODES;
  static constexpr size_t SMEM = 1024 + BAR_OFF + BARS;
  static_assert(CRING >= 4 && SMEM <= BUDGET, "rings fit the CTA's share");
};

// D (+)= A * B: A [64 x 16] bf16 from registers (the widened weight), B
// [16 x N] K-major in shared memory (x); fp32 accumulators
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
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

// A fragment of one k16 step, int8: the weight's columns c0 = 16 warp +
// lane / 4 and c0 + 8 (of the warpgroup's 64) by in-rows 2 (lane % 4)
// (+1, +8, +9).  The four code rows come as 16-byte pieces of the
// swizzled tile holding the warp's 16 columns; byte lane / 4 and the one
// 8 further are the thread's, widened exactly as tc_i8x2 does.
__device__ __forceinline__ void a_frag_i8(uint32_t (&a)[4], const uint4 (&r)[4], int g) {
  const int sel = g & 3;
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = g < 4 ? r[i].x : r[i].y;
    hi[i] = g < 4 ? r[i].z : r[i].w;
  }
  // rows (k, k + 1) of column c0 / c0 + 8, then rows (k + 8, k + 9)
  a[0] = tc_i8x2(__byte_perm(lo[0], lo[1], sel | ((4 + sel) << 4)), 0, 1);
  a[1] = tc_i8x2(__byte_perm(hi[0], hi[1], sel | ((4 + sel) << 4)), 0, 1);
  a[2] = tc_i8x2(__byte_perm(lo[2], lo[3], sel | ((4 + sel) << 4)), 0, 1);
  a[3] = tc_i8x2(__byte_perm(hi[2], hi[3], sel | ((4 + sel) << 4)), 0, 1);
}

// One packed int4 byte (in-rows 2i low, 2i + 1 high, each biased by +8)
// as a bf16x2 of its two codes, exactly as dq_i4 widens them.
__device__ __forceinline__ uint32_t i4_pair(uint32_t b) {
  const uint32_t bits = (b & 0xFu) | ((b & 0xF0u) << 12) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of one k16 step, int4: packed rows 8 kk + lane % 4 and 4
// further hold in-rows (2 (lane % 4), +1) and (+8, +9).
__device__ __forceinline__ void a_frag_i4(uint32_t (&a)[4], const uint4 (&r)[2], int g) {
  const int sh = 8 * (g & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t lo = g < 4 ? r[i].x : r[i].y, hi = g < 4 ? r[i].z : r[i].w;
    a[2 * i] = i4_pair((lo >> sh) & 0xFFu);
    a[2 * i + 1] = i4_pair((hi >> sh) & 0xFFu);
  }
}

// One CTA: columns [n0, n0 + 128) for rows [row0, row0 + NT) of the call
// (row block rb of the column tile), over the K slice [k_lo, k_hi).
// Thread 0 fills both rings at the start; then, each stage, thread 0
// refills the code slot and thread 128 the x slot freed two stages
// before, each code tile also asked of L2 a ring ahead of its copy.
// Warpgroup wg owns the tile's columns 64 wg .. 64 wg + 63 as the M of
// wgmma m64 nNT k16 and runs each stage as: widen its codes into the A
// fragments of the four k-steps, free the code slot, issue the wgmmas
// against the x tile (B), wait.  A group's partial sums (the wgmma
// accumulator) fold into fp32 accumulators with its scales (staged in
// shared memory at the start) when the group ends; int8 folds once, at
// the slice's end.
template <bool INT4, int NT, bool PF>
__global__ void __launch_bounds__(WD_THREADS, wd_ctas_per_sm(INT4, NT))
quant_matmul_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ part_out, int rows, int K, int N, int gk,
                         int kc, int n_split, int ldw, int lds,
                         const int8_t* __restrict__ nw, const float* __restrict__ ns) {
  using L = WdLayout<INT4, NT>;
  constexpr int TN = WD_TN, NA = NT / 2;   // accumulator registers a thread holds
  constexpr int CR = L::CRING, XR = L::XRING;
  // the row blocks of a column tile are neighbours in the grid, so they run
  // together and the second reads the codes from L2
  const int rbs = (rows + NT - 1) / NT, rb = blockIdx.x % rbs;
  const int n0 = blockIdx.x / rbs * TN, split = blockIdx.y, row0 = NT * rb;
  const int k_lo = split * kc, k_hi = min(K, k_lo + kc);
  const int n_st = (k_hi - k_lo) / WD_STAGE;
  const int tid = threadIdx.x;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bars = base + L::BAR_OFF;
  auto x_full = [&](int s) { return bars + 8 * s; };
  auto x_empty = [&](int s) { return bars + 8 * (XR + s); };
  auto c_full = [&](int s) { return bars + 8 * (2 * XR + s); };
  auto c_empty = [&](int s) { return bars + 8 * (2 * XR + CR + s); };
  auto code_row = [&](int j) { return (INT4 ? k_lo / 2 : k_lo) + j * L::CROWS; };
  auto load_codes = [&](int j) {   // thread 0
    const int s = j % CR;
    mbar_expect_tx(c_full(s), L::CODES);
    tma_load_2d(base + L::C_OFF + s * L::CODES, &wmap, c_full(s), n0, code_row(j));
    if (j + CR < n_st) tma_prefetch_2d(&wmap, n0, code_row(j + CR));
  };
  auto load_x = [&](int j) {   // thread 0 at the start, then thread 128
    const int s = j % XR;
    mbar_expect_tx(x_full(s), L::XST);
    tma_load_2d(base + L::X_OFF + s * L::XST, &xmap, x_full(s), k_lo + j * WD_STAGE, row0);
  };

  if (tid == 0) {
    for (int s = 0; s < XR; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), WD_THREADS);
    }
    for (int s = 0; s < CR; ++s) {
      mbar_init(c_full(s), 1);
      mbar_init(c_empty(s), WD_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < min(CR, n_st); ++j) load_codes(j);
    for (int j = 0; j < min(XR, n_st); ++j) load_x(j);
  }
  // K6: warp 0 prefetches the next slab's scale rows of the same tile
  if (PF && tid < 32 && rb == 0) {
    for (int g = k_lo / gk + tid; g <= (k_hi - 1) / gk; g += 32)
      prefetch_span(ns, lds, g, n0, TN, N, 4);
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int cw = 64 * wg + 16 * warp;   // the warp's first column in the tile
  float part[NA], acc[INT4 ? NA : 1];   // acc: int4's folded groups
#pragma unroll
  for (int e = 0; e < NA; ++e) part[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (INT4 ? NA : 1); ++e) acc[e] = 0.f;

  // int4: the slice's scale rows, [group][128 columns], into shared memory
  const int g_lo = k_lo / gk;
  float* sc_s = reinterpret_cast<float*>(sm + L::S_OFF);
  if (INT4) {
    const int n_pairs = ((k_hi - 1) / gk - g_lo + 1) * (TN / 2);
    for (int i = tid; i < n_pairs; i += WD_THREADS) {
      const int gr = i / (TN / 2), c = 2 * (i % (TN / 2));
      *reinterpret_cast<float2*>(sc_s + gr * TN + c) =
          *reinterpret_cast<const float2*>(scale + (size_t)(g_lo + gr) * lds + n0 + c);
    }
    __syncthreads();
  }

  // the A fragments of stage j's four k-steps, widened from its codes
  auto widen = [&](uint32_t (&a)[4][4], int j) {
    const unsigned char* codes = sm + L::C_OFF + (j % CR) * L::CODES;
    // the 16-byte piece of code row r holding the warp's columns
    auto piece = [&](int r) {
      return *reinterpret_cast<const uint4*>(codes + r * TN +
                                             (((cw / 16) ^ (r & 7)) << 4));
    };
#pragma unroll
    for (int kk = 0; kk < WD_STAGE / 16; ++kk) {
      if constexpr (INT4) {
        const uint4 r[2] = {piece(8 * kk + t), piece(8 * kk + t + 4)};
        a_frag_i4(a[kk], r, g);
      } else {
        const int k = 16 * kk + 2 * t;
        const uint4 r[4] = {piece(k), piece(k + 1), piece(k + 8), piece(k + 9)};
        a_frag_i8(a[kk], r, g);
      }
    }
  };
  // accumulator element e: column cw + g + 8 ((e >> 1) & 1) of the tile,
  // row row0 + 8 (e >> 2) + 2 t + (e & 1)
  auto col_scale = [&](const float* s_row, float (&sc)[2]) {
    sc[0] = s_row[cw + g];
    sc[1] = s_row[cw + g + 8];
  };

  // Nothing runs between a stage's wgmmas and their wait: the A
  // fragments they read asynchronously stay untouched while they run.
  // The two warpgroups share the tensor cores, so one widens while the
  // other's products run.
  uint32_t a[4][4];
  for (int j = 0; j < n_st; ++j) {
    const int k0 = k_lo + j * WD_STAGE;
    const bool g_start = j == 0 || k0 % gk == 0;
    mbar_wait(c_full(j % CR), (j / CR) & 1);
    widen(a, j);
    mbar_arrive(c_empty(j % CR));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(a[kk]);
    mbar_wait(x_full(j % XR), (j / XR) & 1);
    reg_fence(part);
    wg_fence();
    const uint32_t xs = base + L::X_OFF + (j % XR) * L::XST;
#pragma unroll
    for (int kk = 0; kk < WD_STAGE / 16; ++kk)
      wgmma_rs(part, a[kk], smem_desc(xs + kk * 32, 16, 1024, 1), !(g_start && kk == 0));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(a[kk]);
    reg_fence(part);
    mbar_arrive(x_empty(j % XR));
    // refill the slots freed two stages ago (by now the other warpgroup,
    // which may trail this one by part of a stage, has freed them too):
    // thread 0 the codes, thread 128 the x, so each warpgroup carries half
    if (tid == 0 && j >= 2 && j - 2 + CR < n_st) {
      mbar_wait(c_empty((j - 2) % CR), ((j - 2) / CR) & 1);
      load_codes(j - 2 + CR);
    }
    if (tid == 128 && j >= 2 && j - 2 + XR < n_st) {
      mbar_wait(x_empty((j - 2) % XR), ((j - 2) / XR) & 1);
      load_x(j - 2 + XR);
    }
    if (PF && tid < 32 && rb == 0) {   // K6: this stage's rows of the next slab
      for (int r = tid; r < L::CROWS; r += 32)
        prefetch_span(nw, ldw, code_row(j) + r, n0, TN, N, 1);
    }
    if (INT4 && j + 1 < n_st && (k0 + WD_STAGE) % gk == 0) {   // the group is complete
      float sc[2];
      col_scale(sc_s + (k0 / gk - g_lo) * TN, sc);
#pragma unroll
      for (int e = 0; e < NA; ++e) acc[e] = fmaf(part[e], sc[(e >> 1) & 1], acc[e]);
    }
  }

  float sc[2];
  if constexpr (INT4) {
    col_scale(sc_s + ((k_hi - 1) / gk - g_lo) * TN, sc);
#pragma unroll
    for (int e = 0; e < NA; ++e) part[e] = fmaf(part[e], sc[(e >> 1) & 1], acc[e]);
  } else {
    // int8: the per-column scale folds once, after the slice's whole dot
    col_scale(scale + n0, sc);
#pragma unroll
    for (int e = 0; e < NA; ++e) part[e] *= sc[(e >> 1) & 1];
  }
#pragma unroll
  for (int e = 0; e < NA; ++e) {
    const int row = row0 + 8 * (e >> 2) + 2 * t + (e & 1);
    const int col = n0 + cw + g + 8 * ((e >> 1) & 1);
    if (row >= rows) continue;
    if (n_split == 1)
      out[(size_t)row * N + col] = __float2bfloat16(part[e]);
    else
      part_out[((size_t)split * rows + row) * N + col] = part[e];
  }
}

// The plane pointers and strides of one call: the live weight and, for
// K6, the next layer's (nw, ns; null for K4/K5); the fp32 workspace
// (work_floats of it) and the merge counters; the card's SM count.
struct QmArgs {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* work;
  long long work_floats;
  int* counters;
  int rows, K, N, groups, ldw, lds, sms;
  const int8_t* nw;
  const float* ns;
};

// Whether the workspace holds n_split slices of [rows, N] fp32 partials.
inline bool work_fits(const QmArgs& a, int n_split) {
  return n_split == 1 || (a.work != nullptr &&
                          (long long)n_split * a.rows * a.N <= a.work_floats);
}

// The second pass of a split K: out = the slices' fp32 partials summed in
// slice order.
template <typename T>
cudaError_t reduce_splits(const QmArgs& a, int n_split, cudaStream_t stream) {
  const long long total = (long long)a.rows * a.N;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 1024);
  quant_matmul_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      a.work, static_cast<T*>(a.out), total, n_split);
  return cudaGetLastError();
}

// static: the flag below stays private to this library, not one
// process-wide symbol shared by every copy of it that is loaded
template <bool INT4, int NT, bool PF>
static cudaError_t launch_decode(const QmArgs& a, int gk, const DecodePlan& pl,
                                 cudaStream_t stream) {
  if (!work_fits(a, pl.n_split) || (pl.n_split > 1 && a.counters == nullptr))
    return cudaErrorInvalidValue;
  auto kern = quant_matmul_decode_kernel<INT4, NT, PF>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem_once(kern, DqLayout<INT4>::SMEM, done);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.N / DQ_TN, pl.n_split), DQ_THREADS, DqLayout<INT4>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.w, a.scale,
      static_cast<__nv_bfloat16*>(a.out), a.work, a.counters, a.rows, a.K, a.N, gk, pl.kc,
      pl.n_split, a.ldw, a.lds, a.nw, a.ns);
  return cudaGetLastError();
}

// x [rows, K] bf16 as a 2-D map of [64 rows][64 k] boxes in the 128-byte
// swizzle (rows past the call's arrive as zeros); the codes [code rows,
// N], rows ldw bytes apart, as [CROWS][128] boxes stored as they are.
template <bool INT4, int NT, bool PF>
cudaError_t launch_wide(const QmArgs& a, int gk, const WidePlan& pl, cudaStream_t stream) {
  using L = WdLayout<INT4, NT>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)a.K, (cuuint64_t)a.rows};
  const cuuint64_t xstride[1] = {(cuuint64_t)a.K * 2};
  const cuuint32_t xbox[2] = {WD_STAGE, NT};
  const cuuint64_t wdims[2] = {(cuuint64_t)a.N, (cuuint64_t)(INT4 ? a.K / 2 : a.K)};
  const cuuint64_t wstride[1] = {(cuuint64_t)a.ldw};
  const cuuint32_t wbox[2] = {(cuuint32_t)WD_TN, (cuuint32_t)L::CROWS};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a.x), xdims,
             xstride, xbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(a.w), wdims,
             wstride, wbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (!work_fits(a, pl.n_split)) return cudaErrorInvalidValue;
  auto kern = quant_matmul_wide_kernel<INT4, NT, PF>;
  cudaError_t err = allow_smem(kern, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N / WD_TN * pl.row_blocks, pl.n_split);
  kern<<<grid, WD_THREADS, L::SMEM, stream>>>(
      xmap, wmap, a.scale, static_cast<__nv_bfloat16*>(a.out), a.work, a.rows, a.K, a.N,
      gk, pl.kc, pl.n_split, a.ldw, a.lds, a.nw, a.ns);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.n_split == 1) return err;
  return reduce_splits<__nv_bfloat16>(a, pl.n_split, stream);
}

template <typename T, bool INT4, int R, bool PF>
cudaError_t launch_quant_matmul(const QmArgs& a, const QmPlan& pl, cudaStream_t stream) {
  const int ks = INT4 ? a.K / 2 : a.K;
  const bool vec = a.N % QM_COLS == 0 && a.ldw % QM_COLS == 0 &&
                   reinterpret_cast<uintptr_t>(a.w) % 8 == 0;
  const size_t smem =
      ((size_t)pl.kc * (INT4 ? 2 : 1) * R + (size_t)QM_LANES * QM_TN) * sizeof(float);
  if (!work_fits(a, pl.n_split)) return cudaErrorInvalidValue;
  auto kernel = quant_matmul_kernel<T, INT4, R, PF>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.rows + R - 1) / R, (a.N + QM_TN - 1) / QM_TN, pl.n_split);
  kernel<<<grid, QM_THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), a.w, a.scale, static_cast<T*>(a.out), a.work, a.rows,
      a.K, a.N, ks / a.groups, pl.kc, pl.n_split, vec, a.ldw, a.lds, a.nw, a.ns);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.n_split == 1) return err;
  return reduce_splits<T>(a, pl.n_split, stream);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Which path a call takes.  Both tensor-core paths read 16-byte code
// and x pieces (the wide one by TMA) and float2 scales.
enum class QmPath { kCudaCores, kTensorDecode, kWide };

inline QmPath pick_path(const QmArgs& a, int gk, bool bf16, bool int4) {
  if (!tc_fits(a.K, a.N, gk, bf16) || !aligned(a.x, 16) || !aligned(a.w, 16) ||
      a.ldw % 16 || !aligned(a.scale, 8) || a.lds % 2 || !aligned(a.out, 16))
    return QmPath::kCudaCores;
  if (a.rows <= DQ_MAX_ROWS)
    return decode_fits(a.K, a.N, gk, int4) ? QmPath::kTensorDecode : QmPath::kCudaCores;
  return a.rows <= WD_MAX_ROWS ? QmPath::kWide : QmPath::kCudaCores;
}

template <typename T, bool INT4, bool PF>
cudaError_t dispatch_rows(const QmArgs& a, cudaStream_t stream) {
  const int gk = a.K / a.groups;   // in-rows per scale group
  switch (pick_path(a, gk, std::is_same<T, __nv_bfloat16>::value, INT4)) {
    case QmPath::kWide: {
      const WidePlan wp = wide_plan(a.rows, a.K, a.N, gk, INT4);
      if (wp.nt == 64) return launch_wide<INT4, 64, PF>(a, gk, wp, stream);
      if (wp.nt == 128) return launch_wide<INT4, 128, PF>(a, gk, wp, stream);
      return launch_wide<INT4, INT4 ? 128 : 256, PF>(a, gk, wp, stream);   // int4: nt <= 128
    }
    case QmPath::kTensorDecode: {
      const DecodePlan dp = decode_plan(a.rows, a.K, a.N, gk, INT4, a.sms);
      return dp.nt == 1 ? launch_decode<INT4, 1, PF>(a, gk, dp, stream)
                        : launch_decode<INT4, 2, PF>(a, gk, dp, stream);
    }
    default:
      break;
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
// work_floats floats: on the decode-row path (bf16 x of at most 16 rows on
// the tensor-core shapes) the card's workspace of
// kaito_quant_matmul_decode_workspace(sms), with its counters (zeroed
// once; every call leaves them at zero); on the other paths at least
// kaito_quant_matmul_workspace_floats(...) floats.  sms: the card's SM
// count.  Returns the CUDA error of the launches (0 = success;
// cudaErrorInvalidValue when the workspace is short).
extern "C" int kaito_quant_matmul(const void* x, const void* w, const float* scale,
                                  void* out, float* work, long long work_floats,
                                  int* counters, int rows, int K, int N, int groups,
                                  int int4, int dtype, int ldw, int lds, int sms,
                                  void* stream) {
  const kaito::QmArgs a{x,    static_cast<const int8_t*>(w), scale, out, work, work_floats,
                        counters, rows, K, N, groups, ldw, lds, sms, nullptr, nullptr};
  return kaito::dispatch<false>(a, int4, dtype, static_cast<cudaStream_t>(stream));
}

// K6: kaito_quant_matmul, and the same tiles of the next layer's codes
// (next_w) and scales (next_scale), in w's and scale's shapes and strides
// and 16-byte aligned, prefetched into L2.  The output is bitwise
// kaito_quant_matmul's.
extern "C" int kaito_quant_matmul_pf(const void* x, const void* w, const float* scale,
                                     const void* next_w, const float* next_scale,
                                     void* out, float* work, long long work_floats,
                                     int* counters, int rows, int K, int N, int groups,
                                     int int4, int dtype, int ldw, int lds, int sms,
                                     void* stream) {
  if (!kaito::aligned(next_w, 16) || !kaito::aligned(next_scale, 16) || ldw % 16 ||
      (int4 && groups > 1 && lds % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const kaito::QmArgs a{x,        static_cast<const int8_t*>(w),
                        scale,    out,
                        work,     work_floats,
                        counters, rows,
                        K,        N,
                        groups,   ldw,
                        lds,      sms,
                        static_cast<const int8_t*>(next_w), next_scale};
  return kaito::dispatch<true>(a, int4, dtype, static_cast<cudaStream_t>(stream));
}

// fp32 scratch a call off the decode-row path needs: one [rows, N]
// partial output per K slice when K is split, else nothing (the larger of
// the paths' needs, as alignment may send a tileable call to the CUDA
// cores).  A decode-row call uses the card's workspace instead.
extern "C" long long kaito_quant_matmul_workspace_floats(int rows, int K, int N,
                                                         int groups, int int4,
                                                         int dtype) {
  using namespace kaito;
  int n_split = qm_plan(rows, K, N, int4 != 0).n_split;
  if (groups >= 1 && tc_fits(K, N, K / groups, dtype == 1) && rows > DQ_MAX_ROWS &&
      rows <= WD_MAX_ROWS)
    n_split = std::max(n_split, wide_plan(rows, K, N, K / groups, int4 != 0).n_split);
  return n_split > 1 ? (long long)n_split * rows * N : 0;
}

// The wide path's plan for a call of this shape, as {nt, row_blocks,
// n_split, kc} in plan[0..3]; returns 1 when bf16 x of these rows and shape takes
// the wide path (given aligned planes), else 0 and leaves plan alone.
// For the tests that hold engine/ops/quant_matmul.py's mirror.
extern "C" int kaito_quant_matmul_wide_plan(int rows, int K, int N, int groups, int int4,
                                            int* plan) {
  using namespace kaito;
  if (rows <= DQ_MAX_ROWS || rows > WD_MAX_ROWS || groups < 1 || K % groups ||
      !tc_fits(K, N, K / groups, true))
    return 0;
  const WidePlan p = wide_plan(rows, K, N, K / groups, int4 != 0);
  plan[0] = p.nt, plan[1] = p.row_blocks, plan[2] = p.n_split, plan[3] = p.kc;
  return 1;
}

// The decode-row path's plan for a call of this shape on a card of `sms`
// SMs, as {nt, n_split, kc} in plan[0..2]; returns 1 when bf16 x of these
// rows and shape takes the decode-row path (given aligned planes), else 0
// and leaves plan alone.  For the tests that hold the mirror.
extern "C" int kaito_quant_matmul_decode_plan(int rows, int K, int N, int groups, int int4,
                                              int sms, int* plan) {
  using namespace kaito;
  if (rows < 1 || rows > DQ_MAX_ROWS || groups < 1 || K % groups ||
      !tc_fits(K, N, K / groups, true) || !decode_fits(K, N, K / groups, int4 != 0))
    return 0;
  const DecodePlan p = decode_plan(rows, K, N, K / groups, int4 != 0, sms);
  plan[0] = p.nt, plan[1] = p.n_split, plan[2] = p.kc;
  return 1;
}

// The card's decode-row workspace: sizes[0] fp32 floats of partials and
// sizes[1] int32 merge counters, enough for every decode-row call on a
// card of `sms` SMs.
extern "C" void kaito_quant_matmul_decode_workspace(int sms, long long* sizes) {
  sizes[0] = kaito::decode_workspace_floats(sms);
  sizes[1] = kaito::decode_workspace_counters(sms);
}
