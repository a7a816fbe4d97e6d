// Paged decode attention for Hopper (sm_90a): K1 and K1q.
//
// Replaces the Pallas TPU kernel
// kaito_tpu/engine/ops/decode_attention.py::paged_decode_attention_pallas
// (body _decode_kernel): one query token per sequence attends over that
// sequence's paged KV history in one layer of the stacked pool
// [L, P, ps, Hkv, D], with GQA, a sliding window (pos >= length - window),
// an optional tanh softcap and an fp32 online softmax.  q is pre-scaled in
// q's dtype.  K1 (bf16 or fp32 pages) rounds P to the cache dtype before
// the PV product, as the Pallas kernel does.  K1q (its quantized=True
// mode) reads int8 codes with fp32 scales [P, Hkv] per page and KV head:
// sigma_k multiplies the fp32 scores after the QK dot, sigma_v the
// probabilities after the running sum l is updated, and P is not rounded.
//
// Bound on the H100: bytes.  A call reads every live KV row once,
// 2 * live * Hkv * D * elt bytes (elt 2 for bf16, 1 for int8 codes plus
// 8 bytes of scales per live page and KV head), and does 4 flops per
// element per query head of the group, far below the 295 flop/byte at
// which the tensor cores would bind.
//
// Launch plan (decode_plan in engine/ops/decode_attention.py mirrors it):
// one CTA per (KV head, block of at most 8 of its G query heads, sequence,
// split).  n_split depends on the batch, the heads and the SM count only
// (about DEC_CTAS_PER_SM CTAs for each SM, at most DEC_MAX_SPLIT), never
// on the page table's width, so the grid and the fp32 scratch
// (B * H * n_split * (D + 2)) are fixed for a batch and a card, and a
// captured CUDA graph replays for any lengths and tables.  Each CTA finds
// its token range on the device (dec_split): the live window
// [length - window, length), started at the page edge at or below it, cut
// into n_split pieces of whole pages (at least one page each); splits past
// the end exit at once.  A sequence with one live split writes its output
// directly.  Otherwise each split leaves its unnormalised accumulator and
// (max, sum) in the scratch, and the last CTA of the (sequence, head
// block) to finish, found by a counter in global memory (__threadfence,
// then atomicAdd), merges the splits in split order and resets the
// counter: one launch per call, deterministic, and the next call (or a
// graph replay) finds every counter at zero.  The merging CTA loads its
// accumulators, 16 bytes a thread for up to 8 splits at once, beside
// every split's (max, sum): one round trip to L2 at the main case.
//
// bf16 q (K1 over bf16 pages, K1q over int8 pages): tensor cores.  The
// DEC_WARPS warps of a CTA each own every DEC_WARPS-th 16-token slice of
// the split and run their own online softmax, with no barrier of the CTA
// until the end.  A warp
// keeps a ring of DEC_STAGES slices in shared memory (two: a slice's
// copies fly while the one before it is scored; a third slot cost more
// in CTAs an SM than it hid), filled by 16-byte cp.async copies whose
// addresses follow the page table row by row, looked up a slice ahead
// (rows past the split's end are zero-filled), in the loaded dtype: bf16
// rows swizzled for conflict-free ldmatrix, int8 codes as they are.  Both
// products are mma.sync m16n8k16 (bf16 operands, fp32 sums) with the
// slice's 16 tokens on M and the G query heads on the N = 8 columns:
// S^T[16, 8] = K[16, D] q^T (even and odd k-steps in two chains), then
// O^T[D, 8] += V^T[D, 16] P^T[16, 8] with V through ldmatrix.trans.  P
// goes back through 256 bytes of shared memory a warp to become the B
// operand.  K1q widens the codes to bf16 in registers (exact) and keeps
// P * sigma_v at ~16 bits by splitting it into two bf16 halves, hi + lo,
// with one product each; the head dim of K and of the output is visited
// in a permuted order that lets each lane read whole words of codes.  The
// slice's scales arrive with its rows (each lane of a page reads the same
// word, so a page's scales are read once).  At the end the warps'
// states merge in shared memory.
//
// fp32 q (the tiny golden models): the CUDA cores, exact fp32 so the
// goldens replay: a 32-token tile of K and V loaded by the whole CTA into
// registers and widened to fp32 in shared memory, the same plan, scratch
// and merge.  No full-width path runs these instances.
//
// What holds the bf16 instances (H100, PERF.md): not bytes but each CTA's
// chain of dependent latencies (lengths, page table, first copies; the
// fence, counter and merge at the end) against three CTAs an SM; more
// splits made it slower.  Not yet done: CTAs that stay resident and
// overlap one split's end with the next one's start; TMA page loads (a map
// over the stacked pool, encoded once per pool); K1q's widening in fewer
// instructions.
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace kaito {

constexpr int DEC_THREADS = 128;     // fp32 path: four warps
constexpr int DEC_WARPS = 4;         // tensor-core path: warps a CTA
constexpr int DEC_HEADS = 8;         // query heads of one CTA (the mma's N)
constexpr int DEC_SLICE = 16;        // tokens of one warp slice (the mma's M)
constexpr int DEC_STAGES = 2;        // ring slots per warp (three CTAs an SM)
constexpr int DEC_CTAS_PER_SM = 4;   // grid target: more splits cost more than they balance
constexpr int DEC_MAX_SPLIT = 64;
constexpr int DEC_TK = 32;           // fp32 path: tokens per tile

// ---------------------------------------------------------------------------
// The plan, shared by host and device.
// ---------------------------------------------------------------------------

__host__ __device__ inline int dec_cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int dec_head_blocks(int G) { return dec_cdiv(G, DEC_HEADS); }

// splits of each sequence: enough CTAs for DEC_CTAS_PER_SM an SM
__host__ __device__ inline int dec_n_split(int B, int H, int Hkv, int sms) {
  const int pairs = B * Hkv * dec_head_blocks(H / Hkv);
  const int n = dec_cdiv(DEC_CTAS_PER_SM * sms, pairs > 0 ? pairs : 1);
  return n < 1 ? 1 : (n > DEC_MAX_SPLIT ? DEC_MAX_SPLIT : n);
}

// Token range [*t0, *t1) of split `split` of a sequence of `length`
// tokens, the window's first position *lo and the number of splits with
// work, *n_live.  Splits start on page edges that are also 16-token
// edges (multiples of lcm(ps, 16)), hold whole such units, and end at
// `length` at the latest.
__host__ __device__ inline void dec_split(int length, int window, int ps, int n_split,
                                          int split, int* lo, int* t0, int* t1,
                                          int* n_live) {
  const int low = ps & -ps;
  const int unit = ps * (DEC_SLICE / (low < DEC_SLICE ? low : DEC_SLICE));
  *lo = window < length ? length - window : 0;
  const int base = *lo / unit * unit;
  const int span = length - base;
  int per = dec_cdiv(dec_cdiv(span > 0 ? span : 1, n_split), unit) * unit;
  *n_live = length > 0 ? dec_cdiv(span, per) : 0;
  *t0 = base + split * per;
  *t1 = *t0 + per < length ? *t0 + per : length;
}

// fp32 floats of the split scratch: per (sequence, query head, split) D
// accumulator values and the split's (max, sum); none with one split.
__host__ __device__ inline long long dec_scratch_floats(int B, int H, int Hkv, int D,
                                                        int sms) {
  const int n = dec_n_split(B, H, Hkv, sms);
  return n > 1 ? (long long)B * H * n * (D + 2) : 0;
}

// ---------------------------------------------------------------------------
// The end of a split, shared by both paths.
// ---------------------------------------------------------------------------

// The CTA's `nw` partial states for its gb heads lie in shared memory as
// m_w/l_w [nw][8] and a_w [nw][8][D].  Merge them; then write the output
// (one live split) or the partial, and let the last split merge.  The
// last split reads every split's (max, sum) at once into `red` (shared
// memory free by then, at least 2 * 8 * DEC_MAX_SPLIT floats), turns them
// into weights, and sums the accumulators with the loads of all splits
// in flight together.
template <typename T, int D>
__device__ void dec_finish(const float* m_w, const float* l_w, const float* a_w, int nw,
                           int gb, size_t head_row, int split, int n_split, int n_live,
                           float* __restrict__ part_acc, float* __restrict__ part_ml,
                           int* __restrict__ counter, T* __restrict__ out, int* flag_s,
                           float* red) {
  const int tid = threadIdx.x;
  for (int i = tid; i < gb * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, m_w[w * DEC_HEADS + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float e = expf(m_w[w * DEC_HEADS + g] - M);
      L += l_w[w * DEC_HEADS + g] * e;
      A += a_w[(w * DEC_HEADS + g) * D + d] * e;
    }
    if (n_live == 1) {
      out[(head_row + g) * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
    } else {
      const size_t r = (head_row + g) * n_split + split;
      part_acc[r * D + d] = A;
      if (d == 0) {
        part_ml[2 * r] = M;
        part_ml[2 * r + 1] = L;
      }
    }
  }
  if (n_live == 1) return;
  // arrival, as a grid barrier does it: the CTA's writes are ordered
  // before thread 0's fence by the barrier, and the fence before the add
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag_s = atomicAdd(counter, 1) == n_live - 1;
  }
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();   // every other split's partials are visible now
  // A thread per 4 columns of a head (all 128 at D = 128 and 4 heads):
  // the accumulators of its first CHUNK splits are loaded while red[g][s]
  // takes every split's (m, l) and then the weight e^(m - M) / L.
  constexpr int CHUNK = 8;
  const int n4 = gb * D / 4;
  float4 x[CHUNK];
  auto load = [&](int i4, int s0) {
    const float4* acc = reinterpret_cast<const float4*>(
        part_acc + ((head_row + i4 / (D / 4)) * n_split + s0) * D + 4 * (i4 % (D / 4)));
#pragma unroll
    for (int s = 0; s < CHUNK; ++s)
      if (s0 + s < n_live) x[s] = __ldcg(acc + (size_t)s * (D / 4));
  };
  if (tid < n4) load(tid, 0);
  for (int i = tid; i < gb * n_live; i += blockDim.x) {
    const int g = i / n_live, s = i % n_live;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) +
                             (head_row + g) * n_split + s);
    red[2 * i] = ml.x;
    red[2 * i + 1] = ml.y;
  }
  __syncthreads();
  for (int g = tid; g < gb; g += blockDim.x) {
    float* r = red + 2 * g * n_live;
    float M = NEG_INF, L = 0.f;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, r[2 * s]);
    for (int s = 0; s < n_live; ++s) L += r[2 * s + 1] * expf(r[2 * s] - M);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < n_live; ++s) r[2 * s] = expf(r[2 * s] - M) * inv;
  }
  __syncthreads();
  if (tid == 0) *counter = 0;   // every split of this call has arrived
  for (int i4 = tid; i4 < n4; i4 += blockDim.x) {
    const float* w = red + 2 * (i4 / (D / 4)) * n_live;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += CHUNK) {
      if (s0 > 0 || i4 != tid) load(i4, s0);
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) {
        if (s0 + s < n_live) {
          const float ws = w[2 * (s0 + s)];
          A.x = fmaf(ws, x[s].x, A.x);
          A.y = fmaf(ws, x[s].y, A.y);
          A.z = fmaf(ws, x[s].z, A.z);
          A.w = fmaf(ws, x[s].w, A.w);
        }
      }
    }
    T* o = out + (head_row + i4 / (D / 4)) * D + 4 * (i4 % (D / 4));
    o[0] = from_f<T>(A.x);
    o[1] = from_f<T>(A.y);
    o[2] = from_f<T>(A.z);
    o[3] = from_f<T>(A.w);
  }
}

// Where a CTA sits in the grid and what it covers.
struct DecCta {
  int h, head0, gb, b, split, lo, t0, t1, n_live;
  size_t head_row;   // row of the first head in [B * H]
};

__device__ __forceinline__ DecCta dec_cta(const int* __restrict__ lengths, int H,
                                          int Hkv, int ps, int n_split, int window) {
  DecCta c;
  const int G = H / Hkv, hb = dec_head_blocks(G);
  c.h = blockIdx.x / hb;
  const int blk = blockIdx.x % hb;
  c.head0 = c.h * G + blk * DEC_HEADS;
  c.gb = min(DEC_HEADS, G - blk * DEC_HEADS);
  c.b = blockIdx.y;
  c.split = blockIdx.z;
  c.head_row = (size_t)c.b * H + c.head0;
  dec_split(lengths[c.b], window, ps, n_split, c.split, &c.lo, &c.t0, &c.t1, &c.n_live);
  return c;
}

// A row of length 0 attends over nothing and comes out zero (split 0
// writes it).  True when this CTA has nothing more to do.
template <typename T, int D>
__device__ __forceinline__ bool dec_idle(const DecCta& c, T* __restrict__ out) {
  if (c.n_live == 0 && c.split == 0)
    for (int i = threadIdx.x; i < c.gb * D; i += blockDim.x)
      out[c.head_row * D + i] = from_f<T>(0.f);
  return c.split >= c.n_live;
}

// ---------------------------------------------------------------------------
// bf16 q: the tensor-core path.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t dec_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void dec_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes `lo` and `hi` of `word` (int8 codes) as a bf16x2, exactly: the
// biased byte sits in the mantissa of 2^23 and the bias goes in fp32.
__device__ __forceinline__ uint32_t dec_i8x2(uint32_t word, int lo, int hi) {
  const uint32_t biased = word ^ 0x80808080u;
  const float a = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7640 | lo)) -
                  8388736.f;
  const float b = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7640 | hi)) -
                  8388736.f;
  return pack_bf16(a, b);
}

// Shared-memory layout of one warp slice (16 rows of K, then of V) in TKV.
// bf16 rows are swizzled in 16-byte chunks so that the 8 rows one
// ldmatrix reads fall in 8 distinct bank groups; int8 rows of 128 bytes
// are swizzled for the lanes' 16-byte reads (K: rows g and g + 1 apart;
// V: rows 2t of one load apart).
template <typename TKV, int D>
struct DecSlice {
  static constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  static constexpr int ROW = D * (int)sizeof(TKV);        // bytes a row
  static constexpr int CH = ROW / 16;                      // 16-byte chunks a row
  static constexpr int MAT = DEC_SLICE * ROW;              // bytes of K (or V)
  static constexpr int BYTES = 2 * MAT + (QUANT ? 2 * DEC_SLICE * 4 : 0);
  static constexpr int COPIES = DEC_SLICE * CH / 32;       // chunks a lane, each matrix
  static_assert(COPIES >= 1 && DEC_SLICE * CH % 32 == 0, "slice split");

  __device__ static __forceinline__ int swz_k(int r, int c) {
    if constexpr (QUANT) return CH == 8 ? c ^ (r & 1) : c;
    else return CH >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
  }
  __device__ static __forceinline__ int swz_v(int r, int c) {
    if constexpr (QUANT) return CH == 8 ? c ^ (((r >> 1) & 3) << 1) : c;
    else return swz_k(r, c);
  }
};

template <typename TKV, int D>
constexpr int dec_tc_smem_bytes() {
  // per warp: the ring, then P (hi and lo for K1q) as [8 heads][16] bf16;
  // the end of the CTA reuses the rings for the warps' fp32 states
  constexpr int ring = DEC_STAGES * DecSlice<TKV, D>::BYTES;
  constexpr int p = (DecSlice<TKV, D>::QUANT ? 2 : 1) * DEC_HEADS * DEC_SLICE * 2;
  constexpr int states = (2 * DEC_HEADS + DEC_HEADS * D) * 4;
  constexpr int per_warp = ring + p;
  return DEC_WARPS * (per_warp > states ? per_warp : states);
}

template <typename TKV, int D>
__global__ void __launch_bounds__(32 * DEC_WARPS)
decode_tc_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ kc,
                 const TKV* __restrict__ vc, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int* __restrict__ counters, const int* __restrict__ page_tables,
                 const int* __restrict__ lengths, int H, int Hkv, int ps, int pmax,
                 int n_split, int window, float scale, float softcap) {
  using S = DecSlice<TKV, D>;
  constexpr bool QUANT = S::QUANT;
  constexpr int KS = D / 16;        // k-steps of QK; m-tiles of PV
  constexpr int W = DEC_WARPS;
  constexpr int P_BYTES = DEC_HEADS * DEC_SLICE * 2;
  constexpr int WARP_BYTES = DEC_STAGES * S::BYTES + (QUANT ? 2 : 1) * P_BYTES;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const DecCta c = dec_cta(lengths, H, Hkv, ps, n_split, window);

  // q pre-scaled and rounded to bf16 as the B operand (heads on N, d on
  // K): natural d order for bf16 K, the permuted order of the int8 reads
  // for K1q (slot 2t + e of k-step ks is d = t * D / 4 + 4 ks + e, slot
  // 2t + 8 + e is d = t * D / 4 + 4 ks + 2 + e)
  uint32_t qb[KS][2];
  {
    // pairs of q as words; the loads fly beside lengths[b]
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + (c.head_row + g) * D);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = QUANT ? t * (D / 4) + 4 * ks + 2 * j : 16 * ks + 2 * t + 8 * j;
        uint32_t w = g < c.gb ? __ldg(qr + d / 2) : 0u;
        const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
        qb[ks][j] = pack_bf16(x.x * scale, x.y * scale);
      }
    }
  }

  if (dec_idle<__nv_bfloat16, D>(c, out)) return;

  unsigned char* ring = smem + warp * WARP_BYTES;
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(ring + DEC_STAGES * S::BYTES);
  __nv_bfloat16* p_lo = p_hi + DEC_HEADS * DEC_SLICE;
  const int* pt = page_tables + (size_t)c.b * pmax;
  const size_t tok_stride = (size_t)Hkv * D, head_off = (size_t)c.h * D;

  // this warp's slices: pos0 = t0 + 16 (W i + warp)
  const int first = c.t0 + DEC_SLICE * warp;
  const int n_sl = first < c.t1 ? dec_cdiv(c.t1 - first, W * DEC_SLICE) : 0;

  // Row `lane` (< 16) of slice i: its page and its token in the layer
  // pool (-1 past the end).  Looked up a slice ahead of its copies, so the
  // page table's latency hides under a slice's products.
  auto lookup = [&](int i, int& tok, int& page) {
    tok = page = -1;
    const int pos = first + W * DEC_SLICE * i + lane;
    if (i < n_sl && lane < DEC_SLICE && pos < c.t1) {
      page = pt[pos / ps];
      tok = page * ps + pos % ps;
    }
  };
  auto issue = [&](int i, int tok, int page) {
    unsigned char* st = ring + (i % DEC_STAGES) * S::BYTES;
#pragma unroll
    for (int j = 0; j < S::COPIES; ++j) {
      const int ci = lane + 32 * j, r = ci / S::CH, col = ci % S::CH;
      const int rt = __shfl_sync(0xffffffffu, tok, r);
      const size_t off = rt >= 0 ? (size_t)rt * tok_stride + head_off : 0;
      const uint32_t n = rt >= 0 ? 16u : 0u;
      cp_async16(dec_smem(st + r * S::ROW + S::swz_k(r, col) * 16),
                 reinterpret_cast<const unsigned char*>(kc + off) + col * 16, n);
      cp_async16(dec_smem(st + S::MAT + r * S::ROW + S::swz_v(r, col) * 16),
                 reinterpret_cast<const unsigned char*>(vc + off) + col * 16, n);
    }
    if constexpr (QUANT) {
      // lanes 0-15 sigma_k of rows 0-15, lanes 16-31 sigma_v; the lanes of
      // one page read one word
      const int pg = __shfl_sync(0xffffffffu, page, lane & 15);
      const float* src =
          (lane < 16 ? k_scale : v_scale) + (pg >= 0 ? (size_t)pg * Hkv + c.h : 0);
      cp_async4(dec_smem(st + 2 * S::MAT + lane * 4), src, pg >= 0 ? 4u : 0u);
    }
  };

  float acc[KS][4];
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  {
    int tok[DEC_STAGES - 1], page[DEC_STAGES - 1];
#pragma unroll
    for (int i = 0; i < DEC_STAGES - 1; ++i) lookup(i, tok[i], page[i]);
#pragma unroll
    for (int i = 0; i < DEC_STAGES - 1; ++i) {
      if (i < n_sl) issue(i, tok[i], page[i]);
      cp_async_commit();
    }
  }
  int tok_n, page_n;   // rows of the next slice to copy
  lookup(DEC_STAGES - 1, tok_n, page_n);
  for (int i = 0; i < n_sl; ++i) {
    if (i + DEC_STAGES - 1 < n_sl) issue(i + DEC_STAGES - 1, tok_n, page_n);
    cp_async_commit();
    lookup(i + DEC_STAGES, tok_n, page_n);
    cp_async_wait<DEC_STAGES - 1>();
    __syncwarp();
    const unsigned char* st = ring + (i % DEC_STAGES) * S::BYTES;
    const unsigned char* ks_base = st;
    const unsigned char* vs_base = st + S::MAT;
    const int pos0 = first + W * DEC_SLICE * i;

    // S^T[16 tokens, 8 heads]: c[0..1] row g, c[2..3] row g + 8, heads 2t, 2t + 1
    // (even and odd k-steps in two chains of mma)
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (QUANT) {
      // lane (g, t) reads D / 4 codes of rows g and g + 8 at byte t * D / 4
      uint32_t w0[KS], w8[KS];
      auto load_row = [&](int r, uint32_t(&w)[KS]) {
        if constexpr (D == 32) {
          const uint2 x = *reinterpret_cast<const uint2*>(ks_base + r * S::ROW + 8 * t);
          w[0] = x.x;
          w[1] = x.y;
        } else {
#pragma unroll
          for (int j = 0; j < D / 64; ++j) {
            const uint4 x = *reinterpret_cast<const uint4*>(
                ks_base + r * S::ROW + S::swz_k(r, t * (D / 64) + j) * 16);
            w[4 * j] = x.x;
            w[4 * j + 1] = x.y;
            w[4 * j + 2] = x.z;
            w[4 * j + 3] = x.w;
          }
        }
      };
      load_row(g, w0);
      load_row(g + 8, w8);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t a[4] = {dec_i8x2(w0[ks], 0, 1), dec_i8x2(w8[ks], 0, 1),
                               dec_i8x2(w0[ks], 2, 3), dec_i8x2(w8[ks], 2, 3)};
        dec_mma(ks & 1 ? s2 : s, a, qb[ks][0], qb[ks][1]);
      }
    } else {
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, dec_smem(ks_base + r * S::ROW + S::swz_k(r, 2 * ks + (lane >> 4)) * 16));
        dec_mma(ks & 1 ? s2 : s, a, qb[ks][0], qb[ks][1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += s2[e];

    // online softmax over the slice, per head (columns 2t, 2t + 1)
    float sk[2] = {1.f, 1.f}, sv[2] = {1.f, 1.f};
    if constexpr (QUANT) {
      const float* sc = reinterpret_cast<const float*>(st + 2 * S::MAT);
      sk[0] = sc[g];
      sk[1] = sc[g + 8];
      sv[0] = sc[16 + g];
      sv[1] = sc[16 + g + 8];
    }
    bool valid[2];
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int pos = pos0 + g + 8 * r2;
      valid[r2] = pos >= c.lo && pos < c.t1;
    }
    float mx[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        float x = s[2 * r2 + e];
        if (QUANT) x *= sk[r2];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[2 * r2 + e] = valid[r2] ? x : NEG_INF;
      }
      mx[e] = fmaxf(s[e], s[2 + e]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float m_new = fmaxf(m_run[e], mx[e]);
      const float alpha = __expf(m_run[e] - m_new);
      m_run[e] = m_new;
      float p[2];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) p[r2] = valid[r2] ? __expf(s[2 * r2 + e] - m_new) : 0.f;
      l_run[e] = l_run[e] * alpha + p[0] + p[1];
#pragma unroll
      for (int m = 0; m < KS; ++m) {
        acc[m][e] *= alpha;
        acc[m][2 + e] *= alpha;
      }
      // P^T into [head][token]: K1 rounds P to bf16; K1q keeps P * sigma_v
      // as hi + lo
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int at = (2 * t + e) * DEC_SLICE + g + 8 * r2;
        if constexpr (QUANT) {
          const float x = p[r2] * sv[r2];
          const __nv_bfloat16 hi = __float2bfloat16(x);
          p_hi[at] = hi;
          p_lo[at] = __float2bfloat16(x - __bfloat162float(hi));
        } else {
          p_hi[at] = __float2bfloat16(p[r2]);
        }
      }
    }
    __syncwarp();
    // B operand P^T[16 tokens, 8 heads]: lane (g, t) holds tokens 2t, 2t + 1
    // and 2t + 8, 2t + 9 of head g
    const uint32_t* ph = reinterpret_cast<const uint32_t*>(p_hi);
    const uint32_t bh0 = ph[g * 8 + t], bh1 = ph[g * 8 + t + 4];
    uint32_t bl0 = 0, bl1 = 0;
    if constexpr (QUANT) {
      const uint32_t* pl = reinterpret_cast<const uint32_t*>(p_lo);
      bl0 = pl[g * 8 + t];
      bl1 = pl[g * 8 + t + 4];
    }

    // O^T[D, 8] += V^T[D, 16] P^T
    if constexpr (QUANT) {
      // lane (g, t) reads D / 8 codes of tokens 2t, 2t + 1, 2t + 8, 2t + 9
      // at byte g * D / 8: m-tile mt, row g + 8 h is d = g * D / 8 + 2 mt + h
      constexpr int WORDS = D / 32;
      uint32_t v[4][WORDS];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 2 * t + (k & 1) + 8 * (k >> 1);
        const unsigned char* row = vs_base + r * S::ROW;
        if constexpr (D == 128) {
          const uint4 x = *reinterpret_cast<const uint4*>(row + S::swz_v(r, g) * 16);
          v[k][0] = x.x;
          v[k][1] = x.y;
          v[k][2] = x.z;
          v[k][3] = x.w;
        } else if constexpr (D == 64) {
          const uint2 x = *reinterpret_cast<const uint2*>(row + 8 * g);
          v[k][0] = x.x;
          v[k][1] = x.y;
        } else {
          v[k][0] = *reinterpret_cast<const uint32_t*>(row + 4 * g);
        }
      }
#pragma unroll
      for (int wd = 0; wd < WORDS; ++wd) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // bytes 2 half, 2 half + 1 of each word: m-tile 2 wd + half
          const uint32_t sel0 = half ? 0x7362u : 0x5140u;
          const uint32_t z0 = __byte_perm(v[0][wd], v[1][wd], sel0);   // tokens 2t, 2t + 1
          const uint32_t z8 = __byte_perm(v[2][wd], v[3][wd], sel0);   // 2t + 8, 2t + 9
          const uint32_t a[4] = {dec_i8x2(z0, 0, 1), dec_i8x2(z0, 2, 3),
                                 dec_i8x2(z8, 0, 1), dec_i8x2(z8, 2, 3)};
          dec_mma(acc[2 * wd + half], a, bh0, bh1);
          dec_mma(acc[2 * wd + half], a, bl0, bl1);
        }
      }
    } else {
      const int mi = lane >> 3;
      const int r = (lane & 7) + 8 * (mi >> 1);
#pragma unroll
      for (int m = 0; m < KS; ++m) {
        uint32_t a[4];
        ldsm_x4_trans(a, dec_smem(vs_base + r * S::ROW + S::swz_v(r, 2 * m + (mi & 1)) * 16));
        dec_mma(acc[m], a, bh0, bh1);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // the warp's state: l summed over its lanes of each head
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], o);
  __syncthreads();   // every ring is drained: reuse it for the states
  float* m_w = reinterpret_cast<float*>(smem);
  float* l_w = m_w + W * DEC_HEADS;
  float* a_w = l_w + W * DEC_HEADS;
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m_w[warp * DEC_HEADS + 2 * t + e] = m_run[e];
      l_w[warp * DEC_HEADS + 2 * t + e] = l_run[e];
    }
  }
  float* aw = a_w + warp * DEC_HEADS * D;
#pragma unroll
  for (int m = 0; m < KS; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = 2 * t + (e & 1), h8 = e >> 1;
      const int d = QUANT ? g * (D / 8) + 2 * m + h8 : 16 * m + g + 8 * h8;
      aw[head * D + d] = acc[m][e];
    }
  __syncthreads();
  dec_finish<__nv_bfloat16, D>(m_w, l_w, a_w, W, c.gb, c.head_row, c.split, n_split,
                               c.n_live, part_acc, part_ml,
                               counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x, out,
                               &flag_s, reinterpret_cast<float*>(smem));
}

// ---------------------------------------------------------------------------
// fp32 q: the CUDA-core path.
// ---------------------------------------------------------------------------

inline size_t decode_fp32_smem_bytes(int D) {
  size_t floats = (size_t)DEC_HEADS * D       // q
                + (size_t)DEC_TK * (D + 1)     // k (rows padded)
                + (size_t)DEC_TK * D           // v
                + (size_t)DEC_HEADS * DEC_TK   // scores / P
                + (size_t)DEC_HEADS * D        // acc
                + 3 * (size_t)DEC_HEADS        // m, l, alpha
                + 2 * (size_t)DEC_TK;          // K1q scales per token
  return floats * sizeof(float);
}

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// One 32-token tile of K and V rows for one KV head, held in registers
// between its loads and its store to shared memory: thread tid owns the
// pieces tid, tid + DEC_THREADS, ... of the tile's rows (16 bytes for
// fp32 rows, 8 bytes of int8 codes).
template <typename TKV, int D>
struct KVTile {
  using Piece = std::conditional_t<sizeof(TKV) == 1, uint2, uint4>;
  static constexpr int V = (int)(sizeof(Piece) / sizeof(TKV));   // values per piece
  static constexpr int R = D / V;                                // pieces per row
  static constexpr int N = DEC_TK * R / DEC_THREADS;             // pieces per thread
  static_assert(N >= 1 && DEC_TK * R % DEC_THREADS == 0, "tile split");
  Piece k[N], v[N];

  // Issue every load of tile t0 (rows at or past `end` read as zero).
  __device__ __forceinline__ void fetch(const TKV* __restrict__ kc,
                                        const TKV* __restrict__ vc,
                                        const int* __restrict__ pt, int t0, int end,
                                        int ps, size_t tok_stride, size_t head_off,
                                        int tid) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * DEC_THREADS;
      const int pos = t0 + i / R;
      k[j] = v[j] = Piece{};
      if (pos < end) {
        const size_t off = ((size_t)pt[pos / ps] * ps + pos % ps) * tok_stride +
                           head_off;
        k[j] = __ldg(reinterpret_cast<const Piece*>(kc + off) + i % R);
        v[j] = __ldg(reinterpret_cast<const Piece*>(vc + off) + i % R);
      }
    }
  }

  // Widen to fp32 into k_s [DEC_TK][D + 1] and v_s [DEC_TK][D].
  __device__ __forceinline__ void store(float* k_s, float* v_s, int tid) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * DEC_THREADS;
      const int r = i / R, c = (i % R) * V;
      const TKV* ek = reinterpret_cast<const TKV*>(&k[j]);
      const TKV* ev = reinterpret_cast<const TKV*>(&v[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        k_s[r * (D + 1) + c + e] = to_f(ek[e]);
        v_s[r * D + c + e] = to_f(ev[e]);
      }
    }
  }
};

// TKV: float, or int8_t for K1q with k_scale and v_scale (one layer's
// [P, Hkv] scales).
template <typename TKV, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_fp32_kernel(const float* __restrict__ q, const TKV* __restrict__ kc,
                   const TKV* __restrict__ vc, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, float* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int* __restrict__ counters, const int* __restrict__ page_tables,
                   const int* __restrict__ lengths, int H, int Hkv, int ps, int pmax,
                   int n_split, int window, float scale, float softcap) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr int DP = D + 1;
  __shared__ int flag_s;
  const DecCta c = dec_cta(lengths, H, Hkv, ps, n_split, window);
  if (dec_idle<float, D>(c, out)) return;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = DEC_THREADS / 32;
  const int G = c.gb;

  extern __shared__ float smem_f[];
  float* q_s = smem_f;                          // [8][D]
  float* k_s = q_s + DEC_HEADS * D;             // [TK][DP]
  float* v_s = k_s + DEC_TK * DP;               // [TK][D]
  float* p_s = v_s + DEC_TK * D;                // [8][TK]
  float* acc_s = p_s + DEC_HEADS * DEC_TK;      // [8][D]
  float* m_s = acc_s + DEC_HEADS * D;           // [8]
  float* l_s = m_s + DEC_HEADS;                 // [8]
  float* a_s = l_s + DEC_HEADS;                 // [8]
  float* sk_s = a_s + DEC_HEADS;                // [TK] K1q: sigma_k, sigma_v per token
  float* sv_s = sk_s + DEC_TK;                  // [TK]

  const int* pt = page_tables + (size_t)c.b * pmax;
  const size_t tok_stride = (size_t)Hkv * D, head_off = (size_t)c.h * D;
  int t0 = c.t0;
  KVTile<TKV, D> tile;
  tile.fetch(kc, vc, pt, t0, c.t1, ps, tok_stride, head_off, tid);

  for (int i = tid; i < G * D; i += DEC_THREADS) {
    q_s[i] = q[c.head_row * D + i] * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += DEC_THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  for (; t0 < c.t1; t0 += DEC_TK) {
    tile.store(k_s, v_s, tid);
    if (QUANT && tid < DEC_TK) {
      // the scales of each token's (page, KV head); rows past the end are
      // masked below, so any finite value does
      const int pos = min(t0 + tid, c.t1 - 1);
      const size_t si = (size_t)pt[pos / ps] * Hkv + c.h;
      sk_s[tid] = k_scale[si];
      sv_s[tid] = v_scale[si];
    }
    __syncthreads();
    // the next tile's loads fly while this one is scored
    if (t0 + DEC_TK < c.t1)
      tile.fetch(kc, vc, pt, t0 + DEC_TK, c.t1, ps, tok_stride, head_off, tid);

    for (int i = tid; i < G * DEC_TK; i += DEC_THREADS) {
      const int g = i / DEC_TK, r = i % DEC_TK;
      const float* qr = q_s + g * D;
      const float* kr = k_s + r * DP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if (QUANT) s *= sk_s[r];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int pos = t0 + r;
      p_s[i] = pos < c.t1 && pos >= c.lo ? s : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      const float s = p_s[g * DEC_TK + lane];
      const int pos = t0 + lane;
      const bool valid = pos < c.t1 && pos >= c.lo;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = valid ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * DEC_TK + lane] = QUANT ? p * sv_s[lane] : p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += DEC_THREADS) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * DEC_TK;
      float a = 0.f;
#pragma unroll 8
      for (int r = 0; r < DEC_TK; ++r) a = fmaf(pr[r], v_s[r * D + d], a);
      acc_s[i] = acc_s[i] * a_s[g] + a;
    }
    __syncthreads();
  }

  dec_finish<float, D>(m_s, l_s, acc_s, 1, G, c.head_row, c.split, n_split, c.n_live,
                       part_acc, part_ml,
                       counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x, out, &flag_s,
                       smem_f);
}

// static: the flags below stay private to this library, not one
// process-wide symbol shared by every copy of it that is loaded
template <typename TKV, int D>
static cudaError_t launch_tc(const void* q, const void* kc, const void* vc, const float* k_scale,
                      const float* v_scale, void* out, float* part, int* counters,
                      const int* page_tables, const int* lengths, dim3 grid, int B, int H,
                      int Hkv, int ps, int pmax, int window, float scale, float softcap,
                      cudaStream_t stream) {
  constexpr int smem = dec_tc_smem_bytes<TKV, D>();
  auto kern = decode_tc_kernel<TKV, D>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem_once(kern, smem, done);
  if (err != cudaSuccess) return err;
  float* part_ml = part + (size_t)B * H * grid.z * D;
  kern<<<grid, 32 * DEC_WARPS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), k_scale, v_scale, static_cast<__nv_bfloat16*>(out), part,
      part_ml, counters, page_tables, lengths, H, Hkv, ps, pmax, grid.z, window, scale,
      softcap);
  return cudaGetLastError();
}

template <typename TKV, int D>
static cudaError_t launch_fp32(const void* q, const void* kc, const void* vc, const float* k_scale,
                        const float* v_scale, void* out, float* part, int* counters,
                        const int* page_tables, const int* lengths, dim3 grid, int B, int H,
                        int Hkv, int ps, int pmax, int window, float scale, float softcap,
                        cudaStream_t stream) {
  const size_t smem = decode_fp32_smem_bytes(D);
  auto kern = decode_fp32_kernel<TKV, D>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem_once(kern, smem, done);
  if (err != cudaSuccess) return err;
  float* part_ml = part + (size_t)B * H * grid.z * D;
  kern<<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(kc), static_cast<const TKV*>(vc),
      k_scale, v_scale, static_cast<float*>(out), part, part_ml, counters, page_tables,
      lengths, H, Hkv, ps, pmax, grid.z, window, scale, softcap);
  return cudaGetLastError();
}

}  // namespace kaito

// q [B, H, D]; k_layer/v_layer: one layer of the pool, [P, ps, Hkv, D], in
// q's dtype, or int8 codes when k_scale/v_scale (that layer's fp32 [P, Hkv]
// scales) are given (K1q; both null for K1); page_tables [B, pmax] and
// lengths [B] int32; out [B, H, D].  part: fp32 scratch of
// kaito_decode_workspace_floats(...) floats (may be null when that is 0);
// counters: kaito_decode_counters(...) int32, zero before the first call
// and left at zero by every call.  sms: the card's SM count.  dtype:
// 0 = float32, 1 = bfloat16.  softcap <= 0 disables it.  Returns the CUDA
// error of the launch (0 = success).
extern "C" int kaito_decode_attention(const void* q, const void* k_layer,
                                      const void* v_layer, void* out,
                                      const int* page_tables, const int* lengths,
                                      float* part, int* counters, const float* k_scale,
                                      const float* v_scale, int B, int H, int Hkv, int D,
                                      int ps, int pmax, int window, float scale,
                                      float softcap, int dtype, int sms, void* stream) {
  using namespace kaito;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr) || B <= 0 || Hkv <= 0 || H % Hkv || ps <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv * dec_head_blocks(H / Hkv), B, dec_n_split(B, H, Hkv, sms));
  if (grid.z > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
#define KAITO_DEC(PATH, TKV, DD)                                                          \
  return (int)PATH<TKV, DD>(q, k_layer, v_layer, k_scale, v_scale, out, part, counters,  \
                            page_tables, lengths, grid, B, H, Hkv, ps, pmax, window,     \
                            scale, softcap, s)
#define KAITO_DEC_D(PATH, TKV)            \
  if (D == 32) KAITO_DEC(PATH, TKV, 32);  \
  if (D == 64) KAITO_DEC(PATH, TKV, 64);  \
  if (D == 128) KAITO_DEC(PATH, TKV, 128)
  if (dtype == 1) {
    if (quant) {
      KAITO_DEC_D(launch_tc, int8_t);
    } else {
      KAITO_DEC_D(launch_tc, __nv_bfloat16);
    }
  } else if (dtype == 0) {
    if (quant) {
      KAITO_DEC_D(launch_fp32, int8_t);
    } else {
      KAITO_DEC_D(launch_fp32, float);
    }
  }
#undef KAITO_DEC_D
#undef KAITO_DEC
  return (int)cudaErrorInvalidValue;
}

// splits per sequence of a call (the grid's z)
extern "C" int kaito_decode_plan(int B, int H, int Hkv, int sms) {
  return kaito::dec_n_split(B, H, Hkv, sms);
}

// fp32 scratch kaito_decode_attention needs: per (sequence, query head,
// split) D accumulator values plus the split's running max and sum.
extern "C" long long kaito_decode_workspace_floats(int B, int H, int Hkv, int D, int sms) {
  return kaito::dec_scratch_floats(B, H, Hkv, D, sms);
}

// int32 merge counters: one per CTA of the grid's (x, y) plane
extern "C" long long kaito_decode_counters(int B, int H, int Hkv) {
  return (long long)B * Hkv * kaito::dec_head_blocks(H / Hkv);
}

// The token range of one split, as each CTA finds it: writes lo, t0, t1,
// n_live.
extern "C" void kaito_decode_split(int length, int window, int ps, int n_split, int split,
                                   int* out4) {
  kaito::dec_split(length, window, ps, n_split, split, out4, out4 + 1, out4 + 2, out4 + 3);
}
