// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// kaito_tpu/engine/ops/decode_attention.py::paged_decode_attention_pallas
// (body _decode_kernel, bf16/fp32 mode): one query token per sequence
// attends over that sequence's paged KV history in one layer of the
// stacked pool [L, P, ps, Hkv, D], with GQA, a sliding window
// (pos >= length - window), an optional tanh softcap and an fp32 online
// softmax.  q is pre-scaled in q's dtype and P is rounded to the cache
// dtype before the PV product, as the Pallas kernel does.
//
// Bound on the H100: bytes.  A decode step reads every live KV row once
// (2 * length * Hkv * D elements per sequence) and does 4 flops per
// element read per query head of the group, far below the 295 flop/byte
// the card needs before compute binds.  Design: split-K over the
// sequence (flash-decoding).  One CTA per (KV head, sequence, 128-token
// split) covers that head's G query heads, so every KV row is read from
// device memory exactly once, and a sequence spreads over several SMs
// instead of walking its pages serially in one CTA.  Rows are fetched
// straight from the pool through the page table (no gather copy): all
// 128 threads of the CTA issue the 16-byte loads of a 32-token tile at
// once into registers, and the next tile's loads are in flight while the
// current tile is scored, so a CTA waits on memory about once per split
// rather than once per row.  Splits and tiles before the window start,
// and rows of length 0, are skipped.  Each split leaves its unnormalised
// accumulator and (max, sum) in fp32 scratch; a second kernel merges the
// splits of each (sequence, query head).  The grid is sized from the page
// table's width, so callers pass only the columns live sequences reach.
// The Pallas kernel's flat [H, ps*Hkv] score panel with a head mask was a
// Mosaic workaround and is not carried over.  Not yet done: TMA loads.
//
// K1q, the int8 instance (the Pallas kernel's quantized=True mode): the
// pools hold int8 codes with fp32 scales [P, Hkv] per page and KV head.
// A tile's codes arrive as 8-byte pieces (half the bytes of a bf16 row),
// are widened after the load, and the scales of its tokens' pages are
// read straight from [P, Hkv] (the Pallas kernel pre-tiles them into
// per-column rows, a Mosaic layout workaround).  sigma_k multiplies the
// fp32 scores after the QK dot and sigma_v the probabilities after the
// running sum l is updated; P stays fp32 against fp32 V (no rounding of P,
// as in the quantized Pallas kernel).  Its bound is bytes too, at half of
// K1's.  The merge kernel is the same.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace kaito {

constexpr int DEC_TK = 32;       // tokens per tile (one per lane in the softmax)
constexpr int DEC_CHUNK = 128;   // tokens per split (a multiple of DEC_TK)
constexpr int DEC_THREADS = 128;

template <int D>
__host__ __device__ constexpr int dec_row() { return D + 1; }  // padded K row

inline size_t decode_smem_bytes(int G, int D) {
  size_t floats = (size_t)G * D            // q
                + (size_t)DEC_TK * (D + 1) // k
                + (size_t)DEC_TK * D       // v
                + (size_t)G * DEC_TK       // scores / P
                + (size_t)G * D            // acc
                + 3 * (size_t)G            // m, l, alpha
                + 2 * (size_t)DEC_TK;      // K1q scales per token
  return floats * sizeof(float);
}

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// One 32-token tile of K and V rows for one KV head, held in registers
// between its loads and its store to shared memory: thread tid owns the
// pieces tid, tid + DEC_THREADS, ... of the tile's rows (16 bytes for
// fp32/bf16 rows, 8 bytes of int8 codes).
template <typename TKV, int D>
struct KVTile {
  using Piece = std::conditional_t<sizeof(TKV) == 1, uint2, uint4>;
  static constexpr int V = (int)(sizeof(Piece) / sizeof(TKV));   // values per piece
  static constexpr int R = D / V;                                // pieces per row
  static constexpr int N = DEC_TK * R / DEC_THREADS;             // pieces per thread
  static_assert(N >= 1 && DEC_TK * R % DEC_THREADS == 0, "tile split");
  Piece k[N], v[N];

  // Issue every load of tile t0 (rows past `length` read as zero).
  __device__ __forceinline__ void fetch(const TKV* __restrict__ kc,
                                        const TKV* __restrict__ vc,
                                        const int* __restrict__ pt, int t0,
                                        int length, int ps, size_t tok_stride,
                                        size_t head_off, int tid) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = tid + j * DEC_THREADS;
      const int pos = t0 + i / R;
      k[j] = v[j] = Piece{};
      if (pos < length) {
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

// T: q/out dtype; TKV: pool dtype (T, or int8_t for K1q with k_scale and
// v_scale, one layer's [P, Hkv] scales).
template <typename T, typename TKV, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_kernel(const T* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, float* __restrict__ part_acc,
                    float* __restrict__ part_ml,
                    const int* __restrict__ page_tables,
                    const int* __restrict__ lengths, int H, int Hkv, int ps,
                    int pmax, int n_split, int window, float scale,
                    float softcap) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr int DP = dec_row<D>();
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = DEC_THREADS / 32;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [G][D]
  float* k_s = q_s + G * D;            // [TK][DP]
  float* v_s = k_s + DEC_TK * DP;      // [TK][D]
  float* p_s = v_s + DEC_TK * D;       // [G][TK]
  float* acc_s = p_s + G * DEC_TK;     // [G][D]
  float* m_s = acc_s + G * D;          // [G]
  float* l_s = m_s + G;                // [G]
  float* a_s = l_s + G;                // [G]
  float* sk_s = a_s + G;               // [TK] K1q: sigma_k, sigma_v per token
  float* sv_s = sk_s + DEC_TK;         // [TK]

  const int length = lengths[b];
  const int lo = window < length ? length - window : 0;
  // splits holding no position of [lo, length) have nothing to do (the
  // merge skips them too); the test is uniform over the block
  if (split < lo / DEC_CHUNK || split * DEC_CHUNK >= length) return;
  const int t_end = min((split + 1) * DEC_CHUNK, length);
  const int* pt = page_tables + (size_t)b * pmax;
  const size_t tok_stride = (size_t)Hkv * D, head_off = (size_t)h * D;
  int t0 = max(split * DEC_CHUNK, (lo / DEC_TK) * DEC_TK);
  KVTile<TKV, D> tile;
  tile.fetch(kc, vc, pt, t0, length, ps, tok_stride, head_off, tid);

  for (int i = tid; i < G * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    const float x = to_f(q[((size_t)b * H + h * G + g) * D + d]);
    q_s[i] = round_to<T>(x * scale);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += DEC_THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  for (; t0 < t_end; t0 += DEC_TK) {
    tile.store(k_s, v_s, tid);
    if (QUANT && tid < DEC_TK) {
      // the scales of each token's (page, KV head); rows past the end are
      // masked below, so any finite value does
      const int pos = min(t0 + tid, length - 1);
      const size_t si = (size_t)pt[pos / ps] * Hkv + h;
      sk_s[tid] = k_scale[si];
      sv_s[tid] = v_scale[si];
    }
    __syncthreads();
    // the next tile's loads fly while this one is scored
    if (t0 + DEC_TK < t_end)
      tile.fetch(kc, vc, pt, t0 + DEC_TK, length, ps, tok_stride, head_off, tid);

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
      const bool valid = pos < length && pos >= length - window;
      p_s[i] = valid ? s : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      const float s = p_s[g * DEC_TK + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * DEC_TK + lane] = QUANT ? p * sv_s[lane] : round_to<T>(p);
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

  // row (sequence b, query head h*G+g, split) of the [B, H, n_split] scratch
  for (int i = tid; i < G * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    part_acc[(((size_t)b * H + h * G + g) * n_split + split) * D + d] = acc_s[i];
  }
  for (int g = tid; g < G; g += DEC_THREADS) {
    const size_t r = ((size_t)b * H + h * G + g) * n_split + split;
    part_ml[2 * r] = m_s[g];
    part_ml[2 * r + 1] = l_s[g];
  }
}

// Merge the splits of one (sequence, query head): thread d owns output
// column d.  out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, T* __restrict__ out,
                    const int* __restrict__ lengths, int H, int n_split,
                    int window) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int length = lengths[b];
  const int lo = window < length ? length - window : 0;
  const int s_lo = lo / DEC_CHUNK;
  const int s_hi = min((length + DEC_CHUNK - 1) / DEC_CHUNK, n_split);
  const size_t row0 = ((size_t)b * H + head) * n_split;
  float M = NEG_INF;
  for (int s = s_lo; s < s_hi; ++s) M = fmaxf(M, part_ml[2 * (row0 + s)]);
  float L = 0.f, acc = 0.f;
  for (int s = s_lo; s < s_hi; ++s) {
    const float w = expf(part_ml[2 * (row0 + s)] - M);
    L += part_ml[2 * (row0 + s) + 1] * w;
    acc += part_acc[(row0 + s) * D + d] * w;
  }
  out[((size_t)b * H + head) * D + d] = from_f<T>(acc / fmaxf(L, 1e-30f));
}

template <typename T, typename TKV, int D>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          const float* k_scale, const float* v_scale, void* out,
                          const int* page_tables, const int* lengths, float* work,
                          int n_split, int B, int H, int Hkv, int ps, int pmax,
                          int window, float scale, float softcap,
                          cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(H / Hkv, D);
  auto split = decode_split_kernel<T, TKV, D>;
  cudaError_t err = allow_smem(split, smem);
  if (err != cudaSuccess) return err;
  float* part_acc = work;
  float* part_ml = work + (size_t)B * H * n_split * D;
  split<<<dim3(Hkv, B, n_split), DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), k_scale, v_scale, part_acc, part_ml, page_tables,
      lengths, H, Hkv, ps, pmax, n_split, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), lengths, H, n_split, window);
  return cudaGetLastError();
}

}  // namespace kaito

// q [B, H, D]; k_layer/v_layer: one layer of the pool, [P, ps, Hkv, D], in
// q's dtype, or int8 codes when k_scale/v_scale (that layer's fp32 [P, Hkv]
// scales) are given (K1q; both null for K1); page_tables [B, pmax] and
// lengths [B] int32; out [B, H, D].  work: fp32 scratch of
// kaito_decode_workspace_floats(...) floats.  dtype: 0 = float32,
// 1 = bfloat16.  softcap <= 0 disables it.  Returns the CUDA error of the
// launches (0 = success).
extern "C" int kaito_decode_attention(const void* q, const void* k_layer,
                                      const void* v_layer, void* out,
                                      const int* page_tables, const int* lengths,
                                      float* work, const float* k_scale,
                                      const float* v_scale, int B, int H, int Hkv,
                                      int D, int ps, int pmax, int window,
                                      float scale, float softcap, int dtype,
                                      void* stream) {
  using namespace kaito;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_split = (pmax * ps + DEC_CHUNK - 1) / DEC_CHUNK;
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr)) return (int)cudaErrorInvalidValue;
#define KAITO_DEC(T, TKV, DD)                                                       \
  return (int)launch_decode<T, TKV, DD>(q, k_layer, v_layer, k_scale, v_scale, out, \
                                        page_tables, lengths, work, n_split, B, H,  \
                                        Hkv, ps, pmax, window, scale, softcap, s)
#define KAITO_DEC_D(T, TKV)            \
  if (D == 32) KAITO_DEC(T, TKV, 32);  \
  if (D == 64) KAITO_DEC(T, TKV, 64);  \
  if (D == 128) KAITO_DEC(T, TKV, 128)
  if (dtype == 1) {
    if (quant) {
      KAITO_DEC_D(__nv_bfloat16, int8_t);
    } else {
      KAITO_DEC_D(__nv_bfloat16, __nv_bfloat16);
    }
  } else if (dtype == 0) {
    if (quant) {
      KAITO_DEC_D(float, int8_t);
    } else {
      KAITO_DEC_D(float, float);
    }
  }
#undef KAITO_DEC_D
#undef KAITO_DEC
  return (int)cudaErrorInvalidValue;
}

// fp32 scratch kaito_decode_attention needs: per (sequence, query head,
// split) D accumulator values plus the split's running max and sum.
extern "C" long long kaito_decode_workspace_floats(int B, int H, int D, int ps,
                                                   int pmax) {
  const long long n_split = (pmax * (long long)ps + kaito::DEC_CHUNK - 1) /
                            kaito::DEC_CHUNK;
  return (long long)B * H * n_split * (D + 2);
}
