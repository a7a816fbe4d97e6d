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
// Pallas kernels.  Fully masked leading key tiles heal: their partials
// are scaled by alpha = exp(NEG_INF - m_new) = 0 once a valid key lands.
//
// Bound on the H100: operations.  A 512-token chunk does ~T*T*D*2 flops
// per head against T*D*2 elements of K/V read, well above the card's
// 295 flop/byte.  Design: one CTA per (batch, query head, 64-row query
// tile); 64-key K/V tiles staged in shared memory in fp32; each of the
// 256 threads owns a 4x4 block of the score tile and a 4 x D/16 block
// of the output accumulator in registers; key tiles past the causal
// diagonal are never loaded.  The kernel masks the ragged tail itself
// (rows and keys at or past T), so T need not be a multiple of the
// tile.  The dot products run on the fp32 FMA units, not the tensor
// cores: wgmma and TMA are later work, and this kernel's distance from
// its bound is in PERF.md.
#include "common.cuh"

namespace kaito {

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

template <bool PACKED>
int dispatch_flash(const void* q, const void* k, const void* v, void* out,
                   const int* true_len, const int* seg_ids, const int* positions,
                   int B, int T_, int H, int Hkv, int D, int window, float scale,
                   float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KAITO_FLASH(TT, DD)                                                        \
  return (int)launch_flash<TT, DD, PACKED>(q, k, v, out, true_len, seg_ids,        \
                                           positions, B, T_, H, Hkv, window, scale, \
                                           softcap, s)
  if (dtype == 1) {
    if (D == 32) KAITO_FLASH(__nv_bfloat16, 32);
    if (D == 64) KAITO_FLASH(__nv_bfloat16, 64);
    if (D == 128) KAITO_FLASH(__nv_bfloat16, 128);
  } else if (dtype == 0) {
    if (D == 32) KAITO_FLASH(float, 32);
    if (D == 64) KAITO_FLASH(float, 64);
    if (D == 128) KAITO_FLASH(float, 128);
  }
#undef KAITO_FLASH
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
