// Decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention` of the
// reference package (src/repro/kernels/decode_attention.py).  Same function:
// one query token per sequence against a KV cache, cache rows at positions
// >= lengths[b] masked, GQA by index, fp32 statistics, exact zeros where
// lengths[b] == 0.  Row order does not matter to the result, so a ring
// buffer whose first lengths[b] slots are valid is served as it lies.
//
// What differs from the TPU kernel, and why:
//  * The TPU grid (B*H, kv blocks) reads each KV head once per query head of
//    its group.  Here one block serves one (sequence, kv head) and all H/K
//    query heads of that group, so a cache byte is read once.
//  * The kernel is bound by bytes: per cache row it reads 2*dh elements and
//    does 4*dh*(H/K) operations.  Eight lanes share a row (16 bytes per lane
//    for bf16 at dh = 64), a block keeps block_kv rows in flight, each lane
//    carries (m, l, acc) for every head of the group over its own rows, and
//    the partial results are merged once at the end: by shuffles inside a
//    warp, through shared memory across warps.
//  * lengths is read on the device; the host never waits for it.
//  * The cache is read in the type it is stored in (bf16 under an fp32
//    query is widened in registers, which is exact).
//
// With B*K blocks only (16 at batch 8, 2 kv heads) the card's 132 SMs are
// mostly idle; splitting the cache axis over blocks with a merge pass is the
// next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TPR = 8;            // lanes per cache row
constexpr int MAX_THREADS = 512;  // block_kv * TPR

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int B, H, K, dh, Smax;
  long long q_b, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_h;
  float scale;
  int vec_ok;  // rows may be read as 16-byte vectors
};

// EPL consecutive elements of one cache row, starting at d0, widened to fp32.
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* row, int d0, int dh, bool valid, bool vec,
                                         float* out) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = 0.f;
  if (!valid) return;
  constexpr int NBYTES = EPL * (int)sizeof(T);
  if constexpr (NBYTES % 16 == 0) {
    if (vec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(row + d0);
#pragma unroll
      for (int i = 0; i < NBYTES / 16; ++i) {
        const uint4 u = p4[i];
        if constexpr (sizeof(T) == 4) {
          out[4 * i + 0] = __uint_as_float(u.x);
          out[4 * i + 1] = __uint_as_float(u.y);
          out[4 * i + 2] = __uint_as_float(u.z);
          out[4 * i + 3] = __uint_as_float(u.w);
        } else {
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // bf16 is the upper half of an fp32
            out[8 * i + 2 * j + 0] = __uint_as_float(w[j] << 16);
            out[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
          }
        }
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    if (d0 + e < dh) out[e] = to_f32<T>(row[d0 + e]);
  }
}

// One block per (kv head, sequence); GC query heads of the group per pass.
template <typename TQ, typename TKV, int EPL, int GC>
__global__ void __launch_bounds__(MAX_THREADS) decode_kernel(const DecodeParams p) {
  constexpr int DHP = TPR * EPL;
  extern __shared__ float4 smem4[];
  float* sm_q = reinterpret_cast<float*>(smem4);  // [GC][DHP]
  const int nwarps = blockDim.x >> 5;
  float* sm_m = sm_q + GC * DHP;         // [nwarps][GC]
  float* sm_l = sm_m + nwarps * GC;      // [nwarps][GC]
  float* sm_acc = sm_l + nwarps * GC;    // [nwarps][GC][DHP]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = p.H / p.K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid % TPR;       // lane within the row's group of TPR
  const int rgrp = tid / TPR;      // which row of the block's rows in flight
  const int rows_in_flight = blockDim.x / TPR;
  const int d0 = sub * EPL;
  const bool vec = p.vec_ok != 0;

  int length = p.lengths[b];
  length = length < 0 ? 0 : (length > p.Smax ? p.Smax : length);

  const TQ* qbase = reinterpret_cast<const TQ*>(p.q) + (long long)b * p.q_b;
  const TKV* kbase =
      reinterpret_cast<const TKV*>(p.k) + (long long)b * p.k_b + (long long)kvh * p.k_h;
  const TKV* vbase =
      reinterpret_cast<const TKV*>(p.v) + (long long)b * p.v_b + (long long)kvh * p.v_h;
  TQ* obase = reinterpret_cast<TQ*>(p.o) + (long long)b * p.o_b;

  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gn = (GC < G - g0) ? GC : (G - g0);
    const int h0 = kvh * G + g0;

    __syncthreads();  // shared memory of the previous pass has been read
    for (int idx = tid; idx < GC * DHP; idx += blockDim.x) {
      const int g = idx / DHP;
      const int d = idx % DHP;
      float val = 0.f;
      if (g < gn && d < p.dh) val = to_f32<TQ>(qbase[(long long)(h0 + g) * p.q_h + d]);
      sm_q[idx] = val;
    }
    __syncthreads();

    float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }

    // every lane of a warp makes the same number of trips (the shuffles
    // below need all of them); a lane whose row is past the end idles
    for (int r0 = 0; r0 < length; r0 += rows_in_flight) {
      const int r = r0 + rgrp;
      const bool valid = r < length;
      float kf[EPL], vf[EPL];
      load_row<TKV, EPL>(kbase + (long long)(valid ? r : 0) * p.k_s, d0, p.dh, valid, vec, kf);
      load_row<TKV, EPL>(vbase + (long long)(valid ? r : 0) * p.v_s, d0, p.dh, valid, vec, vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < gn) {  // uniform over the block
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(sm_q[g * DHP + d0 + e], kf[e], s);
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          if (valid) {
            s *= p.scale;
            const float m_new = fmaxf(m[g], s);
            const float alpha = expf(m[g] - m_new);  // m == -inf gives 0
            const float pj = expf(s - m_new);
            l[g] = l[g] * alpha + pj;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e] * alpha);
            m[g] = m_new;
          }
        }
      }
    }

    // merge the 32 / TPR row groups of a warp (lanes with equal `sub`)
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], m2);
        const float a1 = (m[g] == -INFINITY) ? 0.f : expf(m[g] - mn);
        const float a2 = (m2 == -INFINITY) ? 0.f : expf(m2 - mn);
        l[g] = l[g] * a1 + l2 * a2;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float acc2 = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = acc[g][e] * a1 + acc2 * a2;
        }
        m[g] = mn;
      }
      if (lane < TPR) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[(warp * GC + g) * DHP + d0 + e] = acc[g][e];
        if (lane == 0) {
          sm_m[warp * GC + g] = m[g];
          sm_l[warp * GC + g] = l[g];
        }
      }
    }
    __syncthreads();

    // merge the warps and write the output
    for (int idx = tid; idx < gn * p.dh; idx += blockDim.x) {
      const int g = idx / p.dh;
      const int d = idx % p.dh;
      float mx = -INFINITY;
      for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, sm_m[w * GC + g]);
      float out = 0.f;
      if (mx != -INFINITY) {  // else: empty cache, exact zeros
        float lsum = 0.f, asum = 0.f;
        for (int w = 0; w < nwarps; ++w) {
          const float mw = sm_m[w * GC + g];
          if (mw == -INFINITY) continue;
          const float a = expf(mw - mx);
          lsum += sm_l[w * GC + g] * a;
          asum += sm_acc[(w * GC + g) * DHP + d] * a;
        }
        out = asum / lsum;
      }
      obase[(long long)(h0 + g) * p.o_h + d] = from_f32<TQ>(out);
    }
  }
}

template <typename TQ, typename TKV, int EPL, int GC>
cudaError_t launch_one(DecodeParams p, int threads, cudaStream_t stream) {
  constexpr int DHP = TPR * EPL;
  auto kern = decode_kernel<TQ, TKV, EPL, GC>;
  const int nwarps = threads / 32;
  const size_t smem = ((size_t)GC * DHP + (size_t)nwarps * GC * (2 + DHP)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const size_t esz = sizeof(TKV);
  const bool aligned = (reinterpret_cast<uintptr_t>(p.k) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(p.v) % 16 == 0) &&
                       (p.k_b * esz % 16 == 0) && (p.k_s * esz % 16 == 0) &&
                       (p.k_h * esz % 16 == 0) && (p.v_b * esz % 16 == 0) &&
                       (p.v_s * esz % 16 == 0) && (p.v_h * esz % 16 == 0);
  p.vec_ok = (aligned && p.dh == DHP && (EPL * esz) % 16 == 0) ? 1 : 0;
  const dim3 grid(p.K, p.B);
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int EPL>
cudaError_t launch_gc(const DecodeParams& p, int threads, cudaStream_t stream) {
  const int G = p.H / p.K;
  if (G == 1) return launch_one<TQ, TKV, EPL, 1>(p, threads, stream);
  if (G <= 4) return launch_one<TQ, TKV, EPL, 4>(p, threads, stream);
  return launch_one<TQ, TKV, EPL, 8>(p, threads, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_t(const DecodeParams& p, int threads, cudaStream_t stream) {
  if (p.dh <= 16) return launch_gc<TQ, TKV, 2>(p, threads, stream);
  if (p.dh <= 32) return launch_gc<TQ, TKV, 4>(p, threads, stream);
  if (p.dh <= 64) return launch_gc<TQ, TKV, 8>(p, threads, stream);
  if (p.dh <= 128) return launch_gc<TQ, TKV, 16>(p, threads, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32 query and cache, 1 = bf16 query and cache, 2 = fp32 query
// over a bf16 cache.  The output has the query's type.  Strides are in
// elements; the last dimension of every tensor is contiguous.  block_kv is
// the number of cache rows a block keeps in flight (block_kv * 8 threads).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, int dtype, int B, int H, int K,
                                    int dh, int Smax, long long q_b, long long q_h, long long k_b,
                                    long long k_s, long long k_h, long long v_b, long long v_s,
                                    long long v_h, long long o_b, long long o_h, float scale,
                                    int block_kv, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;  // nothing to compute
  const int threads = block_kv * TPR;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || K < 1 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  DecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.lengths = reinterpret_cast<const int*>(lengths);
  p.o = o;
  p.B = B; p.H = H; p.K = K; p.dh = dh; p.Smax = Smax;
  p.q_b = q_b; p.q_h = q_h;
  p.k_b = k_b; p.k_s = k_s; p.k_h = k_h;
  p.v_b = v_b; p.v_s = v_s; p.v_h = v_h;
  p.o_b = o_b; p.o_h = o_h;
  p.scale = scale;
  p.vec_ok = 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = launch_t<float, float>(p, threads, st);
  else if (dtype == 1) e = launch_t<__nv_bfloat16, __nv_bfloat16>(p, threads, st);
  else if (dtype == 2) e = launch_t<float, __nv_bfloat16>(p, threads, st);
  return (int)e;
}
