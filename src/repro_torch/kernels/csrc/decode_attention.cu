// Decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention` of the
// reference package (src/repro/kernels/decode_attention.py).  Same function:
// one query token per sequence against a KV cache, cache rows at positions
// >= lengths[b] masked, GQA by index, fp32 statistics, exact zeros where
// lengths[b] == 0.  Row order does not matter to the result, so a ring
// buffer whose first lengths[b] slots are valid is served as it lies.
//
// What bounds it on this card: bytes.  Per cache row the kernel reads 2*dh
// elements and does 4*dh*(H/K) operations, far below the card's ~300
// operations a byte, so the least time is the cache's bytes over 3.35 TB/s
// (0.7 us at batch 8, 576 rows, 2 kv heads of 64 in bf16).  Reaching it needs
// enough bytes in flight on every SM, and at serving batch sizes the natural
// grid (one block per sequence and kv head: 16 blocks at batch 8) leaves most
// of the 132 SMs idle while each block walks the whole cache.
//
// The design (flash-decoding, one launch):
//  * Grid (K, B, n_splits).  Split s of sequence b takes the contiguous
//    rows [s*r, min((s+1)*r, lengths[b])) with r = ceil(lengths[b] /
//    n_splits): the range is derived on the device, so the host never waits
//    for lengths, and every sequence's rows are spread over all its splits
//    whatever its length.  A split past the length holds no row and reports
//    m = -inf, l = 0.  The wrapper picks n_splits from shapes alone (split_count in
//    decode_attention.py: up to two blocks per SM, so one wave, and at least
//    one trip of block_kv rows a split).
//  * One block serves one (sequence, kv head, split) and all H/K query heads
//    of that group, so a cache byte is read once.  It walks its rows in trips
//    of block_kv rows: eight lanes a row load K and V (16 bytes a lane for
//    bf16 at dh = 64) and form the row's scores for every head; a warp a head
//    turns a trip's scores into probabilities; a thread a (head, column)
//    adds P V to its accumulator.  The running (m, l, acc) live in shared
//    memory, so no thread carries per-head arrays: the kernel fits in 64
//    registers and two blocks of 512 threads share an SM, and the splits of a
//    serving step run in one wave.
//  * With one split the block writes the output itself.  Otherwise it writes
//    its unnormalised (m, l, acc) to an fp32 scratch that the wrapper
//    allocates, then counts itself done on a per-(sequence, kv head) counter
//    (__threadfence, atomicAdd).  The last block of the group to finish
//    merges the splits (each rescaled to the largest maximum, as the trips
//    are), writes the output and sets the counter back to 0.  A second merge kernel would cost
//    a launch per layer, and the host, not the card, bounds serving.
//  * The counters are a zeroed int32 buffer that the wrapper keeps per
//    device; it is 0 again after every launch, so it stays valid under CUDA
//    graph capture.  Two launches that run at once on different streams of
//    one device must not share it.
//  * The cache is read in the type it is stored in (bf16 under an fp32
//    query is widened in registers, which is exact).

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
  float* part;   // [B][H][n_splits][dh + 2]: acc[dh], m, l (n_splits > 1)
  int* counter;  // [B*K], zero between launches (n_splits > 1)
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

// One block per (kv head, sequence, split); GC query heads of the group per
// pass.  A trip takes R = blockDim.x / TPR rows: (a) TPR lanes a row load its
// K and V, keep V in shared memory and form the row's scores for every head
// (base-2 logits); (b) a warp a head takes the trip's maximum and sum and
// turns the scores into probabilities, updating the head's running (m, l);
// (c) a thread a (head, column) rescales its accumulator and adds P V.  The
// running (m, l, acc) live in shared memory, so a thread holds no per-head
// arrays and two blocks fit an SM.
template <typename TQ, typename TKV, int EPL, int GC>
__global__ void __launch_bounds__(MAX_THREADS, 2) decode_kernel(const DecodeParams p) {
  constexpr int DHP = TPR * EPL;
  const int R = blockDim.x / TPR;
  extern __shared__ float4 smem4[];
  float* sm_q = reinterpret_cast<float*>(smem4);  // [GC][DHP] (see q_slot), times scale * log2(e)
  float* sm_acc = sm_q + GC * DHP;               // [GC][DHP]
  float* sm_v = sm_acc + GC * DHP;               // [R][DHP]: this trip's V rows
  float* sm_p = sm_v + R * DHP;                  // [GC][R]: scores, then probabilities
  float* sm_m = sm_p + GC * R;                   // [GC]: running maximum (base 2)
  float* sm_l = sm_m + GC;                       // [GC]: running sum
  float* sm_a = sm_l + GC;                       // [GC]: this trip's rescale
  __shared__ int sm_last;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int G = p.H / p.K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = tid % TPR;   // lane within the row's group of TPR
  const int rgrp = tid / TPR;  // which row of the trip
  const int d0 = sub * EPL;
  const bool vec = p.vec_ok != 0;
  const float qscale = p.scale * 1.4426950408889634f;  // softmax in base 2
  // where q[g][d] sits in sm_q: the 4-column groups of the TPR lanes of a row
  // side by side, so that a lane's 16-byte reads hit distinct banks
  auto q_slot = [](int g, int d) {
    if constexpr (EPL % 4 == 0)
      return g * DHP + (((d % EPL) / 4) * TPR + d / EPL) * 4 + d % 4;
    else
      return g * DHP + d;
  };

  int length = p.lengths[b];
  length = length < 0 ? 0 : (length > p.Smax ? p.Smax : length);
  // this split's rows: [r_begin, r_end)
  const int per_split = (length + n_splits - 1) / n_splits;
  const int r_begin = min(split * per_split, length);
  const int r_end = min(r_begin + per_split, length);

  const TQ* qbase = reinterpret_cast<const TQ*>(p.q) + (long long)b * p.q_b;
  const TKV* kbase =
      reinterpret_cast<const TKV*>(p.k) + (long long)b * p.k_b + (long long)kvh * p.k_h;
  const TKV* vbase =
      reinterpret_cast<const TKV*>(p.v) + (long long)b * p.v_b + (long long)kvh * p.v_h;
  TQ* obase = reinterpret_cast<TQ*>(p.o) + (long long)b * p.o_b;
  const int pstride = p.dh + 2;  // floats per (head, split) partial

  // K and V of one trip's row into registers (zeros past the split's end)
  float kf[EPL], vf[EPL];
  auto load_trip = [&](int r0) {
    const int r = r0 + rgrp;
    const bool valid = r < r_end;
    load_row<TKV, EPL>(kbase + (long long)(valid ? r : 0) * p.k_s, d0, p.dh, valid, vec, kf);
    load_row<TKV, EPL>(vbase + (long long)(valid ? r : 0) * p.v_s, d0, p.dh, valid, vec, vf);
  };

  for (int g0 = 0; g0 < G; g0 += GC) {
    const int gn = (GC < G - g0) ? GC : (G - g0);
    const int h0 = kvh * G + g0;

    if (r_begin < r_end) load_trip(r_begin);  // in flight while the queries are staged
    __syncthreads();  // shared memory of the previous pass has been read
    for (int idx = tid; idx < GC * DHP; idx += blockDim.x) {
      const int g = idx / DHP;
      const int d = idx % DHP;
      float val = 0.f;
      if (g < gn && d < p.dh) val = to_f32<TQ>(qbase[(long long)(h0 + g) * p.q_h + d]) * qscale;
      sm_q[q_slot(g, d)] = val;
      sm_acc[idx] = 0.f;
    }
    if (tid < GC) {
      sm_m[tid] = -INFINITY;
      sm_l[tid] = 0.f;
    }
    __syncthreads();

    for (int r0 = r_begin; r0 < r_end; r0 += R) {
      // (a) V into shared memory (16-byte stores), scores of this trip's rows
      const bool valid = r0 + rgrp < r_end;
      if constexpr (EPL % 4 == 0) {
#pragma unroll
        for (int e = 0; e < EPL; e += 4)
          *reinterpret_cast<float4*>(sm_v + rgrp * DHP + d0 + e) =
              make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_v[rgrp * DHP + d0 + e] = vf[e];
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < gn) {  // uniform over the block
          float s = 0.f;
          if constexpr (EPL % 4 == 0) {
#pragma unroll
            for (int e = 0; e < EPL; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(sm_q + q_slot(g, d0 + e));
              s = fmaf(qv.x, kf[e], s);
              s = fmaf(qv.y, kf[e + 1], s);
              s = fmaf(qv.z, kf[e + 2], s);
              s = fmaf(qv.w, kf[e + 3], s);
            }
          } else {
#pragma unroll
            for (int e = 0; e < EPL; ++e) s = fmaf(sm_q[q_slot(g, d0 + e)], kf[e], s);
          }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          if (sub == 0) sm_p[g * R + rgrp] = valid ? s : -INFINITY;
        }
      }
      // the next trip's rows are in flight during (b) and (c)
      if (r0 + R < r_end) load_trip(r0 + R);
      __syncthreads();

      // (b) per head: the trip's maximum, probabilities, running (m, l)
      for (int g = warp; g < gn; g += nwarps) {
        float* pg = sm_p + g * R;
        float mx = -INFINITY;
        for (int j = lane; j < R; j += 32) mx = fmaxf(mx, pg[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = sm_m[g];
        const float m_new = fmaxf(m_old, mx);
        const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;  // nothing live yet
        float ls = 0.f;
        for (int j = lane; j < R; j += 32) {
          const float pj = exp2f(pg[j] - m_safe);  // a masked row gives exp2(-inf) = 0
          pg[j] = pj;
          ls += pj;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_safe);  // m == -inf gives 0
          sm_a[g] = alpha;
          sm_l[g] = sm_l[g] * alpha + ls;
          sm_m[g] = m_new;
        }
      }
      __syncthreads();

      // (c) acc = acc * alpha + P V, a thread a (head, 4 columns), two row
      // chains; rows past the end of the split have P = 0 and V = 0
      const int nr4 = (min(R, r_end - r0) + 3) & ~3;
      for (int idx = tid; idx < gn * (DHP / 4); idx += blockDim.x) {
        const int g = idx / (DHP / 4);
        const int d = (idx % (DHP / 4)) * 4;
        const float* pg = sm_p + g * R;
        float4 a0 = *reinterpret_cast<const float4*>(sm_acc + g * DHP + d);
        const float al = sm_a[g];
        a0.x *= al;
        a0.y *= al;
        a0.z *= al;
        a0.w *= al;
        float4 a1 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int j = 0; j < nr4; j += 4) {
          const float4 pj = *reinterpret_cast<const float4*>(pg + j);
          const float4 v0 = *reinterpret_cast<const float4*>(sm_v + (j + 0) * DHP + d);
          const float4 v1 = *reinterpret_cast<const float4*>(sm_v + (j + 1) * DHP + d);
          const float4 v2 = *reinterpret_cast<const float4*>(sm_v + (j + 2) * DHP + d);
          const float4 v3 = *reinterpret_cast<const float4*>(sm_v + (j + 3) * DHP + d);
          a0.x = fmaf(pj.x, v0.x, a0.x); a0.y = fmaf(pj.x, v0.y, a0.y);
          a0.z = fmaf(pj.x, v0.z, a0.z); a0.w = fmaf(pj.x, v0.w, a0.w);
          a1.x = fmaf(pj.y, v1.x, a1.x); a1.y = fmaf(pj.y, v1.y, a1.y);
          a1.z = fmaf(pj.y, v1.z, a1.z); a1.w = fmaf(pj.y, v1.w, a1.w);
          a0.x = fmaf(pj.z, v2.x, a0.x); a0.y = fmaf(pj.z, v2.y, a0.y);
          a0.z = fmaf(pj.z, v2.z, a0.z); a0.w = fmaf(pj.z, v2.w, a0.w);
          a1.x = fmaf(pj.w, v3.x, a1.x); a1.y = fmaf(pj.w, v3.y, a1.y);
          a1.z = fmaf(pj.w, v3.z, a1.z); a1.w = fmaf(pj.w, v3.w, a1.w);
        }
        *reinterpret_cast<float4*>(sm_acc + g * DHP + d) =
            make_float4(a0.x + a1.x, a0.y + a1.y, a0.z + a1.z, a0.w + a1.w);
      }
      __syncthreads();  // sm_v and sm_p are free for the next trip
    }

    // the output itself (one split), else this split's unnormalised partial
    for (int idx = tid; idx < gn * p.dh; idx += blockDim.x) {
      const int g = idx / p.dh;
      const int d = idx % p.dh;
      const float acc = sm_acc[g * DHP + d];
      const float m = sm_m[g];
      if (n_splits == 1) {
        // an empty cache gives exact zeros
        obase[(long long)(h0 + g) * p.o_h + d] = from_f32<TQ>(m == -INFINITY ? 0.f : acc / sm_l[g]);
      } else {
        float* part = p.part + (((long long)b * p.H + h0 + g) * n_splits + split) * pstride;
        part[d] = acc;
        if (d == 0) {
          part[p.dh] = m;
          part[p.dh + 1] = sm_l[g];
        }
      }
    }
  }
  if (n_splits == 1) return;

  // count this split done; the last of the group merges
  int* counter = p.counter + (long long)b * p.K + kvh;
  __threadfence();  // this block's partials are visible device-wide ...
  __syncthreads();  // ... for every thread of it
  if (tid == 0) sm_last = (atomicAdd(counter, 1) == n_splits - 1);
  __syncthreads();
  if (!sm_last) return;
  __threadfence();  // the other splits' partials are visible to this block

  // a warp a head: weight of split s = 2^(m_s - M) / L, L = sum of 2^(m_s - M) l_s,
  // written over the split's m (only this block reads the partials now)
  float* part0 = p.part + ((long long)b * p.H + (long long)kvh * G) * n_splits * pstride;
  for (int g = warp; g < G; g += nwarps) {
    float* pg = part0 + (long long)g * n_splits * pstride;  // [n_splits][pstride]
    float mx = -INFINITY;
    for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, __ldcg(pg + s * pstride + p.dh));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float lsum = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float ms = __ldcg(pg + s * pstride + p.dh);
      if (ms != -INFINITY) lsum += __ldcg(pg + s * pstride + p.dh + 1) * exp2f(ms - mx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    // an empty cache (every m = -inf) gives weights 0: exact zeros
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float ms = __ldcg(pg + s * pstride + p.dh);
      pg[s * pstride + p.dh] = (ms == -INFINITY) ? 0.f : exp2f(ms - mx) * inv;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * p.dh; idx += blockDim.x) {
    const int g = idx / p.dh;
    const int d = idx % p.dh;
    const float* pg = part0 + (long long)g * n_splits * pstride;
    float out = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s)
      out = fmaf(__ldcg(pg + s * pstride + p.dh), __ldcg(pg + s * pstride + d), out);
    obase[(long long)(kvh * G + g) * p.o_h + d] = from_f32<TQ>(out);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <typename TQ, typename TKV, int EPL, int GC>
cudaError_t launch_one(DecodeParams p, int threads, int n_splits, cudaStream_t stream) {
  constexpr int DHP = TPR * EPL;
  auto kern = decode_kernel<TQ, TKV, EPL, GC>;
  const int rows = threads / TPR;
  const size_t smem =
      ((size_t)2 * GC * DHP + (size_t)rows * DHP + (size_t)GC * rows + 3 * GC) * sizeof(float);
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
  const dim3 grid(p.K, p.B, n_splits);
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int EPL>
cudaError_t launch_gc(const DecodeParams& p, int threads, int n_splits, cudaStream_t stream) {
  const int G = p.H / p.K;
  if (G == 1) return launch_one<TQ, TKV, EPL, 1>(p, threads, n_splits, stream);
  if (G <= 4) return launch_one<TQ, TKV, EPL, 4>(p, threads, n_splits, stream);
  return launch_one<TQ, TKV, EPL, 8>(p, threads, n_splits, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_t(const DecodeParams& p, int threads, int n_splits, cudaStream_t stream) {
  if (p.dh <= 16) return launch_gc<TQ, TKV, 2>(p, threads, n_splits, stream);
  if (p.dh <= 32) return launch_gc<TQ, TKV, 4>(p, threads, n_splits, stream);
  if (p.dh <= 64) return launch_gc<TQ, TKV, 8>(p, threads, n_splits, stream);
  if (p.dh <= 128) return launch_gc<TQ, TKV, 16>(p, threads, n_splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32 query and cache, 1 = bf16 query and cache, 2 = fp32 query
// over a bf16 cache.  The output has the query's type.  Strides are in
// elements; the last dimension of every tensor is contiguous.  block_kv is
// the number of cache rows a block keeps in flight (block_kv * 8 threads).
// n_splits > 1 needs `part` (B*H*n_splits*(dh+2) floats) and `counter` (B*K
// ints, all zero; zero again when the kernel ends).  Returns the cudaError_t
// of the launch (0 = launched).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, void* part, void* counter,
                                    int dtype, int B, int H, int K, int dh, int Smax,
                                    long long q_b, long long q_h, long long k_b, long long k_s,
                                    long long k_h, long long v_b, long long v_s, long long v_h,
                                    long long o_b, long long o_h, float scale, int block_kv,
                                    int n_splits, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;  // nothing to compute
  const int threads = block_kv * TPR;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || K < 1 || H % K != 0 ||
      n_splits < 1 || n_splits > 65535 || (n_splits > 1 && (part == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  DecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.lengths = reinterpret_cast<const int*>(lengths);
  p.o = o;
  p.part = reinterpret_cast<float*>(part);
  p.counter = reinterpret_cast<int*>(counter);
  p.B = B; p.H = H; p.K = K; p.dh = dh; p.Smax = Smax;
  p.q_b = q_b; p.q_h = q_h;
  p.k_b = k_b; p.k_s = k_s; p.k_h = k_h;
  p.v_b = v_b; p.v_s = v_s; p.v_h = v_h;
  p.o_b = o_b; p.o_h = o_h;
  p.scale = scale;
  p.vec_ok = 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = launch_t<float, float>(p, threads, n_splits, st);
  else if (dtype == 1) e = launch_t<__nv_bfloat16, __nv_bfloat16>(p, threads, n_splits, st);
  else if (dtype == 2) e = launch_t<float, __nv_bfloat16>(p, threads, n_splits, st);
  return (int)e;
}
