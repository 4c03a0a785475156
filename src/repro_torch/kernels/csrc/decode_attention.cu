// Decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention` of the
// reference package (src/repro/kernels/decode_attention.py).  Same function:
// one query token per sequence against a KV cache, cache rows at positions
// >= lengths[b] masked, GQA by index, fp32 statistics, exact zeros where
// lengths[b] == 0.  Row order does not matter to the result, so a ring
// buffer whose first lengths[b] slots are valid is served as it lies.
//
// What bounds it on this card: bytes.  Per cache row a KV head gives 2*dh
// elements and 4*dh*(H/K) operations, far below the card's ~300 operations a
// byte, so the least time is the cache's bytes over 3.35 TB/s (0.64 ms for
// the 2.15 GB of bf16 keys and values of 128 sequences at 31.8k rows, 2 KV
// heads of 64).  Reaching it takes enough bytes in flight on every SM, by
// Little's law some 40-50 KB at loaded latency, and no serial work between a
// load and the next one.  Two paths, chosen by the wrapper from the inputs'
// types and shapes alone (decode_attention.py: `route`):
//
// decode_kernel: fp32 query (over an fp32 or bf16 cache), and bf16 at head
// widths or groups the tensor-core path does not take.  Flash-decoding in
// one launch:
//  * Grid (K, B, n_splits).  Split s of sequence b takes the contiguous
//    rows [s*r, min((s+1)*r, lengths[b])) with r = ceil(lengths[b] /
//    n_splits): the range is derived on the device, so the host never waits
//    for lengths.  A split past the length holds no row and reports m = -inf,
//    l = 0.  The wrapper picks n_splits from shapes alone (split_count: up to
//    two blocks per SM, so one wave).
//  * One block serves one (sequence, kv head, split) and all H/K query heads
//    of that group, so a cache byte is read once.  It walks its rows in trips
//    of block_kv rows: eight lanes a row load K and V into registers and form
//    the row's scores for every head; a warp a head turns a trip's scores into
//    probabilities; a thread a (head, column) adds P V to its accumulator.
//    The running (m, l, acc) live in shared memory, so the kernel fits in 64
//    registers and two blocks of 512 threads share an SM.  It keeps one trip
//    (~32 KB an SM) in flight, with three block-wide phases between loads: at
//    long caches it streams at ~28 % of the byte bound.
//  * With one split the block writes the output itself.  Otherwise it writes
//    its unnormalised (m, l, acc) to an fp32 scratch that the wrapper
//    allocates and counts itself done on a per-(sequence, kv head) counter
//    (__threadfence, atomicAdd); the last block of the group merges the
//    splits, writes the output and sets the counter back to 0.
//
// decode_kernel_mma: bf16 query over a bf16 cache, dh a multiple of 16 up to
// 128, H/K up to 16.  The cache is streamed by warps that wait on nothing but
// their own copies:
//  * Every warp streams through its own ring of MMA_STAGES stages of block_kv
//    rows of K and V in shared memory, filled by cp.async (16 bytes a lane,
//    straight to shared memory; rows past the end zero-filled, not read).  It
//    issues the stage MMA_STAGES - 1 ahead, waits for its oldest and consumes
//    it; no barrier spans warps inside a sequence.  At the decode_32k shape
//    (block_kv 32, one block of 4 warps an SM) that is 3 stages of 8 KB in
//    flight a warp, 96 KB an SM.
//  * The group's query heads are the 16 rows of an mma.sync m16n8k16 tile (7
//    used at qwen2's 14/2): S = Q K^T in f32 from exact bf16 products, the
//    online softmax in f32 and base 2 on the fragments (a head's maximum and
//    sum over the four lanes that hold it), and O += P V on the tensor cores
//    with P = hi + lo, hi = bf16(P) and lo = bf16(P - hi): two products summed
//    in f32, so P keeps ~16 bits (P rounded once to bf16 would keep 8).
//  * Grid (K / gcd(K, 4), B, n_splits), the fma path's split: split s of
//    sequence b takes the rows [s*r, min((s+1)*r, lengths[b])) with r =
//    ceil(lengths[b] / n_splits), derived on the device.  The wrapper picks
//    n_splits from shapes alone (mma_split_count: as many as fill one wave at
//    the residency shared memory allows, and no more than keep the partials
//    under 2 % of the cache's bytes).  A block takes gcd(K, 4) heads, so its
//    warps read whole 256-byte rows at qwen2's two heads, and the 4 / gcd(K,
//    4) warps of a head take its stages in turn; at the end they combine
//    through shared memory (two block barriers).
//  * With one split the block writes the output itself.  Otherwise each
//    head's first warp writes its (m, l, acc) to the split's slot, counts
//    itself done on the (sequence, head) counter, and the warp that finishes
//    last merges the splits in their order, writes the output and sets the
//    counter back to 0: one launch a call, safe under CUDA-graph capture.
//
// The counters are a zeroed int32 buffer that the wrapper keeps per device;
// both kernels leave it 0 after every launch.  Two launches that run at once
// on different streams of one device must not share it.  The cache is read
// in the type it is stored in (bf16 under an fp32 query is widened in
// registers, which is exact).

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

// ===========================================================================
// bf16 query over a bf16 cache: warps streaming through cp.async rings, the
// group on the tensor cores
// ===========================================================================

constexpr int MMA_WARPS = 4;   // warps a block, each streaming on its own
constexpr int MMA_STAGES = 4;  // ring stages a warp
constexpr int MMA_MAX_G = 16;  // query heads a kv head: the rows of an m16n8k16 tile

struct MmaParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* lengths;
  __nv_bfloat16* o;
  float* part;   // [B][K][n_splits][G][dh + 2]: acc[dh], m, l (n_splits > 1)
  int* counter;  // [B * K], zero between launches (the same)
  int B, H, K, dh, Smax;
  long long q_b, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_h;
  float qscale;        // scale * log2(e)
  int n_splits;
  int warps_per_head;  // 4 / gcd(K, 4): the warps of a block that share a head's rows
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
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

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane i gives the
// address of row (i % 8) of matrix (i / 8); each thread gets, per matrix M,
// the pair M[2t][g], M[2t+1][g] -- the B fragment of a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two consecutive bf16 of a query row as one A-fragment register (zero where not ok)
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* x, bool ok) {
  if (!ok) return 0u;
  return (uint32_t)__bfloat16_as_ushort(x[0]) | ((uint32_t)__bfloat16_as_ushort(x[1]) << 16);
}

// (x0, x1) as the sum of two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // .x = x0 = low 16 bits
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The last warp of a (sequence, kv head) merges its n_splits partials, in
// their order: the weight of split s is 2^(m_s - M) / L, L the sum of
// 2^(m_s - M) l_s; an empty cache (every m = -inf) gives weights 0, so exact
// zeros.  (M, 1/L) of eight heads at a time over lanes a split each, kept in
// `scratch` (the warp's own shared memory); then a lane a (head, column
// pair), eight of them at a time.  Every load of a round is issued before
// any is used (indices past the end are clamped, not branched around), so a
// round costs one trip to L2.
__device__ void merge_splits(const MmaParams& p, int b, int kvh, float* scratch) {
  constexpr int NB = 8;  // heads, or items, a round
  const int lane = threadIdx.x & 31;
  const int G = p.H / p.K;
  const int count = p.n_splits;
  const int pstride = p.dh + 2;
  const long long step = (long long)G * pstride;  // from split s to s + 1
  const float* part0 = p.part + ((long long)b * p.K + kvh) * count * step;
  for (int h0 = 0; h0 < G; h0 += NB) {
    float M[NB], L[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      M[j] = -INFINITY;
      L[j] = 0.f;
    }
    for (int s = lane; s < count; s += 32) {
      float ms[NB], ls[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float* ps = part0 + s * step + min(h0 + j, G - 1) * pstride + p.dh;
        ms[j] = __ldcg(ps);
        ls[j] = __ldcg(ps + 1);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float mn = fmaxf(M[j], ms[j]);
        if (mn != -INFINITY) L[j] = L[j] * exp2f(M[j] - mn) + ls[j] * exp2f(ms[j] - mn);
        M[j] = mn;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float mo = __shfl_xor_sync(0xffffffffu, M[j], off);
        const float lo = __shfl_xor_sync(0xffffffffu, L[j], off);
        const float mn = fmaxf(M[j], mo);
        if (mn != -INFINITY) L[j] = L[j] * exp2f(M[j] - mn) + lo * exp2f(mo - mn);
        M[j] = mn;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        scratch[2 * (h0 + j)] = M[j];
        scratch[2 * (h0 + j) + 1] = L[j] > 0.f ? 1.f / L[j] : 0.f;
      }
    }
  }
  __syncwarp();
  const int pairs = p.dh / 2;
  const int items = G * pairs;
  __nv_bfloat16* ob = p.o + (long long)b * p.o_b + (long long)kvh * G * p.o_h;
  for (int i0 = lane; i0 < items; i0 += 32 * NB) {
    int at[NB], mo[NB];  // where the item's columns and its head's m lie in a slot
    float mx[NB], inv[NB];
    float2 out[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int idx = min(i0 + 32 * j, items - 1);
      const int h = idx / pairs;
      at[j] = h * pstride + 2 * (idx - h * pairs);
      mo[j] = h * pstride + p.dh;
      mx[j] = scratch[2 * h];
      inv[j] = scratch[2 * h + 1];
      out[j] = make_float2(0.f, 0.f);
    }
#pragma unroll 2
    for (int s = 0; s < count; ++s) {
      const float* ps = part0 + s * step;
      float ms[NB];
      float2 a[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        ms[j] = __ldcg(ps + mo[j]);
        a[j] = __ldcg(reinterpret_cast<const float2*>(ps + at[j]));
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float w = (ms[j] == -INFINITY) ? 0.f : exp2f(ms[j] - mx[j]) * inv[j];
        out[j].x = fmaf(w, a[j].x, out[j].x);
        out[j].y = fmaf(w, a[j].y, out[j].y);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int idx = i0 + 32 * j;
      if (idx < items) {
        const int h = idx / pairs;
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)h * p.o_h + 2 * (idx - h * pairs)) =
            __floats2bfloat162_rn(out[j].x, out[j].y);
      }
    }
  }
}

// One block streams one split of one sequence for HB = gcd(K, 4) kv heads,
// 4 / HB warps a head taking its stages in turn (see the note at the top).
// The fragments: lane (g, t) = (lane / 4, lane % 4) holds heads g and g + 8
// of the group, and columns (rows of the stage in S, head dims in O) 2t,
// 2t + 1 of each 8-wide tile.
template <int DHP, int BKV>
__global__ void __launch_bounds__(MMA_WARPS * 32, 2) decode_kernel_mma(const MmaParams p) {
  typedef __nv_bfloat16 T;
  constexpr int STR = DHP + 8;         // elements a staged row: 16 bytes of padding
  constexpr int SLOT = 2 * BKV * STR;  // a stage: BKV rows of K, then BKV rows of V
  constexpr int CPR = DHP / 8;         // 16-byte chunks a row
  constexpr int NT = BKV / 8;          // 8-row tiles of a stage (the n of S)
  constexpr int NV = DHP / 8;          // 8-column tiles of the head (the n of O)
  constexpr int KC = DHP / 16;         // 16-column steps of Q K^T
  constexpr int MSTR = DHP + 2;        // floats a head in the warps' merge area
  static_assert((BKV * CPR) % 32 == 0 && NV % 2 == 0 && BKV % 16 == 0, "tile shapes");
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  T* ring = reinterpret_cast<T*>(smem4) + (size_t)warp * MMA_STAGES * SLOT;
  // [warp][head][MSTR]: each warp's (acc, m, l) at the end
  float* mrg = reinterpret_cast<float*>(reinterpret_cast<T*>(smem4) + (size_t)MMA_WARPS *
                                                                        MMA_STAGES * SLOT);

  const int wph = p.warps_per_head;
  const int kvh = blockIdx.x * (MMA_WARPS / wph) + warp / wph;
  const int sub = warp % wph;  // this warp's turn among its head's
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = p.H / p.K;
  const bool upper = G > 8;  // heads 8..15 of the group: the fragments' second row
  int len = p.lengths[b];
  len = len < 0 ? 0 : (len > p.Smax ? p.Smax : len);
  const int per = (len + p.n_splits - 1) / p.n_splits;
  const int rb = min(split * per, len);
  const int re = min(rb + per, len);  // this split's rows: [rb, re)
  const int stride_rows = wph * BKV;  // from one of this warp's stages to its next

  // the copies: this warp's stages through the split's rows; a stage is one
  // cp.async group (an empty one past the end)
  const T* kbase = p.k + (long long)b * p.k_b + (long long)kvh * p.k_h;
  const T* vbase = p.v + (long long)b * p.v_b + (long long)kvh * p.v_h;
  int pr = rb + sub * BKV;
  auto issue = [&](int slot) {
    if (pr < re) {
      T* ks = ring + slot * SLOT;
      T* vs = ks + BKV * STR;
      const int n = min(BKV, re - pr);
      const T* kr = kbase + (long long)pr * p.k_s;
      const T* vr = vbase + (long long)pr * p.v_s;
#pragma unroll
      for (int i = 0; i < BKV * CPR / 32; ++i) {
        const int idx = lane + 32 * i;
        const int r = idx / CPR;
        const int c = (idx % CPR) * 8;
        const bool ok = r < n && c < p.dh;  // else 16 zero bytes, nothing read
        cp_async16(ks + r * STR + c, ok ? kr + r * p.k_s + c : kr, ok ? 16 : 0);
        cp_async16(vs + r * STR + c, ok ? vr + r * p.v_s + c : vr, ok ? 16 : 0);
      }
      pr += stride_rows;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) issue(s);

  // the group's queries as A fragments: heads g and g + 8, zero past G
  uint32_t qa[KC][4];
  {
    const T* qb = p.q + (long long)b * p.q_b + (long long)kvh * G * p.q_h;
    const bool ok0 = g < G, ok1 = g + 8 < G;
    const T* q0 = qb + (long long)(ok0 ? g : 0) * p.q_h;
    const T* q1 = qb + (long long)(ok1 ? g + 8 : 0) * p.q_h;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = kc * 16 + 2 * t;
      const bool in = c < p.dh;  // dh is a multiple of 16: then c + 8 < dh too
      qa[kc][0] = q_pair(q0 + c, ok0 && in);
      qa[kc][1] = q_pair(q1 + c, ok1 && in);
      qa[kc][2] = q_pair(q0 + c + 8, ok0 && in);
      qa[kc][3] = q_pair(q1 + c + 8, ok1 && in);
    }
  }
  float acc[NV][4];
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nv][i] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the head's sum

  int tile = 0;  // stages consumed
  for (int r0 = rb + sub * BKV; r0 < re; r0 += stride_rows, ++tile) {
    __syncwarp();  // every lane is done with the stage refilled now
    issue((tile + MMA_STAGES - 1) % MMA_STAGES);
    cp_async_wait<MMA_STAGES - 1>();
    __syncwarp();  // every lane's copies of this stage are visible
    const T* ks = ring + (tile % MMA_STAGES) * SLOT;
    const T* vs = ks + BKV * STR;
    const int n = min(BKV, re - r0);

    // S = Q K^T: 16 heads x BKV rows, f32 sums of exact products
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* kp = ks + (nt * 8 + g) * STR + kc * 16 + 2 * t;
        mma_16816(s[nt], qa[kc], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // base-2 logits, the stage's rows past n masked, each head's maximum
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = nt * 8 + 2 * t + (i & 1) < n;
        s[nt][i] = live ? s[nt][i] * p.qscale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;  // nothing live yet
      alpha[r] = exp2f(m[r] - m_safe);                           // m == -inf gives 0
      m[r] = m_new;
      mx[r] = m_safe;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= 2 && !upper) {
          s[nt][i] = 0.f;  // no head in the second row
        } else {
          s[nt][i] = exp2f(s[nt][i] - mx[i >> 1]);  // a masked row gives exp2(-inf) = 0
          psum[i >> 1] += s[nt][i];
        }
      }
    }
    l[0] = l[0] * alpha[0] + psum[0];
    l[1] = l[1] * alpha[1] + psum[1];
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      acc[nv][0] *= alpha[0];
      acc[nv][1] *= alpha[0];
      acc[nv][2] *= alpha[1];
      acc[nv][3] *= alpha[1];
    }

    // O += P V with P = hi + lo: the S tiles 2kk and 2kk + 1 are the A
    // fragments of 16 rows; V's B fragments by ldmatrix.trans, two 8-column
    // tiles a load (lanes 0-15 address rows 0-15 of the first, 16-31 of the next)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const T* vrow = vs + (kk * 16 + (lane & 15)) * STR + (lane >> 4) * 8;
#pragma unroll
      for (int nv = 0; nv < NV; nv += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + nv * 8);
        mma_16816(acc[nv], ph, vb[0], vb[1]);
        mma_16816(acc[nv], pl, vb[0], vb[1]);
        mma_16816(acc[nv + 1], ph, vb[2], vb[3]);
        mma_16816(acc[nv + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // the heads' sums: the four lanes of a fragment row hold its shares
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // the head's warps combined by its first (each lane its own elements),
  // through shared memory
  if (wph > 1) {
    float* mine = mrg + (size_t)warp * MMA_MAX_G * MSTR;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = g + 8 * r;
      if (h >= G) continue;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
        *reinterpret_cast<float2*>(mine + h * MSTR + nv * 8 + 2 * t) =
            make_float2(acc[nv][2 * r], acc[nv][2 * r + 1]);
      if (t == 0) {
        mine[h * MSTR + DHP] = m[r];
        mine[h * MSTR + DHP + 1] = l[r];
      }
    }
    __syncthreads();
    if (sub == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = g + 8 * r;
        if (h >= G) continue;
        float mn = m[r];
        for (int o = 1; o < wph; ++o)
          mn = fmaxf(mn, mrg[((size_t)(warp + o) * MMA_MAX_G + h) * MSTR + DHP]);
        const float a0 = (m[r] == -INFINITY) ? 0.f : exp2f(m[r] - mn);
        l[r] *= a0;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          acc[nv][2 * r] *= a0;
          acc[nv][2 * r + 1] *= a0;
        }
        for (int o = 1; o < wph; ++o) {
          const float* other = mrg + ((size_t)(warp + o) * MMA_MAX_G + h) * MSTR;
          const float mo = other[DHP];
          const float ao = (mo == -INFINITY) ? 0.f : exp2f(mo - mn);
          l[r] = fmaf(ao, other[DHP + 1], l[r]);
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            const float2 x = *reinterpret_cast<const float2*>(other + nv * 8 + 2 * t);
            acc[nv][2 * r] = fmaf(ao, x.x, acc[nv][2 * r]);
            acc[nv][2 * r + 1] = fmaf(ao, x.y, acc[nv][2 * r + 1]);
          }
        }
        m[r] = mn;
      }
    }
    __syncthreads();  // the area is read before any warp writes it again
    if (sub != 0) return;
  }

  if (p.n_splits == 1) {
    // the block holds the whole sequence: the output itself (an empty cache gives zeros)
    T* ob = p.o + (long long)b * p.o_b + (long long)kvh * G * p.o_h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = g + 8 * r;
      if (h >= G) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const int c = nv * 8 + 2 * t;
        if (c < p.dh)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)h * p.o_h + c) =
              __floats2bfloat162_rn(acc[nv][2 * r] * inv, acc[nv][2 * r + 1] * inv);
      }
    }
    return;
  }

  // this split's partial, then count it done; the last merges
  const int pstride = p.dh + 2;
  float* part = p.part + (((long long)b * p.K + kvh) * p.n_splits + split) * G * pstride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = g + 8 * r;
    if (h >= G) continue;
    float* ph = part + h * pstride;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int c = nv * 8 + 2 * t;
      if (c < p.dh)
        *reinterpret_cast<float2*>(ph + c) = make_float2(acc[nv][2 * r], acc[nv][2 * r + 1]);
    }
    if (t == 0) {
      ph[p.dh] = m[r];
      ph[p.dh + 1] = l[r];
    }
  }
  int* counter = p.counter + (long long)b * p.K + kvh;
  __threadfence();  // this warp's partial is visible device-wide ...
  __syncwarp();     // ... for every lane of it
  int last = 0;
  if (lane == 0) last = (atomicAdd(counter, 1) == p.n_splits - 1);
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last) {
    __threadfence();  // the other splits' partials are visible to this warp
    merge_splits(p, b, kvh, mrg + (size_t)warp * MMA_MAX_G * MSTR);
    if (lane == 0) *counter = 0;  // ready for the next launch
  }
}

template <int DHP, int BKV>
cudaError_t launch_mma_one(const MmaParams& p, dim3 grid, cudaStream_t stream) {
  auto kern = decode_kernel_mma<DHP, BKV>;
  const size_t smem =
      (size_t)MMA_WARPS * MMA_STAGES * 2 * BKV * (DHP + 8) * sizeof(__nv_bfloat16) +
      (size_t)MMA_WARPS * MMA_MAX_G * (DHP + 2) * sizeof(float);
  // all of the SM's shared memory, so that as many blocks as fit are resident
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kern<<<grid, MMA_WARPS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// the (padded head width, block_kv) pairs whose rings fit a block's shared
// memory (decode_attention.py: mma_smem_bytes)
cudaError_t launch_mma(const MmaParams& p, int block_kv, dim3 grid, cudaStream_t stream) {
  const int dhp = p.dh <= 16 ? 16 : p.dh <= 32 ? 32 : p.dh <= 64 ? 64 : 128;
  switch (dhp * 1000 + block_kv) {
    case 16016: return launch_mma_one<16, 16>(p, grid, stream);
    case 16032: return launch_mma_one<16, 32>(p, grid, stream);
    case 16064: return launch_mma_one<16, 64>(p, grid, stream);
    case 32016: return launch_mma_one<32, 16>(p, grid, stream);
    case 32032: return launch_mma_one<32, 32>(p, grid, stream);
    case 32064: return launch_mma_one<32, 64>(p, grid, stream);
    case 64016: return launch_mma_one<64, 16>(p, grid, stream);
    case 64032: return launch_mma_one<64, 32>(p, grid, stream);
    case 128016: return launch_mma_one<128, 16>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
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

// bf16 query and cache on the tensor cores (decode_kernel_mma): dh a multiple
// of 16 up to 128, H/K up to 16, block_kv rows a ring stage (see launch_mma
// for the pairs compiled).  Grid (K / gcd(K, 4), B, n_splits).  n_splits > 1
// needs `part` (B*H*n_splits*(dh+2) floats) and `counter` (B*K ints, all
// zero; zero again when the kernel ends).  Strides in elements, the last
// dimension contiguous, rows of K and V 16-byte aligned.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_mma_fwd(const void* q, const void* k, const void* v,
                                        const void* lengths, void* o, void* part, void* counter,
                                        int B, int H, int K, int dh, int Smax, long long q_b,
                                        long long q_h, long long k_b, long long k_s, long long k_h,
                                        long long v_b, long long v_s, long long v_h,
                                        long long o_b, long long o_h, float scale, int block_kv,
                                        int n_splits, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;  // nothing to compute
  if (K < 1 || H % K != 0 || H / K > 16 || dh < 16 || dh > 128 || dh % 16 != 0 || Smax < 1 ||
      B > 65535 || n_splits < 1 || n_splits > 65535 ||
      (n_splits > 1 && (part == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  int hb = MMA_WARPS;  // kv heads a block: gcd(K, 4)
  while (K % hb != 0) hb /= 2;
  MmaParams p;
  p.q = reinterpret_cast<const __nv_bfloat16*>(q);
  p.k = reinterpret_cast<const __nv_bfloat16*>(k);
  p.v = reinterpret_cast<const __nv_bfloat16*>(v);
  p.lengths = reinterpret_cast<const int*>(lengths);
  p.o = reinterpret_cast<__nv_bfloat16*>(o);
  p.part = reinterpret_cast<float*>(part);
  p.counter = reinterpret_cast<int*>(counter);
  p.B = B; p.H = H; p.K = K; p.dh = dh; p.Smax = Smax;
  p.q_b = q_b; p.q_h = q_h;
  p.k_b = k_b; p.k_s = k_s; p.k_h = k_h;
  p.v_b = v_b; p.v_s = v_s; p.v_h = v_h;
  p.o_b = o_b; p.o_h = o_h;
  p.qscale = scale * 1.4426950408889634f;  // softmax in base 2
  p.n_splits = n_splits;
  p.warps_per_head = MMA_WARPS / hb;
  return (int)launch_mma(p, block_kv, dim3(K / hb, B, n_splits),
                         reinterpret_cast<cudaStream_t>(stream));
}
