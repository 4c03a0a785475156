// Mamba-1 selective scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_ssm_kernel` / `ssm_scan` of the reference
// package (src/repro/kernels/ssm_scan.py).  Same function: zero initial
// state, state and arithmetic in fp32, output in the input's type:
//
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) (x) B_t
//   y_t = h_t . C_t + D_skip * x_t
//
// What bounds it on this card.  Per (batch, channel, step) it reads x and
// dt, writes y, and does N exponentials and 3N multiply-adds on an fp32
// state of N values; B_t and C_t are shared by every channel.  At Jamba's
// mixer width (B=2, S=2048, D=8192, N=16) that is 404 MB to move in f32
// (0.121 ms at 3.35 TB/s) and 537 M exponentials.  An exponential is a
// special-function (MUFU) instruction, and an SM retires 16 of those a
// clock against 128 fp32 multiply-adds: 537 M / (16 x 132 SMs x 1.98 GHz)
// = 0.128 ms.  The exponentials bound it, in f32 and more so in bf16.
//
// What the design does about it:
//  * Each exponential once, on the SFU.  A's row is scaled by log2(e) once,
//    when it is loaded; exp(dt A) is then one multiply and one
//    `ex2.approx.ftz` (MUFU.EX2, ~2 ulp), computed exactly once per
//    (batch, step, channel, state) of the padded state, never recomputed.
//  * Lanes split the state.  A channel belongs to L neighbouring lanes of a
//    warp (8 states a lane: L = 2 at N = 16; a padded state of 4 is one
//    lane); lane l keeps states
//    n = 4 (L m + l) + q and their A values in registers, so the L lanes
//    read neighbouring 16-byte words of B_t and C_t (no bank conflict) and
//    the channels of a warp read the same words (broadcast).  y is the sum
//    of the lanes' partials by log2 L `__shfl_xor_sync` rounds.
//  * The `block_d` channels of the reference's block (a group) are split
//    over G blocks; the wrapper picks G from the shapes and the SM count so
//    that one call puts a block on every SM (`ssm_scan.split`).  One thread
//    a channel held B*D = 16,384 threads at this width, on 64 SMs; 2 lanes a
//    channel and G = 4 hold 32,768 threads in 256 blocks.  Every block
//    reads its own channels of x and dt, once.
//  * Staging overlaps the steps.  B_t and C_t of `chunk` steps (the
//    reference's knob, here the staging depth) go to shared memory as
//    16-byte `cp.async` copies in the input's type, issued for chunk c+1
//    before chunk c's steps (double-buffered in f32; one bf16 buffer
//    widened once per chunk into fp32 in bf16).  Rows that are not 16-byte
//    aligned are staged by plain loads.  x and dt are read coalesced along
//    the channel axis straight from global memory, one group of U = 8
//    steps ahead, and kept as stored until they are used (a bf16 value
//    widened where it is loaded makes the thread wait for the load there).
//  * Steps run in groups of U with no guard and no store between them, so
//    that a step's work overlaps the steps before it; a group's outputs are
//    stored after it.
//  * N is a template parameter (4, 8, 16, 32 or 64); a state padded past N
//    has A = B = C = 0 and stays exactly zero.  The ragged ends of S and D
//    are masked; nothing is padded by a copy.
//
// The TPU kernel's grid carried the state across sequence chunks in
// scratch memory; here the sequence loop is inside the thread, and the
// blocks run in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int U = 8;  // steps a thread computes as one group, their outputs stored after
constexpr int MAX_THREADS = 512;  // threads a block may have
constexpr size_t MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct SsmParams {
  const void* x;       // (B, S, D)
  const void* dt;      // (B, S, D)
  const float* A;      // (D, N)
  const void* Bm;      // (B, S, N)
  const void* Cm;      // (B, S, N)
  const float* Dskip;  // (D,)
  void* y;             // (B, S, D)
  int S, D, N, chunk;
  int block_d, groups, cpc;  // channels of a group, blocks a group, channels a block
  int vec;                   // rows of B, C are 16-byte aligned: stage by cp.async
};

// Stage B and C of steps [t0, t0 + tn) into dst[tn][2][NP] (input type),
// zero past N.
template <typename T, int NP>
__device__ __forceinline__ void stage(const SsmParams& p, const T* Bb, const T* Cb, int t0,
                                      int tn, T* dst) {
  constexpr int ROW = 2 * NP;
  if (p.vec) {
    constexpr int EPC = 16 / (int)sizeof(T);
    constexpr int CPR = NP / EPC > 0 ? NP / EPC : 1;  // copies an array row
    const int total = tn * 2 * CPR;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / (2 * CPR);
      const int rem = i - row * 2 * CPR;
      const int arr = rem / CPR;
      const int e0 = (rem - arr * CPR) * EPC;
      const T* src = (arr == 0 ? Bb : Cb) + (long long)(t0 + row) * p.N;
      const int valid = min(max(p.N - e0, 0), EPC);
      cp_async16(dst + row * ROW + arr * NP + e0, valid ? src + e0 : src, valid * (int)sizeof(T));
    }
  } else {
    const int total = tn * ROW;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / ROW;
      const int rem = i - row * ROW;
      const int arr = rem / NP;
      const int e = rem - arr * NP;
      const T* src = (arr == 0 ? Bb : Cb) + (long long)(t0 + row) * p.N;
      dst[i] = e < p.N ? src[e] : from_f32<T>(0.f);
    }
  }
}

// bf16 -> fp32 of the first n elements (n a multiple of 8), 16 bytes a read
__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst, int n) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x) {
    const uint4 x = s[i];
    d[2 * i] = make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                           __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
    d[2 * i + 1] = make_float4(__uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
                               __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
  }
}

// one state: exp(dt A) on the SFU, the update, the output's share
__device__ __forceinline__ void elem(float dtv, float a2, float dtx, float bb, float cc,
                                     float& h, float& acc) {
  h = fmaf(ex2(dtv * a2), h, dtx * bb);
  acc = fmaf(h, cc, acc);
}

template <typename T, int NP, int L>
__global__ void __launch_bounds__(MAX_THREADS) ssm_kernel(const SsmParams p) {
  constexpr int NS = NP / L;  // states a lane keeps
  constexpr int NQ = NS / 4;
  constexpr int ROW = 2 * NP;
  constexpr bool WIDEN = sizeof(T) == 2;
  static_assert(NS % 4 == 0, "a lane keeps whole 16-byte words of a row");
  extern __shared__ float4 smem4[];
  // f32: two buffers [2][chunk][ROW]; bf16: the widened copy [chunk][ROW],
  // then the staged bf16 [chunk][ROW]
  float* fbuf = reinterpret_cast<float*>(smem4);
  T* raw = reinterpret_cast<T*>(fbuf + (size_t)p.chunk * ROW);

  const int lane = threadIdx.x % L;
  const int c = threadIdx.x / L;  // this thread's channel in the block
  const int grp = blockIdx.x / p.groups;
  const int in_grp = (blockIdx.x - grp * p.groups) * p.cpc + c;  // ... in the group
  const int d = grp * p.block_d + in_grp;
  const bool live = c < p.cpc && in_grp < p.block_d && d < p.D;
  const int dd = live ? d : 0;
  const int b = blockIdx.y;

  float a2[NS], h[NS];
#pragma unroll
  for (int m = 0; m < NQ; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = 4 * (L * m + lane) + q;
      a2[4 * m + q] = (live && n < p.N) ? p.A[(long long)dd * p.N + n] * LOG2E : 0.f;
      h[4 * m + q] = 0.f;
    }
  const float dskip = (live && lane == 0) ? p.Dskip[dd] : 0.f;  // added once, by lane 0

  const long long bsd = (long long)b * p.S * p.D;
  const T* xcol = reinterpret_cast<const T*>(p.x) + bsd + dd;
  const T* dtcol = reinterpret_cast<const T*>(p.dt) + bsd + dd;
  T* ycol = reinterpret_cast<T*>(p.y) + bsd + dd;
  const T* Bb = reinterpret_cast<const T*>(p.Bm) + (long long)b * p.S * p.N;
  const T* Cb = reinterpret_cast<const T*>(p.Cm) + (long long)b * p.S * p.N;

  // U steps of the channel's x and dt from step t, as stored (widened when
  // used: a bf16 value widened here would make the thread wait for its
  // load here); steps past the end re-read the last one
  T xn[U], dn[U];
  auto load = [&](int t) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = (long long)min(t + u, p.S - 1) * p.D;
      xn[u] = xcol[off];
      dn[u] = dtcol[off];
    }
  };

  const int nch = (p.S + p.chunk - 1) / p.chunk;
  stage<T, NP>(p, Bb, Cb, 0, min(p.chunk, p.S), WIDEN ? raw : (T*)fbuf);
  cp_async_commit();
  load(0);

  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * p.chunk;
    const int tn = min(p.chunk, p.S - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk ch is staged, and every thread is done with ch - 1
    const float* cur;
    if constexpr (WIDEN) {
      widen(reinterpret_cast<const __nv_bfloat16*>(raw), fbuf, tn * ROW);
      __syncthreads();  // widened; the staging buffer is free
      cur = fbuf;
    } else {
      cur = fbuf + (size_t)(ch & 1) * p.chunk * ROW;
    }
    if (ch + 1 < nch) {  // chunk ch + 1 is copied while chunk ch is computed
      T* dst = WIDEN ? raw : (T*)(fbuf + (size_t)((ch + 1) & 1) * p.chunk * ROW);
      stage<T, NP>(p, Bb, Cb, t0 + p.chunk, min(p.chunk, p.S - t0 - p.chunk), dst);
    }
    cp_async_commit();

    for (int g = 0; g < tn; g += U) {
      const int cnt = min(U, tn - g);
      float xc[U], dc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xc[u] = to_f32<T>(xn[u]);
        dc[u] = to_f32<T>(dn[u]);
      }
      // the next group's loads go out before this group's steps
      load(g + U < tn ? t0 + g + U : t0 + p.chunk);
      float yv[U];
      auto step = [&](int u) {
        const float4* b4 = reinterpret_cast<const float4*>(cur + (g + u) * ROW) + lane;
        const float4* c4 = b4 + NP / 4;
        const float dtv = dc[u];
        const float dtx = dtv * xc[u];
        float a0 = dskip * xc[u], a1 = 0.f;
#pragma unroll
        for (int m = 0; m < NQ; ++m) {
          const float4 bb = b4[m * L], cc = c4[m * L];
          elem(dtv, a2[4 * m + 0], dtx, bb.x, cc.x, h[4 * m + 0], a0);
          elem(dtv, a2[4 * m + 1], dtx, bb.y, cc.y, h[4 * m + 1], a1);
          elem(dtv, a2[4 * m + 2], dtx, bb.z, cc.z, h[4 * m + 2], a0);
          elem(dtv, a2[4 * m + 3], dtx, bb.w, cc.w, h[4 * m + 3], a1);
        }
        float acc = a0 + a1;
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        yv[u] = acc;
      };
      // no guard and no store between the steps of a full group, so that a
      // step's work overlaps the steps before it; the outputs go out after
      if (cnt == U) {
#pragma unroll
        for (int u = 0; u < U; ++u) step(u);
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (u < cnt) step(u);
      }
      if (lane == 0 && live) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (u < cnt) ycol[(long long)(t0 + g + u) * p.D] = from_f32<T>(yv[u]);
      }
    }
  }
}

template <typename T, int NP>
size_t smem_bytes(int chunk) {
  // f32: two buffers; bf16: the fp32 copy and one bf16 buffer
  return (size_t)chunk * 2 * NP * (sizeof(T) == 2 ? 4 + 2 : 2 * 4);
}

// 8 states a lane (L = NP / 8 lanes a channel); a padded state of 4 is one
// lane of 4
template <typename T, int NP>
cudaError_t launch(const SsmParams& p, int B, cudaStream_t stream) {
  constexpr int L = NP >= 8 ? NP / 8 : 1;
  const int threads = (p.cpc * L + 31) / 32 * 32;
  const long long ngroups = (p.D + p.block_d - 1) / p.block_d;
  if (p.cpc < 1 || threads > MAX_THREADS || B > 65535 || ngroups * p.groups > 2147483647LL)
    return cudaErrorInvalidValue;
  auto kern = ssm_kernel<T, NP, L>;
  const size_t smem = smem_bytes<T, NP>(p.chunk);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // all of the SM's shared memory, so that as many blocks as fit are resident
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(ngroups * p.groups), B);
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const SsmParams& p, int B, cudaStream_t stream) {
  if (p.N <= 4) return launch<T, 4>(p, B, stream);
  if (p.N <= 8) return launch<T, 8>(p, B, stream);
  if (p.N <= 16) return launch<T, 16>(p, B, stream);
  if (p.N <= 32) return launch<T, 32>(p, B, stream);
  if (p.N <= 64) return launch<T, 64>(p, B, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y); A and D_skip are
// float32.  Every tensor is contiguous.  chunk: steps of B/C staged in
// shared memory at a time; block_d: channels of a group; groups: blocks a
// group is split over, cpc = ceil(block_d / groups) channels each.  A
// channel's state is split over N padded / 8 lanes (one lane at N <= 4).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dskip, void* y, int dtype, int B, int S,
                            int D, int N, int chunk, int block_d, int groups, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;  // nothing to compute
  if (N < 1 || chunk < 1 || block_d < 1 || groups < 1) return (int)cudaErrorInvalidValue;
  SsmParams p;
  p.x = x; p.dt = dt; p.A = reinterpret_cast<const float*>(A);
  p.Bm = Bm; p.Cm = Cm; p.Dskip = reinterpret_cast<const float*>(Dskip); p.y = y;
  p.S = S; p.D = D; p.N = N; p.chunk = chunk;
  p.block_d = block_d; p.groups = groups; p.cpc = (block_d + groups - 1) / groups;
  const int esz = dtype == 1 ? 2 : 4;
  p.vec = aligned16(Bm) && aligned16(Cm) && (N * esz) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = launch_n<float>(p, B, st);
  else if (dtype == 1) e = launch_n<__nv_bfloat16>(p, B, st);
  return (int)e;
}
