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
// mixer width (B=2, S=2048, D=8192, N=16) that is 404 MB to move (0.12 ms
// at 3.35 TB/s) and 537 M exponentials on the special-function units
// (about 0.13 ms).  But every step depends on the one before, so a thread
// walks 2048 dependent steps: the kernel is bound by the latency of that
// chain unless each step's operands are already in flight when it starts.
//
// What the design does about it:
//  * One thread per channel keeps its state h[N] and its row A[d, :] in
//    registers for the whole sequence: the state never leaves the SM.
//  * B_t and C_t of `chunk` steps are staged in shared memory by the whole
//    block in one coalesced pass (`chunk` is the reference's knob, here the
//    staging depth), and every thread reads them as broadcasts.
//  * x and dt are read coalesced (neighbouring threads, neighbouring
//    channels) in groups of U steps, and the next group's loads are issued
//    before the current group is computed (software pipelining), so a
//    global-load latency is paid once per chunk, not once per step.
//  * N is a template parameter (4, 8, 16, 32 or 64); a state padded past N
//    has A = B = C = 0 and stays exactly zero.  The ragged ends of S and D
//    are masked; nothing is padded by a copy.
//
// The TPU kernel's grid carried the state across sequence chunks in
// scratch memory; here the sequence loop is inside the thread, and the
// grid (D / block_d, B) runs in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int U = 8;  // steps per group of x/dt loads in flight
constexpr size_t MAX_SMEM = 232448;

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

// threads a block may have for a padded state of NP values: the state and
// A's row take 2*NP registers a thread
template <int NP> struct MaxThreads {
  static constexpr int value = NP <= 8 ? 1024 : (NP <= 16 ? 512 : 256);
};

struct SsmParams {
  const void* x;       // (B, S, D)
  const void* dt;      // (B, S, D)
  const float* A;      // (D, N)
  const void* Bm;      // (B, S, N)
  const void* Cm;      // (B, S, N)
  const float* Dskip;  // (D,)
  void* y;             // (B, S, D)
  int S, D, N, chunk;
};

template <typename T>
__device__ __forceinline__ void load_group(const T* base, int D, int t, int cnt, bool live,
                                           float* out) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    out[u] = (live && u < cnt) ? to_f32<T>(base[(long long)(t + u) * D]) : 0.f;
}

template <typename T, int NP>
__global__ void __launch_bounds__(MaxThreads<NP>::value) ssm_kernel(const SsmParams p) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);  // [chunk][NP]
  float* sC = sB + (size_t)p.chunk * NP;        // [chunk][NP]

  const int b = blockIdx.y;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = d < p.D;
  const int dd = live ? d : 0;

  float a[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    a[n] = (live && n < p.N) ? p.A[(long long)dd * p.N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dskip = live ? p.Dskip[dd] : 0.f;

  const long long bsd = (long long)b * p.S * p.D;
  const T* xcol = reinterpret_cast<const T*>(p.x) + bsd + dd;
  const T* dtcol = reinterpret_cast<const T*>(p.dt) + bsd + dd;
  T* ycol = reinterpret_cast<T*>(p.y) + bsd + dd;
  const T* Bb = reinterpret_cast<const T*>(p.Bm) + (long long)b * p.S * p.N;
  const T* Cb = reinterpret_cast<const T*>(p.Cm) + (long long)b * p.S * p.N;

  float xc[U], dc[U], xn[U], dn[U];
  for (int t0 = 0; t0 < p.S; t0 += p.chunk) {
    const int tn = min(p.chunk, p.S - t0);
    // the chunk's first group of x/dt is in flight while B/C are staged
    load_group<T>(xcol, p.D, t0, min(U, tn), live, xn);
    load_group<T>(dtcol, p.D, t0, min(U, tn), live, dn);
    __syncthreads();  // every thread is done with the previous chunk's B/C
    for (int i = threadIdx.x; i < tn * NP; i += blockDim.x) {
      const int tt = i / NP;
      const int n = i - tt * NP;
      float bv = 0.f, cv = 0.f;
      if (n < p.N) {
        const long long off = (long long)(t0 + tt) * p.N + n;
        bv = to_f32<T>(Bb[off]);
        cv = to_f32<T>(Cb[off]);
      }
      sB[i] = bv;
      sC[i] = cv;
    }
    __syncthreads();

    for (int g = 0; g < tn; g += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xc[u] = xn[u];
        dc[u] = dn[u];
      }
      if (g + U < tn) {  // the next group's loads go out before this group's work
        load_group<T>(xcol, p.D, t0 + g + U, min(U, tn - g - U), live, xn);
        load_group<T>(dtcol, p.D, t0 + g + U, min(U, tn - g - U), live, dn);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g + u < tn) {
          const float* bt = sB + (g + u) * NP;
          const float* ct = sC + (g + u) * NP;
          const float dtx = dc[u] * xc[u];
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            const float dA = expf(dc[u] * a[n]);
            h[n] = fmaf(dA, h[n], dtx * bt[n]);
            acc[n & 3] = fmaf(h[n], ct[n], acc[n & 3]);
          }
          if (live)
            ycol[(long long)(t0 + g + u) * p.D] =
                from_f32<T>(fmaf(dskip, xc[u], (acc[0] + acc[1]) + (acc[2] + acc[3])));
        }
      }
    }
  }
}

template <typename T, int NP>
cudaError_t launch(const SsmParams& p, int B, int block_d, cudaStream_t stream) {
  if (block_d < 1 || block_d > MaxThreads<NP>::value) return cudaErrorInvalidValue;
  auto kern = ssm_kernel<T, NP>;
  const size_t smem = 2 * (size_t)p.chunk * NP * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.D + block_d - 1) / block_d, B);
  kern<<<grid, block_d, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const SsmParams& p, int B, int block_d, cudaStream_t stream) {
  if (p.N <= 4) return launch<T, 4>(p, B, block_d, stream);
  if (p.N <= 8) return launch<T, 8>(p, B, block_d, stream);
  if (p.N <= 16) return launch<T, 16>(p, B, block_d, stream);
  if (p.N <= 32) return launch<T, 32>(p, B, block_d, stream);
  if (p.N <= 64) return launch<T, 64>(p, B, block_d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y); A and D_skip are
// float32.  Every tensor is contiguous.  chunk: steps of B/C staged in
// shared memory at a time; block_d: channels (threads) per block.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dskip, void* y, int dtype, int B, int S,
                            int D, int N, int chunk, int block_d, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;  // nothing to compute
  if (N < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  SsmParams p;
  p.x = x; p.dt = dt; p.A = reinterpret_cast<const float*>(A);
  p.Bm = Bm; p.Cm = Cm; p.Dskip = reinterpret_cast<const float*>(Dskip); p.y = y;
  p.S = S; p.D = D; p.N = N; p.chunk = chunk;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = launch_n<float>(p, B, block_d, st);
  else if (dtype == 1) e = launch_n<__nv_bfloat16>(p, B, block_d, st);
  return (int)e;
}
