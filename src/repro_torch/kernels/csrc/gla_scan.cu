// RWKV-6 wkv (gated linear attention) scan for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_gla_kernel` / `gla_scan` of the reference
// package (src/repro/kernels/gla_scan.py).  Same function: zero initial
// state, an fp32 state S (dk x dv) per (batch, head), output in the input's
// type, and the output of a step uses the state *before* its update:
//
//   y_t = r_t . S + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S   = diag(w_t) S + k_t (x) v_t
//
// What bounds it on this card.  Per (batch, head, step) it reads r, k, w
// (dk values each) and v, writes y (dv values each) and does about 4 dk dv
// operations on the state.  At RWKV-6 3B's width (B=2, S=2048, H=40,
// dk=dv=64) that is 210 MB (0.063 ms at 3.35 TB/s) and 2.7 GFLOP (0.04 ms
// at the fp32 rate), but each step depends on the one before: a thread
// walks 2048 dependent steps, so latency, not bytes, is the bound.
//
// What the design does about it:
//  * One block per (head, batch); each computing thread owns one column j
//    of S and keeps its dk values in registers for the whole sequence.  A
//    dv wider than a block can hold is split over blocks (grid.x).
//  * r_t, k_t, w_t and the block's columns of v_t for `chunk` steps (the
//    reference's knob, here the staging depth) are staged in shared memory
//    by all the block's threads, UNR elements a thread in flight at once,
//    so a chunk pays a few global-load latencies, not one a step.  The
//    block has at least STAGE_THREADS threads for that, whatever dv is.
//  * The step's bonus sum_i r u k is computed once per step for the block.
//  * The step loop is not unrolled and the loop over the state is, fully:
//    the state's index is then a constant everywhere and S stays in
//    registers; r, k and w are read as 16-byte broadcasts.
//  * dk is a template parameter (8, 16, 32, 64 or 128); rows of S past dk
//    have r = k = 0 (and w = 1) and stay exactly zero.
//
// The TPU kernel's grid carried S across sequence chunks in scratch
// memory; here the sequence loop is inside the thread.  With one block per
// (batch, head) there are only B*H blocks (80 at the width above, on 132
// SMs), and staging does not overlap the steps: both are left to a later
// version (split dk over several lanes per column, double-buffer a chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int UNR = 4;              // staged elements a thread has in flight, per array
constexpr int STAGE_THREADS = 256;  // threads a block has at least, for staging
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

// threads a block may have for a padded key dim of DKP: a computing thread
// keeps DKP state values in registers
template <int DKP> struct MaxThreads {
  static constexpr int value = DKP <= 32 ? 1024 : (DKP <= 64 ? 512 : 256);
};

struct GlaParams {
  const void* r;  // (B, S, H, dk)
  const void* k;  // (B, S, H, dk)
  const void* v;  // (B, S, H, dv)
  const void* w;  // (B, S, H, dk)
  const float* u; // (H, dk)
  void* y;        // (B, S, H, dv)
  int S, H, dk, dv, chunk, bv;  // bv: columns of S a block owns
};

// Stage rows [t0, t0 + tn) of a (step, col) slab into dst[tn][ncp] as fp32:
// columns past `ncols` get `fill`.  Each thread loads UNR elements before it
// stores any of them.
template <typename T>
__device__ __forceinline__ void stage(const T* src, long long step_stride, int t0, int tn,
                                      int ncols, int ncp, float fill, float* dst) {
  const int total = tn * ncp;
  for (int base = threadIdx.x; base < total; base += UNR * blockDim.x) {
    float vals[UNR];
#pragma unroll
    for (int q = 0; q < UNR; ++q) {
      const int idx = base + q * blockDim.x;
      const int tt = idx / ncp;
      const int c = idx - tt * ncp;
      vals[q] = (idx < total && c < ncols)
                    ? to_f32<T>(src[(long long)(t0 + tt) * step_stride + c]) : fill;
    }
#pragma unroll
    for (int q = 0; q < UNR; ++q) {
      const int idx = base + q * blockDim.x;
      if (idx < total) dst[idx] = vals[q];
    }
  }
}

template <typename T, int DKP>
__global__ void __launch_bounds__(MaxThreads<DKP>::value) gla_kernel(const GlaParams p) {
  extern __shared__ float4 smem4[];
  float* sR = reinterpret_cast<float*>(smem4);  // [chunk][DKP]
  float* sK = sR + (size_t)p.chunk * DKP;       // [chunk][DKP]
  float* sW = sK + (size_t)p.chunk * DKP;       // [chunk][DKP]
  float* sU = sW + (size_t)p.chunk * DKP;       // [DKP]
  float* sV = sU + DKP;                         // [chunk][bv]
  float* sBonus = sV + (size_t)p.chunk * p.bv;  // [chunk]

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * p.bv;
  const int ncols = min(p.bv, p.dv - col0);  // live columns of this block
  const bool computes = tid < ncols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long long srow = (long long)p.H * p.dk;  // one step of r, k, w
  const long long vrow = (long long)p.H * p.dv;  // one step of v, y
  const long long bh = (long long)b * p.S * p.H + h;
  const T* rb = reinterpret_cast<const T*>(p.r) + bh * p.dk;
  const T* kb = reinterpret_cast<const T*>(p.k) + bh * p.dk;
  const T* wb = reinterpret_cast<const T*>(p.w) + bh * p.dk;
  const T* vb = reinterpret_cast<const T*>(p.v) + bh * p.dv + col0;
  T* ycol = reinterpret_cast<T*>(p.y) + bh * p.dv + col0 + (computes ? tid : 0);

  for (int i = tid; i < DKP; i += blockDim.x)
    sU[i] = i < p.dk ? p.u[(long long)h * p.dk + i] : 0.f;

  float st[DKP];
#pragma unroll
  for (int i = 0; i < DKP; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += p.chunk) {
    const int tn = min(p.chunk, p.S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    stage<T>(rb, srow, t0, tn, p.dk, DKP, 0.f, sR);
    stage<T>(kb, srow, t0, tn, p.dk, DKP, 0.f, sK);
    stage<T>(wb, srow, t0, tn, p.dk, DKP, 1.f, sW);
    stage<T>(vb, vrow, t0, tn, ncols, p.bv, 0.f, sV);
    __syncthreads();
    for (int tt = tid; tt < tn; tt += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DKP; ++i) s = fmaf(sR[tt * DKP + i] * sU[i], sK[tt * DKP + i], s);
      sBonus[tt] = s;
    }
    __syncthreads();

    if (computes) {
#pragma unroll 1
      for (int tt = 0; tt < tn; ++tt) {
        const float4* rt = reinterpret_cast<const float4*>(sR + tt * DKP);
        const float4* kt = reinterpret_cast<const float4*>(sK + tt * DKP);
        const float4* wt = reinterpret_cast<const float4*>(sW + tt * DKP);
        const float vv = sV[tt * p.bv + tid];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i4 = 0; i4 < DKP / 4; ++i4) {
          const float4 r4 = rt[i4], k4 = kt[i4], w4 = wt[i4];
          const int i = 4 * i4;
          // the output reads the state before the update
          acc[0] = fmaf(r4.x, st[i + 0], acc[0]);
          acc[1] = fmaf(r4.y, st[i + 1], acc[1]);
          acc[2] = fmaf(r4.z, st[i + 2], acc[2]);
          acc[3] = fmaf(r4.w, st[i + 3], acc[3]);
          st[i + 0] = fmaf(w4.x, st[i + 0], k4.x * vv);
          st[i + 1] = fmaf(w4.y, st[i + 1], k4.y * vv);
          st[i + 2] = fmaf(w4.z, st[i + 2], k4.z * vv);
          st[i + 3] = fmaf(w4.w, st[i + 3], k4.w * vv);
        }
        ycol[(long long)(t0 + tt) * vrow] =
            from_f32<T>(fmaf(sBonus[tt], vv, (acc[0] + acc[1]) + (acc[2] + acc[3])));
      }
    }
  }
}

// columns of S a block owns, and the block's threads
template <int DKP> void block_shape(int dv, int* bv, int* threads) {
  const int maxt = MaxThreads<DKP>::value;
  *bv = dv < maxt ? dv : maxt;
  int t = *bv > STAGE_THREADS ? *bv : STAGE_THREADS;
  t = (t + 31) / 32 * 32;
  *threads = t < maxt ? t : maxt;
}

template <typename T, int DKP>
cudaError_t launch(GlaParams p, int B, cudaStream_t stream) {
  int threads;
  block_shape<DKP>(p.dv, &p.bv, &threads);
  auto kern = gla_kernel<T, DKP>;
  const size_t smem = ((size_t)p.chunk * (3 * DKP + p.bv + 1) + DKP) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.dv + p.bv - 1) / p.bv, p.H, B);
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dk(const GlaParams& p, int B, cudaStream_t stream) {
  if (p.dk <= 8) return launch<T, 8>(p, B, stream);
  if (p.dk <= 16) return launch<T, 16>(p, B, stream);
  if (p.dk <= 32) return launch<T, 32>(p, B, stream);
  if (p.dk <= 64) return launch<T, 64>(p, B, stream);
  if (p.dk <= 128) return launch<T, 128>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y); u is float32.  Every
// tensor is contiguous.  chunk: steps of r/k/w/v staged in shared memory at
// a time.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int gla_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, int dtype, int B, int S, int H, int dk,
                            int dv, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dv <= 0) return (int)cudaSuccess;  // nothing to compute
  if (dk < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  GlaParams p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = reinterpret_cast<const float*>(u); p.y = y;
  p.S = S; p.H = H; p.dk = dk; p.dv = dv; p.chunk = chunk; p.bv = 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = launch_dk<float>(p, B, st);
  else if (dtype == 1) e = launch_dk<__nv_bfloat16>(p, B, st);
  return (int)e;
}
