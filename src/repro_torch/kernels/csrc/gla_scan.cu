// RWKV-6 wkv (gated linear attention) scan for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_gla_kernel` / `gla_scan` of the reference
// package (src/repro/kernels/gla_scan.py).  Same function: zero initial
// state, an fp32 state S (dk x dv) per (batch, head), output in the input's
// type, and the output of a step uses the state *before* its update:
//
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S      = diag(w_t) S + k_t (x) v_t
//
// What bounds it on this card.  Per (batch, head, step) it reads r, k, w
// (dk values each) and v, writes y (dv values each) and does 4 dk dv fp32
// operations on the state (the bonus folded in: t = k v, q = u t + S,
// y += r q, S = w S + t).  At RWKV-6 3B's width (B=2, S=2048, H=40,
// dk=dv=64) that is 210 MB in f32 (0.063 ms at 3.35 TB/s) and 2.7 G
// operations (0.041 ms at the 67 TFLOP/s fp32 rate), so bytes bound it in
// f32 and operations in bf16.  Each step depends on the one before only
// through one multiply-add per state value, so the work spreads over as
// many threads as there are state values; what limits a thread that keeps
// a few of them is how fast it gets r, k and w: every column needs all of
// them each step, and shared memory delivers 128 bytes a clock an SM.
//
// What the design does about it:
//  * A thread keeps a tile of the state: NS rows by CT = 4 columns.  Its
//    rows i = 4 (L m + l) + q (m < NS / 4, q < 4) are read once a step as
//    16-byte words and used for all CT columns, 4x less shared-memory
//    traffic than a thread a column; the L lanes of a column group read
//    neighbouring words (no bank conflict).
//  * Lanes split the key dim.  A column group belongs to L neighbouring
//    lanes of a warp (NS = 8 rows a lane, 4 when a block would be one warp
//    or alone on its SM); each lane's partial over its rows carries its share of the
//    bonus; a reduce-scatter over the L lanes (log2 L shuffle rounds, the
//    first ones halving the columns a lane holds) leaves each column's y
//    with one lane.  No bonus pass, no barrier inside a chunk.
//  * Columns split over blocks.  A block owns `cols` columns of one
//    (batch, head); the wrapper picks `cols` and L from the shapes, the SM
//    count and the staging depth (`gla_scan.split`): the fewest waves of
//    blocks, then a block on every SM, then the fewest blocks.  Blocks of
//    one head stage the same r, k, w; L2 serves the re-reads.
//  * Staging overlaps the steps.  r, k, w and the block's columns of v of
//    `chunk` steps (the reference's knob, here the staging depth) go to
//    shared memory as 16-byte `cp.async` copies in the input's type,
//    issued for chunk c+1 before chunk c's steps: one barrier per chunk in
//    f32.  bf16 is staged as bf16 and widened once per chunk by the whole
//    block into an fp32 copy (a second barrier), not at every read, which
//    would add an integer operation per value read.  Rows that are not
//    16-byte aligned are staged by plain loads (same layout).
//  * Steps run in groups of U = 8 with no guard and no store between them,
//    so that a step's loads overlap the steps before it; a group's outputs
//    are stored after it.
//  * dk is a template parameter (8, 16, 32, 64 or 128) and so is L; rows
//    of S past dk have r = k = w = 0 and stay exactly zero.
//
// The TPU kernel's grid carried S across sequence chunks in scratch
// memory; here the sequence loop is inside the thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int U = 8;  // steps a thread computes as one group, their outputs stored after
constexpr int CT = 4;  // columns of S a thread keeps
constexpr int MAX_THREADS = 512;  // threads a block may have
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct GlaParams {
  const void* r;  // (B, S, H, dk)
  const void* k;  // (B, S, H, dk)
  const void* v;  // (B, S, H, dv)
  const void* w;  // (B, S, H, dk)
  const float* u; // (H, dk)
  void* y;        // (B, S, H, dv)
  int S, H, dk, dv, chunk, cols;  // cols: columns of S a block owns (a multiple of 8)
  int vec_rkw;    // rows of r, k, w are 16-byte aligned: stage them by cp.async
  int vec_v;      // so are the block's columns of v
};

// Stage steps [t0, t0 + tn) into dst[tn][ROW] (input type): r, k, w (DKP
// each, zero past dk), then the block's `cols` columns of v (zero past dv).
template <typename T, int DKP>
__device__ __forceinline__ void stage(const GlaParams& p, const T* rb, const T* kb, const T* wb,
                                      const T* vb, long long srow, long long vrow, int ncols,
                                      int t0, int tn, T* dst) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements a 16-byte copy
  const int ROW = 3 * DKP + p.cols;
  if (p.vec_rkw) {
    constexpr int CPR = DKP / EPC;  // copies an array row
    const int total = tn * 3 * CPR;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / (3 * CPR);
      const int rem = i - row * 3 * CPR;
      const int arr = rem / CPR;
      const int e0 = (rem - arr * CPR) * EPC;
      const T* src = (arr == 0 ? rb : arr == 1 ? kb : wb) + (long long)(t0 + row) * srow;
      const int valid = min(max(p.dk - e0, 0), EPC);
      cp_async16(dst + row * ROW + arr * DKP + e0, valid ? src + e0 : src,
                 valid * (int)sizeof(T));
    }
  } else {
    const int total = tn * 3 * DKP;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / (3 * DKP);
      const int rem = i - row * 3 * DKP;
      const int arr = rem / DKP;
      const int e = rem - arr * DKP;
      const T* src = (arr == 0 ? rb : arr == 1 ? kb : wb) + (long long)(t0 + row) * srow;
      dst[row * ROW + rem] = e < p.dk ? src[e] : from_f32<T>(0.f);
    }
  }
  if (p.vec_v) {
    const int cpr = p.cols / EPC;
    const int total = tn * cpr;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / cpr;
      const int e0 = (i - row * cpr) * EPC;
      const T* src = vb + (long long)(t0 + row) * vrow;
      const int valid = min(max(ncols - e0, 0), EPC);
      cp_async16(dst + row * ROW + 3 * DKP + e0, valid ? src + e0 : src,
                 valid * (int)sizeof(T));
    }
  } else {
    const int total = tn * p.cols;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int row = i / p.cols;
      const int e = i - row * p.cols;
      dst[row * ROW + 3 * DKP + e] =
          e < ncols ? vb[(long long)(t0 + row) * vrow + e] : from_f32<T>(0.f);
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

// Sum the CT partials a[] over the L lanes of a group (the lanes lane ^ off,
// off < L) as a reduce-scatter: while a lane holds more than one value, a
// round halves them (it keeps one half and adds its partner's share of it),
// then plain butterfly rounds.  The lane ends with the full sums of columns
// first .. first + max(1, CT / L) in a[0 ..]; returns first.
template <int L, int CT>
__device__ __forceinline__ int reduce_lanes(float (&a)[CT], int lane) {
  int first = 0;
  int n = CT;
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    if (n > 1) {
      const bool hi = (lane & off) != 0;
      const int half = n / 2;
#pragma unroll
      for (int j = 0; j < CT / 2; ++j) {
        if (j < half) {
          const float send = hi ? a[j] : a[j + half];
          const float keep = hi ? a[j + half] : a[j];
          a[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      first += hi ? half : 0;
      n = half;
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], off);
    }
  }
  return first;
}

// one state value: the output reads S before the update
__device__ __forceinline__ void elem(float r, float k, float w, float u, float v, float& s,
                                     float& acc) {
  const float t = k * v;
  acc = fmaf(r, fmaf(u, t, s), acc);
  s = fmaf(w, s, t);
}

template <typename T, int DKP, int L>
__global__ void __launch_bounds__(MAX_THREADS) gla_kernel(const GlaParams p) {
  constexpr int NS = DKP / L;               // rows of S a lane keeps
  constexpr int NQ = NS / 4;
  constexpr int NY = CT >= L ? CT / L : 1;  // columns a lane holds after the reduction
  constexpr int DUP = L > CT ? L / CT : 1;  // lanes that hold the same columns
  constexpr bool WIDEN = sizeof(T) == 2;
  static_assert(NS % 4 == 0, "a lane keeps whole 16-byte words of a row");
  extern __shared__ float4 smem4[];
  const int ROW = 3 * DKP + p.cols;  // r, k, w, then the block's columns of v
  // f32: two buffers [2][chunk][ROW]; bf16: the widened copy [chunk][ROW],
  // then the staged bf16 [chunk][ROW]
  float* fbuf = reinterpret_cast<float*>(smem4);
  T* raw = reinterpret_cast<T*>(fbuf + (size_t)p.chunk * ROW);

  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int cg = tid / L;  // this thread's columns: cg * CT .. + CT of the block's
  // where its v sits in a staged row (threads past the block's columns, there
  // to round the block up to whole warps, read the last group and store nothing)
  const int vofs = 3 * DKP + min(cg * CT, p.cols - CT);
  const int col0 = blockIdx.x * p.cols;
  const int ncols = min(p.cols, p.dv - col0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long long srow = (long long)p.H * p.dk;  // one step of r, k, w
  const long long vrow = (long long)p.H * p.dv;  // one step of v, y
  const long long bh = (long long)b * p.S * p.H + h;
  const T* rb = reinterpret_cast<const T*>(p.r) + bh * p.dk;
  const T* kb = reinterpret_cast<const T*>(p.k) + bh * p.dk;
  const T* wb = reinterpret_cast<const T*>(p.w) + bh * p.dk;
  const T* vb = reinterpret_cast<const T*>(p.v) + bh * p.dv + col0;
  T* yb = reinterpret_cast<T*>(p.y) + bh * p.dv + col0;

  float st[NS][CT], uu[NS];
#pragma unroll
  for (int m = 0; m < NQ; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * (L * m + lane) + q;
      uu[4 * m + q] = i < p.dk ? p.u[(long long)h * p.dk + i] : 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) st[4 * m + q][j] = 0.f;
    }

  const int nch = (p.S + p.chunk - 1) / p.chunk;
  stage<T, DKP>(p, rb, kb, wb, vb, srow, vrow, ncols, 0, min(p.chunk, p.S),
                WIDEN ? raw : (T*)fbuf);
  cp_async_commit();

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
      stage<T, DKP>(p, rb, kb, wb, vb, srow, vrow, ncols, t0 + p.chunk,
                    min(p.chunk, p.S - t0 - p.chunk), dst);
    }
    cp_async_commit();

    for (int g = 0; g < tn; g += U) {
      const int cnt = min(U, tn - g);
      float yv[U][NY];
      int first = 0;
      auto step = [&](int u) {
        const float* row = cur + (g + u) * ROW;
        const float4* r4 = reinterpret_cast<const float4*>(row) + lane;
        const float4* k4 = r4 + DKP / 4;
        const float4* w4 = r4 + DKP / 2;
        float vv[CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) vv[j] = row[vofs + j];
        float acc[CT];
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[j] = 0.f;
#pragma unroll
        for (int m = 0; m < NQ; ++m) {
          const float4 rr = r4[m * L], kk = k4[m * L], ww = w4[m * L];
          const float rq[4] = {rr.x, rr.y, rr.z, rr.w}, kq[4] = {kk.x, kk.y, kk.z, kk.w},
                      wq[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < CT; ++j)
              elem(rq[q], kq[q], wq[q], uu[4 * m + q], vv[j], st[4 * m + q][j], acc[j]);
        }
        first = reduce_lanes<L, CT>(acc, lane);
#pragma unroll
        for (int y = 0; y < NY; ++y) yv[u][y] = acc[y];
      };
      // no guard and no store between the steps of a full group, so that a
      // step's loads overlap the steps before it; the outputs go out after
      if (cnt == U) {
#pragma unroll
        for (int u = 0; u < U; ++u) step(u);
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (u < cnt) step(u);
      }
      if (lane % DUP == 0) {
#pragma unroll
        for (int y = 0; y < NY; ++y) {
          const int col = cg * CT + first + y;
          if (col < ncols) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (u < cnt) yb[(long long)(t0 + g + u) * vrow + col] = from_f32<T>(yv[u][y]);
          }
        }
      }
    }
  }
}

template <typename T, int DKP>
size_t smem_bytes(int chunk, int cols) {
  // f32: two buffers; bf16: the fp32 copy and one bf16 buffer
  return (size_t)chunk * (3 * DKP + cols) * (sizeof(T) == 2 ? 4 + 2 : 2 * 4);
}

template <typename T, int DKP, int L>
cudaError_t launch(const GlaParams& p, int B, cudaStream_t stream, int* resident) {
  const int threads = (p.cols / CT * L + 31) / 32 * 32;
  if (p.cols < 8 || p.cols % 8 != 0 || threads > MAX_THREADS || p.H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  auto kern = gla_kernel<T, DKP, L>;
  const size_t smem = smem_bytes<T, DKP>(p.chunk, p.cols);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // all of the SM's shared memory, so that as many blocks as fit are resident
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (resident) {  // a query: blocks of this launch resident on one SM
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern, threads, smem);
  }
  const dim3 grid((p.dv + p.cols - 1) / p.cols, p.H, B);
  kern<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the lane counts instantiated for a padded key dim: 4 or 8 rows a lane
template <typename T, int DKP>
cudaError_t launch_lanes(const GlaParams& p, int B, int lanes, cudaStream_t stream,
                         int* resident) {
  if (lanes * 4 == DKP) return launch<T, DKP, (DKP / 4 > 0 ? DKP / 4 : 1)>(p, B, stream, resident);
  if (lanes * 8 == DKP) return launch<T, DKP, (DKP / 8 > 0 ? DKP / 8 : 1)>(p, B, stream, resident);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dk(const GlaParams& p, int B, int lanes, cudaStream_t stream,
                      int* resident) {
  if (p.dk <= 8) return launch_lanes<T, 8>(p, B, lanes, stream, resident);
  if (p.dk <= 16) return launch_lanes<T, 16>(p, B, lanes, stream, resident);
  if (p.dk <= 32) return launch_lanes<T, 32>(p, B, lanes, stream, resident);
  if (p.dk <= 64) return launch_lanes<T, 64>(p, B, lanes, stream, resident);
  if (p.dk <= 128) return launch_lanes<T, 128>(p, B, lanes, stream, resident);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y); u is float32.  Every
// tensor is contiguous.  chunk: steps of r/k/w staged in shared memory at a
// time; lanes: lanes a column of the state is split over (dk padded / lanes
// in {4, 8}); cols: columns of the state a block owns (a multiple of 8).  Returns the
// cudaError_t of the launch (0 = launched).
int run(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
        int dtype, int B, int S, int H, int dk, int dv, int chunk, int lanes, int cols,
        void* stream, int* resident) {
  if (dk < 1 || chunk < 1 || lanes < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  GlaParams p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = reinterpret_cast<const float*>(u); p.y = y;
  p.S = S; p.H = H; p.dk = dk; p.dv = dv; p.chunk = chunk; p.cols = cols;
  const int esz = dtype == 1 ? 2 : 4;
  p.vec_rkw = aligned16(r) && aligned16(k) && aligned16(w) && (dk * esz) % 16 == 0;
  p.vec_v = aligned16(v) && (dv * esz) % 16 == 0;  // cols * esz is a multiple of 16
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = launch_dk<float>(p, B, lanes, st, resident);
  else if (dtype == 1) e = launch_dk<__nv_bfloat16>(p, B, lanes, st, resident);
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y); u is float32.  Every
// tensor is contiguous.  chunk: steps of r/k/w staged in shared memory at a
// time; lanes: lanes a column of the state is split over (dk padded / lanes
// in {4, 8}); cols: columns of the state a block owns (a multiple of 8).  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int gla_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, int dtype, int B, int S, int H, int dk,
                            int dv, int chunk, int lanes, int cols, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dv <= 0) return (int)cudaSuccess;  // nothing to compute
  return run(r, k, v, w, u, y, dtype, B, S, H, dk, dv, chunk, lanes, cols, stream, nullptr);
}

// Blocks of such a launch resident on one SM, into *resident; launches
// nothing.  Returns the cudaError_t of the query.
extern "C" int gla_scan_occupancy(int dtype, int dk, int chunk, int lanes, int cols,
                                  int* resident) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dtype, 1, 1, 1, dk, cols,
             chunk, lanes, cols, nullptr, resident);
}
