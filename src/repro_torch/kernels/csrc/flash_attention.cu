// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of the
// reference package (src/repro/kernels/flash_attention.py).  Same function:
// tiled online-softmax attention, GQA by index (kv head = h / (H/K)), causal
// masking with offset Sk - Sq, sliding window (causal, and |k - q| < w when
// not causal), positional masks only, m / l / acc in fp32, and exact zeros
// for a query row that attends nothing.
//
// What every kernel here shares, and how it differs from the TPU kernel:
//  * Blocks run in no order, so the KV loop is inside the block, with the
//    query rows, m, l and the output accumulator on chip and K and V tiles
//    of block_kv rows staged in shared memory.
//  * The tile range comes from the mask geometry, so a dead tile is never
//    loaded.  Tensors are read in their (B, S, H, d) layout through strides;
//    the ragged edges are masked (or zero-filled by the copy) here, nothing
//    is transposed or padded first.  A head dim is padded on chip to a
//    compiled width (DP); dv may differ from dh.
//
// What bounds it on this card: operations.  At the serving shapes (dh = 64,
// prompt 512, causal) a head does 4*dh operations per live (query, key) pair
// against 4 tensors of S*dh elements, far above the card's ~300 operations
// a byte (bf16), so the least time is the arithmetic at the tensor cores'
// rate (bf16) or at the FMA units' rate (fp32: the 2e-5 bound needs full
// fp32, no TF32).  What keeps a kernel from it is feeding the units: copies
// that do not overlap the math, operands re-read from shared memory for
// every FMA, too few warps, and a causal grid whose last wave is long.
//
// Four kernels; which one takes a call is decided by the wrapper
// (flash_attention.py, `route`) and checked here:
//  * flash_fwd_wgmma_kernel: bf16, block_q 64 or 128, dh == dv a multiple of
//    16 up to 128, and pointers and strides that TMA takes (16-byte aligned).
//    One producer warp keeps TMA loads of K and V tiles (block_kv rows, 128-
//    byte swizzle, zero-filled past the sequence) in flight in a ring of 2-4
//    stages (as deep as leaves room for a second block on the SM) with an
//    mbarrier per stage ("full": bytes landed; "empty": the consumers are
//    done).  One or two consumer warpgroups of 64 query rows each run S =
//    Q K^T as wgmma m64nBKVk16 with Q and K from shared memory (both
//    K-major), the online softmax in registers over the accumulator layout
//    (masking only the tiles that cross a row's range), round P to bf16 in
//    registers (as the oracle rounds it) and run O += P V as wgmma with A = P
//    from registers and V read MN-major (its natural [key][d] layout, the
//    transpose flag), 64 value columns a product.  The products are
//    asynchronous: S of tile j+1 and PV of tile j are issued together and the
//    softmax of tile j+1 runs while PV of tile j is on the tensor cores; two
//    warpgroups take turns at issuing (named barriers), so one's softmax
//    overlaps the other's products.  Q arrives by TMA too.  The grid walks
//    query tiles longest first, so the causal grid's last wave is short.
//    The tensor maps are encoded per call over (d, heads, S, B) with the
//    outer dims ordered by stride, and passed as __grid_constant__
//    parameters.  cuTensorMapEncodeTiled is reached through the runtime's
//    driver entry point, so the library links no libcuda.
//  * flash_fwd_mma_kernel: every other bf16 call at block_q 16..128 (dh not a
//    multiple of 16, dv != dh, block_q 16 or 32, views TMA refuses): one warp
//    per 16 query rows, both products on mma.sync.m16n8k16 with fp32
//    accumulation; Q in registers as A fragments, K and V staged row-major in
//    bf16 with 16 bytes of row padding, V fragments by ldmatrix.trans, P kept
//    in registers.  The copy does not overlap the math.
//  * flash_fwd_tiled_kernel: fp32 at block_q 16..64 and block_kv 16..64.
//    256 threads at most, a 16-wide grid of threads over keys (and over value
//    columns): each thread holds a 4-row by block_kv/16-key tile of S and a
//    4-row by DP/16-column tile of O, so every value read from shared memory
//    feeds 4 or more FMAs; P goes through shared memory between the two
//    products.  Q, K and V move with cp.async (16 bytes a thread) in a
//    two-stage ring, so the load of tile j+1 overlaps the work on tile j.
//    At block 64 x 64 and dh 64 a block takes 104 KB: two blocks an SM.
//  * flash_fwd_kernel: block_q below 16, either type: one thread per query
//    row, fp32 FMAs, K and V staged as fp32 and read as broadcasts.
//
// GQA: each block serves one query head; the heads of a group read the same
// K/V tiles, which the grid order (heads fastest) keeps in the L2 cache.  At
// the serving shape the wgmma kernel is only ~5 % slower with a K/V head per
// query head (nothing to share) than with groups of 7 (PERF.md), so sharing
// a group's tiles on chip could gain at most that; it is not done.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KC = 8;             // keys per online-softmax update
constexpr int MAX_THREADS = 256;  // one thread per query row

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

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, K, dh, dv;
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
  float scale;
  int causal;
  int window;  // <= 0: none
  int block_q, block_kv;
  int vec_ok;  // K and V rows may be read as 16-byte vectors
};

// Key range [lo, hi) that query row `row` attends (hi <= lo: nothing).
__device__ __forceinline__ void row_range(const FlashParams& p, int row, int& lo, int& hi) {
  const int offset = p.Sk - p.Sq;
  lo = 0;
  hi = p.Sk;
  if (p.causal) {
    hi = row + offset + 1;
    if (p.window > 0) lo = row + offset - p.window + 1;
  } else if (p.window > 0) {
    lo = row - p.window + 1;
    hi = row + p.window;
  }
  lo = lo < 0 ? 0 : lo;
  hi = hi > p.Sk ? p.Sk : hi;
  if (row >= p.Sq) hi = lo;  // a row past the end attends nothing
}

// Key range of the query rows [r0, r0 + n) together, clipped to [0, Sk);
// empty (hi <= lo) when every row is past the end.
__device__ __forceinline__ void rows_range(const FlashParams& p, int r0, int n, int& lo, int& hi) {
  const int r_last = (r0 + n < p.Sq ? r0 + n : p.Sq) - 1;
  if (r_last < r0) {
    lo = hi = 0;
    return;
  }
  int lo0, hi0, lo1, hi1;
  row_range(p, r0, lo0, hi0);
  row_range(p, r_last, lo1, hi1);
  lo = lo0 < lo1 ? lo0 : lo1;
  hi = hi0 > hi1 ? hi0 : hi1;
}

// Stage `rows` rows of `d` valid elements into shared memory as fp32, row
// stride DP, zero-filling the padded columns and the rows in [rows, rows_pad).
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long long row_stride,
                                           int rows, int rows_pad, int d) {
  for (int idx = threadIdx.x; idx < rows_pad * DP; idx += blockDim.x) {
    const int r = idx / DP;
    const int c = idx % DP;
    float val = 0.f;
    if (r < rows && c < d) val = to_f32<T>(src[(long long)r * row_stride + c]);
    dst[idx] = val;
  }
}

template <typename T, int DHP, int DVP>
__global__ void __launch_bounds__(MAX_THREADS) flash_fwd_kernel(const FlashParams p) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kv rows][DHP]
  const int kv_rows = p.block_kv > KC ? p.block_kv : KC;
  float* Vs = Ks + (size_t)kv_rows * DHP;  // [kv rows][DVP]

  const int q0 = blockIdx.x * p.block_q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int qpos = q0 + threadIdx.x;
  const bool row_ok = qpos < p.Sq;
  const int offset = p.Sk - p.Sq;

  // key range [lo_t, hi_t) this thread's row attends; block range [k_lo, k_hi)
  const int q_last = (q0 + p.block_q < p.Sq ? q0 + p.block_q : p.Sq) - 1;
  int lo_t = 0, hi_t = p.Sk, k_lo = 0, k_hi = p.Sk;
  if (p.causal) {
    hi_t = qpos + offset + 1;
    k_hi = q_last + offset + 1;
    if (p.window > 0) {
      lo_t = qpos + offset - p.window + 1;
      k_lo = q0 + offset - p.window + 1;
    }
  } else if (p.window > 0) {
    lo_t = qpos - p.window + 1;
    hi_t = qpos + p.window;
    k_lo = q0 - p.window + 1;
    k_hi = q_last + p.window;
  }
  lo_t = lo_t < 0 ? 0 : lo_t;
  hi_t = hi_t > p.Sk ? p.Sk : hi_t;
  k_lo = k_lo < 0 ? 0 : k_lo;
  k_hi = k_hi > p.Sk ? p.Sk : k_hi;
  k_lo = (k_lo / p.block_kv) * p.block_kv;

  float qreg[DHP];
  {
    const T* qptr = reinterpret_cast<const T*>(p.q) + (long long)b * p.q_b +
                    (long long)(row_ok ? qpos : 0) * p.q_s + (long long)h * p.q_h;
#pragma unroll
    for (int d = 0; d < DHP; ++d) qreg[d] = (row_ok && d < p.dh) ? to_f32<T>(qptr[d]) : 0.f;
  }

  float acc[DVP];
#pragma unroll
  for (int d = 0; d < DVP; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  const T* kbase = reinterpret_cast<const T*>(p.k) + (long long)b * p.k_b + (long long)kvh * p.k_h;
  const T* vbase = reinterpret_cast<const T*>(p.v) + (long long)b * p.v_b + (long long)kvh * p.v_h;

  for (int k0 = k_lo; k0 < k_hi; k0 += p.block_kv) {
    const int rows = (p.block_kv < k_hi - k0) ? p.block_kv : (k_hi - k0);
    const int rows_pad = (rows + KC - 1) / KC * KC;
    __syncthreads();  // the previous tile has been consumed by every thread
    stage_tile<T, DHP>(Ks, kbase + (long long)k0 * p.k_s, p.k_s, rows, rows_pad, p.dh);
    stage_tile<T, DVP>(Vs, vbase + (long long)k0 * p.v_s, p.v_s, rows, rows_pad, p.dv);
    __syncthreads();
    if (!row_ok) continue;
    // rows of the tile past `rows` are zero padding, not keys (they matter
    // when block_kv is smaller than a chunk)
    const int hi_tile = hi_t < k0 + rows ? hi_t : k0 + rows;

    for (int j0 = 0; j0 < rows_pad; j0 += KC) {
      const int kp0 = k0 + j0;
      if (kp0 >= hi_tile || kp0 + KC <= lo_t) continue;  // nothing live for this row

      float s[KC];
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int d = 0; d < DHP; d += 4) {
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(&Ks[(j0 + jj) * DHP + d]);
          s[jj] = fmaf(qreg[d + 0], kk.x, s[jj]);
          s[jj] = fmaf(qreg[d + 1], kk.y, s[jj]);
          s[jj] = fmaf(qreg[d + 2], kk.z, s[jj]);
          s[jj] = fmaf(qreg[d + 3], kk.w, s[jj]);
        }
      }

      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int kp = kp0 + jj;
        const bool live = kp >= lo_t && kp < hi_tile;
        s[jj] = live ? s[jj] * p.scale : -INFINITY;
        m_new = fmaxf(m_new, s[jj]);
      }
      // at least one key of the chunk is live, so m_new is finite
      const float alpha = expf(m - m_new);  // m == -inf gives 0
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        s[jj] = expf(s[jj] - m_new);  // a masked key gives exp(-inf) = 0
        psum += s[jj];
      }
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int d = 0; d < DVP; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
#pragma unroll
        for (int d = 0; d < DVP; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[(j0 + jj) * DVP + d]);
          acc[d + 0] = fmaf(s[jj], vv.x, acc[d + 0]);
          acc[d + 1] = fmaf(s[jj], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[jj], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[jj], vv.w, acc[d + 3]);
        }
      }
    }
  }

  if (row_ok) {
    // a row that attended nothing has l == 0: exact zeros, not 0/0
    const bool alive = l > 0.f;
    const float denom = alive ? l : 1.f;
    T* optr = reinterpret_cast<T*>(p.o) + (long long)b * p.o_b + (long long)qpos * p.o_s +
              (long long)h * p.o_h;
#pragma unroll
    for (int d = 0; d < DVP; ++d) {
      if (d < p.dv) optr[d] = from_f32<T>(alive ? acc[d] / denom : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int KCH = 32;            // keys per online-softmax update (4 n-tiles of 8)
constexpr int MMA_MAX_THREADS = 256;  // 8 warps of 16 query rows

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low 16 bits
  return *reinterpret_cast<const uint32_t*>(&v);
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

// Stage `rows` rows of `d` valid bf16 elements, row stride STR in shared
// memory, zero-filling the padded columns and the rows in [rows, rows_pad).
template <int DP, int STR>
__device__ __forceinline__ void stage_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int rows, int rows_pad,
                                                int d, bool vec) {
  if (vec) {  // d and every stride are multiples of 8 elements, pointers of 16 bytes
    constexpr int CPR = DP / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < rows_pad * CPR; idx += blockDim.x) {
      const int r = idx / CPR;
      const int c = (idx % CPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < d)
        val = *reinterpret_cast<const uint4*>(src + (long long)r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * STR + c) = val;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int idx = threadIdx.x; idx < rows_pad * DP; idx += blockDim.x) {
      const int r = idx / DP;
      const int c = idx % DP;
      dst[r * STR + c] = (r < rows && c < d) ? src[(long long)r * row_stride + c] : zero;
    }
  }
}

// two consecutive bf16 of a global row as one A-fragment register, zero past `d`
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, bool ok, int c, int d) {
  const unsigned short lo = (ok && c < d) ? __bfloat16_as_ushort(row[c]) : (unsigned short)0;
  const unsigned short hi = (ok && c + 1 < d) ? __bfloat16_as_ushort(row[c + 1]) : (unsigned short)0;
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <int DHP, int DVP>
__global__ void __launch_bounds__(MMA_MAX_THREADS) flash_fwd_mma_kernel(const FlashParams p) {
  typedef __nv_bfloat16 T;
  constexpr int KSTR = DHP + 8;  // row strides in elements: 16 bytes of padding
  constexpr int VSTR = DVP + 8;
  extern __shared__ float4 smem4[];
  const int kv_rows = p.block_kv > KCH ? p.block_kv : KCH;
  T* Ks = reinterpret_cast<T*>(smem4);    // [kv_rows][KSTR]   K[key][d]
  T* Vs = Ks + (size_t)kv_rows * KSTR;    // [kv_rows][VSTR]   V[key][c]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row half of the warp's tile
  const int t = lane & 3;   // column pair within an 8-wide tile
  const int q0 = blockIdx.x * p.block_q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int offset = p.Sk - p.Sq;

  const int wrow = q0 + warp * 16;  // first query row of this warp
  const int row[2] = {wrow + g, wrow + g + 8};
  const bool row_ok[2] = {row[0] < p.Sq, row[1] < p.Sq};

  // key ranges: per row [lo, hi), per warp [wlo, whi), per block [k_lo, k_hi)
  const int q_last = (q0 + p.block_q < p.Sq ? q0 + p.block_q : p.Sq) - 1;
  const int w_last = (wrow + 16 < p.Sq ? wrow + 16 : p.Sq) - 1;
  int lo[2] = {0, 0}, hi[2] = {p.Sk, p.Sk};
  int wlo = 0, whi = p.Sk, k_lo = 0, k_hi = p.Sk;
  if (p.causal) {
    hi[0] = row[0] + offset + 1;
    hi[1] = row[1] + offset + 1;
    whi = w_last + offset + 1;
    k_hi = q_last + offset + 1;
    if (p.window > 0) {
      lo[0] = row[0] + offset - p.window + 1;
      lo[1] = row[1] + offset - p.window + 1;
      wlo = wrow + offset - p.window + 1;
      k_lo = q0 + offset - p.window + 1;
    }
  } else if (p.window > 0) {
    lo[0] = row[0] - p.window + 1;
    lo[1] = row[1] - p.window + 1;
    hi[0] = row[0] + p.window;
    hi[1] = row[1] + p.window;
    wlo = wrow - p.window + 1;
    whi = w_last + p.window;
    k_lo = q0 - p.window + 1;
    k_hi = q_last + p.window;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lo[r] = lo[r] < 0 ? 0 : lo[r];
    hi[r] = hi[r] > p.Sk ? p.Sk : hi[r];
    if (!row_ok[r]) hi[r] = lo[r];  // a row past the end attends nothing
  }
  if (w_last < wrow) whi = wlo;  // the whole warp is past the end
  k_lo = k_lo < 0 ? 0 : k_lo;
  k_hi = k_hi > p.Sk ? p.Sk : k_hi;
  k_lo = (k_lo / p.block_kv) * p.block_kv;

  // Q as A fragments, one per 16 columns of the head dim
  uint32_t qa[DHP / 16][4];
  {
    const T* qb = reinterpret_cast<const T*>(p.q) + (long long)b * p.q_b + (long long)h * p.q_h;
    const T* r0 = qb + (long long)(row_ok[0] ? row[0] : 0) * p.q_s;
    const T* r1 = qb + (long long)(row_ok[1] ? row[1] : 0) * p.q_s;
#pragma unroll
    for (int kc = 0; kc < DHP / 16; ++kc) {
      const int c = kc * 16 + 2 * t;
      qa[kc][0] = load_pair(r0, row_ok[0], c, p.dh);
      qa[kc][1] = load_pair(r1, row_ok[1], c, p.dh);
      qa[kc][2] = load_pair(r0, row_ok[0], c + 8, p.dh);
      qa[kc][3] = load_pair(r1, row_ok[1], c + 8, p.dh);
    }
  }

  float acc[DVP / 8][4];
#pragma unroll
  for (int nv = 0; nv < DVP / 8; ++nv) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nv][i] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sum

  const T* kbase = reinterpret_cast<const T*>(p.k) + (long long)b * p.k_b + (long long)kvh * p.k_h;
  const T* vbase = reinterpret_cast<const T*>(p.v) + (long long)b * p.v_b + (long long)kvh * p.v_h;
  const bool vec = p.vec_ok != 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += p.block_kv) {
    const int rows = (p.block_kv < k_hi - k0) ? p.block_kv : (k_hi - k0);
    const int rows_pad = (rows + KCH - 1) / KCH * KCH;
    __syncthreads();  // the previous tile has been consumed by every warp
    stage_tile_bf16<DHP, KSTR>(Ks, kbase + (long long)k0 * p.k_s, p.k_s, rows, rows_pad, p.dh, vec);
    stage_tile_bf16<DVP, VSTR>(Vs, vbase + (long long)k0 * p.v_s, p.v_s, rows, rows_pad, p.dv, vec);
    __syncthreads();

    // rows of the tile past `rows` are zero padding, not keys (they matter
    // when block_kv is smaller than a chunk)
    const int tile_end = k0 + rows;
    const int hi_tile[2] = {hi[0] < tile_end ? hi[0] : tile_end,
                            hi[1] < tile_end ? hi[1] : tile_end};

    for (int j0 = 0; j0 < rows_pad; j0 += KCH) {
      const int kp0 = k0 + j0;
      if (kp0 >= whi || kp0 + KCH <= wlo) continue;  // nothing live for this warp

      // S = Q K^T for 16 rows x 32 keys
      float s[KCH / 8][4];
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < DHP / 16; ++kc) {
#pragma unroll
        for (int nt = 0; nt < KCH / 8; ++nt) {
          const T* kp = Ks + (j0 + nt * 8 + g) * KSTR + kc * 16 + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
          mma_bf16_16816(s[nt], qa[kc], b0, b1);
        }
      }

      // mask, scale, row maxima (a row's 32 scores lie in the 4 lanes of a quad)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int key = kp0 + nt * 8 + 2 * t + (i & 1);
          const bool live = key >= lo[r] && key < hi_tile[r];
          s[nt][i] = live ? s[nt][i] * p.scale : -INFINITY;
          mx[r] = fmaxf(mx[r], s[nt][i]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;  // a row with nothing live yet
        alpha[r] = expf(m[r] - m_safe);                           // m == -inf gives 0
        m[r] = m_new;
        mx[r] = m_safe;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < KCH / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] = expf(s[nt][i] - mx[i >> 1]);  // a masked key gives exp(-inf) = 0
          psum[i >> 1] += s[nt][i];
        }
      }
      l[0] = l[0] * alpha[0] + psum[0];
      l[1] = l[1] * alpha[1] + psum[1];
#pragma unroll
      for (int nv = 0; nv < DVP / 8; ++nv) {
        acc[nv][0] *= alpha[0];
        acc[nv][1] *= alpha[0];
        acc[nv][2] *= alpha[1];
        acc[nv][3] *= alpha[1];
      }

      // O += P V: the scores of n-tiles 2kk and 2kk+1 are the A fragment of P
#pragma unroll
      for (int kk = 0; kk < KCH / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        // B fragments of V[key][col] for two 8-column tiles per ldmatrix:
        // lanes 0-15 address keys 0-15 of the first tile, lanes 16-31 of the next
        const T* vrow = Vs + (j0 + kk * 16 + (lane & 15)) * VSTR + (lane >> 4) * 8;
#pragma unroll
        for (int nv = 0; nv < DVP / 8; nv += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + nv * 8);
          mma_bf16_16816(acc[nv], pa, vb[0], vb[1]);
          mma_bf16_16816(acc[nv + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  // row sums across the quad, normalise, store; l == 0 gives exact zeros
  T* ob = reinterpret_cast<T*>(p.o) + (long long)b * p.o_b + (long long)h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (!row_ok[r]) continue;
    const bool alive = l[r] > 0.f;
    const float denom = alive ? l[r] : 1.f;
    T* orow = ob + (long long)row[r] * p.o_s;
#pragma unroll
    for (int nv = 0; nv < DVP / 8; ++nv) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = nv * 8 + 2 * t + i;
        if (c < p.dv) orow[c] = __float2bfloat16(alive ? acc[nv][2 * r + i] / denom : 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: register tiles, cp.async staging
// ---------------------------------------------------------------------------

constexpr int TL_TC = 16;           // threads across keys and value columns
constexpr int TL_RM = 4;            // query rows per thread
constexpr int TL_MAX_THREADS = 256;  // block_q 64

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Stage rows [0, rows) of a (rows, d) fp32 matrix into shared memory [rows_pad][STR],
// zero-filling columns >= d (up to DP) and rows >= rows: 16-byte cp.async where
// the layout allows (vec), plain loads otherwise.
template <int DP, int STR>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long row_stride,
                                          int rows, int rows_pad, int d, bool vec) {
  if (vec) {  // d and the row stride are multiples of 4, the pointer of 16 bytes
    constexpr int CH = DP / 4;
    for (int idx = threadIdx.x; idx < rows_pad * CH; idx += blockDim.x) {
      const int r = idx / CH;
      const int c = (idx % CH) * 4;
      const bool ok = r < rows && c < d;
      cp_async16(dst + r * STR + c, ok ? src + (long long)r * row_stride + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows_pad * DP; idx += blockDim.x) {
      const int r = idx / DP;
      const int c = idx % DP;
      dst[r * STR + c] = (r < rows && c < d) ? src[(long long)r * row_stride + c] : 0.f;
    }
  }
}

// The CPT value columns of one V row that thread `tc` owns: groups of 4
// (64 apart) from DP = 64 on, else CPT consecutive columns.
template <int DP>
__device__ __forceinline__ int tl_col(int tc, int e) {
  constexpr int CPT = DP / TL_TC;
  if constexpr (CPT >= 4) return (e / 4) * 64 + tc * 4 + (e % 4);
  else return tc * CPT + e;
}

template <int DP>
__device__ __forceinline__ void tl_load_v(const float* vrow, int tc, float (&out)[DP / TL_TC]) {
  constexpr int CPT = DP / TL_TC;
  if constexpr (CPT >= 4) {
#pragma unroll
    for (int j = 0; j < CPT / 4; ++j) {
      const float4 v4 = *reinterpret_cast<const float4*>(vrow + j * 64 + tc * 4);
      out[4 * j + 0] = v4.x;
      out[4 * j + 1] = v4.y;
      out[4 * j + 2] = v4.z;
      out[4 * j + 3] = v4.w;
    }
  } else if constexpr (CPT == 2) {
    const float2 v2 = *reinterpret_cast<const float2*>(vrow + tc * 2);
    out[0] = v2.x;
    out[1] = v2.y;
  } else {
    out[0] = vrow[tc];
  }
}

// block_q = 4 * blockDim.x / 16 query rows, BKV = 16 * RN keys a tile.
template <int RN, int DP>
__global__ void __launch_bounds__(TL_MAX_THREADS) flash_fwd_tiled_kernel(const FlashParams p) {
  constexpr int BKV = TL_TC * RN;
  constexpr int CPT = DP / TL_TC;  // value columns per thread
  constexpr int STR = DP + 4;      // row stride of Q, K, V in shared memory (floats)
  constexpr int PSTR = BKV + 4;    // row stride of P
  const int BQ = p.block_q;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][STR]
  float* Ks = Qs + BQ * STR;                     // [2][BKV][STR]
  float* Vs = Ks + 2 * BKV * STR;                // [2][BKV][STR]
  float* Ps = Vs + 2 * BKV * STR;                // [BQ][PSTR]

  const int tc = threadIdx.x % TL_TC;
  const int tr = threadIdx.x / TL_TC;
  const int TR = blockDim.x / TL_TC;  // row groups: rows tr + TR * i
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest query tiles first
  const int kvh = h / (p.H / p.K);
  const bool vec = p.vec_ok != 0;

  int lo[TL_RM], hi[TL_RM];
#pragma unroll
  for (int i = 0; i < TL_RM; ++i) row_range(p, q0 + tr + TR * i, lo[i], hi[i]);
  int k_lo, k_hi;
  rows_range(p, q0, BQ, k_lo, k_hi);
  k_lo = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BKV - 1) / BKV : 0;

  const float* qbase = reinterpret_cast<const float*>(p.q) + (long long)b * p.q_b +
                       (long long)h * p.q_h + (long long)q0 * p.q_s;
  const float* kbase = reinterpret_cast<const float*>(p.k) + (long long)b * p.k_b +
                       (long long)kvh * p.k_h;
  const float* vbase = reinterpret_cast<const float*>(p.v) + (long long)b * p.v_b +
                       (long long)kvh * p.v_h;
  const int q_rows = p.Sq - q0 < BQ ? p.Sq - q0 : BQ;

  auto stage_kv = [&](int t) {
    const int k0 = k_lo + t * BKV;
    const int rows = p.Sk - k0 < BKV ? p.Sk - k0 : BKV;
    const int buf = t & 1;
    stage_f32<DP, STR>(Ks + buf * BKV * STR, kbase + (long long)k0 * p.k_s, p.k_s, rows, BKV,
                       p.dh, vec);
    stage_f32<DP, STR>(Vs + buf * BKV * STR, vbase + (long long)k0 * p.v_s, p.v_s, rows, BKV,
                       p.dv, vec);
  };

  stage_f32<DP, STR>(Qs, qbase, p.q_s, q_rows, BQ, p.dh, vec);
  if (n_tiles > 0) stage_kv(0);
  cp_async_commit();

  float o[TL_RM][CPT];
  float m[TL_RM], l[TL_RM];  // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < TL_RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every thread is done with tile t-1 and its P
    if (t + 1 < n_tiles) stage_kv(t + 1);  // overlaps the work on tile t
    cp_async_commit();
    const float* Kb = Ks + (t & 1) * BKV * STR;
    const float* Vb = Vs + (t & 1) * BKV * STR;
    const int k0 = k_lo + t * BKV;

    // S = Q K^T: 4 rows x RN keys a thread (keys tc + 16 k)
    float s[TL_RM][RN];
#pragma unroll
    for (int i = 0; i < TL_RM; ++i) {
#pragma unroll
      for (int k = 0; k < RN; ++k) s[i][k] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[TL_RM], kv[RN];
#pragma unroll
      for (int i = 0; i < TL_RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (tr + TR * i) * STR + d);
#pragma unroll
      for (int k = 0; k < RN; ++k)
        kv[k] = *reinterpret_cast<const float4*>(Kb + (tc + TL_TC * k) * STR + d);
#pragma unroll
      for (int i = 0; i < TL_RM; ++i) {
#pragma unroll
        for (int k = 0; k < RN; ++k) {
          s[i][k] = fmaf(qv[i].x, kv[k].x, s[i][k]);
          s[i][k] = fmaf(qv[i].y, kv[k].y, s[i][k]);
          s[i][k] = fmaf(qv[i].z, kv[k].z, s[i][k]);
          s[i][k] = fmaf(qv[i].w, kv[k].w, s[i][k]);
        }
      }
    }

    // mask, scale, online softmax; a row's keys lie in the 16 lanes with its tr
#pragma unroll
    for (int i = 0; i < TL_RM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < RN; ++k) {
        const int key = k0 + tc + TL_TC * k;
        s[i][k] = (key >= lo[i] && key < hi[i]) ? s[i][k] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][k]);
      }
#pragma unroll
      for (int off = 1; off < TL_TC; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;  // nothing live yet
      const float alpha = expf(m[i] - m_safe);                  // m == -inf gives 0
      m[i] = m_new;
      float psum = 0.f;
      float* prow = Ps + (tr + TR * i) * PSTR;
#pragma unroll
      for (int k = 0; k < RN; ++k) {
        const float pk = expf(s[i][k] - m_safe);  // a masked key gives exp(-inf) = 0
        psum += pk;
        prow[tc + TL_TC * k] = pk;
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

    // O += P V: 4 rows x CPT columns a thread
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 pv[TL_RM];
#pragma unroll
      for (int i = 0; i < TL_RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (tr + TR * i) * PSTR + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
        tl_load_v<DP>(Vb + (j + jj) * STR, tc, vv);
#pragma unroll
        for (int i = 0; i < TL_RM; ++i) {
          const float pij = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(pij, vv[c], o[i][c]);
        }
      }
    }
  }
  cp_async_wait_all();

  // row sums across the 16 lanes, normalise, store; l == 0 gives exact zeros
  float* ob = reinterpret_cast<float*>(p.o) + (long long)b * p.o_b + (long long)h * p.o_h;
#pragma unroll
  for (int i = 0; i < TL_RM; ++i) {
#pragma unroll
    for (int off = 1; off < TL_TC; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + tr + TR * i;
    if (row >= p.Sq) continue;
    const bool alive = l[i] > 0.f;
    const float inv = alive ? 1.f / l[i] : 0.f;
    float* orow = ob + (long long)row * p.o_s;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tl_col<DP>(tc, c);
      if (col < p.dv) orow[col] = alive ? o[i][c] * inv : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;      // query rows of a consumer warpgroup
constexpr int WG_CHUNK = 64;     // head-dim columns per TMA box: 128 bytes, the swizzle span
constexpr int WG_Q_BYTES = WG_ROWS * WG_CHUNK * 2;
constexpr int WG_SMEM_LIMIT = 232448;

// Shared memory of one block and the depth of its K/V ring: as many stages
// (2 to 4) as leave room for two blocks an SM after Q, the barriers and the
// slack that aligns the tiles to 1024 bytes (a deeper ring would cost the
// second block, whose prologue overlaps this one's work).
__host__ __device__ constexpr int wg_stage_bytes(int DP, int BKV) { return 2 * (DP / WG_CHUNK) * BKV * WG_CHUNK * 2; }
__host__ __device__ constexpr int wg_fixed_bytes(int NWG, int DP) {
  return 1024 + NWG * (DP / WG_CHUNK) * WG_Q_BYTES + 8 * (2 * 4 + 1);
}
__host__ __device__ constexpr int wg_stages(int NWG, int DP, int BKV) {
  return (WG_SMEM_LIMIT / 2 - wg_fixed_bytes(NWG, DP)) / wg_stage_bytes(DP, BKV) >= 4   ? 4
         : (WG_SMEM_LIMIT / 2 - wg_fixed_bytes(NWG, DP)) / wg_stage_bytes(DP, BKV) >= 3 ? 3
                                                                                         : 2;
}
__host__ __device__ constexpr int wg_smem_bytes(int NWG, int DP, int BKV) {
  return wg_fixed_bytes(NWG, DP) + wg_stages(NWG, DP, BKV) * wg_stage_bytes(DP, BKV);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that has
// not ended after ~2^34 cycles (seconds) can only be a broken pipeline: it
// traps, which fails the launch, rather than hold the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}
// One box of a 4-d tensor map into shared memory, completion counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// The tensor maps' outer dims are (heads, S, B) in increasing stride; `order`
// holds, in 2 bits per map dim 1..3, which of them (0 = head, 1 = S, 2 = B).
__device__ __forceinline__ int pick_hsb(int which, int hd, int s, int b) {
  return which == 0 ? hd : (which == 1 ? s : b);
}
__device__ __forceinline__ void tma_load_hsb(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int order, int d, int hd, int s, int b) {
  tma_load_4d(dst, map, bar, d, pick_hsb(order & 3, hd, s, b), pick_hsb((order >> 2) & 3, hd, s, b),
              pick_hsb((order >> 4) & 3, hd, s, b));
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle: start
// address, leading / stride byte offsets (the stride one: 8 rows of 128 bytes).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x N) = A (64 x 16) B^T, A and B K-major in shared memory
template <int N> struct WgmmaSS;

template <> struct WgmmaSS<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// O += P V for 64 value columns: A (P) from registers, B (V) MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one tile of S in the accumulator layout (this thread:
// rows g and g+8 of its warp's 16, columns 8j + 2qd, +1): scale to base 2,
// mask unless the tile lies inside every row's range (`full`), update the
// running max and sum, leave the probabilities in s.
template <int BKV>
__device__ __forceinline__ void wg_softmax(float (&s)[BKV / 2], int kp0, bool full,
                                           const int (&lo)[2], const int (&hi)[2], int qd,
                                           float sc, float (&m)[2], float (&l)[2],
                                           float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (full) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      s[i] *= sc;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = kp0 + 8 * j + 2 * qd + (i & 1);
        const bool live = key >= lo[r] && key < hi[r];
        s[4 * j + i] = live ? s[4 * j + i] * sc : -INFINITY;
        mx[r] = fmaxf(mx[r], s[4 * j + i]);
      }
    }
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_safe[r] = (m_new == -INFINITY) ? 0.f : m_new;  // a row with nothing live yet
    alpha[r] = ex2(m[r] - m_safe[r]);                // m == -inf gives 0
    m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    s[i] = ex2(s[i] - m_safe[(i >> 1) & 1]);  // a masked key gives 0
    psum[(i >> 1) & 1] += s[i];
  }
  l[0] = l[0] * alpha[0] + psum[0];
  l[1] = l[1] * alpha[1] + psum[1];
}

// P in bf16: the scores of key tiles 2kk and 2kk+1 are the A fragment of keys 16kk..
template <int BKV>
__device__ __forceinline__ void wg_pack(uint32_t (&pa)[BKV / 16][4], const float (&s)[BKV / 2]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (ping-pong): each waits for its turn before issuing and hands the turn on
// after, so one warpgroup's softmax runs while the other's products do.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// block_q = 64 * NWG query rows (NWG consumer warpgroups) and one producer
// warp; BKV keys a tile; DP = 64 or 128 head-dim columns (dh == dv).
template <int NWG, int DP, int BKV>
__global__ void __launch_bounds__(NWG * 128 + 32)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const FlashParams p,
                           const int4 order) {
  constexpr int NCH = DP / WG_CHUNK;
  constexpr int KV_BYTES = BKV * WG_CHUNK * 2;  // one 64-column chunk of a K or V tile
  constexpr int STAGE_BYTES = wg_stage_bytes(DP, BKV);  // K and V of one tile
  constexpr int STAGES = wg_stages(NWG, DP, BKV);
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q: [NWG][NCH][64 rows][128 B]
  const uint32_t skv = sq + NWG * NCH * WG_Q_BYTES;           // [stage][K chunks, V chunks]
  const uint32_t sbar = skv + STAGES * STAGE_BYTES;           // full[], empty[], q
  const uint32_t q_bar = sbar + 16 * STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * (NWG * WG_ROWS);  // longest query tiles first
  const int kvh = h / (p.H / p.K);

  int k_lo, k_hi;
  rows_range(p, q0, NWG * WG_ROWS, k_lo, k_hi);
  k_lo = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sbar + 8 * s, 1);                    // full: the producer's arrival
      mbar_init(sbar + 8 * (STAGES + s), 4 * NWG);   // empty: every consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // producer: Q once, then K and V tiles into the ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, NWG * NCH * WG_Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < NCH; ++c)
          tma_load_hsb(sq + (w * NCH + c) * WG_Q_BYTES, &tm_q, q_bar, order.x, c * WG_CHUNK, h,
                       q0 + w * WG_ROWS, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(sbar + 8 * (STAGES + st), ((t / STAGES) & 1) ^ 1);  // the consumers freed it
        const uint32_t full = sbar + 8 * st;
        mbar_expect_tx(full, STAGE_BYTES);
        const int k0 = k_lo + t * BKV;
        const uint32_t stage = skv + st * STAGE_BYTES;
        for (int c = 0; c < NCH; ++c) {
          tma_load_hsb(stage + c * KV_BYTES, &tm_k, full, order.y, c * WG_CHUNK, kvh, k0, b);
          tma_load_hsb(stage + (NCH + c) * KV_BYTES, &tm_v, full, order.z, c * WG_CHUNK, kvh, k0,
                       b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [wrow, wrow + 64); warp wq of it
  // rows 16 wq .. 16 wq + 15, this thread rows g and g + 8 of those
  const int wg = warp / 4;
  const int wq = warp % 4;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int wrow = q0 + wg * WG_ROWS;
  const int row[2] = {wrow + wq * 16 + g, wrow + wq * 16 + g + 8};
  int lo[2], hi[2];
  row_range(p, row[0], lo[0], hi[0]);
  row_range(p, row[1], lo[1], hi[1]);
  int wlo, whi;  // keys any row of this warpgroup attends
  rows_range(p, wrow, WG_ROWS, wlo, whi);
  int lo_max, hi_min;  // keys every row of it attends: a tile inside needs no mask
  {
    int lo_a, hi_a, lo_b, hi_b;
    row_range(p, wrow, lo_a, hi_a);
    row_range(p, wrow + WG_ROWS - 1, lo_b, hi_b);
    lo_max = lo_a > lo_b ? lo_a : lo_b;
    hi_min = hi_a < hi_b ? hi_a : hi_b;
  }
  const float sc = p.scale * 1.4426950408889634f;  // softmax in base 2
  // this warpgroup's live tiles: [t_first, t_last], contiguous
  int t_first = n_tiles, t_last = n_tiles - 1;
  if (wlo < whi) {
    t_first = (wlo - k_lo) / BKV;
    t_last = min((whi - k_lo + BKV - 1) / BKV, n_tiles) - 1;
  }
  // two warpgroups take n_tiles + 1 turns each: one a product batch, one
  // empty turn for each tile a warpgroup does not see
  auto turn_wait = [&]() {
    if constexpr (NWG == 2) named_sync(1 + wg);
  };
  auto turn_pass = [&]() {
    if constexpr (NWG == 2) named_arrive(2 - wg);
  };
  if constexpr (NWG == 2) {
    if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
  }

  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sum
  const uint32_t q_tile = sq + wg * NCH * WG_Q_BYTES;
  mbar_wait(q_bar, 0);

  auto wait_tile = [&](int t) { mbar_wait(sbar + 8 * (t % STAGES), (t / STAGES) & 1); };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(sbar + 8 * (STAGES + t % STAGES));
  };
  // S = Q K^T: 16 columns of the head dim a product (32 bytes into the swizzled rows)
  auto issue_s = [&](float (&s)[BKV / 2], int t) {
    const uint32_t k_tile = skv + (t % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32u;  // bytes into the chunk's 128-byte rows
      WgmmaSS<BKV>::run(s, wg_desc(q_tile + (kk / 4) * WG_Q_BYTES + off, 0),
                        wg_desc(k_tile + (kk / 4) * KV_BYTES + off, 0), kk > 0 ? 1 : 0);
    }
  };
  // O += P V: V is [key][d], read MN-major; 16 keys (2048 bytes) a product
  auto issue_pv = [&](uint32_t (&pa)[BKV / 16][4], int t) {
    const uint32_t v_tile = skv + (t % STAGES) * STAGE_BYTES + NCH * KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        wgmma_rs_n64(o[c], pa[kk], wg_desc(v_tile + c * KV_BYTES + kk * 2048, 0));
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j + 0] *= alpha[0];
        o[c][4 * j + 1] *= alpha[0];
        o[c][4 * j + 2] *= alpha[1];
        o[c][4 * j + 3] *= alpha[1];
      }
    }
  };

  int t = 0;
  for (; t < t_first; ++t) {  // tiles no row of this warpgroup sees
    wait_tile(t);
    turn_wait();
    turn_pass();
    release(t);
  }
  if (t_first <= t_last) {
    // pipelined: while the tensor cores run PV of tile t-1 (and S of tile t
    // before it), the warpgroup does the softmax of tile t
    float s[BKV / 2];
    uint32_t pa[BKV / 16][4];
    float alpha[2];
    wait_tile(t_first);
    turn_wait();
    wg_fence();
    issue_s(s, t_first);
    wg_commit();
    turn_pass();
    wg_wait_all();
    reg_fence(s);
    int kp0 = k_lo + t_first * BKV;
    wg_softmax<BKV>(s, kp0, kp0 >= lo_max && kp0 + BKV <= hi_min, lo, hi, qd, sc, m, l, alpha);
    wg_pack<BKV>(pa, s);  // O is still zero: nothing to rescale
    for (t = t_first + 1; t <= t_last; ++t) {
      wait_tile(t);
      turn_wait();
      wg_fence();
      issue_s(s, t);
      wg_commit();
      issue_pv(pa, t - 1);
      wg_commit();
      turn_pass();
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile t is in
      reg_fence(s);
      kp0 = k_lo + t * BKV;
      wg_softmax<BKV>(s, kp0, kp0 >= lo_max && kp0 + BKV <= hi_min, lo, hi, qd, sc, m, l, alpha);
      wg_wait_all();  // PV of tile t-1 is in; its P registers and its stage are free
#pragma unroll
      for (int c = 0; c < NCH; ++c) reg_fence(o[c]);
      reg_fence_u32(pa);
      release(t - 1);
      rescale(alpha);
      wg_pack<BKV>(pa, s);
    }
    turn_wait();
    wg_fence();
    issue_pv(pa, t_last);
    wg_commit();
    turn_pass();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NCH; ++c) reg_fence(o[c]);
    reg_fence_u32(pa);
    release(t_last);
    t = t_last + 1;
  }
  for (; t < n_tiles; ++t) {  // tiles past this warpgroup's rows
    wait_tile(t);
    turn_wait();
    turn_pass();
    release(t);
  }
  if constexpr (NWG == 2) {
    if (t_first > t_last) {  // no live tile: the turn of the final product
      turn_wait();
      turn_pass();
    }
    if (wg == 0) named_sync(1);  // warpgroup 1's last hand-over
  }

  // row sums across the quad, normalise, store bf16 pairs; l == 0 gives exact zeros
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(p.o) + (long long)b * p.o_b +
                      (long long)h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= p.Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = ob + (long long)row[r] * p.o_s;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * WG_CHUNK + 8 * j + 2 * qd;
        if (col < p.dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * r] * inv, o[c][4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int pad_head_dim(int d) {
  if (d <= 16) return 16;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  return 0;
}

cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// one thread per query row (block_q < 16)
template <typename T, int DP>
cudaError_t launch_fma_one(const FlashParams& p, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DP, DP>;
  const int kv_rows = p.block_kv > KC ? p.block_kv : KC;
  const size_t smem = (size_t)kv_rows * 2 * DP * sizeof(float);
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + p.block_q - 1) / p.block_q, p.H, p.B);
  kern<<<grid, p.block_q, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const FlashParams& p, cudaStream_t stream) {
  if (p.block_q > MAX_THREADS) return cudaErrorInvalidValue;
  switch (pad_head_dim(p.dh > p.dv ? p.dh : p.dv)) {
    case 16: return launch_fma_one<T, 16>(p, stream);
    case 32: return launch_fma_one<T, 32>(p, stream);
    case 64: return launch_fma_one<T, 64>(p, stream);
    case 128: return launch_fma_one<T, 128>(p, stream);
  }
  return cudaErrorInvalidValue;
}

// bf16, mma.sync (block_q 16..128)
template <int DP>
cudaError_t launch_mma_one(const FlashParams& p, cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<DP, DP>;
  const int kv_rows = p.block_kv > KCH ? p.block_kv : KCH;
  const size_t smem = (size_t)kv_rows * 2 * (DP + 8) * sizeof(__nv_bfloat16);
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return e;
  FlashParams pv = p;
  pv.vec_ok = (p.dh % 8 == 0 && p.dv % 8 == 0 && p.k_b % 8 == 0 && p.k_s % 8 == 0 &&
               p.k_h % 8 == 0 && p.v_b % 8 == 0 && p.v_s % 8 == 0 && p.v_h % 8 == 0 &&
               aligned16(p.k) && aligned16(p.v))
                  ? 1
                  : 0;
  const dim3 grid((p.Sq + p.block_q - 1) / p.block_q, p.H, p.B);
  kern<<<grid, p.block_q * 2, smem, stream>>>(pv);  // a warp per 16 query rows
  return cudaGetLastError();
}

cudaError_t launch_mma(const FlashParams& p, cudaStream_t stream) {
  if (p.block_q < 16 || p.block_q * 2 > MMA_MAX_THREADS || (p.block_q & (p.block_q - 1)) != 0)
    return cudaErrorInvalidValue;
  switch (pad_head_dim(p.dh > p.dv ? p.dh : p.dv)) {
    case 16: return launch_mma_one<16>(p, stream);
    case 32: return launch_mma_one<32>(p, stream);
    case 64: return launch_mma_one<64>(p, stream);
    case 128: return launch_mma_one<128>(p, stream);
  }
  return cudaErrorInvalidValue;
}

// fp32, register tiles (block_q 16..64, block_kv 16..64)
template <int RN, int DP>
cudaError_t launch_tiled_one(const FlashParams& p, cudaStream_t stream) {
  auto kern = flash_fwd_tiled_kernel<RN, DP>;
  constexpr int BKV = TL_TC * RN;
  const size_t smem =
      ((size_t)p.block_q * (DP + 4) + 4 * (size_t)BKV * (DP + 4) + (size_t)p.block_q * (BKV + 4)) *
      sizeof(float);
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return e;
  FlashParams pv = p;
  pv.vec_ok = (p.dh % 4 == 0 && p.dv % 4 == 0 && p.q_b % 4 == 0 && p.q_s % 4 == 0 &&
               p.q_h % 4 == 0 && p.k_b % 4 == 0 && p.k_s % 4 == 0 && p.k_h % 4 == 0 &&
               p.v_b % 4 == 0 && p.v_s % 4 == 0 && p.v_h % 4 == 0 && aligned16(p.q) &&
               aligned16(p.k) && aligned16(p.v))
                  ? 1
                  : 0;
  const dim3 grid(p.H, p.B, (p.Sq + p.block_q - 1) / p.block_q);
  kern<<<grid, p.block_q * TL_TC / TL_RM, smem, stream>>>(pv);
  return cudaGetLastError();
}

template <int RN>
cudaError_t launch_tiled_dp(const FlashParams& p, cudaStream_t stream) {
  switch (pad_head_dim(p.dh > p.dv ? p.dh : p.dv)) {
    case 16: return launch_tiled_one<RN, 16>(p, stream);
    case 32: return launch_tiled_one<RN, 32>(p, stream);
    case 64: return launch_tiled_one<RN, 64>(p, stream);
    case 128: return launch_tiled_one<RN, 128>(p, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_tiled(const FlashParams& p, cudaStream_t stream) {
  if (p.block_q != 16 && p.block_q != 32 && p.block_q != 64) return cudaErrorInvalidValue;
  switch (p.block_kv) {
    case 16: return launch_tiled_dp<1>(p, stream);
    case 32: return launch_tiled_dp<2>(p, stream);
    case 64: return launch_tiled_dp<4>(p, stream);
  }
  return cudaErrorInvalidValue;
}

// bf16, wgmma + TMA.  cuTensorMapEncodeTiled comes from the driver through the
// runtime's entry-point query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

constexpr int TMA_ENCODE_FAILED = 10000;  // + the CUresult

// A 4-d map over (d, heads, S, B) of a bf16 tensor with element strides
// s_h, s_s, s_b (d contiguous), box (64, 1, rows, 1), 128-byte swizzle,
// zero fill past the edges.  The outer dims go in increasing stride (a dim
// of size 1 last); `order` gets which is which (see tma_load_hsb).
int make_map(CUtensorMap* map, const void* ptr, int d, int heads, int S, int B, long long s_h,
             long long s_s, long long s_b, int rows, int* order) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TMA_ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  const long long dims[3] = {heads, S, B};
  long long strides[3] = {s_h * 2, s_s * 2, s_b * 2};  // bytes
  long long extent = (long long)d * 2;
  for (int i = 0; i < 3; ++i)
    if (dims[i] > 1 && strides[i] * dims[i] > extent) extent = strides[i] * dims[i];
  extent = (extent + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i)
    if (dims[i] == 1) strides[i] = extent;
  int idx[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)  // insertion sort by stride, stable
    for (int j = i; j > 0 && strides[idx[j]] < strides[idx[j - 1]]; --j) {
      const int tmp = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = tmp;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {WG_CHUNK, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = (cuuint64_t)dims[idx[i]];
    gstride[i] = (cuuint64_t)strides[idx[i]];
    if (idx[i] == 1) box[i + 1] = (cuuint32_t)rows;
  }
  *order = idx[0] | (idx[1] << 2) | (idx[2] << 4);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
                            gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE_FAILED + (int)r;
}

template <int NWG, int DP, int BKV>
int launch_wgmma_one(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int4 order;
  int r = make_map(&mq, p.q, p.dh, p.H, p.Sq, p.B, p.q_h, p.q_s, p.q_b, WG_ROWS, &order.x);
  if (r == 0) r = make_map(&mk, p.k, p.dh, p.K, p.Sk, p.B, p.k_h, p.k_s, p.k_b, BKV, &order.y);
  if (r == 0) r = make_map(&mv, p.v, p.dv, p.K, p.Sk, p.B, p.v_h, p.v_s, p.v_b, BKV, &order.z);
  if (r != 0) return r;
  order.w = 0;
  auto kern = flash_fwd_wgmma_kernel<NWG, DP, BKV>;
  constexpr size_t smem = wg_smem_bytes(NWG, DP, BKV);
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.H, p.B, (p.Sq + NWG * WG_ROWS - 1) / (NWG * WG_ROWS));
  kern<<<grid, NWG * 128 + 32, smem, stream>>>(mq, mk, mv, p, order);
  return (int)cudaGetLastError();
}

template <int NWG, int DP>
int launch_wgmma_bkv(const FlashParams& p, cudaStream_t stream) {
  switch (p.block_kv) {
    case 16: return launch_wgmma_one<NWG, DP, 16>(p, stream);
    case 32: return launch_wgmma_one<NWG, DP, 32>(p, stream);
    case 64: return launch_wgmma_one<NWG, DP, 64>(p, stream);
    case 128: return launch_wgmma_one<NWG, DP, 128>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// What TMA takes: 16-byte aligned base, strides of 16 bytes (8 elements) in
// every dim of size > 1.
bool tma_ok(const void* ptr, int heads, int S, int B, long long s_h, long long s_s, long long s_b) {
  return aligned16(ptr) && (heads == 1 || (s_h > 0 && s_h % 8 == 0)) &&
         (S == 1 || (s_s > 0 && s_s % 8 == 0)) && (B == 1 || (s_b > 0 && s_b % 8 == 0));
}

int launch_wgmma(const FlashParams& p, cudaStream_t stream) {
  if ((p.block_q != 64 && p.block_q != 128) || p.dh != p.dv || p.dh % 16 != 0 || p.dh > 128 ||
      p.o_s % 2 != 0 || p.o_h % 2 != 0 || p.o_b % 2 != 0 ||
      reinterpret_cast<uintptr_t>(p.o) % 4 != 0 ||
      !tma_ok(p.q, p.H, p.Sq, p.B, p.q_h, p.q_s, p.q_b) ||
      !tma_ok(p.k, p.K, p.Sk, p.B, p.k_h, p.k_s, p.k_b) ||
      !tma_ok(p.v, p.K, p.Sk, p.B, p.v_h, p.v_s, p.v_b))
    return (int)cudaErrorInvalidValue;
  const bool two = p.block_q == 128;
  if (p.dh <= 64) return two ? launch_wgmma_bkv<2, 64>(p, stream) : launch_wgmma_bkv<1, 64>(p, stream);
  return two ? launch_wgmma_bkv<2, 128>(p, stream) : launch_wgmma_bkv<1, 128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are in
// elements; the last dimension of every tensor is contiguous.  kernel: 0 = one
// thread per query row (block_q < 16, either type), 1 = mma.sync (bf16,
// block_q 16..128), 2 = wgmma + TMA (bf16, block_q 64 or 128, dh == dv a
// multiple of 16 up to 128, TMA-aligned), 3 = register tiles (fp32, block_q
// and block_kv 16..64).  A call the named kernel cannot take returns
// cudaErrorInvalidValue.  Returns the cudaError_t of the launch (0 =
// launched), or 10000 + the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                                   int B, int Sq, int Sk, int H, int K, int dh, int dv,
                                   long long q_b, long long q_s, long long q_h, long long k_b,
                                   long long k_s, long long k_h, long long v_b, long long v_s,
                                   long long v_h, long long o_b, long long o_s, long long o_h,
                                   float scale, int causal, int window, int block_q, int block_kv,
                                   int kernel, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;  // nothing to compute
  if (block_q < 1 || block_kv < 1 || K < 1 || H % K != 0 || pad_head_dim(dh) == 0 ||
      pad_head_dim(dv) == 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.K = K; p.dh = dh; p.dv = dv;
  p.q_b = q_b; p.q_s = q_s; p.q_h = q_h;
  p.k_b = k_b; p.k_s = k_s; p.k_h = k_h;
  p.v_b = v_b; p.v_s = v_s; p.v_h = v_h;
  p.o_b = o_b; p.o_s = o_s; p.o_h = o_h;
  p.scale = scale; p.causal = causal; p.window = window;
  p.block_q = block_q; p.block_kv = block_kv;
  p.vec_ok = 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kernel == 0 && dtype == 0) return (int)launch_fma<float>(p, st);
  if (kernel == 0 && dtype == 1) return (int)launch_fma<__nv_bfloat16>(p, st);
  if (kernel == 1 && dtype == 1) return (int)launch_mma(p, st);
  if (kernel == 2 && dtype == 1) return launch_wgmma(p, st);
  if (kernel == 3 && dtype == 0) return (int)launch_tiled(p, st);
  return (int)cudaErrorInvalidValue;
}
