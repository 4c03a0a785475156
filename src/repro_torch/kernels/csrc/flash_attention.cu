// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of the
// reference package (src/repro/kernels/flash_attention.py).  Same function:
// tiled online-softmax attention, GQA by index (kv head = h / (H/K)), causal
// masking with offset Sk - Sq, sliding window (causal, and |k - q| < w when
// not causal), positional masks only, m / l / acc in fp32, and exact zeros
// for a query row that attends nothing.
//
// What differs from the TPU kernel, and why:
//  * Blocks run in no order, so the KV loop is inside the block: grid
//    (cdiv(Sq, block_q), H, B), with the q rows, m, l and the output
//    accumulator in registers and K and V tiles of block_kv rows staged in
//    shared memory.
//  * The tile range comes from the mask geometry, so a dead tile is never
//    loaded, and a thread (a warp, in the tensor-core kernel) skips the key
//    chunks its own rows cannot see.
//  * Tensors are read in their (B, S, H, d) layout through strides and the
//    ragged edges are masked here; nothing is transposed or padded first.
//
// Bound on this card: at the serving shapes (dh = 64, prompt 512) the work
// is 4*Sq*Sk*dh/2 operations per head against 4 tensors of Sq*dh elements,
// far above the memory line, so the bound is the arithmetic rate.
//
// Two kernels share the geometry above:
//  * flash_fwd_kernel (fp32 inputs, and any type at block_q < 16): one thread
//    per query row, fp32 FMAs (no TF32: the 2e-5 bound needs full fp32), K and
//    V staged as fp32 and read by every thread at the same address (a
//    broadcast, no bank conflict); keys are taken KC at a time so that the
//    accumulator is rescaled once per KC keys and the KC dot products form
//    independent FMA chains.  Its ceiling is the fp32 rate outside the tensor
//    cores.
//  * flash_fwd_mma_kernel (bf16 inputs): one warp per 16 query rows, both
//    products on the tensor cores through mma.sync.m16n8k16 with fp32
//    accumulation.  Q lives in registers as A fragments; K and V are staged
//    row-major in bf16 (16-byte copies where the layout allows) with rows
//    padded by 16 bytes, so that a K fragment is one conflict-free 32-bit
//    load and a V fragment comes transposed out of ldmatrix; the score
//    fragments of two neighbouring 8-key tiles are exactly the A fragment of
//    P for the second product, so P never leaves registers.  P is rounded to bf16 before PV,
//    as the oracle rounds it.  wgmma and TMA are later work.

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
  int vec_ok;  // K and V rows may be read as 16-byte vectors (tensor-core kernel)
};

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

template <int DHP, int DVP>
cudaError_t launch_mma_one(const FlashParams& p, cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<DHP, DVP>;
  const int kv_rows = p.block_kv > KCH ? p.block_kv : KCH;
  const size_t smem = (size_t)kv_rows * (DHP + 8 + DVP + 8) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  FlashParams pv = p;
  pv.vec_ok = (p.dh % 8 == 0 && p.dv % 8 == 0 && p.k_b % 8 == 0 && p.k_s % 8 == 0 &&
               p.k_h % 8 == 0 && p.v_b % 8 == 0 && p.v_s % 8 == 0 && p.v_h % 8 == 0 &&
               reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(p.v) % 16 == 0)
                  ? 1
                  : 0;
  const dim3 grid((p.Sq + p.block_q - 1) / p.block_q, p.H, p.B);
  kern<<<grid, p.block_q * 2, smem, stream>>>(pv);  // a warp per 16 query rows
  return cudaGetLastError();
}

template <int DHP>
cudaError_t launch_mma_dv(const FlashParams& p, int dvp, cudaStream_t stream) {
  switch (dvp) {
    case 16: return launch_mma_one<DHP, 16>(p, stream);
    case 32: return launch_mma_one<DHP, 32>(p, stream);
    case 64: return launch_mma_one<DHP, 64>(p, stream);
    case 128: return launch_mma_one<DHP, 128>(p, stream);
  }
  return cudaErrorInvalidValue;
}

int pad_head_dim(int d) {
  if (d <= 16) return 16;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  return 0;
}

template <typename T, int DHP, int DVP>
cudaError_t launch_one(const FlashParams& p, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DHP, DVP>;
  const int kv_rows = p.block_kv > KC ? p.block_kv : KC;
  const size_t smem = (size_t)kv_rows * (DHP + DVP) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + p.block_q - 1) / p.block_q, p.H, p.B);
  kern<<<grid, p.block_q, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_dv(const FlashParams& p, int dvp, cudaStream_t stream) {
  switch (dvp) {
    case 16: return launch_one<T, DHP, 16>(p, stream);
    case 32: return launch_one<T, DHP, 32>(p, stream);
    case 64: return launch_one<T, DHP, 64>(p, stream);
    case 128: return launch_one<T, DHP, 128>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(const FlashParams& p, cudaStream_t stream) {
  const int dvp = pad_head_dim(p.dv);
  switch (pad_head_dim(p.dh)) {
    case 16: return launch_dv<T, 16>(p, dvp, stream);
    case 32: return launch_dv<T, 32>(p, dvp, stream);
    case 64: return launch_dv<T, 64>(p, dvp, stream);
    case 128: return launch_dv<T, 128>(p, dvp, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_mma(const FlashParams& p, cudaStream_t stream) {
  const int dvp = pad_head_dim(p.dv);
  switch (pad_head_dim(p.dh)) {
    case 16: return launch_mma_dv<16>(p, dvp, stream);
    case 32: return launch_mma_dv<32>(p, dvp, stream);
    case 64: return launch_mma_dv<64>(p, dvp, stream);
    case 128: return launch_mma_dv<128>(p, dvp, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are in
// elements; the last dimension of every tensor is contiguous.  bfloat16 at
// block_q >= 16 (then a power of two, at most 128) takes the tensor-core
// kernel, everything else the fp32 one (block_q at most 256).  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                                   int B, int Sq, int Sk, int H, int K, int dh, int dv,
                                   long long q_b, long long q_s, long long q_h, long long k_b,
                                   long long k_s, long long k_h, long long v_b, long long v_s,
                                   long long v_h, long long o_b, long long o_s, long long o_h,
                                   float scale, int causal, int window, int block_q, int block_kv,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;  // nothing to compute
  if (block_q < 1 || block_q > MAX_THREADS || block_kv < 1 || K < 1 || H % K != 0)
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
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    e = launch_t<float>(p, st);
  } else if (dtype == 1 && block_q >= 16) {
    if (block_q * 2 <= MMA_MAX_THREADS && (block_q & (block_q - 1)) == 0) e = launch_mma(p, st);
  } else if (dtype == 1) {
    e = launch_t<__nv_bfloat16>(p, st);
  }
  return (int)e;
}
