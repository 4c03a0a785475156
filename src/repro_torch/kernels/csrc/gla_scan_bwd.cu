// RWKV-6 wkv (gated linear attention) scan, its gradient, for Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  The reference package's scan (src/repro/kernels/
// gla_scan.py) has no Pallas backward: its custom_vjp recomputes the
// chunked oracle under autograd, and so did the port, where that recompute
// and its own backward took 0.73-0.75 of an RWKV-6 train step's backward.
// This is the exact gradient of the forward's recurrence (csrc/gla_scan.cu):
// zero initial state, an fp32 state S (dk x dv) per (batch, head),
//
//   y_t = r_t^T (S_t + diag(u) k_t v_t^T),   S_{t+1} = diag(w_t) S_t + k_t v_t^T
//
// and, with G_t = dL/dS_t (G_S = 0: the final state is no output),
//
//   G_t   = diag(w_t) G_{t+1} + r_t dy_t^T
//   dr_t  = S_t dy_t + u (.) k_t (v_t . dy_t)
//   dk_t  = G_{t+1} v_t + u (.) r_t (v_t . dy_t)
//   dv_t  = G_{t+1}^T k_t + (r_t . u (.) k_t) dy_t
//   dw_t  = sum_j G_{t+1}[:, j] S_t[:, j]
//   du    = sum over batch and time of r_t (.) k_t (v_t . dy_t)
//
// What bounds it on this card.  Per (batch, head, token) it reads r, k, w,
// v, dy and writes dr, dk, dv, dw: at RWKV-6 3B's width (B=2, S=2048, H=40,
// dk=dv=64) 210 MB in and 168 MB out in f32, 0.113 ms at 3.35 TB/s; the
// sequential recurrence does 12 dk dv operations a token (the state and its
// gradient updated, read for dr, dk, dv and dw), 8.1 GFLOP, 0.120 ms at the
// 67 TFLOP/s fp32 rate.  A single sequential pass per (batch, head), as the
// forward is, would leave most of the 132 SMs idle with 80 (batch, head)
// pairs and do all of that work in its dependency chain, so the sequence is
// cut in chunks of C tokens, as the chunked oracle cuts it:
//
//  1. gla_bwd_states walks the sequence once per (batch, head, column
//     block) in each direction at once (blockIdx.z = 2 b + direction):
//     forward, S = diag(w) S + k v^T, storing S at each chunk's start;
//     backward, G = diag(w) G + r dy^T, storing G at each chunk's end.  The
//     two walks are the same code with (k, v) or (r, dy) and time reversed.
//     A thread keeps 4 x 4 state values and reads its rows of the staged
//     step as 16-byte words; the next stage of steps is fetched, 16 bytes a
//     load, into registers while the current one is computed.  The padded
//     state width and the block's columns are template parameters, so the
//     staging's index arithmetic folds to constants.  These states are the
//     design's own traffic: 2 x 168 MB written and read at C = 16.
//  2. gla_bwd_chunks takes every (batch, head, chunk) tile at once (10,240
//     at the width above and C = 16).  From the chunk's start state S0 and end
//     gradient GE it computes its tokens' dr, dk, dv, dw and a partial du
//     in shared memory, in f32 FFMA: the intra-chunk pairs s < t through
//     the decays exp2(excl_t - cum_s) of the inclusive (cum) and exclusive
//     (excl) cumulative log2-decays, which are <= 0 for every pair kept, so
//     no strong decay overflows; the carried terms through S0 and GE as
//     small products.  A thread owns 4 tokens of one channel (dr, dk) or of
//     one column (dv), so each value read from shared memory feeds 4
//     independent sums; rows of v, dy, S0 and GE are read as 16-byte words
//     (their row stride is 4 mod 8 words: no bank conflict), the others
//     column-wise with an odd stride.
//  3. gla_bwd_du sums the partial du over batch and chunks in a fixed order.
//
// The decay's gradient.  dL/dw_m is the sum over the token pairs s < m < t
// of r_t k_s prod_{s<n<t, n != m} w_n (v_s . dy_t), per channel: the product
// leaves w_m out.  The tile takes it so, from decays before m (s < m) and
// after m (t > m), each the exp2 of a sum of log2-decays <= 0, never as
// (dL/dlog w_m) / w_m.  The reverse cumulative-sum identity over r dr - k dk
// (the chunked oracle's autograd) would cancel terms of order one to leave
// one of order w_m and then divide by w_m: with decays near 0 (w ~ 1e-6) its
// f32 dw is off by 0.15 of the largest (by 1e8 nearer 1e-20), while this
// form is as close to a float64 answer as the other gradients are (a
// chunk's own state before m, carried from m to m + 1 as the state is, does
// it in O(C^2) a channel).  w is clamped at 1e-30 before its log, as in
// the oracle.
//
// Determinism: no atomics; every sum runs in a fixed order, so two calls on
// the same inputs give the same bits.  bf16 inputs are widened on load; the
// gradients are stored in the inputs' type, du in f32.  Nothing here is
// named like the forward's kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIM = 128;       // largest dk and dv
constexpr int WALK_VECS = 8;       // 16-byte words a thread of the state walk fetches a stage
constexpr int TILE_THREADS = 256;  // threads of a chunk tile
constexpr int TOKENS = 4;          // tokens (of one channel or column) a tile thread owns
constexpr int DW_PARTS = 4;        // threads a channel's dw is cut over (by token)
constexpr size_t MAX_SMEM = 232448;
constexpr float MIN_DECAY = 1e-30f;  // w is clamped here before its log, as the oracle does

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

// 4 values of T in one load: 16 bytes of f32, 8 of bf16
template <typename T> struct Word4;
template <> struct Word4<float> { using type = float4; };
template <> struct Word4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 widen4(float4 x) { return x; }
__device__ __forceinline__ float4 widen4(uint2 x) {
  return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
}

// src[0 .. 4) as f32, the first n of them (the rest 0): one load when `word`
// says src is aligned and n >= 4
template <typename T>
__device__ __forceinline__ float4 load4(const T* src, int n, bool word) {
  if (word && n >= 4) return widen4(*reinterpret_cast<const typename Word4<T>::type*>(src));
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = e < n ? to_f32(src[e]) : 0.f;
  return make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

struct BwdParams {
  const void* r;   // (B, S, H, dk)
  const void* k;   // (B, S, H, dk)
  const void* v;   // (B, S, H, dv)
  const void* w;   // (B, S, H, dk)
  const void* dy;  // (B, S, H, dv)
  const float* u;  // (H, dk)
  void* gr;        // dr (B, S, H, dk)
  void* gk;        // dk (B, S, H, dk)
  void* gv;        // dv (B, S, H, dv)
  void* gw;        // dw (B, S, H, dk)
  float* gu;       // du (H, dk)
  float* states;   // (B, H, nc, dk, dv): S at each chunk's first token
  float* dstates;  // (B, H, nc, dk, dv): G after each chunk's last token
  float* du_part;  // (B, nc, H, dk): du of each chunk
  int B, S, H, dk, dv, chunk, nc;
  bool word_rkw;   // rows of r, k, w load as words (aligned, dk % 4 == 0)
  bool word_v;     // so do rows of v, dy (dv % 4 == 0)
};

// ---------------------------------------------------------------------------
// 1. the states at the chunks' boundaries, forward and backward
// ---------------------------------------------------------------------------

// ROWS: dk rounded up to a power of two (>= 8); COLS: columns of the state a
// block owns.  blockIdx.x: column block; blockIdx.y: head; blockIdx.z:
// 2 b + direction (0: S forward from zero with (k, v); 1: G backward from
// zero with (r, dy))
template <typename T, int ROWS, int COLS>
__global__ void __launch_bounds__(ROWS / 4 * (COLS / 4)) gla_bwd_states(const BwdParams p) {
  constexpr int THREADS = ROWS / 4 * (COLS / 4);
  constexpr int WORDS = (2 * ROWS + COLS) / 4;  // a staged step: a, w (ROWS each), b (COLS)
  constexpr int STEPS = WALK_VECS * THREADS / WORDS > 0 ? WALK_VECS * THREADS / WORDS : 1;
  constexpr int STAGE = STEPS * WORDS;  // words a stage
  constexpr int PER = (STAGE + THREADS - 1) / THREADS;
  extern __shared__ float4 walk_smem4[];
  const int dir = blockIdx.z & 1;
  const int b = blockIdx.z >> 1;
  const int h = blockIdx.y;
  const int col0 = blockIdx.x * COLS;
  const int tid = threadIdx.x;
  const int cg = tid % (COLS / 4);  // neighbouring threads: neighbouring columns
  const int rg = tid / (COLS / 4);
  const int sp = p.nc * p.chunk;  // padded length: steps past S carry nothing

  const T* a = reinterpret_cast<const T*>(dir ? p.r : p.k);
  const T* bv = reinterpret_cast<const T*>(dir ? p.dy : p.v);
  const T* w = reinterpret_cast<const T*>(p.w);
  float* out = dir ? p.dstates : p.states;
  const long long bh = (long long)b * p.S * p.H + h;  // (b, t=0, h) in units of a row

  float4 pf[PER];
  // the words of the stage whose first (walk-order) step is tau0, into pf
  auto fetch = [&](int tau0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int idx = tid + q * THREADS;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < STAGE) {
        const int step = idx / WORDS;
        const int slot = idx - step * WORDS;
        const int tau = tau0 + step;
        const int t = dir ? sp - 1 - tau : tau;
        const bool in = tau < sp && t < p.S;
        const long long row = bh + (long long)t * p.H;
        if (slot < ROWS / 4) {
          const int e = 4 * slot;
          if (in) val = load4(a + row * p.dk + e, p.dk - e, p.word_rkw);
        } else if (slot < ROWS / 2) {
          const int e = 4 * (slot - ROWS / 4);
          val = in ? load4(w + row * p.dk + e, p.dk - e, p.word_rkw)
                   : make_float4(1.f, 1.f, 1.f, 1.f);
        } else {
          const int j = col0 + 4 * (slot - ROWS / 2);
          if (in) val = load4(bv + row * p.dv + j, p.dv - j, p.word_v);
        }
      }
      pf[q] = val;
    }
  };
  auto commit = [&](float4* dst) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int idx = tid + q * THREADS;
      if (idx < STAGE) dst[idx] = pf[q];
    }
  };

  float st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[i][j] = 0.f;

  const int nstages = (sp + STEPS - 1) / STEPS;
  fetch(0);
  commit(walk_smem4);
  __syncthreads();
  for (int sg = 0; sg < nstages; ++sg) {
    const float4* cur = walk_smem4 + (sg & 1) * STAGE;
    if (sg + 1 < nstages) fetch((sg + 1) * STEPS);  // in flight during the steps below
    const int tau0 = sg * STEPS;
    const int tn = min(STEPS, sp - tau0);
#pragma unroll 4
    for (int q = 0; q < tn; ++q) {
      const int tau = tau0 + q;
      if ((tau & (p.chunk - 1)) == 0) {  // a boundary: the state before chunk c's first
        // token (forward), the gradient after chunk c's last one (backward)
        const int c = dir ? p.nc - 1 - tau / p.chunk : tau / p.chunk;
        float* o = out + (((long long)b * p.H + h) * p.nc + c) * p.dk * p.dv;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 4 * rg + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = col0 + 4 * cg + j;
            if (row < p.dk && col < p.dv) o[(long long)row * p.dv + col] = st[i][j];
          }
        }
      }
      const float4* srow = cur + q * WORDS;
      const float4 a4 = srow[rg], w4 = srow[ROWS / 4 + rg], b4 = srow[ROWS / 2 + cg];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w},
                  bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = fmaf(wv[i], st[i][j], av[i] * bb[j]);
    }
    if (sg + 1 < nstages) commit(walk_smem4 + ((sg + 1) & 1) * STAGE);
    __syncthreads();  // the next stage is staged; every thread is done with this one
  }
}

// ---------------------------------------------------------------------------
// 2. every (batch, head, chunk) tile
// ---------------------------------------------------------------------------

// row strides: odd for arrays read down a column one word at a time; 4 mod 8
// for arrays whose rows are read as 16-byte words, one row a lane
__host__ __device__ inline int odd(int d) { return d % 2 ? d : d + 1; }
__host__ __device__ inline int quad(int d) {
  const int d4 = (d + 3) / 4 * 4;
  return d4 % 8 ? d4 : d4 + 4;
}

__host__ __device__ inline size_t tile_floats(int C, int dk, int dv) {
  const size_t ks = odd(dk), vs = quad(dv);
  // (C, dv): v, dy; (dk, dv): S0, GE; (C, dk): r, k, cum, excl, Y, X, kt
  // (then a Z), three more Z; (C, C): P, A; u; the bonus r.u.k
  return 2 * C * vs + 2 * (size_t)dk * vs + (6 + DW_PARTS) * C * ks +
         2 * (size_t)C * (C + 1) + dk + C;
}

// blockIdx.x: chunk; blockIdx.y: head; blockIdx.z: batch
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS) gla_bwd_chunks(const BwdParams p) {
  extern __shared__ float4 tile_smem4[];
  const int C = p.chunk, dk = p.dk, dv = p.dv;
  const int ks = odd(dk), vs = quad(dv), ps = C + 1;
  const int dk4 = (dk + 3) / 4, dv4 = (dv + 3) / 4;  // 4-value words a row
  float* V = reinterpret_cast<float*>(tile_smem4);  // rows of 16-byte words first
  float* DY = V + C * vs;
  float* S0 = DY + C * vs;
  float* GE = S0 + dk * vs;
  float* R = GE + dk * vs;
  float* K = R + C * ks;
  float* CUM = K + C * ks;   // log2 decay through token t of the chunk
  float* EXC = CUM + C * ks;  // ... through t - 1
  float* Y = EXC + C * ks;    // (S0 dy_t)_i
  float* X = Y + C * ks;      // (GE v_t)_i
  float* KT = X + C * ks;     // k decayed to the chunk's end; after 3b the first Z
  float* P = KT + DW_PARTS * C * ks;  // P[t][s] = v_s . dy_t, s <= t
  float* A = P + C * ps;    // A[t][s] = sum_i r_t k_s exp2(excl_t - cum_s), s < t
  float* U = A + C * ps;
  float* BN = U + dk;       // r_t . u (.) k_t

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * C;
  const long long bh = (long long)b * p.S * p.H + h;
  const T* rg = reinterpret_cast<const T*>(p.r);
  const T* kg = reinterpret_cast<const T*>(p.k);
  const T* vg = reinterpret_cast<const T*>(p.v);
  const T* wg = reinterpret_cast<const T*>(p.w);
  const T* dyg = reinterpret_cast<const T*>(p.dy);
  const long long sofs = (((long long)b * p.H + h) * p.nc + c) * dk * dv;

  // 0. stage the chunk (zero past S, decay 1 there), the boundary states, u
  for (int idx = tid; idx < C * dk4; idx += TILE_THREADS) {
    const int t = idx / dk4, e = (idx - t * dk4) * 4;
    const int tg = t0 + t;
    float4 rv = make_float4(0.f, 0.f, 0.f, 0.f), kv = rv, wv = make_float4(1.f, 1.f, 1.f, 1.f);
    if (tg < p.S) {
      const long long o = (bh + (long long)tg * p.H) * dk + e;
      rv = load4(rg + o, dk - e, p.word_rkw);
      kv = load4(kg + o, dk - e, p.word_rkw);
      wv = load4(wg + o, dk - e, p.word_rkw);
    }
    const float r4[4] = {rv.x, rv.y, rv.z, rv.w}, k4[4] = {kv.x, kv.y, kv.z, kv.w},
                w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (e + q < dk) {
        R[t * ks + e + q] = r4[q];
        K[t * ks + e + q] = k4[q];
        CUM[t * ks + e + q] = log2f(fmaxf(w4[q], MIN_DECAY));
      }
    }
  }
  for (int idx = tid; idx < C * dv4; idx += TILE_THREADS) {
    const int t = idx / dv4, j = (idx - t * dv4) * 4;
    const int tg = t0 + t;
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f), gv = vv;
    if (tg < p.S) {
      const long long o = (bh + (long long)tg * p.H) * dv + j;
      vv = load4(vg + o, dv - j, p.word_v);
      gv = load4(dyg + o, dv - j, p.word_v);
    }
    reinterpret_cast<float4*>(V + t * vs)[j / 4] = vv;
    reinterpret_cast<float4*>(DY + t * vs)[j / 4] = gv;
  }
  for (int idx = tid; idx < dk * dv4; idx += TILE_THREADS) {
    const int i = idx / dv4, j = (idx - i * dv4) * 4;
    const long long o = sofs + (long long)i * dv + j;
    reinterpret_cast<float4*>(S0 + i * vs)[j / 4] = load4(p.states + o, dv - j, dv % 4 == 0);
    reinterpret_cast<float4*>(GE + i * vs)[j / 4] = load4(p.dstates + o, dv - j, dv % 4 == 0);
  }
  for (int i = tid; i < dk; i += TILE_THREADS) U[i] = p.u[(long long)h * dk + i];
  __syncthreads();

  // 1. cumulative log2-decays, a channel a thread
  for (int i = tid; i < dk; i += TILE_THREADS) {
    float run = 0.f;
    for (int t = 0; t < C; ++t) {
      const float lw = CUM[t * ks + i];
      EXC[t * ks + i] = run;
      run += lw;
      CUM[t * ks + i] = run;
    }
  }
  __syncthreads();

  // 2. the token pairs: P (s <= t), A (s < t), the bonus (s == t)
  for (int idx = tid; idx < C * C; idx += TILE_THREADS) {
    const int t = idx / C, s = idx - t * C;
    if (s > t) continue;
    const float4* v4 = reinterpret_cast<const float4*>(V + s * vs);
    const float4* d4 = reinterpret_cast<const float4*>(DY + t * vs);
    float pv = 0.f;
    for (int j = 0; j < dv4; ++j) pv = dot4(v4[j], d4[j], pv);
    P[t * ps + s] = pv;
    float av = 0.f;
    if (s < t) {
      for (int i = 0; i < dk; ++i)
        av = fmaf(R[t * ks + i] * K[s * ks + i], exp2f(EXC[t * ks + i] - CUM[s * ks + i]), av);
      A[t * ps + s] = av;
    } else {
      for (int i = 0; i < dk; ++i) av = fmaf(R[t * ks + i] * U[i], K[t * ks + i], av);
      BN[t] = av;
    }
  }
  __syncthreads();

  // 3a. dr and dk of tokens tb .. tb + 3, channel i
  const int cend = (C - 1) * ks;
  const int groups = (C + TOKENS - 1) / TOKENS;
  for (int idx = tid; idx < groups * dk; idx += TILE_THREADS) {
    const int tb = idx / dk * TOKENS, i = idx - idx / dk * dk;
    float ys[TOKENS], xs[TOKENS], et[TOKENS], ct[TOKENS], ri[TOKENS], ki[TOKENS];
#pragma unroll
    for (int q = 0; q < TOKENS; ++q) {
      const int t = min(tb + q, C - 1);  // a token past the chunk is computed, never stored
      ys[q] = xs[q] = ri[q] = ki[q] = 0.f;
      et[q] = EXC[t * ks + i];
      ct[q] = CUM[t * ks + i];
    }
    const float4* s0 = reinterpret_cast<const float4*>(S0 + i * vs);
    const float4* ge = reinterpret_cast<const float4*>(GE + i * vs);
    for (int j = 0; j < dv4; ++j) {
      const float4 sa = s0[j], ga = ge[j];
#pragma unroll
      for (int q = 0; q < TOKENS; ++q) {
        const int t = min(tb + q, C - 1);
        ys[q] = dot4(sa, reinterpret_cast<const float4*>(DY + t * vs)[j], ys[q]);
        xs[q] = dot4(ga, reinterpret_cast<const float4*>(V + t * vs)[j], xs[q]);
      }
    }
    for (int s = 0; s < C; ++s) {  // the pairs inside the chunk, both ways
      const float cs = CUM[s * ks + i], kv = K[s * ks + i];
      const float es = EXC[s * ks + i], rv = R[s * ks + i];
#pragma unroll
      for (int q = 0; q < TOKENS; ++q) {
        const int t = tb + q;
        if (t >= C) continue;
        if (s < t) ri[q] = fmaf(exp2f(et[q] - cs) * kv, P[t * ps + s], ri[q]);
        else if (s > t) ki[q] = fmaf(exp2f(es - ct[q]) * rv, P[s * ps + t], ki[q]);
      }
    }
    const float cend_i = CUM[cend + i];
#pragma unroll
    for (int q = 0; q < TOKENS; ++q) {
      const int t = tb + q;
      if (t >= C) continue;
      const float rt = R[t * ks + i], kt = K[t * ks + i];
      const float dec = exp2f(cend_i - ct[q]);
      const float bonus = U[i] * P[t * ps + t];
      Y[t * ks + i] = ys[q];
      X[t * ks + i] = xs[q];
      KT[t * ks + i] = dec * kt;
      const int tg = t0 + t;
      if (tg < p.S) {
        const long long o = (bh + (long long)tg * p.H) * dk + i;
        reinterpret_cast<T*>(p.gr)[o] = from_f32<T>(fmaf(exp2f(et[q]), ys[q], ri[q]) + bonus * kt);
        reinterpret_cast<T*>(p.gk)[o] = from_f32<T>(fmaf(dec, xs[q], ki[q]) + bonus * rt);
      }
    }
  }
  __syncthreads();

  // 3b. dv of tokens sb .. sb + 3, column j
  for (int idx = tid; idx < groups * dv; idx += TILE_THREADS) {
    const int sb = idx / dv * TOKENS, j = idx - idx / dv * dv;
    float acc[TOKENS];
#pragma unroll
    for (int q = 0; q < TOKENS; ++q) acc[q] = 0.f;
    for (int i = 0; i < dk; ++i) {
      const float g = GE[i * vs + j];
#pragma unroll
      for (int q = 0; q < TOKENS; ++q) acc[q] = fmaf(KT[min(sb + q, C - 1) * ks + i], g, acc[q]);
    }
    for (int t = sb + 1; t < C; ++t) {
      const float d = DY[t * vs + j];
#pragma unroll
      for (int q = 0; q < TOKENS; ++q)
        if (t > sb + q) acc[q] = fmaf(A[t * ps + sb + q], d, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < TOKENS; ++q) {
      const int s = sb + q, sg = t0 + s;
      if (s < C && sg < p.S)
        reinterpret_cast<T*>(p.gv)[(bh + (long long)sg * p.H) * dv + j] =
            from_f32<T>(fmaf(BN[s], DY[s * vs + j], acc[q]));
    }
  }
  __syncthreads();

  // 4. dw, a channel and a quarter of the chunk's tokens a thread, and du.
  // dw_m = sum over the pairs s < m < t of c(s, t) / w_m, taken without w_m:
  //   alpha_t = r_t exp2(excl_t - cum_m)        (t > m: the decay after m)
  //   beta_s  = k_s exp2(excl_m - cum_s)        (s < m: the decay before m)
  //   dw_m = sum_{t>m} alpha_t (exp2(excl_m) Y_t + Z_t) + exp2(cum_end - cum_m) Xs
  //        + exp2(excl_m + cum_end - cum_m) sum_j S0 GE
  // with Z_t = sum_{s<m} beta_s P[t][s] (the chunk's own state before m, read
  // by dy_t) and Xs = sum_{s<m} beta_s X_s, both carried from m to m + 1 as
  // the state is (Z_t <- w_m Z_t + k_m P[t][m]).  A thread starts its range of
  // m from Z and Xs summed afresh.
  for (int item = tid; item < DW_PARTS * dk; item += TILE_THREADS) {
    const int q = item / dk, i = item - q * dk;
    const int m0 = q * C / DW_PARTS, m1 = (q + 1) * C / DW_PARTS;
    float* Z = KT + q * C * ks;
    const float cend_i = CUM[cend + i];
    const float4* s0 = reinterpret_cast<const float4*>(S0 + i * vs);
    const float4* ge = reinterpret_cast<const float4*>(GE + i * vs);
    float cross = 0.f;  // pairs across both of the chunk's ends
    for (int j = 0; j < dv4; ++j) cross = dot4(s0[j], ge[j], cross);
    for (int t = m0 + 1; t < C; ++t) Z[t * ks + i] = 0.f;
    float xs = 0.f;
    if (m0 < C) {
      const float e0 = EXC[m0 * ks + i];
      for (int s = 0; s < m0; ++s) {
        const float beta = K[s * ks + i] * exp2f(e0 - CUM[s * ks + i]);
        xs = fmaf(beta, X[s * ks + i], xs);
        for (int t = m0 + 1; t < C; ++t) Z[t * ks + i] = fmaf(beta, P[t * ps + s], Z[t * ks + i]);
      }
    }
    for (int m = m0; m < m1; ++m) {
      const float em = EXC[m * ks + i], cm = CUM[m * ks + i];
      const float before = exp2f(em);
      float acc = 0.f;
      for (int t = m + 1; t < C; ++t) {
        const float alpha = R[t * ks + i] * exp2f(EXC[t * ks + i] - cm);
        acc = fmaf(alpha, fmaf(before, Y[t * ks + i], Z[t * ks + i]), acc);
      }
      const float after = exp2f(cend_i - cm);
      const float dw = fmaf(after, xs, fmaf(before * after, cross, acc));
      const int mg = t0 + m;
      if (mg < p.S)
        reinterpret_cast<T*>(p.gw)[(bh + (long long)mg * p.H) * dk + i] = from_f32<T>(dw);
      const float wm = exp2f(cm - em), km = K[m * ks + i];
      xs = fmaf(wm, xs, km * X[m * ks + i]);
      for (int t = m + 2; t < C; ++t) Z[t * ks + i] = fmaf(wm, Z[t * ks + i], km * P[t * ps + m]);
    }
    if (q == 0) {
      float du = 0.f;
      for (int m = 0; m < C; ++m) du = fmaf(R[m * ks + i] * K[m * ks + i], P[m * ps + m], du);
      p.du_part[(((long long)b * p.nc + c) * p.H + h) * dk + i] = du;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. du: the chunks' partials summed in a fixed order
// ---------------------------------------------------------------------------

__global__ void gla_bwd_du(const BwdParams p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // h * dk + i
  if (idx >= p.H * p.dk) return;
  const long long stride = (long long)p.H * p.dk;
  float acc = 0.f;
  for (long long n = 0; n < (long long)p.B * p.nc; ++n) acc += p.du_part[n * stride + idx];
  p.gu[idx] = acc;
}

template <typename T, int ROWS, int COLS>
cudaError_t launch_states(const BwdParams& p, cudaStream_t stream) {
  constexpr int THREADS = ROWS / 4 * (COLS / 4);
  constexpr int WORDS = (2 * ROWS + COLS) / 4;
  constexpr int STEPS = WALK_VECS * THREADS / WORDS > 0 ? WALK_VECS * THREADS / WORDS : 1;
  const size_t smem = 2 * (size_t)STEPS * WORDS * sizeof(float4);
  auto kern = gla_bwd_states<T, ROWS, COLS>;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.dv + COLS - 1) / COLS, p.H, 2 * p.B);
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the block's columns: the state's width rounded up to a power of two, 32 at most
template <typename T, int ROWS>
cudaError_t launch_cols(const BwdParams& p, cudaStream_t stream) {
  if (p.dv <= 8) return launch_states<T, ROWS, 8>(p, stream);
  if (p.dv <= 16) return launch_states<T, ROWS, 16>(p, stream);
  return launch_states<T, ROWS, 32>(p, stream);
}

template <typename T>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const size_t tile_smem = tile_floats(p.chunk, p.dk, p.dv) * sizeof(float);
  if (tile_smem > MAX_SMEM || p.H > 65535 || 2 * p.B > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gla_bwd_chunks<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile_smem);
  if (e != cudaSuccess) return e;
  if (p.dk <= 8) e = launch_cols<T, 8>(p, stream);
  else if (p.dk <= 16) e = launch_cols<T, 16>(p, stream);
  else if (p.dk <= 32) e = launch_cols<T, 32>(p, stream);
  else if (p.dk <= 64) e = launch_cols<T, 64>(p, stream);
  else e = launch_cols<T, 128>(p, stream);
  if (e != cudaSuccess) return e;
  gla_bwd_chunks<T><<<dim3(p.nc, p.H, p.B), TILE_THREADS, tile_smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gla_bwd_du<<<(p.H * p.dk + 255) / 256, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, dy and dr, dk, dv, dw); u
// and du are float32.  Every tensor is contiguous.  states and dstates hold
// B * H * nc * dk * dv floats, du_part B * nc * H * dk, nc = ceil(S /
// chunk).  dk and dv at most 128; chunk a power of two such that a tile's
// shared memory fits (gla_scan.py's bwd_chunk).  Returns the cudaError_t of
// the launches (0 = launched).
extern "C" int gla_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* dy, void* dr, void* dk, void* dv,
                            void* dw, void* du, void* states, void* dstates, void* du_part,
                            int dtype, int B, int S, int H, int dkd, int dvd, int chunk,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;  // nothing to compute
  if (dkd < 1 || dvd < 1 || dkd > MAX_DIM || dvd > MAX_DIM || chunk < 1 ||
      (chunk & (chunk - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.dy = dy; p.u = reinterpret_cast<const float*>(u);
  p.gr = dr; p.gk = dk; p.gv = dv; p.gw = dw; p.gu = reinterpret_cast<float*>(du);
  p.states = reinterpret_cast<float*>(states);
  p.dstates = reinterpret_cast<float*>(dstates);
  p.du_part = reinterpret_cast<float*>(du_part);
  p.B = B; p.S = S; p.H = H; p.dk = dkd; p.dv = dvd; p.chunk = chunk;
  p.nc = (S + chunk - 1) / chunk;
  const int word = dtype == 1 ? 8 : 16;
  p.word_rkw = aligned(r, word) && aligned(k, word) && aligned(w, word) && dkd % 4 == 0;
  p.word_v = aligned(v, word) && aligned(dy, word) && dvd % 4 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}
