// Kernel B: batched SPD factor + solve, blocked, any T.
//
//   X[b] = sym(spd[b])^{-1} rhs[b],  spd (n, T, T), rhs (n, T, R)
//
// Replaces the TPU kernels of hdpgpc_tpu/ops/pallas/chol_solve.py:
// _chol_solve_kernel_batched (fused_spd_solve, batched=True, with
// _panel_factor_b and _inv_lower_b; pallas_call at :295) and
// _chol_solve_kernel (the grid=(n,) form for n > 32, :313). Every step
// of every cluster refit solves one stack of SPD systems through it:
// {S_innov, P_pred, V_int, V_obs} against {C P_pred, A P, I, I} for
// each of up to 4 batched jobs (models/gplds.py::make_forward_step).
//
// What bounds it. At the refit's shape (16, 90, 90) the work is
// T^3/3 + 2 T^2 R = 1.70 MFLOP per system, 27.2 MFLOP in all, and the
// bytes are spd and rhs read once and X written once: 1.56 MB in
// float32, 3.11 MB in float64. At 3.35 TB/s and 67 TFLOP/s that is a
// bound of 0.46 us (float32) and 0.93 us (float64), set by the bytes.
// In practice the time is latency: one block per system (16 blocks on
// 132 SMs), and inside a block a chain of dependent steps, of which the
// longest is the diagonal blocks' pivots (T of them, one warp). An
// unblocked kernel adds two block barriers per pivot, and a
// substitution with one thread per right-hand-side column a chain of
// ~T^2 dependent multiply-adds per thread.
//
// Design: what the TPU kernel does (blocked factor, inverted diagonal
// blocks, substitutions as small products), with blocks of this card.
// One block of 256 threads per system.
// * Load: sym(spd[b]) is read with coalesced 16-byte loads of the flat
//   matrix, 8 per thread in flight (scalar loads where the system's
//   base is not 16-byte aligned), into a Tp x Tp tile, Tp = T rounded
//   up to the panel width kNB = 32, then symmetrised in place. The
//   padding is an identity block (as the Pallas kernel pads to 128), so
//   no tile is ragged and the padded rows of the solution are zero.
// * Blocked right-looking Cholesky, panel width 32: one warp (32
//   lanes, one row each) matches a 32 x 32 diagonal block, and 32
//   keeps the panels, and so the block barriers, few (3 panels at
//   T = 90; four barriers each). Per panel:
//   - warp 0 factors the diagonal block in registers (pivots by
//     rsqrt, no block barrier), in loops over its columns that are not
//     unrolled; each finished column is broadcast through shared memory
//     and read back with 16-byte loads, and the next pivot is shuffled
//     out before that broadcast. A lone warp issues slowly, so the loop
//     body is kept short: no selects, and only the columns still in the
//     block are updated (see factor_columns). A
//     non-positive or NaN pivot sets the system's failure flag, which
//     every thread reads after the next barrier;
//   - all 8 warps invert the diagonal block by forward substitution,
//     4 columns each;
//   - the panel below is solved one thread per row and 4 of its
//     columns, as a product with the inverted block (no chain);
//   - the trailing lower triangle is updated by all warps in 4 x 4
//     register tiles. FFMA / DFMA throughout, no tensor cores: float32
//     must not go through TF32.
// * Storage: the factor is kept transposed in the upper triangle of
//   the tile (the off-diagonal blocks as L', the diagonal blocks as
//   their inverses, transposed), so the panel solve and the updates
//   never write what they read in the same phase. The tile's rows are
//   16-byte aligned, so the substitutions read L with 16-byte loads.
//   The finished panel is also staged in shared memory for the
//   trailing update.
// * Substitutions: L Y = B, then L' X = Y, one block row of 32 at a
//   time: an update from the finished rows, then a product with the
//   inverted diagonal block, each thread holding 4 rows x G column
//   groups of 32 in registers (G, 1 to 4, a template parameter); two
//   barriers per block row. The right-hand-side columns are staged in
//   shared memory in chunks of 32 G columns (up to 128; fewer where
//   shared memory is short).
// * Any T. The tile and two right-hand-side buffers stay in shared
//   memory while they fit in the 227 KB a block may use (float32 up to
//   T = 192, float64 up to T = 128). Above that the kernel factors a
//   copy of the system in a global scratch buffer that the wrapper
//   allocates (torch.empty) and passes in, and keeps the staged panel
//   and the right-hand-side chunk in shared memory; only when even one
//   32-column chunk does not fit (T > 448 in float64, T > 896 in
//   float32) do those move to the scratch buffer too.
//
// No jitter is added: callers add theirs. A failed system's whole
// solution is written as NaN, as the plain version (ops/linalg.py::chol,
// then two triangular solves) returns. The algorithm is mirrored step
// by step by ops/spd_solve.py::spd_solve_blocked_plain, and
// tools/kernel_b_phases.py times its phases on the card.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kNB = 32;                    // panel width, one warp
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kNB / kWarps;        // rows of a block row per warp
constexpr int kMaxGroups = 4;              // 32-column groups per chunk
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may take on sm_90 (232,448 bytes),
// less room for the kernel's static shared memory
constexpr size_t kMaxDynSmem = 232448 - 2048;

__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }

// four consecutive values from 16-byte aligned memory
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename scalar_t>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void get(const float4& q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void get(const double2& q, double* v) {
    v[0] = q.x; v[1] = q.y;
  }
};

// sym(A) into the tile M (leading dimension ldm), identity padding
// below and right of T on and below the diagonal. The global loads go
// in batches of kBatch per thread, all in flight before the first store
template <typename scalar_t>
__device__ void load_system(const scalar_t* __restrict__ A, scalar_t* M,
                            int ldm, int T, int Tp) {
  constexpr int kBatch = 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long count = static_cast<long long>(T) * T;
  using V = Vec16<scalar_t>;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(A) & 15) == 0) {
    const long long nv = count / V::n;
    const typename V::type* Av = reinterpret_cast<const typename V::type*>(A);
    // (row, column) of the thread's next element, advanced by the
    // stride without a division per vector
    const long long step = static_cast<long long>(kThreads) * V::n;
    const int di = static_cast<int>(step / T);
    const int dj = static_cast<int>(step - static_cast<long long>(di) * T);
    int i0 = static_cast<int>((static_cast<long long>(tid) * V::n) / T);
    int j0 = static_cast<int>(static_cast<long long>(tid) * V::n -
                              static_cast<long long>(i0) * T);
    for (long long v0 = tid; v0 < nv;
         v0 += static_cast<long long>(kBatch) * kThreads) {
      typename V::type q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long v = v0 + static_cast<long long>(u) * kThreads;
        if (v < nv) q[u] = __ldg(Av + v);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (v0 + static_cast<long long>(u) * kThreads < nv) {
          scalar_t x[V::n];
          V::get(q[u], x);
          int i = i0, j = j0;
#pragma unroll
          for (int e = 0; e < V::n; ++e) {
            M[static_cast<size_t>(i) * ldm + j] = x[e];
            if (++j == T) { j = 0; ++i; }
          }
        }
        i0 += di;
        j0 += dj;
        if (j0 >= T) { j0 -= T; ++i0; }
      }
    }
    done = nv * V::n;
  }
  for (long long idx = done + tid; idx < count; idx += kThreads) {
    const int i = static_cast<int>(idx / T);
    const int j = static_cast<int>(idx - static_cast<long long>(i) * T);
    M[static_cast<size_t>(i) * ldm + j] = __ldg(A + idx);
  }
  for (int i = T + warp; i < Tp; i += kWarps)
    for (int j = lane; j <= i; j += 32)
      M[static_cast<size_t>(i) * ldm + j] = scalar_t(i == j ? 1 : 0);
  __syncthreads();
  for (int i = 1 + warp; i < T; i += kWarps)
    for (int j = lane; j < i; j += 32) {
      const size_t lo = static_cast<size_t>(i) * ldm + j;
      M[lo] = scalar_t(0.5) * (M[lo] + M[static_cast<size_t>(j) * ldm + i]);
    }
}

// columns [j0, j1) of warp 0's diagonal factor (factor_diagonal): r[0]
// is column j and r[k] column j + k; only the W positions that can
// still lie in the block (j + k <= 31 for every j here) are updated
template <typename scalar_t, int W>
__device__ __forceinline__ void factor_columns(int j0, int j1,
                                               scalar_t (&r)[kNB],
                                               scalar_t& d, bool& bad,
                                               scalar_t* Lc, scalar_t* rd,
                                               scalar_t (*cb)[2 * kNB]) {
  const int i = threadIdx.x & 31;
#pragma unroll 1
  for (int j = j0; j < j1; ++j) {
    bad |= !(d > scalar_t(0));
    const scalar_t rs = rsq(d);
    const scalar_t l = (i > j) ? r[0] * rs : scalar_t(0);   // L[i][j]
    // the next pivot leaves the chain early: lane j + 1 holds L[j+1][j]
    // itself and updates its own diagonal entry (the same operation as
    // its update below) before the column is broadcast
    const scalar_t dn = __shfl_sync(kFull, mad(-l, l, r[1]), (j + 1) & 31);
    Lc[j * kNB + i] = l;
    if (i == j) rd[j] = rs;
    // L[j + k][j] lands at cb[k - 1]; lanes i <= j write past kNB.
    // Two buffers in turn: a lane still reading column j never sees
    // column j + 1 written over it
    scalar_t* buf = cb[j & 1];
    buf[(i - j - 1) & (2 * kNB - 1)] = l;
    __syncwarp();
    scalar_t v[(W + 3) / 4 * 4];
#pragma unroll
    for (int q = 0; q < W; q += 4) load4(buf + q, v + q);
    // every entry of the row is updated, with no select: entries right
    // of the diagonal (column j + k > i) are never read back, since a
    // column's value is masked where it is formed (l above)
#pragma unroll
    for (int k = 1; k <= W; ++k) r[k - 1] = mad(-l, v[k - 1], r[k]);
    d = dn;
  }
}

// warp 0: factor the diagonal block at (k0, k0), lane i holding row i
// in registers, one column per iteration of a loop that is not
// unrolled (unrolled, the 32 x 32 chain is thousands of instructions
// run once per panel), in four quarters whose updates shrink with the
// columns left. The finished column is broadcast through shared
// memory, stored so that the lanes read it back with 16-byte loads
// (cheaper than 31 shuffles of a lone warp). Column j of L goes to
// Lc[j][i] (transposed, conflict-free; 0 on and above the diagonal),
// 1 / L[j][j] to rd[j]. Returns true on a non-positive or NaN pivot
// (the same in every lane).
template <typename scalar_t>
__device__ bool factor_diagonal(const scalar_t* M, int ldm, int k0,
                                scalar_t* Lc, scalar_t* rd,
                                scalar_t (*cb)[2 * kNB]) {
  const int i = threadIdx.x & 31;
  scalar_t r[kNB];
  const scalar_t* row = M + static_cast<size_t>(k0 + i) * ldm + k0;
#pragma unroll
  for (int c = 0; c < kNB; c += 4) load4(row + c, r + c);
  bool bad = false;
  scalar_t d = __shfl_sync(kFull, r[0], 0);
  factor_columns<scalar_t, 31>(0, 8, r, d, bad, Lc, rd, cb);
  factor_columns<scalar_t, 23>(8, 16, r, d, bad, Lc, rd, cb);
  factor_columns<scalar_t, 15>(16, 24, r, d, bad, Lc, rd, cb);
  factor_columns<scalar_t, 7>(24, 32, r, d, bad, Lc, rd, cb);
  return bad;
}

// all warps: the inverse of the factored diagonal block (Lc, rd) by
// forward substitution, warp w taking columns w, w + 8, w + 16, w + 24
// (lane i holds row i of each); written transposed into the block's
// upper triangle, zeros below
template <typename scalar_t>
__device__ void invert_diagonal(scalar_t* M, int ldm, int k0,
                                const scalar_t* Lc, const scalar_t* rd) {
  const int i = threadIdx.x & 31, warp = threadIdx.x >> 5;
  scalar_t x[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
    x[t] = scalar_t(i == warp + kWarps * t ? 1 : 0);
  // step m: row m is final once scaled; rows below take it out
#pragma unroll 4
  for (int m = warp; m < kNB; ++m) {
    const scalar_t lim = Lc[m * kNB + i];
    const scalar_t rm = rd[m];
    // lim = L[i][m] is stored as 0 for i <= m, so rows at and above m
    // are left as they are without a predicate
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      if (i == m) x[t] *= rm;
      const scalar_t xm = __shfl_sync(kFull, x[t], m);
      x[t] = mad(-lim, xm, x[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int c = warp + kWarps * t;
    M[static_cast<size_t>(k0 + c) * ldm + k0 + i] =
        (c <= i) ? x[t] : scalar_t(0);
  }
}

// rows [k1, Tp) of the panel: L21 = A21 Linv', one thread per row and
// 4 of its columns; written transposed into the upper triangle, and into the
// staged panel P (kNB x Tp) for the trailing update
template <typename scalar_t>
__device__ void solve_panel(scalar_t* M, int ldm, scalar_t* P, int k0,
                            int Tp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k1 = k0 + kNB;
  for (int rb = k1; rb < Tp; rb += 32) {
    const int i = rb + lane;
    scalar_t a[kNB];
    const scalar_t* row = M + static_cast<size_t>(i) * ldm + k0;
#pragma unroll
    for (int m = 0; m < kNB; m += 4) load4(row + m, a + m);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int j = warp + kWarps * t;
      const scalar_t* inv = M + static_cast<size_t>(k0) * ldm + k0 + j;
      scalar_t acc = scalar_t(0);
#pragma unroll
      for (int m = 0; m < kNB; ++m)
        acc = mad(a[m], inv[static_cast<size_t>(m) * ldm], acc);
      M[static_cast<size_t>(k0 + j) * ldm + i] = acc;
      P[static_cast<size_t>(j) * Tp + (i - k1)] = acc;
    }
  }
}

// A22 -= L21 L21' on and below the diagonal, 4 x 4 tiles per thread
template <typename scalar_t>
__device__ void update_trailing(scalar_t* M, int ldm, const scalar_t* P,
                                int k1, int Tp) {
  const int S4 = (Tp - k1) / 4;
  const int ntiles = S4 * (S4 + 1) / 2;
  for (int t = threadIdx.x; t < ntiles; t += kThreads) {
    int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > t) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int tj = t - ti * (ti + 1) / 2;
    scalar_t acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = scalar_t(0);
#pragma unroll 4
    for (int m = 0; m < kNB; ++m) {
      scalar_t u[4], v[4];
      load4(P + static_cast<size_t>(m) * Tp + 4 * ti, u);
      load4(P + static_cast<size_t>(m) * Tp + 4 * tj, v);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = mad(u[a], v[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (ti != tj || a >= b) {
          scalar_t* p = M + static_cast<size_t>(k1 + 4 * ti + a) * ldm +
                        k1 + 4 * tj + b;
          *p = *p - acc[a][b];
        }
  }
}

// acc[t][g] = sum over m in [m0, m1) of L(m, r_t) V[m][c_g] for the
// block row at k0 (r_t = k0 + 4 warp + t, c_g = lane + 32 g): with
// kTrans false L(m, r) is the stored M[m][r], with kTrans true M[r][m].
// Four steps of m at a time, so that L comes in 16-byte loads (the
// tile's rows are 16-byte aligned)
template <typename scalar_t, bool kTrans, int G>
__device__ __forceinline__ void block_product(const scalar_t* M, int ldm,
                                              int k0, const scalar_t* V,
                                              int m0, int m1,
                                              scalar_t acc[kRows][G]) {
  constexpr int cw = 32 * G;
  const int lane = threadIdx.x & 31;
  const int r0 = k0 + kRows * (threadIdx.x >> 5);
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[t][g] = scalar_t(0);
#pragma unroll 2
  for (int m = m0; m < m1; m += 4) {
    scalar_t l[kRows][4];   // l[t][u] = L(m + u, r0 + t)
    if (kTrans) {
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        load4(M + static_cast<size_t>(r0 + t) * ldm + m, l[t]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        scalar_t q[kRows];
        load4(M + static_cast<size_t>(m + u) * ldm + r0, q);
#pragma unroll
        for (int t = 0; t < kRows; ++t) l[t][u] = q[t];
      }
    }
    scalar_t v[4][G];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[u][g] = V[static_cast<size_t>(m + u) * cw + lane + 32 * g];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int t = 0; t < kRows; ++t)
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[t][g] = mad(l[t][u], v[u][g], acc[t][g]);
  }
}

// W[r_t][c_g] = acc (kSub false) or W[r_t][c_g] - acc (kSub true)
template <typename scalar_t, bool kSub, int G>
__device__ __forceinline__ void store_rows(scalar_t* W, int k0,
                                           const scalar_t acc[kRows][G]) {
  constexpr int cw = 32 * G;
  const int lane = threadIdx.x & 31;
  const int r0 = k0 + kRows * (threadIdx.x >> 5);
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      scalar_t* p = W + static_cast<size_t>(r0 + t) * cw + lane + 32 * g;
      *p = kSub ? *p - acc[t][g] : acc[t][g];
    }
}

// L Y = B, then L' X = Y, for the right-hand sides in chunks of 32 G
// columns staged in Bs (then X) and Ys
template <typename scalar_t, int G>
__device__ void substitute(const scalar_t* M, int ldm, int Tp, scalar_t* Bs,
                           scalar_t* Ys, const scalar_t* __restrict__ Bg,
                           scalar_t* __restrict__ Xg, int T, int R) {
  constexpr int cw = 32 * G;
  constexpr int kBatch = 4;   // rows of loads in flight per thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  scalar_t acc[kRows][G];
  for (int c0 = 0; c0 < R; c0 += cw) {
    // Tp / kWarps is a multiple of kBatch: every row below is < Tp
    for (int i0 = warp; i0 < Tp; i0 += kBatch * kWarps) {
      scalar_t q[kBatch][G];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int i = i0 + u * kWarps, c = c0 + lane + 32 * g;
          q[u][g] = (i < T && c < R)
                        ? __ldg(Bg + static_cast<size_t>(i) * R + c)
                        : scalar_t(0);
        }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          Bs[static_cast<size_t>(i0 + u * kWarps) * cw + lane + 32 * g] =
              q[u][g];
    }
    __syncthreads();
    // L Y = B: R_p = B_p - L[p, :k0] Y[:k0], then Y_p = Linv_p R_p
    for (int k0 = 0; k0 < Tp; k0 += kNB) {
      block_product<scalar_t, false, G>(M, ldm, k0, Ys, 0, k0, acc);
      store_rows<scalar_t, true, G>(Bs, k0, acc);
      __syncthreads();
      block_product<scalar_t, false, G>(M, ldm, k0, Bs, k0, k0 + kNB, acc);
      store_rows<scalar_t, false, G>(Ys, k0, acc);
      __syncthreads();
    }
    // L' X = Y: R_p = Y_p - L[k1:, p]' X[k1:], then X_p = Linv_p' R_p
    for (int k0 = Tp - kNB; k0 >= 0; k0 -= kNB) {
      block_product<scalar_t, true, G>(M, ldm, k0, Bs, k0 + kNB, Tp, acc);
      store_rows<scalar_t, true, G>(Ys, k0, acc);
      __syncthreads();
      block_product<scalar_t, true, G>(M, ldm, k0, Ys, k0, k0 + kNB, acc);
      store_rows<scalar_t, false, G>(Bs, k0, acc);
      __syncthreads();
    }
    for (int i = warp; i < T; i += kWarps)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = lane + 32 * g;
        if (c0 + c < R)
          Xg[static_cast<size_t>(i) * R + c0 + c] =
              Bs[static_cast<size_t>(i) * cw + c];
      }
    __syncthreads();
  }
}

// the tile's leading dimension in shared memory: 16-byte aligned rows
template <typename scalar_t>
__host__ __device__ constexpr int resident_ld(int Tp) {
  return Tp + 16 / static_cast<int>(sizeof(scalar_t));
}

// kResident: the tile lives in shared memory; otherwise in work +
// b * wstride (leading dimension Tp), with the right-hand-side buffers
// after it when rhs_global is set. The staged panel and the diagonal
// block's factor share the right-hand-side buffers' room while the
// system is factored
template <typename scalar_t, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
spd_solve_kernel(const scalar_t* __restrict__ spd,
                 const scalar_t* __restrict__ rhs, scalar_t* __restrict__ X,
                 scalar_t* work, long long wstride, int T, int R, int Tp,
                 int G, int rhs_global) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ scalar_t rd[kNB];   // the diagonal block's 1 / L[j][j]
  __shared__ __align__(16) scalar_t cb[2][2 * kNB];   // column broadcast
  __shared__ int failed;
  scalar_t* sm = reinterpret_cast<scalar_t*>(smem_raw);
  const size_t b = blockIdx.x;
  const int ldm = kResident ? resident_ld<scalar_t>(Tp) : Tp;
  scalar_t* M = kResident ? sm : work + b * wstride;
  scalar_t* Bs = kResident ? sm + static_cast<size_t>(Tp) * ldm
                           : (rhs_global ? M + static_cast<size_t>(Tp) * Tp
                                         : sm);
  scalar_t* Ys = Bs + static_cast<size_t>(Tp) * 32 * G;
  scalar_t* P = Bs;                                     // kNB x Tp
  scalar_t* Lc = Bs + static_cast<size_t>(kNB) * Tp;   // kNB x kNB
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const scalar_t* Bg = rhs + b * T * R;
  scalar_t* Xg = X + b * T * R;

  if (tid == 0) failed = 0;
  load_system(spd + b * T * T, M, ldm, T, Tp);
  __syncthreads();

  for (int k0 = 0; k0 < Tp; k0 += kNB) {
    if (warp == 0 && factor_diagonal(M, ldm, k0, Lc, rd, cb) && lane == 0)
      failed = 1;
    __syncthreads();
    if (failed) break;
    invert_diagonal(M, ldm, k0, Lc, rd);
    __syncthreads();
    const int k1 = k0 + kNB;
    if (k1 == Tp) break;
    solve_panel(M, ldm, P, k0, Tp);
    __syncthreads();
    update_trailing(M, ldm, P, k1, Tp);
    __syncthreads();
  }

  if (failed) {
    const scalar_t qnan = scalar_t(NAN);
    for (size_t idx = tid; idx < static_cast<size_t>(T) * R; idx += kThreads)
      Xg[idx] = qnan;
    return;
  }
  switch (G) {
    case 1: substitute<scalar_t, 1>(M, ldm, Tp, Bs, Ys, Bg, Xg, T, R); break;
    case 2: substitute<scalar_t, 2>(M, ldm, Tp, Bs, Ys, Bg, Xg, T, R); break;
    case 3: substitute<scalar_t, 3>(M, ldm, Tp, Bs, Ys, Bg, Xg, T, R); break;
    default: substitute<scalar_t, 4>(M, ldm, Tp, Bs, Ys, Bg, Xg, T, R);
  }
}

struct Plan {
  bool resident;
  int G;
  size_t smem;
  long long work;   // scratch elements per system
  bool rhs_global;
};

// resident if the tile and two chunk buffers of at least 32 columns fit
// in shared memory; else the tile in scratch, and the chunk buffers in
// shared memory while 32 columns fit
template <typename scalar_t>
Plan make_plan(int T, int R) {
  const size_t s = sizeof(scalar_t);
  const size_t Tp = (static_cast<size_t>(T) + kNB - 1) / kNB * kNB;
  int want = (R + 31) / 32;
  if (want > kMaxGroups) want = kMaxGroups;
  const size_t ld = resident_ld<scalar_t>(static_cast<int>(Tp));
  for (int G = want; G >= 1; --G) {
    const size_t need = (Tp * ld + 2 * Tp * 32 * G) * s;
    if (need <= kMaxDynSmem) return {true, G, need, 0, false};
  }
  const long long tile = static_cast<long long>(Tp) * Tp;
  for (int G = want; G >= 1; --G) {
    const size_t need = 2 * Tp * 32 * G * s;
    if (need <= kMaxDynSmem) return {false, G, need, tile, false};
  }
  return {false, want, 0,
          tile + 2 * static_cast<long long>(Tp) * 32 * want, true};
}

template <typename scalar_t, bool kResident>
cudaError_t raise_smem_limit() {
  // raised once per device and instantiation to the most any T needs
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(spd_solve_kernel<scalar_t, kResident>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxDynSmem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}

template <typename scalar_t>
int launch(const void* spd, const void* rhs, void* x, void* work, int n,
           int T, int R, void* stream) {
  if (n <= 0 || T <= 0 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan<scalar_t>(T, R);
  if (p.work > 0 && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Tp = (T + kNB - 1) / kNB * kNB;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const scalar_t* a = static_cast<const scalar_t*>(spd);
  const scalar_t* bb = static_cast<const scalar_t*>(rhs);
  scalar_t* xx = static_cast<scalar_t*>(x);
  scalar_t* w = static_cast<scalar_t*>(work);
  cudaError_t err;
  if (p.resident) {
    err = raise_smem_limit<scalar_t, true>();
    if (err != cudaSuccess) return static_cast<int>(err);
    spd_solve_kernel<scalar_t, true><<<n, kThreads, p.smem, st>>>(
        a, bb, xx, nullptr, 0, T, R, Tp, p.G, 0);
  } else {
    err = raise_smem_limit<scalar_t, false>();
    if (err != cudaSuccess) return static_cast<int>(err);
    spd_solve_kernel<scalar_t, false><<<n, kThreads, p.smem, st>>>(
        a, bb, xx, w, p.work, T, R, Tp, p.G, p.rhs_global ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch elements per system that the launch needs in `work` (0 when
// the system fits in shared memory); the wrapper allocates n times this
extern "C" long long spd_solve_work_f32(int T, int R) {
  return make_plan<float>(T, R).work;
}

extern "C" long long spd_solve_work_f64(int T, int R) {
  return make_plan<double>(T, R).work;
}

extern "C" int spd_solve_f32(const void* spd, const void* rhs, void* x,
                             void* work, int n, int T, int R, void* stream) {
  return launch<float>(spd, rhs, x, work, n, T, R, stream);
}

extern "C" int spd_solve_f64(const void* spd, const void* rhs, void* x,
                             void* work, int n, int T, int R, void* stream) {
  return launch<double>(spd, rhs, x, work, n, T, R, stream);
}
