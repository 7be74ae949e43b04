// Kernel B: batched SPD factor + solve.
//
//   X[b] = spd[b]^{-1} rhs[b],  spd (n, T, T), rhs (n, T, R), T <= 128
//
// Replaces the TPU kernels of hdpgpc_tpu/ops/pallas/chol_solve.py:
// _chol_solve_kernel_batched (fused_spd_solve, batched=True, with
// _panel_factor_b and _inv_lower_b) and _chol_solve_kernel (the
// grid=(n,) form for n > 32). Every step of every cluster refit solves
// one stack of SPD systems through it: {S_innov, P_pred, V_int, V_obs}
// against {C P_pred, A P, I, I} for each of up to 4 batched jobs
// (models/gplds.py::make_forward_step).
//
// Bound on this card: latency. The refit launches n = 4 * jobs <= 16
// blocks per step on 132 SMs, and each block runs a dependent chain of
// T pivot steps (two barriers each) and T-long substitutions. The
// flops (T^3 / 3 + 2 T^2 R per system, 0.7 MFLOP at T = 90) are
// nothing next to that; the card stays mostly idle and launch latency
// sets the pace of the step.
//
// Design: one thread block per system. The block loads sym(spd[b]) into
// dynamic shared memory (T*T scalars: 64.8 KB in float64 at T = 90,
// 128 KB at T = 128, above the 48 KB default, hence the
// cudaFuncSetAttribute, made once per device) and factors it in place with an unblocked
// right-looking Cholesky: per pivot, the threads scale the column into
// L and a contiguous copy (colk), then update the trailing lower
// triangle with warps over rows and lanes over columns, so that a
// warp touches consecutive addresses and no index needs a division.
// The substitutions run one thread per right-hand-side column, on a
// copy of that column in shared memory beside the factor (as many
// columns at once as there are threads, or as fit: 96 in float64 at
// T = 128), reading the factor as a broadcast (all threads read the
// same L[i][k]).
//
// The Pallas kernel's padding to 128, masked rank-1 panel updates and
// one-hot column extraction existed because Mosaic had no dynamic
// slicing; none of that is needed here. No jitter is added: callers
// add theirs. A non-positive (or NaN) pivot marks the system as failed
// and its whole solution is written as NaN, as the plain version
// (ops/linalg.py::chol, then two triangular solves) returns.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 128;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
// dynamic shared memory a block may take on sm_90 (232,448 bytes),
// less room for the kernel's static shared memory
constexpr size_t kMaxDynSmem = 232448 - 2048;

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const scalar_t* __restrict__ spd,
                 const scalar_t* __restrict__ rhs,
                 scalar_t* __restrict__ X, int T, int R, int cw) {
  extern __shared__ unsigned char smem_raw[];
  scalar_t* L = reinterpret_cast<scalar_t*>(smem_raw);   // T * T
  scalar_t* Xs = L + T * T;                               // T * cw
  __shared__ scalar_t colk[kMaxT];
  __shared__ scalar_t dk;
  __shared__ int failed;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int ny = nt >> 5;
  const size_t b = blockIdx.x;
  const scalar_t* A = spd + b * T * T;
  const scalar_t* B = rhs + b * T * R;
  scalar_t* Xb = X + b * T * R;

  if (tid == 0) failed = 0;
  for (int idx = tid; idx < T * T; idx += nt) {
    const int i = idx / T;
    const int j = idx - i * T;
    const scalar_t v = scalar_t(0.5) * (A[idx] + A[j * T + i]);
    L[idx] = v;
    if (idx == 0) dk = v;
  }
  __syncthreads();

  // right-looking Cholesky, two barriers per pivot: (a) scale column k
  // by the pivot's square root into L and colk; (b) update the
  // trailing lower triangle from colk, warps over rows and lanes over
  // columns (conflict-free), thread 0 handing the next pivot over in dk
  for (int k = 0; k < T; ++k) {
    const scalar_t d = dk;
    const scalar_t s = sqrt(d);
    if (tid == 0 && !(d > scalar_t(0))) failed = 1;
    for (int i = k + tid; i < T; i += nt) {
      const scalar_t v = (i == k) ? s : L[i * T + k] / s;
      L[i * T + k] = v;
      colk[i] = v;
    }
    __syncthreads();
    for (int i = k + 1 + ty; i < T; i += ny) {
      const scalar_t li = colk[i];
      for (int j = k + 1 + tx; j <= i; j += 32) {
        const scalar_t v = L[i * T + j] - li * colk[j];
        L[i * T + j] = v;
        if (i == k + 1 && j == k + 1) dk = v;
      }
    }
    __syncthreads();
  }

  // substitutions, one thread per right-hand-side column, on a copy of
  // the column in shared memory (column slot tid of Xs; no other thread
  // touches it, so no barrier is needed)
  const bool bad = failed != 0;
  if (tid >= cw) return;
  for (int j = tid; j < R; j += cw) {
    scalar_t* x = Xs + tid;
    for (int i = 0; i < T; ++i) x[i * cw] = B[i * R + j];
    if (bad) {
      for (int i = 0; i < T; ++i) x[i * cw] = nan("");
    } else {
      for (int i = 0; i < T; ++i) {
        scalar_t acc = x[i * cw];
        for (int k = 0; k < i; ++k) acc -= L[i * T + k] * x[k * cw];
        x[i * cw] = acc / L[i * T + i];
      }
      for (int i = T - 1; i >= 0; --i) {
        scalar_t acc = x[i * cw];
        for (int k = i + 1; k < T; ++k) acc -= L[k * T + i] * x[k * cw];
        x[i * cw] = acc / L[i * T + i];
      }
    }
    for (int i = 0; i < T; ++i) Xb[i * R + j] = x[i * cw];
  }
}

template <typename scalar_t>
int launch(const void* spd, const void* rhs, void* x, int n, int T, int R,
           void* stream) {
  if (n <= 0 || T <= 0 || R <= 0 || T > kMaxT)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t fac = static_cast<size_t>(T) * T * sizeof(scalar_t);
  // right-hand-side columns staged at once: as many as there are
  // threads, or as the shared memory left beside the factor holds
  // (96 in float64 at T = 128), in whole warps
  size_t cw =
      (kMaxDynSmem - fac) / (static_cast<size_t>(T) * sizeof(scalar_t));
  if (cw > static_cast<size_t>(kThreads)) cw = kThreads;
  cw -= cw % 32;
  const size_t smem = fac + static_cast<size_t>(T) * cw * sizeof(scalar_t);
  if (smem > kDefaultSmem) {
    // raised once per device to the most any T needs, not per launch
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(spd_solve_kernel<scalar_t>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxDynSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
  }
  spd_solve_kernel<scalar_t><<<n, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const scalar_t*>(spd), static_cast<const scalar_t*>(rhs),
      static_cast<scalar_t*>(x), T, R, static_cast<int>(cw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the largest T the kernel takes; the Python wrapper reads it from here
extern "C" int spd_solve_max_t() { return kMaxT; }

extern "C" int spd_solve_f32(const void* spd, const void* rhs, void* x,
                             int n, int T, int R, void* stream) {
  return launch<float>(spd, rhs, x, n, T, R, stream);
}

extern "C" int spd_solve_f64(const void* spd, const void* rhs, void* x,
                             int n, int T, int R, void* stream) {
  return launch<double>(spd, rhs, x, n, T, R, stream);
}
