// Kernel A: RBF Gram matrix on a 1-D input grid.
//
//   out[i, j] = c * exp(-0.5 * (x1[i] - x2[j])^2 / l^2)
//
// Replaces the TPU kernel hdpgpc_tpu/ops/pallas/gram.py::_gram_kernel
// (rbf_gram_pallas). The refit path builds every cluster's prior Gram
// K0 through it (models/gplds.py: init_cluster_state,
// apply_kernel_fit).
//
// Bound on this card: stores. Each output costs one exp and 4 flops
// and is written once; the inputs are T1 + T2 scalars. At T = 90 the
// whole call is 64.8 KB of stores in float64, far below what one
// launch's latency covers, so the launch itself sets the time.
//
// Design: one thread per output element in 16 x 16 tiles. A block
// reads its 16 row and 16 column grid points once into shared memory;
// neighbouring threads of a warp write neighbouring columns, so the
// stores coalesce. The arithmetic is written in the same order as the
// plain PyTorch version (ops/kernels.py::rbf_gram): (-0.5 * d^2) / l2,
// exp, times c, with IEEE division and the accurate exp, so the two
// agree to the last bits. c and l are read from device memory (cl[0],
// cl[1]), so a launch never waits for the host. No padding: the ragged
// edge is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

template <typename scalar_t>
__global__ void rbf_gram_kernel(const scalar_t* __restrict__ x1,
                                const scalar_t* __restrict__ x2,
                                const scalar_t* __restrict__ cl,
                                scalar_t* __restrict__ out, int T1, int T2) {
  __shared__ scalar_t xr[kTile];
  __shared__ scalar_t xc[kTile];
  const scalar_t c = cl[0];
  const scalar_t l2 = cl[1] * cl[1];
  const int i = blockIdx.y * kTile + threadIdx.y;
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (threadIdx.y == 0 && j < T2) xc[threadIdx.x] = x2[j];
  if (threadIdx.x == 0 && i < T1) xr[threadIdx.y] = x1[i];
  __syncthreads();
  if (i < T1 && j < T2) {
    const scalar_t d = xr[threadIdx.y] - xc[threadIdx.x];
    const scalar_t z = scalar_t(-0.5) * (d * d);
    out[static_cast<size_t>(i) * T2 + j] = c * exp(z / l2);
  }
}

template <typename scalar_t>
int launch(const void* x1, const void* x2, const void* cl, void* out,
           int T1, int T2, void* stream) {
  if (T1 <= 0 || T2 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(kTile, kTile);
  dim3 grid((T2 + kTile - 1) / kTile, (T1 + kTile - 1) / kTile);
  rbf_gram_kernel<scalar_t><<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const scalar_t*>(x1), static_cast<const scalar_t*>(x2),
      static_cast<const scalar_t*>(cl), static_cast<scalar_t*>(out), T1, T2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rbf_gram_f32(const void* x1, const void* x2, const void* cl,
                            void* out, int T1, int T2, void* stream) {
  return launch<float>(x1, x2, cl, out, T1, T2, stream);
}

extern "C" int rbf_gram_f64(const void* x1, const void* x2, const void* cl,
                            void* out, int T1, int T2, void* stream) {
  return launch<double>(x1, x2, cl, out, T1, T2, stream);
}
