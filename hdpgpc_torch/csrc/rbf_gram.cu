// Kernel A: the GP prior Gram on a (T, D) input grid, in one launch.
//
//   out[i, j] = c * exp(-0.5 * sum_d (x1[i, d] - x2[j, d])^2 / l^2)
//               (+ n if i == j)
//
// x1 (T1, D) and x2 (T2, D) are row-major; a 1-D grid is D = 1.
//
// Replaces the TPU kernel hdpgpc_tpu/ops/pallas/gram.py::_gram_kernel
// (rbf_gram_pallas). The refit path builds every cluster's prior Gram
// K0 through it (models/gplds.py: init_cluster_state,
// apply_kernel_fit), and ops/kernels.py::gram sends every Gram on the
// card here, with the white noise n on the diagonal when asked.
//
// Bound on this card: stores. Each output costs one exp and 3 D + 3
// flops and is written once; the inputs are (T1 + T2) D + 3 scalars. At T = 90
// the whole call is 32.4 KB (float32) or 64.8 KB (float64) of stores,
// about 10-20 ns at 3.35 TB/s, far below one launch's latency, so the
// launch itself sets the time.
//
// Design: what used to be several launches on the host's path (casting
// c and l into a device pair, the Gram, then noise * eye and an add)
// is one launch. c, l and n are read through three device pointers
// (the KernelParams' own 0-d tensors), so a launch never waits for the
// host. Each thread writes 16 bytes of a row (4 floats or 2 doubles)
// with one vector store where the row length allows it (T2 a multiple
// of 4 in float32, of 2 in float64), else element by element; a warp
// writes 512 consecutive bytes of a row. The arithmetic is written in
// the same order as the plain PyTorch version (ops/kernels.py::
// rbf_gram, then + n * eye): each square rounded (no fused multiply-add)
// and summed over d in order, (-0.5 * d2) / l2, exp, times c, plus n,
// with IEEE division and the accurate exp, so the two agree to the last
// bits; at D = 1 the sum is the one square, the arithmetic of the 1-D
// kernel. No padding: the ragged edge is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;   // threads along a row
constexpr int kRowsPerBlock = 8;

// a product rounded on its own, so that the next add is not fused
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename scalar_t>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static type make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static type make(const double* v) {
    return make_double2(v[0], v[1]);
  }
};

template <typename scalar_t>
__global__ void rbf_gram_kernel(const scalar_t* __restrict__ x1,
                                const scalar_t* __restrict__ x2,
                                const scalar_t* __restrict__ cp,
                                const scalar_t* __restrict__ lp,
                                const scalar_t* __restrict__ np,
                                scalar_t* __restrict__ out, int T1, int T2,
                                int D, int vec) {
  using V = Vec16<scalar_t>;
  const int i = blockIdx.y * kRowsPerBlock + threadIdx.y;
  const int j0 = (blockIdx.x * kCols + threadIdx.x) * V::n;
  if (i >= T1 || j0 >= T2) return;
  const scalar_t c = *cp;
  const scalar_t l = *lp;
  const scalar_t l2 = l * l;
  const scalar_t* xi = x1 + static_cast<size_t>(i) * D;
  scalar_t v[V::n];
#pragma unroll
  for (int e = 0; e < V::n; ++e) {
    const int j = j0 + e;
    if (j < T2) {
      const scalar_t* xj = x2 + static_cast<size_t>(j) * D;
      scalar_t d = xi[0] - xj[0];
      scalar_t d2 = mul_rn(d, d);
      for (int k = 1; k < D; ++k) {
        d = xi[k] - xj[k];
        d2 = d2 + mul_rn(d, d);
      }
      const scalar_t z = scalar_t(-0.5) * d2;
      v[e] = c * exp(z / l2);
      if (np != nullptr && i == j) v[e] = v[e] + *np;
    }
  }
  scalar_t* row = out + static_cast<size_t>(i) * T2;
  if (vec) {
    *reinterpret_cast<typename V::type*>(row + j0) = V::make(v);
  } else {
#pragma unroll
    for (int e = 0; e < V::n; ++e)
      if (j0 + e < T2) row[j0 + e] = v[e];
  }
}

template <typename scalar_t>
int launch(const void* x1, const void* x2, const void* c, const void* l,
           const void* noise, void* out, int T1, int T2, int D,
           void* stream) {
  if (T1 <= 0 || T2 <= 0 || D <= 0 || c == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int n = Vec16<scalar_t>::n;
  // whole vectors on every row: T2 a multiple of the vector and out
  // 16-byte aligned
  const int vec =
      (T2 % n == 0 && (reinterpret_cast<size_t>(out) & 15) == 0) ? 1 : 0;
  const int per_row = (T2 + n - 1) / n;
  dim3 block(kCols, kRowsPerBlock);
  dim3 grid((per_row + kCols - 1) / kCols,
            (T1 + kRowsPerBlock - 1) / kRowsPerBlock);
  rbf_gram_kernel<scalar_t><<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const scalar_t*>(x1), static_cast<const scalar_t*>(x2),
      static_cast<const scalar_t*>(c), static_cast<const scalar_t*>(l),
      static_cast<const scalar_t*>(noise), static_cast<scalar_t*>(out), T1,
      T2, D, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x1 (T1, D), x2 (T2, D) row-major; noise may be null: no diagonal term
extern "C" int rbf_gram_f32(const void* x1, const void* x2, const void* c,
                            const void* l, const void* noise, void* out,
                            int T1, int T2, int D, void* stream) {
  return launch<float>(x1, x2, c, l, noise, out, T1, T2, D, stream);
}

extern "C" int rbf_gram_f64(const void* x1, const void* x2, const void* c,
                            const void* l, const void* noise, void* out,
                            int T1, int T2, int D, void* stream) {
  return launch<double>(x1, x2, c, l, noise, out, T1, T2, D, stream);
}
