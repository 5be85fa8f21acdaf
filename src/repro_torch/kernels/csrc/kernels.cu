// Hand-written Hopper (sm_90a) kernels of the case-study datapaths.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.  Each
// *_launch function launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  The wrappers check device, dtype, shape and
// contiguity before calling in.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// gf2_bmvm — Williams' LUT-XOR GF(2) matrix-vector product.
//
// Replaces: src/repro/kernels/gf2_bmvm.py gf2_bmvm_pallas (body _kernel).
// Computes out[m, r] = XOR_c lut[c, v[m, c], r]; lut (C, P=2^k, R), v (M, C),
// out (M, R), all int32 words (k <= 16, so the uint32 bit patterns fit).
//
// Bound on H100: bytes.  Each (m, c) gathers one LUT row of R words, so the
// work moves at most M*C*R*4 bytes of LUT rows (64 MiB at n=4096, k=8, M=64:
// about 20 us at 3.35 TB/s) against M*C*R XORs, which are nothing beside it.
// Design: one thread per (m, r), one block per (m, 256 r's).  The block stages
// its row v[m, :] in shared memory (the TPU kernel's scalar prefetch), then
// each thread walks c and XOR-accumulates in a register, so the C-long
// reduction never leaves the SM.  Neighbouring threads read neighbouring r of
// the same LUT row: every gather is one coalesced 1 KiB line run.  Indices are
// masked to k bits, so a malformed word cannot read outside its LUT slab.
// ---------------------------------------------------------------------------
constexpr int kBmvmThreads = 256;

__global__ void gf2_bmvm_kernel(const int32_t* __restrict__ lut,
                                const int32_t* __restrict__ v,
                                int32_t* __restrict__ out, int C, int P, int R) {
  extern __shared__ int32_t v_row[];
  const int64_t m = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    v_row[c] = v[m * C + c] & (P - 1);
  }
  __syncthreads();
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t slab = static_cast<int64_t>(P) * R;
  const int32_t* col = lut + r;
  int32_t acc = 0;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    acc ^= __ldg(col + c * slab + static_cast<int64_t>(v_row[c]) * R);
  }
  out[m * R + r] = acc;
}

// ---------------------------------------------------------------------------
// minsum_check — LDPC min-sum check-node update (two-min trick).
//
// Replaces: src/repro/kernels/minsum.py minsum_check_pallas (body _kernel).
// out[c, j] = prod_{i!=j} sign(u_ci) * min_{i!=j} |u_ci| for u (n, deg) f32,
// deg <= 32.  sign(x) = (x < 0 ? -1 : +1), so -0.0 counts as positive; the
// argmin is the first index of the minimum (strict <), as in the reference.
//
// Bound on H100: bytes.  One read and one write of n*deg floats (88 MB for
// 3.67 M checks of degree 3: about 26 us at 3.35 TB/s); the arithmetic is a
// handful of compares per element.
// Design: a block of 128 check rows is copied into shared memory with
// consecutive threads on consecutive floats (coalesced whatever deg is), one
// thread then runs the whole two-min pass over its row out of shared memory,
// writes the row back in place, and the block stores the tile coalesced.
// ---------------------------------------------------------------------------
constexpr int kMinsumRows = 128;

__global__ void minsum_check_kernel(const float* __restrict__ u,
                                    float* __restrict__ out, int n, int deg) {
  extern __shared__ float tile[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kMinsumRows;
  const int left = n - static_cast<int>(row0);
  const int rows = left < kMinsumRows ? left : kMinsumRows;
  const int count = rows * deg;
  const float* src = u + row0 * deg;
  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = src[i];
  __syncthreads();
  if (threadIdx.x < rows) {
    float* row = tile + threadIdx.x * deg;
    float sign = 1.0f;
    float min1 = INFINITY;
    float min2 = INFINITY;
    int amin = 0;
    for (int j = 0; j < deg; ++j) {
      const float x = row[j];
      const float mag = fabsf(x);
      if (x < 0.0f) sign = -sign;
      if (mag < min1) {
        min2 = min1;
        min1 = mag;
        amin = j;
      } else if (mag < min2) {
        min2 = mag;
      }
    }
    for (int j = 0; j < deg; ++j) {
      const float sj = row[j] < 0.0f ? -1.0f : 1.0f;
      row[j] = (sign * sj) * (j == amin ? min2 : min1);
    }
  }
  __syncthreads();
  float* dst = out + row0 * deg;
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = tile[i];
}

// ---------------------------------------------------------------------------
// particle_histogram — normalized weighted histogram + fused Bhattacharyya.
//
// Replaces: src/repro/kernels/histogram.py particle_histogram_pallas (body
// _kernel).  hist[n, b] = sum_{p: bins[n,p]==b} w[p] / max(sum, 1e-12) and
// bc[n] = sum_b sqrt(hist[n, b] * ref[b]); bins outside [0, n_bins) count
// nowhere; n_bins <= 32.
//
// Bound on H100: bytes.  The int32 bin map is read once, N*px*4 bytes (64 MiB
// for 4096 particles of a 64x64 ROI: about 20 us at 3.35 TB/s); the weights
// and reference histogram stay in L2.
// Design: one block per particle.  Each thread strides over the pixels
// (coalesced loads) into a private per-bin column of shared memory, so there
// are no atomics; a fixed-order tree over the 256 columns then sums each bin,
// and thread 0 runs the normalization and Bhattacharyya epilogue in the same
// kernel.  The summation order is fixed, so results repeat bit for bit.
// ---------------------------------------------------------------------------
constexpr int kHistThreads = 256;

__global__ void particle_histogram_kernel(const int32_t* __restrict__ bins,
                                          const float* __restrict__ w,
                                          const float* __restrict__ ref,
                                          float* __restrict__ hist,
                                          float* __restrict__ bc, int px,
                                          int n_bins) {
  extern __shared__ float part[];  // part[b * kHistThreads + t]
  const int t = threadIdx.x;
  const int64_t n = blockIdx.x;
  for (int b = 0; b < n_bins; ++b) part[b * kHistThreads + t] = 0.0f;
  const int32_t* row = bins + n * px;
  for (int p = t; p < px; p += kHistThreads) {
    const int b = row[p];
    if (static_cast<unsigned>(b) < static_cast<unsigned>(n_bins)) {
      part[b * kHistThreads + t] += w[p];
    }
  }
  __syncthreads();
  for (int s = kHistThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      for (int b = 0; b < n_bins; ++b) {
        part[b * kHistThreads + t] += part[b * kHistThreads + t + s];
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    float total = 0.0f;
    for (int b = 0; b < n_bins; ++b) total += part[b * kHistThreads];
    const float denom = fmaxf(total, 1e-12f);
    float acc = 0.0f;
    for (int b = 0; b < n_bins; ++b) {
      const float h = part[b * kHistThreads] / denom;
      hist[n * n_bins + b] = h;
      acc += sqrtf(h * ref[b]);
    }
    bc[n] = acc;
  }
}

}  // namespace

extern "C" {

const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gf2_bmvm_launch(const void* lut, const void* v, void* out, int C, int P,
                    int R, int M, void* stream) {
  const dim3 grid(M, (R + kBmvmThreads - 1) / kBmvmThreads);
  gf2_bmvm_kernel<<<grid, kBmvmThreads, C * sizeof(int32_t),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lut), static_cast<const int32_t*>(v),
      static_cast<int32_t*>(out), C, P, R);
  return static_cast<int>(cudaGetLastError());
}

int minsum_check_launch(const void* u, void* out, int n, int deg, void* stream) {
  const int blocks = (n + kMinsumRows - 1) / kMinsumRows;
  minsum_check_kernel<<<blocks, kMinsumRows, kMinsumRows * deg * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(out), n, deg);
  return static_cast<int>(cudaGetLastError());
}

int particle_histogram_launch(const void* bins, const void* w, const void* ref,
                              void* hist, void* bc, int N, int px, int n_bins,
                              void* stream) {
  particle_histogram_kernel<<<N, kHistThreads,
                              n_bins * kHistThreads * sizeof(float),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), static_cast<const float*>(w),
      static_cast<const float*>(ref), static_cast<float*>(hist),
      static_cast<float*>(bc), px, n_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
