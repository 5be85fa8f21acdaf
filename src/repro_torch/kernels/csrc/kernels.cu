// Hand-written Hopper (sm_90a) kernels of the port: the three case-study
// datapaths and the flash-attention forward of the LM stack.
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
#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// flash_attention — attention forward with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention_pallas (body
// _kernel).  q (B, Hq, S, D), k/v (B, Hkv, T, D), all float or all bf16, D <=
// 128 -> out (B, Hq, S, D) in the input type; float32 math throughout.  Query
// head h reads kv head h / (Hq / Hkv) (GQA).  Scores are q.k * D^-0.5; causal
// rows see keys t <= q + (T - S).  m, l and acc follow the Pallas kernel's
// online softmax (m starts at -1e30, out = acc / max(l, 1e-30)), except that
// a key a row does not see adds exactly nothing: a row that sees no key
// (causal with S > T) returns zeros.
//
// Bound on H100: operations at whisper's shapes.  The encoder's self-attention
// (B=4, H=20, S=T=1500, D=64) does 4*B*H*S*T*D = 46 GFLOP against 61 MB of
// bf16 q, k, v and out: 0.047 ms at the 989 TFLOP/s bf16 tensor-core peak,
// 0.018 ms at 3.35 TB/s.  This kernel runs on the float32 CUDA cores (67
// TFLOP/s peak), so it cannot come near that bound; tensor cores (mma.sync or
// wgmma on bf16 tiles) are the next step.
// Design: one block of 128 threads per (b, h, tile of queries).  A query row
// belongs to G = ceil(D / 32) neighbouring lanes, each holding 32 of its head
// dims of q and of the output accumulator in registers; the partial dot
// products meet by warp shuffles.  The block walks the keys in tiles of 32:
// K and V rows are loaded coalesced, converted to float and staged in shared
// memory, where every lane of a warp reads the same row (a broadcast, 16 bytes
// per load; each lane's 32-dim slice is padded to 36 floats so the G slices
// of one row fall in different banks).  Per tile, each row takes the new
// running max over its visible keys, rescales l and acc once, and adds the
// tile's p * V.  Ragged S and T are bounds checks: rows past S load and write
// nothing, keys past T or past a causal row's limit get p = 0, and a causal
// block stops after the last key any of its rows sees.
// ---------------------------------------------------------------------------
constexpr int kFlashThreads = 128;
constexpr int kFlashSlice = 32;               // head dims one thread holds
constexpr int kFlashPitch = kFlashSlice + 4;  // floats per slice in shared memory
constexpr int kFlashKeys = 32;                // keys per K/V tile
constexpr int kFlashMaxD = 128;
constexpr float kFlashMask = -1e30f;

__device__ __forceinline__ float load_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int group, int S, int Tk, int D, int causal, float scale) {
  constexpr int kRows = kFlashThreads / G;  // query rows per block
  constexpr int kTile = kFlashKeys * G * kFlashPitch;
  __shared__ __align__(16) float ks[kTile];
  __shared__ __align__(16) float vs[kTile];
  const int g = threadIdx.x % G;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + threadIdx.x / G;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t q_row = (static_cast<int64_t>(b) * Hq + h) * S + row;
  const int64_t kv_base =
      (static_cast<int64_t>(b) * (Hq / group) + h / group) * Tk * D;
  const int d0 = g * kFlashSlice;
  const bool live = row < S;

  // Slice columns past D are zeroed here and never written again, so they
  // add nothing to the dot products.
  for (int i = threadIdx.x; i < kTile; i += kFlashThreads) {
    ks[i] = 0.0f;
    vs[i] = 0.0f;
  }
  float qr[kFlashSlice];
  float acc[kFlashSlice];
#pragma unroll
  for (int d = 0; d < kFlashSlice; ++d) {
    qr[d] = (live && d0 + d < D) ? load_float(q + q_row * D + d0 + d) : 0.0f;
    acc[d] = 0.0f;
  }
  // last key this row sees, and the last key any row of the block sees
  const int offset = Tk - S;
  const int last = causal ? min(row + offset, Tk - 1) : Tk - 1;
  const int block_last =
      causal ? min(min(row0 + kRows, S) - 1 + offset, Tk - 1) : Tk - 1;
  float m = kFlashMask;
  float l = 0.0f;
  for (int t0 = 0; t0 <= block_last; t0 += kFlashKeys) {
    __syncthreads();  // the zero fill, or the previous tile, is done with
    const int count = min(kFlashKeys, Tk - t0) * D;
    const T* kt = k + kv_base + static_cast<int64_t>(t0) * D;
    const T* vt = v + kv_base + static_cast<int64_t>(t0) * D;
    for (int i = threadIdx.x; i < count; i += kFlashThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int at = (j * G + d / kFlashSlice) * kFlashPitch + d % kFlashSlice;
      ks[at] = load_float(kt + i);
      vs[at] = load_float(vt + i);
    }
    __syncthreads();

    float s[kFlashKeys];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kFlashKeys; ++j) {
      const float4* kr =
          reinterpret_cast<const float4*>(ks + (j * G + g) * kFlashPitch);
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < kFlashSlice / 4; ++c) {
        const float4 kk = kr[c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int lane = 1; lane < G; lane <<= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, lane);
      }
      s[j] = dot * scale;
      if (t0 + j <= last) m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kFlashSlice; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kFlashKeys; ++j) {
      const float p = (t0 + j <= last) ? expf(s[j] - m_new) : 0.0f;
      l += p;
      const float4* vr =
          reinterpret_cast<const float4*>(vs + (j * G + g) * kFlashPitch);
#pragma unroll
      for (int c = 0; c < kFlashSlice / 4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }
  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  T* o = out + q_row * D + d0;
#pragma unroll
  for (int d = 0; d < kFlashSlice; ++d) {
    if (d0 + d < D) store_float(o + d, acc[d] / denom);
  }
}

template <typename T, int G>
int flash_attention_grid(const void* q, const void* k, const void* v, void* out,
                         int B, int Hq, int Hkv, int S, int Tk, int D,
                         int causal, cudaStream_t stream) {
  constexpr int kRows = kFlashThreads / G;
  const dim3 grid((S + kRows - 1) / kRows, Hq, B);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  flash_attention_kernel<T, G><<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hq / Hkv, S, Tk, D,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_attention_dispatch(const void* q, const void* k, const void* v,
                             void* out, int B, int Hq, int Hkv, int S, int Tk,
                             int D, int causal, cudaStream_t stream) {
  if (D <= kFlashSlice) {
    return flash_attention_grid<T, 1>(q, k, v, out, B, Hq, Hkv, S, Tk, D, causal, stream);
  }
  if (D <= 2 * kFlashSlice) {
    return flash_attention_grid<T, 2>(q, k, v, out, B, Hq, Hkv, S, Tk, D, causal, stream);
  }
  return flash_attention_grid<T, 4>(q, k, v, out, B, Hq, Hkv, S, Tk, D, causal, stream);
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

int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           int B, int Hq, int Hkv, int S, int T, int D,
                           int causal, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T < 1 || D < 1 ||
      D > kFlashMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return flash_attention_dispatch<float>(q, k, v, out, B, Hq, Hkv, S, T, D, causal, st);
  }
  if (dtype == 1) {
    return flash_attention_dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, S, T, D,
                                                   causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
