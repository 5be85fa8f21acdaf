// Hand-written Hopper (sm_90a) kernels of the port: the three case-study
// datapaths and the flash-attention forward of the LM stack.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.  Each
// *_launch function launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  The wrappers check device, dtype, shape and
// contiguity, and allocate outputs and scratch, before calling in.

#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

// dynamic shared memory one block may use on an H100 (227 KB)
constexpr int64_t kMaxBlockSmem = 232448;

// ---------------------------------------------------------------------------
// gf2_bmvm — Williams' LUT-XOR GF(2) matrix-vector product.
//
// Replaces: src/repro/kernels/gf2_bmvm.py gf2_bmvm_pallas (body _kernel).
// Computes out[m, r] = XOR_c lut[c, v[m, c], r]; lut (C, P=2^k, R), v (M, C),
// out (M, R), all int32 words (k <= 16, so the uint32 bit patterns fit).
// Indices are masked to k bits, so a malformed word cannot read outside its
// LUT slab.
//
// Bound on H100: bytes.  Each (m, c) gathers one LUT row of R words, so the
// work moves at most M*C*R*4 bytes of LUT rows (64 MiB at n=4096, k=8, M=64;
// the rows these inputs touch, 57 MiB: 17.8 us at 3.35 TB/s) against M*C*R
// XORs, which are nothing beside it.
//
// What it replaces (first port): one thread per (m, r) walking all C columns
// with 4-byte loads, a grid of (M, R/256) = 128 blocks of 256 threads on 132
// SMs.  At most 256 threads x 8 unrolled loads x 4 B = 8 KiB were in flight
// per SM, where Little's law asks for about 3.35 TB/s x 0.7 us / 132 = 18 KiB:
// 0.0570 / 0.0573 / 0.0566 ms (31 % of the bound) on an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 2).
//
// Design: the C-long XOR is exact in any order, so it is split.  The grid is
// (M, C chunks, R tiles of 512 words) and the chunks of one (m, R tile) form
// one thread-block cluster; gf2_bmvm.launch_shape in Python picks the chunk
// (8 chunks of 64 columns, 512 blocks of 128 threads, at the main shape).  A
// block stages its chunk of v[m, :] in shared memory (1024 columns at a time)
// and each thread XORs 4 consecutive words of the 2 KiB LUT rows with one
// 16-byte load per column, 8 columns unrolled: 16 KiB in flight per block,
// about 62 KiB per SM.  m runs fastest in the grid, so the blocks that gather
// the same rows of one chunk run together and meet in L2.  The cluster's
// blocks then leave their partial words in shared memory, and block 0 XORs
// them over distributed shared memory and stores out: no memset, no atomics,
// and a second launch repeats the first bit for bit.  R % 4 != 0 or a LUT or
// out base that is not 16-byte aligned takes the same loop with 4-byte loads.
// Measured on the same card (scripts/case_kernels.py): 0.036-0.037 ms, 48-49 %
// of the bound, when the timing overwrites the L2 by writing (the write-back of
// the dirty flush costs about 6 us); 0.0296 ms, 60 %, with a clean L2.  More
// loads in flight (16 a thread, or 16-block clusters) and fewer (4, or 4
// chunks) were each 4-7 us slower: what is left is the DRAM locality of
// random 2 KiB rows, not the bytes in flight.
// ---------------------------------------------------------------------------
constexpr int kBmvmThreads = 128;
constexpr int kBmvmTile = 4 * kBmvmThreads;  // output words of one block
constexpr int kBmvmStage = 1024;             // columns of v staged at a time
constexpr int kBmvmUnroll = 8;               // LUT rows in flight per thread
constexpr int kBmvmMaxCluster = 8;           // chunks of C (portable cluster size)

template <bool kVec>
__global__ void __launch_bounds__(kBmvmThreads)
    gf2_bmvm_kernel(const int32_t* __restrict__ lut, const int32_t* __restrict__ v,
                    int32_t* __restrict__ out, int C, int P, int R, int chunk) {
  __shared__ int32_t v_s[kBmvmStage];
  __shared__ int4 part[kBmvmThreads];
  const int64_t m = blockIdx.x;
  const int c_end = min(C, static_cast<int>(blockIdx.y) * chunk + chunk);
  const int r = blockIdx.z * kBmvmTile + 4 * threadIdx.x;
  const int nw = r < R ? min(4, R - r) : 0;
  const int64_t slab = static_cast<int64_t>(P) * R;
  int32_t acc[4] = {0, 0, 0, 0};
  for (int s0 = blockIdx.y * chunk; s0 < c_end; s0 += kBmvmStage) {
    const int cn = min(kBmvmStage, c_end - s0);
    __syncthreads();  // every thread is done with the previous stage
    for (int i = threadIdx.x; i < cn; i += kBmvmThreads) {
      v_s[i] = __ldg(v + m * C + s0 + i) & (P - 1);
    }
    __syncthreads();
    if (nw == 0) continue;
    const int32_t* base = lut + s0 * slab + r;
    if constexpr (kVec) {
#pragma unroll kBmvmUnroll
      for (int c = 0; c < cn; ++c) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(
            base + c * slab + static_cast<int64_t>(v_s[c]) * R));
        acc[0] ^= x.x;
        acc[1] ^= x.y;
        acc[2] ^= x.z;
        acc[3] ^= x.w;
      }
    } else {
#pragma unroll kBmvmUnroll
      for (int c = 0; c < cn; ++c) {
        const int32_t* row = base + c * slab + static_cast<int64_t>(v_s[c]) * R;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < nw) acc[k] ^= __ldg(row + k);
        }
      }
    }
  }
  part[threadIdx.x] = make_int4(acc[0], acc[1], acc[2], acc[3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial words are in its shared memory
  if (cluster.block_rank() == 0 && nw > 0) {
    for (unsigned q = 1; q < cluster.num_blocks(); ++q) {
      const int4 x = cluster.map_shared_rank(part, q)[threadIdx.x];
      acc[0] ^= x.x;
      acc[1] ^= x.y;
      acc[2] ^= x.z;
      acc[3] ^= x.w;
    }
    int32_t* dst = out + m * R + r;
    if constexpr (kVec) {
      *reinterpret_cast<int4*>(dst) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < nw) dst[k] = acc[k];
      }
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

// ---------------------------------------------------------------------------
// minsum_check — LDPC min-sum check-node update (two-min trick).
//
// Replaces: src/repro/kernels/minsum.py minsum_check_pallas (body _kernel).
// out[c, j] = prod_{i!=j} sign(u_ci) * min_{i!=j} |u_ci| for u (n, deg) in
// float32, bf16 or fp16, any deg.  sign(x) = (x < 0 ? -1 : +1), so -0.0
// counts as positive; the argmin is the first index of the minimum (strict
// <), as in the reference.  bf16 and fp16 load, compare in float32 and store
// in their own type: min, argmin and sign flips are exact in any float type,
// so every type is bit-exact against the plain version.
//
// Bound on H100: bytes.  One read and one write of n*deg elements (88 MB for
// 3.67 M float32 checks of degree 3: about 26 us at 3.35 TB/s); the
// arithmetic is a handful of compares per element.
// Design: a block of `rows` check rows (128, or fewer when 128 rows of deg
// elements would pass the 227 KB a block can hold: minsum.launch_shape in
// Python) is copied into shared memory with consecutive threads on
// consecutive elements (coalesced whatever deg is), one thread then runs the
// two-min pass over its whole row out of shared memory, writes the row back
// in place, and the block stores the tile coalesced.  The pass walks the row
// one element at a time, so a degree has no limit but the shared memory.
// Rows sit `pitch` elements apart: deg, or deg + 1 where a row of deg
// elements is a whole number of 8-byte words, which would put the 32 threads
// of a warp on one bank (deg = 64 in float32: 32-way conflicts); the main
// path (deg = 3) keeps pitch = deg and its straight copy loops.
// ---------------------------------------------------------------------------
constexpr int kMinsumThreads = 128;

__device__ __forceinline__ float load_float(float x) { return x; }
__device__ __forceinline__ float load_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float load_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_float(__half* p, float x) { *p = __float2half(x); }

template <typename T>
__global__ void __launch_bounds__(kMinsumThreads)
    minsum_check_kernel(const T* __restrict__ u, T* __restrict__ out, int n, int deg,
                        int rows_per_block, int pitch) {
  extern __shared__ __align__(16) uint8_t minsum_smem[];
  T* const tile = reinterpret_cast<T*>(minsum_smem);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int left = n - static_cast<int>(row0);
  const int rows = left < rows_per_block ? left : rows_per_block;
  const int count = rows * deg;
  const T* src = u + row0 * deg;
  if (pitch == deg) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i / deg * pitch + i % deg] = src[i];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    T* row = tile + static_cast<int64_t>(r) * pitch;
    float sign = 1.0f;
    float min1 = INFINITY;
    float min2 = INFINITY;
    int amin = 0;
    for (int j = 0; j < deg; ++j) {
      const float x = load_float(row[j]);
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
      const float sj = load_float(row[j]) < 0.0f ? -1.0f : 1.0f;
      store_float(row + j, (sign * sj) * (j == amin ? min2 : min1));
    }
  }
  __syncthreads();
  T* dst = out + row0 * deg;
  if (pitch == deg) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = tile[i];
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = tile[i / deg * pitch + i % deg];
  }
}

// ---------------------------------------------------------------------------
// particle_histogram — normalized weighted histogram + fused Bhattacharyya.
//
// Replaces: src/repro/kernels/histogram.py particle_histogram_pallas (body
// _kernel).  hist[n, b] = sum_{p: bins[n,p]==b} w[p] / max(sum, 1e-12) and
// bc[n] = sum_b sqrt(hist[n, b] * ref[b]); bins outside [0, n_bins) count
// nowhere; n_bins up to what one warp's columns fit in a block (1816 bins,
// 227 KB: histogram.MAX_BINS).
//
// Bound on H100: bytes.  The int32 bin map is read once, N*px*4 bytes (64 MiB
// for 4096 particles of a 64x64 ROI: 20.1 us at 3.35 TB/s); the weights and
// reference histogram stay in L2.
//
// What it replaces (first port): one block of 256 threads per particle, each
// thread with one 4-byte load in flight before a read-modify-write of shared
// memory, then an 8-step tree with a __syncthreads() per step and thread 0
// alone running the epilogue, with no load in flight during either: about 2
// KiB in flight per SM, where Little's law asks for about 3.35 TB/s x 0.7 us /
// 132 = 18 KiB.  0.0630 / 0.0633 / 0.0626 ms (32 % of the bound) on an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 2).
//
// Design: a warp owns a particle; a block of 8 warps stages w in shared memory
// once (when it fits: histogram.launch_shape in Python decides, and picks the
// grid, one particle per warp up to a few blocks per SM; past 28 bins a warp's
// columns take 1 KB a bin, and it gives a block fewer warps so that they fit).  Each lane reads the
// row with 16-byte loads, 8 unrolled (4 KiB per warp; with 31 warps a SM at
// the main shape, about 120 KiB in flight), and adds each weight into its own
// column of a per-warp shared-memory histogram: lane l's bin b sits at
// [b][l], so the 32 lanes always hit 32 distinct banks.  A row that does not
// start on 16 bytes (px % 4 != 0, or an unaligned base) takes a scalar head
// up to the first 16-byte boundary and a scalar tail.  The epilogue is spread
// over the lanes: lane l sums bins l, l + 32, ... over the 32 columns in a
// fixed rotated order (conflict-free), then the total and the Bhattacharyya
// sum are fixed xor-shuffle butterflies.  Past 32 bins (the kWide instances)
// bins past the first 32 park their sums in their row's first column (only
// their lane reads that row) for a second pass that normalizes them; up to
// 32 bins the kernel is the one-bin-a-lane code with 8 warps a block, whose
// registers the wide epilogue would push past the 64 of the launch bounds.  No atomics, and every sum has a fixed order, so a
// second launch repeats the first bit for bit.  The first batch of loads is
// issued before w is staged, so the stream starts at once.
// Measured on the same card (scripts/case_kernels.py): 0.037-0.038 ms, 52-54 %
// of the bound (0.031 ms, 64-66 %, with a clean L2); reading w through L1
// instead of staging it took 0.050 ms, and 4 loads a lane 0.038.
// ---------------------------------------------------------------------------
constexpr int kHistWarps = 8;  // most warps a block: one per particle
constexpr int kHistUnroll = 8;  // 16-byte loads in flight per lane
constexpr int kHistMinBlocks = 4;  // blocks an SM: caps registers at 64 a thread

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <bool kStageW, bool kWide>
__global__ void __launch_bounds__(kHistWarps * 32, kHistMinBlocks)
    particle_histogram_kernel(const int32_t* __restrict__ bins, const float* __restrict__ w,
                              const float* __restrict__ ref, float* __restrict__ hist,
                              float* __restrict__ bc, int N, int px, int n_bins) {
  extern __shared__ float4 hist_smem[];  // per-warp columns, then w if staged
  float* const smem = reinterpret_cast<float*>(hist_smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = kWide ? static_cast<int>(blockDim.x >> 5) : kHistWarps;
  float* const cols = smem + warp * 32 * n_bins;  // cols[b * 32 + l]: lane l, bin b
  const int stride = gridDim.x * warps;
  const int n0 = blockIdx.x * warps + warp;

  // where a row's 16-byte body starts and ends
  auto layout = [&](int n, const int32_t*& row, int& head, int& n4) {
    row = bins + static_cast<int64_t>(n) * px;
    head = min(static_cast<int>((0u - (reinterpret_cast<uintptr_t>(row) >> 2)) & 3u), px);
    n4 = (px - head) >> 2;
  };
  auto load_batch = [&](const int4* row4, int i, int n4, int4 (&q)[kHistUnroll]) {
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int j = i + u * 32;
      q[u] = j < n4 ? __ldg(row4 + j) : make_int4(-1, -1, -1, -1);
    }
  };

  int4 q[kHistUnroll];
  if (n0 < N) {  // the first batch is in flight while w is staged
    const int32_t* row;
    int head, n4;
    layout(n0, row, head, n4);
    load_batch(reinterpret_cast<const int4*>(row + head), lane, n4, q);
  }
  float* const w_s = smem + warps * 32 * n_bins;
  const float* const ws = kStageW ? w_s : w;
  if constexpr (kStageW) {
    for (int p = threadIdx.x; p < px; p += warps * 32) w_s[p] = __ldg(w + p);
    __syncthreads();
  }
  const float ref_l = lane < n_bins ? __ldg(ref + lane) : 0.0f;

  for (int n = n0; n < N; n += stride) {
    const int32_t* row;
    int head, n4;
    layout(n, row, head, n4);
    const int4* row4 = reinterpret_cast<const int4*>(row + head);
    const bool vec_w = head == 0 && (reinterpret_cast<uintptr_t>(ws) & 15u) == 0;
    float* const col = cols + lane;
    for (int b = 0; b < n_bins; ++b) col[b * 32] = 0.0f;
    auto add = [&](int b, float x) {
      if (static_cast<unsigned>(b) < static_cast<unsigned>(n_bins)) col[b * 32] += x;
    };
    if (lane < head) add(row[lane], ws[lane]);
    for (int i = lane; i < n4; i += 32 * kHistUnroll) {
      if (n != n0 || i != lane) load_batch(row4, i, n4, q);
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u) {
        const int j = i + u * 32;
        if (j < n4) {
          const int p = head + 4 * j;
          float4 x;
          if (vec_w) {
            x = *reinterpret_cast<const float4*>(ws + p);
          } else {
            x = make_float4(ws[p], ws[p + 1], ws[p + 2], ws[p + 3]);
          }
          add(q[u].x, x.x);
          add(q[u].y, x.y);
          add(q[u].z, x.z);
          add(q[u].w, x.w);
        }
      }
    }
    const int tail = head + 4 * n4 + lane;
    if (tail < px) add(row[tail], ws[tail]);
    __syncwarp();
    float* const out = hist + static_cast<int64_t>(n) * n_bins;
    if constexpr (!kWide) {
      // lane b sums bin b over the 32 lanes' columns, rotated so that the
      // lanes hit distinct banks
      float h = 0.0f;
      if (lane < n_bins) {
        const float* bin = cols + lane * 32;
#pragma unroll
        for (int j = 0; j < 32; ++j) h += bin[(lane + j) & 31];
      }
      const float denom = fmaxf(warp_sum(h), 1e-12f);
      h = h / denom;
      const float s = warp_sum(lane < n_bins ? sqrtf(h * ref_l) : 0.0f);
      if (lane < n_bins) out[lane] = h;
      if (lane == 0) bc[n] = s;
    } else {
      // lane l sums bins l, l + 32, ... the same way; the sums past bin 31
      // wait in their row's first column for the normalizing pass
      float h = 0.0f;     // bin `lane`
      float part = 0.0f;  // this lane's bins
      for (int b = lane; b < n_bins; b += 32) {
        const float* bin = cols + b * 32;
        float hb = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) hb += bin[(lane + j) & 31];
        if (b == lane) {
          h = hb;
        } else {
          cols[b * 32] = hb;
        }
        part += hb;
      }
      const float denom = fmaxf(warp_sum(part), 1e-12f);
      h = h / denom;
      float s = sqrtf(h * ref_l);
      for (int b = lane + 32; b < n_bins; b += 32) {
        const float hb = cols[b * 32] / denom;
        out[b] = hb;
        s += sqrtf(hb * __ldg(ref + b));
      }
      s = warp_sum(s);
      out[lane] = h;
      if (lane == 0) bc[n] = s;
    }
    __syncwarp();  // every lane has read the columns before they are zeroed
  }
}

// ---------------------------------------------------------------------------
// flash_attention — attention forward with an online softmax, in two kernels
// and a combine pass.
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention_pallas (body
// _kernel).  q (B, Hq, S, D), k/v (B, Hkv, T, D), D <= 256 -> out (B, Hq, S,
// D) in q's type.  Query head h reads kv head h / (Hq / Hkv) (GQA).  Scores
// are q.k * D^-0.5; causal rows see keys t <= q + (T - S).  m, l and acc
// follow the Pallas kernel's online softmax (m starts at -1e30, out = acc /
// max(l, 1e-30)), except that a key a row does not see adds exactly nothing:
// it gets p = 0, not exp(-1e30 - m), so a row that sees no key (causal with
// S > T) returns zeros.
//
// float32 inputs: flash_attention_f32_kernel, float32 CUDA cores, float32
// products as in the reference (the tests' 3e-5 tolerance needs them; TF32
// would not hold it).
// bf16 and fp16 inputs: flash_attention_tc_kernel, on the tensor cores.
//
// Bound on H100: operations at whisper's encoder shape.  Its self-attention
// (B=4, H=20, S=T=1500, D=64) does 4*B*H*S*T*D = 46 GFLOP against 61 MB of
// bf16 q, k, v and out: 0.047 ms at the 989 TFLOP/s bf16 tensor-core peak,
// 0.018 ms at 3.35 TB/s.  The decoder's cross-attention at prompt 32 (S=32,
// T=1500) is bound by bytes: 31 MB of k and v, 0.0094 ms, against 0.98 GFLOP.
//
// What the tensor-core design does about the three limits of the CUDA-core
// kernel it replaced (2.2188 and 0.3668 ms on these inputs, H100 SXM, 700 W):
// 1. Arithmetic ran on the float32 CUDA cores (67 TFLOP/s peak).  Both
//    products are now wgmma.mma_async (m64nNk16, f32 accumulators in
//    registers) from bf16/fp16 operands.  Q.K^T takes Q and K from shared
//    memory; P.V takes P from registers, rounded to the input type (its one
//    new rounding, at most 2^-9 relative per p.v term in bf16), and V from
//    shared memory in its natural (T, D) layout with B's transpose bit.  The
//    softmax runs on the accumulator fragments: exp2 on the special-function
//    unit, and the per-key mask only on tiles that cross T or a causal limit.
// 2. K and V were converted one element at a time and staged behind a
//    __syncthreads().  Now the Q tile is loaded once and K/V tiles of 64 keys
//    stream through a ring of 4 stages (3 at DP = 128) in shared memory by TMA
//    (cp.async.bulk.tensor, 128-byte swizzle matching the wgmma descriptors,
//    completion on an mbarrier per stage), up to 4 tiles ahead of the one
//    being computed.  TMA zero-fills reads past S, T and D.
// 3. A block held one (b, h, query tile), so the cross-attention's 80 blocks
//    left 52 of the 132 SMs idle.  A block now owns 128 query rows (two
//    warpgroups of 64); when B * Hq * ceil(S / 128) blocks leave a wave of
//    two blocks per SM unfilled, the wrapper splits the key tiles into
//    n_split contiguous ranges (num_splits in flash_attention.py): each block
//    writes its range's f32 (m, l, acc), and flash_attention_combine_kernel
//    merges them in a fixed order, without atomics.  The cross-attention
//    goes from 80 blocks to 240.
// ---------------------------------------------------------------------------
constexpr float kFlashMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// -- float32: CUDA cores ------------------------------------------------------
// One block of 128 threads per (b, h, tile of queries).  A query row belongs
// to G = 1, 2, 4 or 8 neighbouring lanes (D up to 32, 64, 128 or 256), each
// holding 32 of its head dims of q and of the output accumulator in
// registers; the partial dot products meet by warp shuffles.  K and V tiles
// of 32 keys (16 at G = 8, so that both fit the 48 KB of static shared
// memory) are staged in shared memory,
// where every lane of a warp reads the same row (a broadcast; each lane's
// 32-dim slice is padded to 36 floats so the G slices of one row fall in
// different banks).  Rows past S load and write nothing, keys past T or past
// a causal row's limit get p = 0, and a causal block stops after the last key
// any of its rows sees.
constexpr int kFlashThreads = 128;
constexpr int kFlashSlice = 32;               // head dims one thread holds
constexpr int kFlashPitch = kFlashSlice + 4;  // floats per slice in shared memory
constexpr int kFlashMaxD = 256;

template <int G>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Hq,
                           int group, int S, int Tk, int D, int causal, float scale) {
  constexpr int kRows = kFlashThreads / G;           // query rows per block
  constexpr int kFlashKeys = G <= 4 ? 32 : 16;       // keys per K/V tile
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
    qr[d] = (live && d0 + d < D) ? __ldg(q + q_row * D + d0 + d) : 0.0f;
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
    const float* kt = k + kv_base + static_cast<int64_t>(t0) * D;
    const float* vt = v + kv_base + static_cast<int64_t>(t0) * D;
    for (int i = threadIdx.x; i < count; i += kFlashThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int at = (j * G + d / kFlashSlice) * kFlashPitch + d % kFlashSlice;
      ks[at] = __ldg(kt + i);
      vs[at] = __ldg(vt + i);
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
  float* o = out + q_row * D + d0;
#pragma unroll
  for (int d = 0; d < kFlashSlice; ++d) {
    if (d0 + d < D) o[d] = acc[d] / denom;
  }
}

template <int G>
int flash_attention_f32_grid(const void* q, const void* k, const void* v, void* out,
                             int B, int Hq, int Hkv, int S, int Tk, int D,
                             int causal, cudaStream_t stream) {
  constexpr int kRows = kFlashThreads / G;
  const dim3 grid((S + kRows - 1) / kRows, Hq, B);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  flash_attention_f32_kernel<G><<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hq / Hkv, S, Tk,
      D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}


// -- bf16 / fp16: tensor cores ------------------------------------------------
// A block is two consumer warpgroups (256 threads); warpgroup w owns query
// rows row0 + 64 w .. + 63.  Thread 0 issues every TMA copy.  The head dim is
// padded to DP in {64, 128, 256} in shared memory only: TMA zero-fills columns
// past D (whole 64-column boxes past D included), so they add nothing to
// either product, and the scale uses the real D.  Shared memory holds each
// operand as 64-column chunks of 128-byte rows in the 128-byte swizzle (TMA
// writes it, wgmma reads it through descriptors):
//   Q    kChunks x (128 rows x 128 B), loaded once;
//   K, V kStages x kChunks x (64 keys x 128 B) each (4 stages at DP = 64,
//        3 at DP = 128, 2 at DP = 256).
// At DP = 256 the block holds 64 KB of Q and two 64 KB K/V stages (193 KB:
// one block an SM), and each thread keeps 128 output accumulators; P.V is
// two m64n128k16 wgmmas a step, on the two 128-column halves of V.
// Accumulator fragments (m64nNk16, f32): thread (warp w, lane i) holds rows
// r0 = 16 w + i / 4 and r0 + 8 of its warpgroup's 64, and in register 4 j + c
// (row r0) or 4 j + 2 + c (row r0 + 8) the column 8 j + 2 (i % 4) + c.  A
// row's max and sum meet across the 4 lanes of its quad.  The same fragment
// of 16 columns of P, packed in pairs, is the A operand of the P.V wgmma.
constexpr int kTcRows = 128;     // query rows per block
constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kTcKeys = 64;      // keys per K/V tile: the N of Q.K^T
constexpr int kTcChunk = 64;     // head dims per 128-byte row
constexpr int kTcMaxSplits = 16;

struct bf16_tag {};
struct f16_tag {};

template <typename T>
struct TcType;
template <>
struct TcType<__nv_bfloat16> {
  using tag = bf16_tag;
  static constexpr CUtensorMapDataType map_type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct TcType<__half> {
  using tag = f16_tag;
  static constexpr CUtensorMapDataType map_type = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// arrive once and expect `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed.  A wait of
// more than 10 s can only be a copy that never lands: trap, so that the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) start = now;
    if (now - start > 10000000000ull) __trap();
  }
}

// TMA: copy the box at (c0, c1, c2) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle (layout
// type 1): start address, leading and stride byte offsets, all in 16 B units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

// 2^x on the special-function unit (flushes denormal results to zero; 2^x
// of a masked score's -1.4e30 is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16 with f32 accumulators: _ss reads A and B through
// shared-memory descriptors (both K-major), _rs takes A from registers and B
// (transposed: MN-major) through a descriptor.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(
    bf16_tag, float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(
    bf16_tag, float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(
    bf16_tag, float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(
    f16_tag, float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(
    f16_tag, float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(
    f16_tag, float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <typename T, int DP>
struct TcShape {
  static constexpr int kChunks = DP / kTcChunk;
  static constexpr int kQChunkBytes = kTcRows * 128;   // one 64-column chunk of Q
  static constexpr int kKvChunkBytes = kTcKeys * 128;  // one of K or V
  static constexpr int kQBytes = kChunks * kQChunkBytes;
  static constexpr int kTileBytes = kChunks * kKvChunkBytes;
  static constexpr int kStages = DP == 64 ? 4 : DP == 128 ? 3 : 2;  // K/V ring depth
  // 1 KB of slack for the swizzle's 1024-byte alignment, then Q, the K ring,
  // the V ring and 1 + kStages mbarriers: 82 KB at DP = 64 (two blocks per
  // SM), 132 KB at DP = 128, 193 KB at DP = 256
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + kStages);
};

template <typename T, int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, void* __restrict__ out,
                          float* __restrict__ part_m, float* __restrict__ part_l, int Hq,
                          int group, int S, int Tk, int D, int causal, int n_split,
                          float scale) {
  using Shape = TcShape<T, DP>;
  using Tag = typename TcType<T>::tag;
  constexpr int kChunks = Shape::kChunks;
  constexpr int kStages = Shape::kStages;
  constexpr int kOut = DP / 2;  // output accumulator registers per thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + Shape::kQBytes;           // stage s at + s * kTileBytes
  const uint32_t v_s = k_s + kStages * Shape::kTileBytes;
  const uint32_t q_bar = v_s + kStages * Shape::kTileBytes;  // then kStages full bars

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int split = blockIdx.x % n_split;
  const int row0 = (blockIdx.x / n_split) * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_plane = b * Hq + h;
  const int kv_plane = b * (Hq / group) + h / group;

  // this block's key tiles: its split's contiguous range, cut after the last
  // key any of its rows sees
  const int n_all = (Tk + kTcKeys - 1) / kTcKeys;
  const int per = (n_all + n_split - 1) / n_split;
  const int tile_lo = split * per;
  int tile_hi = min(tile_lo + per, n_all);
  if (causal) {
    const int last = min(min(row0 + kTcRows, S) - 1 + Tk - S, Tk - 1);
    tile_hi = min(tile_hi, last < 0 ? 0 : last / kTcKeys + 1);
  }
  const int n_tiles = max(tile_hi - tile_lo, 0);

  auto load_kv = [&](int stage, int tile) {
    const uint32_t bar = q_bar + 8 * (1 + stage);
    mbar_expect_tx(bar, 2 * Shape::kTileBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint32_t at = stage * Shape::kTileBytes + c * Shape::kKvChunkBytes;
      tma_load_3d(k_s + at, &k_map, bar, c * kTcChunk, tile * kTcKeys, kv_plane);
      tma_load_3d(v_s + at, &v_map, bar, c * kTcChunk, tile * kTcKeys, kv_plane);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(q_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, Shape::kQBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_3d(q_s + c * Shape::kQChunkBytes, &q_map, q_bar, c * kTcChunk, row0, q_plane);
    }
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, tile_lo + s);
  }

  // this thread's two rows, and the key each row's visible range ends before
  const int r0 = row0 + wg * 64 + warp * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int lim0 = causal ? min(Tk, r0 + Tk - S + 1) : Tk;
  const int lim1 = causal ? min(Tk, r1 + Tk - S + 1) : Tk;
  const float scale2 = scale * kLog2e;  // exp(x * scale - m) = exp2(x * scale2 - m * log2 e)
  float m0 = kFlashMask, m1 = kFlashMask, l0 = 0.0f, l1 = 0.0f;
  float o[kOut];
  float sc[kTcKeys / 2];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kTcKeys / 2; ++i) sc[i] = 0.0f;

  mbar_wait(q_bar, 0);
  const uint32_t q_wg = q_s + wg * 64 * 128;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(q_bar + 8 * (1 + stage), (it / kStages) & 1);
    const uint32_t ks = k_s + stage * Shape::kTileBytes;
    const uint32_t vs = v_s + stage * Shape::kTileBytes;

    // S = Q K^T over DP / 16 steps of 16 head dims (32 bytes along a row)
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t at = (kk % 4) * 32;
      wgmma_m64n64k16_ss(Tag{}, sc,
                         sw128_desc(q_wg + (kk / 4) * Shape::kQChunkBytes + at, 16, 1024),
                         sw128_desc(ks + (kk / 4) * Shape::kKvChunkBytes + at, 16, 1024),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax over the visible keys of this tile; a tile that every
    // row of the block sees whole (inside T, and inside the causal limit of
    // the block's first row) skips the per-key mask
    const int t0 = (tile_lo + it) * kTcKeys;
    const bool whole = t0 + kTcKeys <= Tk && (!causal || t0 + kTcKeys <= row0 + Tk - S + 1);
    float alpha0, alpha1;
    auto softmax = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      const int tq = t0 + 2 * quad;
      float mx0 = -INFINITY, mx1 = -INFINITY;  // largest visible raw score (scale > 0)
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (!kMasked || tq + 8 * j + c < lim0) mx0 = fmaxf(mx0, sc[4 * j + c]);
          if (!kMasked || tq + 8 * j + c < lim1) mx1 = fmaxf(mx1, sc[4 * j + 2 + c]);
        }
      }
      mx0 = fmaxf(m0, fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1)) * scale);
      mx1 = fmaxf(m1, fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1)) * scale);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      alpha0 = fast_exp2((m0 - mx0) * kLog2e);
      alpha1 = fast_exp2((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * kLog2e, mb1 = mx1 * kLog2e;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p0 = fast_exp2(sc[4 * j + c] * scale2 - mb0);
          float p1 = fast_exp2(sc[4 * j + 2 + c] * scale2 - mb1);
          if constexpr (kMasked) {
            p0 = tq + 8 * j + c < lim0 ? p0 : 0.0f;
            p1 = tq + 8 * j + c < lim1 ? p1 : 0.0f;
          }
          sc[4 * j + c] = p0;
          sc[4 * j + 2 + c] = p1;
          l0 += p0;
          l1 += p1;
        }
      }
    };
    if (whole) {
      softmax(std::false_type{});
    } else {
      softmax(std::true_type{});
    }
    uint32_t pa[kTcKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // registers 8 kk + 2 r, + 1: (row r0, keys 16 kk + 2 quad + {0, 1}),
        // (r0 + 8, same), (r0, + 8), (r0 + 8, + 8) -- wgmma's A fragment
        pa[kk][r] = TcType<T>::pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O += P V over 4 steps of 16 keys (16 rows of 128 B of V)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 16 * 128, Shape::kKvChunkBytes, 1024);
      if constexpr (DP == 64) {
        wgmma_m64n64k16_rs(Tag{}, o, pa[kk], dv, 1);
      } else if constexpr (DP == 128) {
        wgmma_m64n128k16_rs(Tag{}, o, pa[kk], dv, 1);
      } else {
        // columns 128 + 8 j + ... of the upper half sit in registers 64 + 4 j
        // + ..., the same fragment layout as one n = 256 product
        const uint64_t dv_hi =
            sw128_desc(vs + 2 * Shape::kKvChunkBytes + kk * 16 * 128, Shape::kKvChunkBytes, 1024);
        wgmma_m64n128k16_rs(Tag{}, *reinterpret_cast<float(*)[64]>(o), pa[kk], dv, 1);
        wgmma_m64n128k16_rs(Tag{}, *reinterpret_cast<float(*)[64]>(o + 64), pa[kk], dv_hi, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    __syncthreads();  // both warpgroups are done with this stage: refill it
    if (tid == 0 && it + kStages < n_tiles) load_kv(stage, tile_lo + it + kStages);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int rows[2] = {r0, r1};
  const float ls[2] = {l0, l1};
  const float ms[2] = {m0, m1};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rows[half];
    if (r >= S) continue;
    if (n_split == 1) {
      const float denom = fmaxf(ls[half], 1e-30f);
      T* dst = static_cast<T*>(out) + (static_cast<int64_t>(q_plane) * S + r) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * quad + c;
          if (col < D) store_float(dst + col, o[4 * j + 2 * half + c] / denom);
        }
      }
    } else {
      // partials (n_split, B, Hq, S) and (n_split, B, Hq, S, D), unnormalized
      const int64_t at =
          (static_cast<int64_t>(split) * gridDim.z * Hq + q_plane) * S + r;
      if (quad == 0) {
        part_m[at] = ms[half];
        part_l[at] = ls[half];
      }
      float* dst = static_cast<float*>(out) + at * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * quad + c;
          if (col < D) dst[col] = o[4 * j + 2 * half + c];
        }
      }
    }
  }
}

// out[r, d] = sum_s exp(m_s - M) acc_s[r, d] / max(sum_s exp(m_s - M) l_s, 1e-30)
// with M = max_s m_s, over the splits in order; a split whose keys a row does
// not see has l = 0 and acc = 0 and adds nothing.  One thread per (row, d);
// it issues all of its loads before it uses any, one trip to memory.
template <typename O>
__global__ void flash_attention_combine_kernel(const float* __restrict__ m,
                                               const float* __restrict__ l,
                                               const float* __restrict__ acc,
                                               O* __restrict__ out, int n_split,
                                               int64_t rows, int D) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const int64_t r = i / D;
  float ms[kTcMaxSplits], ls[kTcMaxSplits], as[kTcMaxSplits];
#pragma unroll
  for (int s = 0; s < kTcMaxSplits; ++s) {
    if (s < n_split) {
      ms[s] = __ldg(m + s * rows + r);
      ls[s] = __ldg(l + s * rows + r);
      as[s] = __ldg(acc + s * rows * D + i);
    }
  }
  float mx = ms[0];
#pragma unroll
  for (int s = 1; s < kTcMaxSplits; ++s) {
    if (s < n_split) mx = fmaxf(mx, ms[s]);
  }
  float num = 0.0f;
  float den = 0.0f;
#pragma unroll
  for (int s = 0; s < kTcMaxSplits; ++s) {
    if (s < n_split) {
      const float w = expf(ms[s] - mx);
      den += w * ls[s];
      num += w * as[s];
    }
  }
  store_float(out + i, num / fmaxf(den, 1e-30f));
}

// cuTensorMapEncodeTiled, fetched from the CUDA driver at run time (the library
// links against the runtime only)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                           12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// TMA map of a contiguous (planes, rows, Dp) tensor: boxes of 64 columns x
// box_rows rows of one plane, 128-byte swizzle, zero fill out of bounds
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int Dp, int rows, int planes,
                int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Dp) * sizeof(T),
                                 static_cast<cuuint64_t>(Dp) * rows * sizeof(T)};
  const cuuint32_t box[3] = {kTcChunk, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, TcType<T>::map_type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP>
int flash_attention_tc_grid(const void* q, const void* k, const void* v, void* out,
                            void* part_m, void* part_l, int B, int Hq, int Hkv, int S,
                            int Tk, int D, int Dp, int causal, int n_split,
                            cudaStream_t stream) {
  constexpr int kSmem = TcShape<T, DP>::kSmemBytes;
  static bool allowed[64] = {};  // per device: the shared-memory limit is raised
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && (device >= 64 || !allowed[device])) {
    e = cudaFuncSetAttribute(flash_attention_tc_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess && device < 64) allowed[device] = true;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map<T>(&q_map, q, Dp, S, B * Hq, kTcRows) ||
      !encode_map<T>(&k_map, k, Dp, Tk, B * Hkv, kTcKeys) ||
      !encode_map<T>(&v_map, v, Dp, Tk, B * Hkv, kTcKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(((S + kTcRows - 1) / kTcRows) * n_split, Hq, B);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  flash_attention_tc_kernel<T, DP><<<grid, kTcThreads, kSmem, stream>>>(
      q_map, k_map, v_map, out, static_cast<float*>(part_m), static_cast<float*>(part_l), Hq,
      Hq / Hkv, S, Tk, D, causal, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_attention_tc_dispatch(const void* q, const void* k, const void* v, void* out,
                                void* part_m, void* part_l, int B, int Hq, int Hkv, int S,
                                int Tk, int D, int Dp, int causal, int n_split,
                                cudaStream_t stream) {
  if (Dp <= 64) {
    return flash_attention_tc_grid<T, 64>(q, k, v, out, part_m, part_l, B, Hq, Hkv, S, Tk,
                                          D, Dp, causal, n_split, stream);
  }
  if (Dp <= 128) {
    return flash_attention_tc_grid<T, 128>(q, k, v, out, part_m, part_l, B, Hq, Hkv, S, Tk,
                                           D, Dp, causal, n_split, stream);
  }
  return flash_attention_tc_grid<T, 256>(q, k, v, out, part_m, part_l, B, Hq, Hkv, S, Tk, D,
                                         Dp, causal, n_split, stream);
}

template <typename O>
int flash_attention_combine_grid(const void* m, const void* l, const void* acc, void* out,
                                 int n_split, int rows, int D, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t n = static_cast<int64_t>(rows) * D;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  flash_attention_combine_kernel<O><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(acc), static_cast<O*>(out), n_split, rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// chunk: columns of C each block reduces; the ceil(C / chunk) <= 8 chunks of
// one (m, R tile) run as one cluster and merge in distributed shared memory.
int gf2_bmvm_launch(const void* lut, const void* v, void* out, int C, int P, int R, int M,
                    int chunk, void* stream) {
  if (C < 1 || P < 1 || (P & (P - 1)) != 0 || R < 1 || M < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = (C + chunk - 1) / chunk;
  if (n_chunks > kBmvmMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(M, n_chunks, (R + kBmvmTile - 1) / kBmvmTile);
  config.blockDim = dim3(kBmvmThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = n_chunks;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(lut) | reinterpret_cast<uintptr_t>(out);
  const auto* l = static_cast<const int32_t*>(lut);
  const auto* vw = static_cast<const int32_t*>(v);
  auto* o = static_cast<int32_t*>(out);
  const cudaError_t e =
      R % 4 == 0 && (bases & 15u) == 0
          ? cudaLaunchKernelEx(&config, gf2_bmvm_kernel<true>, l, vw, o, C, P, R, chunk)
          : cudaLaunchKernelEx(&config, gf2_bmvm_kernel<false>, l, vw, o, C, P, R, chunk);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// rows: check rows of one block (<= 128), `pitch` (>= deg) elements apart in
// rows * pitch elements of shared memory; dtype 0 float32, 1 bf16, 2 fp16.
int minsum_check_launch(const void* u, void* out, int n, int deg, int rows, int pitch,
                        int dtype, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  const int64_t smem = static_cast<int64_t>(rows) * pitch * size;
  if (n < 1 || deg < 1 || rows < 1 || rows > kMinsumThreads || pitch < deg ||
      smem > kMaxBlockSmem || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + rows - 1) / rows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto* typed) -> int {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(typed)>>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          minsum_check_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    minsum_check_kernel<T><<<blocks, kMinsumThreads, smem, st>>>(
        static_cast<const T*>(u), static_cast<T*>(out), n, deg, rows, pitch);
    return static_cast<int>(cudaGetLastError());
  };
  if (dtype == 1) return go(static_cast<__nv_bfloat16*>(nullptr));
  if (dtype == 2) return go(static_cast<__half*>(nullptr));
  return go(static_cast<float*>(nullptr));
}

// blocks: the grid and warps the warps of a block (each warp walks particles
// warp, warp + blocks * warps, ...); smem_bytes: warps * 32 * n_bins floats of
// per-lane columns, plus px floats of w when stage_w is set.
int particle_histogram_launch(const void* bins, const void* w, const void* ref, void* hist,
                              void* bc, int N, int px, int n_bins, int blocks, int warps,
                              int smem_bytes, int stage_w, void* stream) {
  const int64_t want = (warps * 32 * static_cast<int64_t>(n_bins) +
                        (stage_w ? static_cast<int64_t>(px) : 0)) * sizeof(float);
  const bool wide = n_bins > 32;
  if (N < 1 || px < 0 || n_bins < 1 || blocks < 1 || warps < 1 || warps > kHistWarps ||
      (!wide && warps != kHistWarps) || smem_bytes != want || want > kMaxBlockSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(const int32_t*, const float*, const float*, float*, float*, int, int, int) =
      wide ? (stage_w ? &particle_histogram_kernel<true, true>
                      : &particle_histogram_kernel<false, true>)
           : (stage_w ? &particle_histogram_kernel<true, false>
                      : &particle_histogram_kernel<false, false>);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), static_cast<const float*>(w),
      static_cast<const float*>(ref), static_cast<float*>(hist), static_cast<float*>(bc), N, px,
      n_bins);
  return static_cast<int>(cudaGetLastError());
}

int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* out, int B,
                               int Hq, int Hkv, int S, int T, int D, int causal,
                               void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T < 1 || D < 1 || D > kFlashMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= kFlashSlice) {
    return flash_attention_f32_grid<1>(q, k, v, out, B, Hq, Hkv, S, T, D, causal, st);
  }
  if (D <= 2 * kFlashSlice) {
    return flash_attention_f32_grid<2>(q, k, v, out, B, Hq, Hkv, S, T, D, causal, st);
  }
  if (D <= 4 * kFlashSlice) {
    return flash_attention_f32_grid<4>(q, k, v, out, B, Hq, Hkv, S, T, D, causal, st);
  }
  return flash_attention_f32_grid<8>(q, k, v, out, B, Hq, Hkv, S, T, D, causal, st);
}

// q (B, Hq, S, Dp), k/v (B, Hkv, T, Dp) bf16 (dtype 1) or fp16 (dtype 2), Dp
// the head dim D padded to a multiple of 8 (TMA's 16-byte strides).  With
// n_split == 1 the kernel writes out (B, Hq, S, D) in the input type.
// Otherwise it writes the float32 partials m, l (n_split, B, Hq, S) and acc
// (n_split, B, Hq, S, D), and then, unless out is null, the combine kernel
// merges them into out on the same stream.
int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                              void* m, void* l, void* acc, int B, int Hq, int Hkv, int S,
                              int T, int D, int Dp, int causal, int n_split, int dtype,
                              void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || T < 1 || D < 1 || Dp < D ||
      Dp % 8 != 0 || Dp > kFlashMaxD || n_split < 1 || n_split > kTcMaxSplits ||
      (dtype != 1 && dtype != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* dst = n_split == 1 ? out : acc;
  const int rc =
      dtype == 1
          ? flash_attention_tc_dispatch<__nv_bfloat16>(q, k, v, dst, m, l, B, Hq, Hkv, S, T, D,
                                                       Dp, causal, n_split, st)
          : flash_attention_tc_dispatch<__half>(q, k, v, dst, m, l, B, Hq, Hkv, S, T, D, Dp,
                                                causal, n_split, st);
  if (rc != 0 || n_split == 1 || out == nullptr) return rc;
  const int rows = B * Hq * S;
  return dtype == 1
             ? flash_attention_combine_grid<__nv_bfloat16>(m, l, acc, out, n_split, rows, D, st)
             : flash_attention_combine_grid<__half>(m, l, acc, out, n_split, rows, D, st);
}

// dynamic shared memory of one tensor-core block at padded head dim dp
int flash_attention_tc_smem_bytes(int dp) {
  return dp <= 64    ? TcShape<__nv_bfloat16, 64>::kSmemBytes
         : dp <= 128 ? TcShape<__nv_bfloat16, 128>::kSmemBytes
                     : TcShape<__nv_bfloat16, 256>::kSmemBytes;
}

// m, l (n_split, rows), acc (n_split, rows, D) float32 -> out (rows, D) in
// float32 (dtype 0), bf16 (1) or fp16 (2)
int flash_attention_combine_launch(const void* m, const void* l, const void* acc, void* out,
                                   int n_split, int rows, int D, int dtype, void* stream) {
  if (n_split < 1 || rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return flash_attention_combine_grid<float>(m, l, acc, out, n_split, rows, D, st);
  }
  if (dtype == 1) {
    return flash_attention_combine_grid<__nv_bfloat16>(m, l, acc, out, n_split, rows, D, st);
  }
  if (dtype == 2) {
    return flash_attention_combine_grid<__half>(m, l, acc, out, n_split, rows, D, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
