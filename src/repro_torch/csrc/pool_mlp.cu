// Eq.-7 pool scoring on Hopper: for every target feature f and pool head p,
// the Table-4 head MLP  w -> 16 -> 256 -> 64 -> 16 -> 1  (sigmoid, sigmoid,
// leaky-ReLU 0.01, leaky-ReLU, linear) on the (R, w) probe batch of feature
// f, and the mean squared error against y.  Output err[f, p], (nf, ns) fp32.
//
// Replaces the TPU kernel src/repro/kernels/pool_mlp/kernel.py:_pool_kernel
// (grid (nf, ns/BP), BP heads resident in VMEM).
//
// What bounds it on this card: the work is about R*2*(w*16 + 16*256 +
// 256*64 + 64*16 + 16) flops per (feature, head), 2.16 MFLOP at R=50, w=3,
// on the fp32 CUDA cores (TF32 tensor cores would break selection identity),
// against reading each head's 21,921 weights (88 KB at w=3) once.  At the
// batched engine's nf=4, ns=512 that is 4.4 GFLOP against 45 MB: bound by
// operations.  At the sequential engine's nf=1, ns=4 the grid has four
// blocks and the time is one block's latency plus the launch.
//
// Design: one thread block per pool head, so ns needs no padding and has no
// block-size rule.  The block stages its head's weights in shared memory
// once (88 KB: a whole head fits, the TPU's BP-head block does not) and
// loops over all nf features and over R in 32-row tiles, holding the tile's
// hidden activations in shared memory (32x256 fp32 = 32 KB for the widest
// layer).  Threads own output neurons.  Every dot product is an fp32 FMA
// chain with the bias added last; the sigmoid uses expf; build without
// --use_fast_math.  The mean over R is summed by one thread in row order,
// so the result is deterministic, needs no atomics, and err[f, p] is
// written once.  Non-finite scores and rows that `valid` marks invalid are
// written as +inf, which argmin never selects.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int H0 = 16, H1 = 256, H2 = 64, H3 = 16;
constexpr int THREADS = 256;        // == H1: layer 1 gives each thread a column
constexpr int TILE = 32;            // probe rows per tile
constexpr int ROW_GROUPS = THREADS / H2;          // layer 2: 4 groups of rows
constexpr int ROWS_PER_THREAD = TILE / ROW_GROUPS;  // 8 rows per thread
constexpr float LRELU_SLOPE = 0.01f;

static_assert(THREADS == H1, "layer 1 maps one thread to one column");
static_assert(TILE % ROW_GROUPS == 0, "layer 2 splits the tile evenly");

__host__ __device__ constexpr size_t weight_floats(int w) {
  return (size_t)w * H0 + H0 + H0 * H1 + H1 + H1 * H2 + H2 + H2 * H3 + H3 +
         H3 + 1;
}

__host__ __device__ constexpr size_t smem_floats(int w) {
  // weights + per-tile x, y, h0, h1, h2, h3 and squared errors
  return weight_floats(w) + (size_t)TILE * (w + 1 + H0 + H1 + H2 + H3 + 1);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.0f ? x : LRELU_SLOPE * x;
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS)
pool_mlp_kernel(const float* __restrict__ xd,   // (nf, R, w)
                const float* __restrict__ y,    // (R,)
                const float* __restrict__ w0, const float* __restrict__ b0,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                const float* __restrict__ w4, const float* __restrict__ b4,
                const unsigned char* __restrict__ valid,  // (ns,) or null
                float* __restrict__ out,        // (nf, ns)
                int nf, int ns, int R, int w) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int t = threadIdx.x;

  float* sw0 = smem;
  float* sb0 = sw0 + w * H0;
  float* sw1 = sb0 + H0;
  float* sb1 = sw1 + H0 * H1;
  float* sw2 = sb1 + H1;
  float* sb2 = sw2 + H1 * H2;
  float* sw3 = sb2 + H2;
  float* sb3 = sw3 + H2 * H3;
  float* sw4 = sb3 + H3;
  float* sb4 = sw4 + H3;
  float* sx = sb4 + 1;               // (TILE, w)
  float* sy = sx + TILE * w;         // (TILE,)
  float* sh0 = sy + TILE;            // (TILE, 16)
  float* sh1 = sh0 + TILE * H0;      // (TILE, 256)
  float* sh2 = sh1 + TILE * H1;      // (TILE, 64)
  float* sh3 = sh2 + TILE * H2;      // (TILE, 16)
  float* ssq = sh3 + TILE * H3;      // (TILE,)

  // this head's weights, read from device memory once
  stage(sw0, w0 + (size_t)p * w * H0, w * H0);
  stage(sb0, b0 + (size_t)p * H0, H0);
  stage(sw1, w1 + (size_t)p * H0 * H1, H0 * H1);
  stage(sb1, b1 + (size_t)p * H1, H1);
  stage(sw2, w2 + (size_t)p * H1 * H2, H1 * H2);
  stage(sb2, b2 + (size_t)p * H2, H2);
  stage(sw3, w3 + (size_t)p * H2 * H3, H2 * H3);
  stage(sb3, b3 + (size_t)p * H3, H3);
  stage(sw4, w4 + (size_t)p * H3, H3);
  stage(sb4, b4 + p, 1);
  // layer 2 reads whole tiles; rows past R then hold zeros, never garbage
  for (int i = t; i < TILE * (w + 1 + H0 + H1 + H2 + H3 + 1); i += THREADS)
    sx[i] = 0.0f;

  const bool keep = valid == nullptr || valid[p];
  for (int f = 0; f < nf; ++f) {
    const float* x = xd + (size_t)f * R * w;
    float sum = 0.0f;                // thread 0's running sum over rows
    for (int r0 = 0; r0 < R; r0 += TILE) {
      const int rows = min(TILE, R - r0);
      __syncthreads();               // weights staged / last tile consumed
      stage(sx, x + (size_t)r0 * w, rows * w);
      stage(sy, y + r0, rows);
      __syncthreads();

      // layer 0: (rows, w) @ (w, 16), sigmoid
      for (int i = t; i < rows * H0; i += THREADS) {
        const int r = i / H0, k = i % H0;
        float a = 0.0f;
        for (int c = 0; c < w; ++c) a = fmaf(sx[r * w + c], sw0[c * H0 + k], a);
        sh0[r * H0 + k] = sigmoid(a + sb0[k]);
      }
      __syncthreads();

      // layer 1: (rows, 16) @ (16, 256), sigmoid; thread t owns column t
      {
        float wc[H0];
#pragma unroll
        for (int k = 0; k < H0; ++k) wc[k] = sw1[k * H1 + t];
        const float bj = sb1[t];
        for (int r = 0; r < rows; ++r) {
          float a = 0.0f;
#pragma unroll
          for (int k = 0; k < H0; ++k) a = fmaf(sh0[r * H0 + k], wc[k], a);
          sh1[r * H1 + t] = sigmoid(a + bj);
        }
      }
      __syncthreads();

      // layer 2: (rows, 256) @ (256, 64), leaky-ReLU; thread t owns column
      // t % 64 for rows t / 64 + 4 i.  A warp shares its rows, so the h1
      // reads are broadcasts and the w2 reads hit 32 consecutive banks.
      {
        const int m = t % H2, g = t / H2;
        float a[ROWS_PER_THREAD];
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) a[i] = 0.0f;
        for (int j = 0; j < H1; ++j) {
          const float wv = sw2[j * H2 + m];
#pragma unroll
          for (int i = 0; i < ROWS_PER_THREAD; ++i)
            a[i] = fmaf(sh1[(g + ROW_GROUPS * i) * H1 + j], wv, a[i]);
        }
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
          const int r = g + ROW_GROUPS * i;
          if (r < rows) sh2[r * H2 + m] = lrelu(a[i] + sb2[m]);
        }
      }
      __syncthreads();

      // layer 3: (rows, 64) @ (64, 16), leaky-ReLU
      for (int i = t; i < rows * H3; i += THREADS) {
        const int r = i / H3, q = i % H3;
        float a = 0.0f;
        for (int m = 0; m < H2; ++m) a = fmaf(sh2[r * H2 + m], sw3[m * H3 + q], a);
        sh3[r * H3 + q] = lrelu(a + sb3[q]);
      }
      __syncthreads();

      // layer 4: (rows, 16) @ (16, 1), then the squared error per row
      if (t < rows) {
        float a = 0.0f;
#pragma unroll
        for (int q = 0; q < H3; ++q) a = fmaf(sh3[t * H3 + q], sw4[q], a);
        const float d = sy[t] - (a + sb4[0]);
        ssq[t] = d * d;
      }
      __syncthreads();
      if (t == 0)
        for (int r = 0; r < rows; ++r) sum += ssq[r];
    }
    if (t == 0) {
      float err = sum / (float)R;
      if (!keep || !isfinite(err)) err = INFINITY;
      out[(size_t)f * ns + p] = err;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for probe width w.
long long pool_mlp_smem_bytes(int w) {
  return (long long)(smem_floats(w) * sizeof(float));
}

// Launch the sweep on `stream` (a cudaStream_t) of device `device`.  All
// pointers are device pointers of contiguous fp32 tensors (valid: bool, or
// null for all-valid).  Returns cudaGetLastError() after the launch: 0 when
// the launch was accepted.
int pool_mlp_errors_f32(const float* xd, const float* y,
                        const float* w0, const float* b0,
                        const float* w1, const float* b1,
                        const float* w2, const float* b2,
                        const float* w3, const float* b3,
                        const float* w4, const float* b4,
                        const unsigned char* valid, float* out,
                        int nf, int ns, int R, int w, int device,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = smem_floats(w) * sizeof(float);
  e = cudaFuncSetAttribute(pool_mlp_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  pool_mlp_kernel<<<ns, THREADS, bytes, (cudaStream_t)stream>>>(
      xd, y, w0, b0, w1, b1, w2, b2, w3, b3, w4, b4, valid, out, nf, ns, R,
      w);
  return (int)cudaGetLastError();
}

const char* pool_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
